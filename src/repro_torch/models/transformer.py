"""Transformer assembly: the dense, MoE, vlm and encoder-decoder audio
families, and the LM loss.

The port of ``repro/models/transformer.py``: param declarations in the
reference's names, shapes and init kinds, GQA and MLA (DeepSeek-V2
multi-head latent) attention against an optional cache, cross attention
(K/V from the encoder output, or from the cached cross K/V), the layer
body (sequential or ``parallel_block`` residual, a dense MLP or the MoE
FFN of ``models/moe.py``, then the cross-attention block of a decoder
layer with its own norm), the layer stacks (``layers``: the dense ones,
then ``moe_layers``; the encoder-decoder's ``enc_layers`` and decoder
``layers``), the non-causal encoder, embedding and the LM-head logits.

The reference scans the stacked layer axis with ``jax.lax.scan``; here
``scan_layers`` loops over it.  Under ``remat=True`` (the loss's call
only) each layer runs under ``torch.utils.checkpoint`` with the config's
``remat_policy`` ("nothing": only the layer's input is kept; "dots":
matrix products without a batch axis are kept too, the reference's
``dots_with_no_batch_dims_saveable``), and with ``cfg.scan_layers`` the
layers are grouped by ``_pick_group`` into checkpointed groups of
checkpointed layers: the reference's two-level sqrt-depth schedule.
``chunked_cross_entropy`` is the reference's memory-bounded loss.

A cache is a dict of (L, B, S_max, Hkv, Dh) tensors that the layers
update IN PLACE (a cached call returns the same dict): the
session layer owns its cache grid, and copying it per step would move the
whole cache.  MLA caches the compressed latent instead: {"c_kv" (L, B,
S_max, r), "k_rope" (L, B, S_max, 1, dr)}.  The encoder-decoder's cache
is {"self": {"k", "v", "cross": {"k", "v"} (L, B, S_enc, Hkv, Dh)}}: a
prefill with the encoder output fills "cross" (the caller sizes it to the
frames), every other cached call reads it and never writes it.  ``pos``
is a Python int (the uncached prefill, as in the reference) or a tensor,
0-d or per lane (B,): each lane writes its K/V rows at its own position
and attends over its own length, which is how the session layer runs
every slot at its own position in one call.  As
``jax.lax.dynamic_update_slice`` does, a write that would run past the
cache is moved back to end at its last row (only masked steps of a lane
at ``seq_cap`` reach it; their rows are never read).

``bake_lm_params`` casts every leaf to the activation dtype once and
splits the stacked layers into per-layer views: the reference casts each
fp32 weight at every use, which is the same bits, and on the card would
re-read the fp32 tree every step.  The MoE router is the exception: the
reference casts it to fp32 at each use, so it stays fp32 (a bf16 router
would route otherwise), and so do the leaves the recurrent families cast
to fp32 at their use (RWKV's decay base, bonus and group-norm affine,
Mamba's ``a_log`` and ``dt_bias``).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (
    MLP_FNS,
    NEG_INF,
    apply_norm,
    apply_rope,
    attention,
    rmsnorm,
    rope_angles,
)
from repro_torch.models.moe import moe_ffn, moe_param_defs
from repro_torch.models.params import ParamDef, map_defs
from repro_torch.models.rwkv import FP32_KEYS as RWKV_FP32
from repro_torch.models.ssm import FP32_KEYS as SSM_FP32
from repro_torch.sharding.ctx import constrain
from repro_torch.sharding.placed import (
    is_dt,
    lane_layout,
    lane_local,
    like,
    linear,
    local_apply,
    merge_heads,
    mesh_of,
    replicated,
    split_heads,
    use,
)
from repro_torch.utils.trees import tree_leaves, tree_map, tree_unflatten


def act_dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.act_dtype == "bfloat16" else torch.float32


# ---------------------------------------------------------------------------
# Parameter declarations
# ---------------------------------------------------------------------------

def norm_param_defs(cfg: ArchConfig) -> dict:
    D = cfg.d_model
    if cfg.norm_type == "rmsnorm":
        return {"w": ParamDef((D,), ("embed",), init="ones")}
    if cfg.norm_type == "layernorm":
        return {"w": ParamDef((D,), ("embed",), init="ones"),
                "b": ParamDef((D,), ("embed",), init="zeros")}
    return {}  # layernorm_np: non-parametric


def attn_param_defs(cfg: ArchConfig) -> dict:
    D, H, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.dh
    if cfg.use_mla:
        dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
        dv, r = cfg.v_head_dim, cfg.kv_lora_rank
        return {
            "wq": ParamDef((D, H * (dn + dr)), ("embed", "heads")),
            "w_dkv": ParamDef((D, r + dr), ("embed", None)),
            "kv_norm": ParamDef((r,), (None,), init="ones"),
            "w_ukv": ParamDef((r, H * (dn + dv)), (None, "heads")),
            "wo": ParamDef((H * dv, D), ("heads", "embed"),
                           scale=(H * dv) ** -0.5),
        }
    defs = {
        "wq": ParamDef((D, H * Dh), ("embed", "heads")),
        "wk": ParamDef((D, Hkv * Dh), ("embed", "kv_heads")),
        "wv": ParamDef((D, Hkv * Dh), ("embed", "kv_heads")),
        "wo": ParamDef((H * Dh, D), ("heads", "embed"),
                       scale=(H * Dh) ** -0.5),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((H * Dh,), ("heads",), init="zeros")
        defs["bk"] = ParamDef((Hkv * Dh,), ("kv_heads",), init="zeros")
        defs["bv"] = ParamDef((Hkv * Dh,), ("kv_heads",), init="zeros")
    return defs


def mlp_param_defs(cfg: ArchConfig) -> dict:
    D, F = cfg.d_model, cfg.d_ff
    if cfg.mlp_type == "swiglu":
        return {
            "wg": ParamDef((D, F), ("embed", "ffn")),
            "wi": ParamDef((D, F), ("embed", "ffn")),
            "wd": ParamDef((F, D), ("ffn", "embed"), scale=F ** -0.5),
        }
    defs = {
        "wi": ParamDef((D, F), ("embed", "ffn")),
        "wd": ParamDef((F, D), ("ffn", "embed"), scale=F ** -0.5),
    }
    if cfg.mlp_bias:
        defs["bi"] = ParamDef((F,), ("ffn",), init="zeros")
        defs["bd"] = ParamDef((D,), ("embed",), init="zeros")
    return defs


def layer_param_defs(cfg: ArchConfig, *, moe: bool = False,
                     cross: bool = False) -> dict:
    defs = {"attn_norm": norm_param_defs(cfg), "attn": attn_param_defs(cfg)}
    if not cfg.parallel_block:
        defs["mlp_norm"] = norm_param_defs(cfg)
    defs["mlp"] = moe_param_defs(cfg) if moe else mlp_param_defs(cfg)
    if cross:
        defs["cross_norm"] = norm_param_defs(cfg)
        defs["cross"] = attn_param_defs(cfg.replace(use_mla=False))
    return defs


def stack_defs(defs, n: int):
    """Prepend the stacked ``layers`` dimension to every ParamDef."""
    return map_defs(lambda d: ParamDef((n,) + d.shape, ("layers",) + d.axes,
                                       d.init, d.dtype, d.scale), defs)


def model_param_defs(cfg: ArchConfig) -> dict:
    """The dense, MoE and vlm trees (the two decoder stacks), or the
    encoder-decoder's (``enc_layers``, ``enc_norm`` and the decoder
    ``layers`` with cross attention)."""
    D, V = cfg.d_model, cfg.vocab_size
    defs = {
        "embed": ParamDef((V, D), ("vocab", "embed"), init="embed"),
        "final_norm": norm_param_defs(cfg),
        "lm_head": ParamDef((D, V), ("embed", "vocab")),
    }
    if cfg.is_encdec:
        defs["enc_layers"] = stack_defs(layer_param_defs(cfg),
                                        cfg.n_enc_layers)
        defs["enc_norm"] = norm_param_defs(cfg)
        defs["layers"] = stack_defs(layer_param_defs(cfg, cross=True),
                                    cfg.n_layers)
        return defs
    n_moe, n_dense = stack_sizes(cfg)
    if n_dense:
        defs["layers"] = stack_defs(layer_param_defs(cfg), n_dense)
    if n_moe:
        defs["moe_layers"] = stack_defs(layer_param_defs(cfg, moe=True),
                                        n_moe)
    return defs


def stack_sizes(cfg: ArchConfig) -> tuple[int, int]:
    """(MoE layers, dense layers): the first ``n_dense_layers`` are dense
    when the config has experts."""
    n_moe = cfg.n_layers - cfg.n_dense_layers if cfg.n_experts else 0
    return n_moe, cfg.n_layers - n_moe


# (param stack, cache part, MoE) of the decoder, in model order
STACKS = (("layers", "dense", False), ("moe_layers", "moe", True))
ENCDEC_STACKS = (("layers", "self", False),)
# every stacked layer tree a params dict may hold
LAYER_STACKS = ("layers", "moe_layers", "enc_layers")


def unstack_layers(stacked) -> list:
    """Per-layer views of a stacked layer tree (no copy).  ``unbind``: its
    backward stacks the L layers' gradients in one op, where L ``a[i]``
    selects would each scatter into a zero tensor of the whole stack."""
    per_leaf = [a.unbind(0) for a in tree_leaves(stacked)]
    return [tree_unflatten(stacked, [u[i] for u in per_leaf])
            for i in range(len(per_leaf[0]))]


# leaves every family's forward casts to fp32 at their use
FP32_LEAVES = frozenset(("router",) + RWKV_FP32 + SSM_FP32)


def _bake(node, dtype, key=None):
    if isinstance(node, dict):
        return {k: _bake(v, dtype, k) for k, v in node.items()}
    return node.float() if key in FP32_LEAVES else node.to(dtype)


def bake_lm_params(params: dict, cfg: ArchConfig) -> dict:
    """The serving tree: every leaf cast once to the activation dtype
    (bit-identical to the reference's cast at each use), the leaves the
    reference casts to fp32 at their use kept fp32 (``FP32_LEAVES``), and
    each layer stack as a list of per-layer views.  Idempotent: a baked
    tree comes back as it is."""
    dtype = act_dtype(cfg)
    out = {k: _bake(v, dtype) for k, v in params.items()
           if k not in LAYER_STACKS}
    for name in LAYER_STACKS:
        if name not in params:
            continue
        layers = params[name]
        if isinstance(layers, dict):
            layers = unstack_layers(_bake(layers, dtype))
        out[name] = [_bake(p, dtype) for p in layers]
    return out


# ---------------------------------------------------------------------------
# Attention block with an optional cache
# ---------------------------------------------------------------------------

def _write_rows(buf, new, pos):
    """Write ``new`` (B, S, ...) into the cache leaf ``buf`` (B, S_max, ...)
    at rows [pos, pos + S) of each lane, in place.  ``pos``: a Python int,
    or a tensor 0-d or (B,)."""
    if is_dt(buf):
        return _write_rows_placed(buf, new, pos)
    S, s_max = new.shape[1], buf.shape[1]
    new = new.to(buf.dtype)
    if isinstance(pos, int):
        start = min(max(pos, 0), s_max - S)
        buf[:, start:start + S] = new
        return
    B = buf.shape[0]
    start = torch.clamp(pos.reshape(-1).expand(B), 0, s_max - S)
    rows = start[:, None] + torch.arange(S, device=buf.device)
    lanes = torch.arange(B, device=buf.device)[:, None].expand(B, S)
    buf.index_put_((lanes, rows), new)


def _write_rows_placed(buf, new, pos):
    """``_write_rows`` into a placed cache leaf: each rank writes its own
    lanes' rows into its block.  Where the sequence is sharded (a
    context-parallel cache, ``launch/specs.cache_pspecs``) a rank keeps
    the rows that fall in its block and sends the others to a scratch
    row."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.sharding import spmd

    mesh, pl = buf.device_mesh, buf.placements
    whole = [Replicate() if isinstance(q, Shard) and q.dim == 1 else q
             for q in pl]
    nl = new.to(buf.dtype).redistribute(mesh, whole).to_local()
    bl = buf.to_local()
    pos = lane_local(pos, mesh, pl)
    lo, hi = spmd.block_range(mesh, pl, 1, buf.shape[1])
    per = hi - lo
    if per == buf.shape[1]:
        return _write_rows(bl, nl, pos)
    Bl, S = nl.shape[:2]
    start = torch.clamp(torch.as_tensor(pos, device=bl.device).reshape(-1)
                        .expand(Bl), 0, buf.shape[1] - S)
    rows = start[:, None] + torch.arange(S, device=bl.device) - lo
    rows = torch.where((rows >= 0) & (rows < per), rows, per)
    lanes = torch.arange(Bl, device=bl.device)[:, None].expand(Bl, S)
    tmp = torch.cat([bl, bl.new_zeros((Bl, 1) + tuple(bl.shape[2:]))], 1)
    tmp.index_put_((lanes, rows), nl)
    bl.copy_(tmp[:, :per])


def gqa_attn(p, cfg: ArchConfig, x, rope_cs, cache, pos, *, causal=True,
             kv_x=None, cross_cached=False):
    """Self- or cross-attention with an optional cache (this layer's
    {"k", "v"} views).  The reference's modes, chosen by the caller:

      self, no cache        training-shaped calls and the encoder
      self, cache + pos     prefill or a step: K/V rows written in place
      cross, kv_x           K/V from the encoder output ``kv_x`` (no rope,
                            not causal); with a cache, copied into it
      cross, cross_cached   the cached cross K/V, read and never written
    """
    B, S, _ = x.shape
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh
    q = linear(x, use(p["wq"], x.dtype))
    if "bq" in p:
        q = q + use(p["bq"], x.dtype)
    q = split_heads(q, B, S, H, Dh)
    if rope_cs is not None:
        cos, sin = rope_cs
        q = apply_rope(q, cos, sin)
    q = constrain(q, ("batch", None, "heads_act", None))
    kv_len, q_offset = None, 0
    if cross_cached:
        k, v = cache["k"], cache["v"]
    else:
        src = x if kv_x is None else kv_x
        k = linear(src, use(p["wk"], x.dtype))
        v = linear(src, use(p["wv"], x.dtype))
        if "bk" in p:
            k = k + use(p["bk"], x.dtype)
            v = v + use(p["bv"], x.dtype)
        k, v = split_heads(k, B, -1, Hkv, Dh), split_heads(v, B, -1, Hkv, Dh)
        if rope_cs is not None and kv_x is None:
            k = apply_rope(k, cos, sin)
        if kv_x is not None and cache is not None:
            # the cross prefill: the leaves are the frames' length
            cache["k"].copy_(k)
            cache["v"].copy_(v)
        elif cache is not None:
            _write_rows(cache["k"], k, pos)
            _write_rows(cache["v"], v, pos)
            k, v = cache["k"], cache["v"]
            kv_len, q_offset = pos + S, pos
    if cfg.attn_kv_repeat and Hkv < H and S > 1:
        # the reference repeats KV to full heads for multi-token calls (the
        # sequence gathered first, then the heads sharded); decode (S ==
        # 1) attends grouped
        k = constrain(k, ("batch", None, None, None))
        v = constrain(v, ("batch", None, None, None))
        k, v = repeat_heads(k, H // Hkv), repeat_heads(v, H // Hkv)
        k = constrain(k, ("batch", None, "heads_act", None))
        v = constrain(v, ("batch", None, "heads_act", None))
    out = attention(q, k, v, causal=causal and kv_x is None
                    and not cross_cached, q_offset=q_offset, kv_len=kv_len,
                    chunked_threshold=cfg.attn_chunk_threshold)
    return linear(merge_heads(out, B, S, H * Dh), use(p["wo"], x.dtype))


def repeat_heads(t, n: int):
    """``torch.repeat_interleave(t, n, dim=2)`` as an expand: the same
    values, and a backward that sums the n copies by a reduction of fixed
    order (PyTorch lists ``repeat_interleave``'s backward, an index add,
    among its CUDA ops whose order is left to the hardware)."""
    B, S, Hkv, Dh = t.shape
    return t[:, :, :, None].expand(B, S, Hkv, n, Dh).reshape(B, S, Hkv * n,
                                                             Dh)


def _lane_len(v):
    """A cache length, int or tensor (0-d or per lane (B,)), shaped to
    broadcast against (B, H, S, S_kv) scores."""
    return v.reshape(-1, 1, 1, 1) if isinstance(v, torch.Tensor) else v


def mla_attn(p, cfg: ArchConfig, x, rope_cs, cache, pos):
    """DeepSeek-V2 multi-head latent attention.  Caches only the
    compressed latent (``cache`` = this layer's {"c_kv" (B, S_max, r),
    "k_rope" (B, S_max, 1, dr)} views, written in place) and up-projects
    it per call (the baseline); with ``cfg.mla_absorb`` a cached S=1 call
    folds W_uk into the query and W_uv into the output and attends in the
    latent space, scores in fp32 (the reference's
    ``preferred_element_type``), masked to -1e30 past the lane's
    length."""
    B, S, _ = x.shape
    H = cfg.n_heads
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    dv, r = cfg.v_head_dim, cfg.kv_lora_rank
    cos, sin = rope_cs
    q = split_heads(linear(x, use(p["wq"], x.dtype)), B, S, H, dn + dr)
    q_nope, q_rope = q[..., :dn], apply_rope(q[..., dn:], cos, sin)
    dkv = linear(x, use(p["w_dkv"], x.dtype))
    c_kv = rmsnorm(dkv[..., :r], p["kv_norm"])
    k_rope = apply_rope(dkv[..., None, r:], cos, sin)  # one shared head
    kv_len, q_offset = None, 0
    if cache is not None:
        _write_rows(cache["c_kv"], c_kv, pos)
        _write_rows(cache["k_rope"], k_rope, pos)
        c_kv, k_rope = cache["c_kv"].to(x.dtype), cache["k_rope"].to(x.dtype)
        kv_len, q_offset = pos + S, pos
    w_ukv = use(p["w_ukv"], x.dtype)
    if cfg.mla_absorb and S == 1 and cache is not None:
        w_ukv = w_ukv.view(r, H, dn + dv)
        w_uk, w_uv = w_ukv[..., :dn], w_ukv[..., dn:]
        q_eff = torch.einsum("bshd,rhd->bshr", q_nope, w_uk)
        scores = torch.einsum("bshr,bkr->bhsk", q_eff.float(), c_kv.float())
        scores = scores + torch.einsum("bshd,bkzd->bhsk", q_rope.float(),
                                       k_rope.float())
        scores = scores * (dn + dr) ** -0.5
        live = torch.arange(c_kv.shape[1], device=x.device) \
            < _lane_len(kv_len)
        scores = torch.where(live, scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        ctx = torch.einsum("bhsk,bkr->bshr", probs, c_kv)
        out = torch.einsum("bshr,rhd->bshd", ctx, w_uv)
    else:
        ukv = split_heads(linear(c_kv, w_ukv), B, -1, H, dn + dv)
        k_nope, v = ukv[..., :dn], ukv[..., dn:]
        k = torch.cat([k_nope, k_rope.expand(B, k_nope.shape[1], H, dr)],
                      dim=-1)
        out = attention(torch.cat([q_nope, q_rope], dim=-1), k, v,
                        causal=True, q_offset=q_offset, kv_len=kv_len,
                        softmax_scale=(dn + dr) ** -0.5,
                        chunked_threshold=cfg.attn_chunk_threshold)
    return linear(merge_heads(out, B, S, H * dv), use(p["wo"], x.dtype))


# ---------------------------------------------------------------------------
# Layer body + stacks
# ---------------------------------------------------------------------------

def layer_fwd(p, cfg: ArchConfig, x, rope_cs, cache, pos, *,
              moe: bool = False, causal=True, enc_h=None):
    """One transformer layer; updates ``cache`` in place.  A decoder layer
    of the encoder-decoder ends with cross attention (its own norm, after
    the MLP): over ``enc_h`` when given (filling ``cache["cross"]`` when
    cached), else over the cached ``cache["cross"]``.  Returns (x,
    metrics): the MoE FFN's {"moe_aux", "moe_dropped"}, else {}."""
    x = constrain(x, ("batch", "seq_act", None))
    h = apply_norm(cfg.norm_type, p, "attn_norm", x)
    if cfg.use_mla:
        a = mla_attn(p["attn"], cfg, h, rope_cs, cache, pos)
    else:
        a = gqa_attn(p["attn"], cfg, h, rope_cs, cache, pos, causal=causal)

    def ffn(h):
        if moe:
            return moe_ffn(p["mlp"], cfg, h)
        return MLP_FNS[cfg.mlp_type](p["mlp"], h), {}

    if cfg.parallel_block:
        m, metrics = ffn(h)
        x = x + a + m
    else:
        x = constrain(x + a, ("batch", "seq_act", None))
        m, metrics = ffn(apply_norm(cfg.norm_type, p, "mlp_norm", x))
        x = x + m
    if enc_h is not None or (cache is not None and "cross" in cache):
        x = constrain(x, ("batch", "seq_act", None))
        h = apply_norm(cfg.norm_type, p, "cross_norm", x)
        x = x + gqa_attn(p["cross"], cfg, h, None,
                         None if cache is None else cache["cross"], None,
                         causal=False, kv_x=enc_h,
                         cross_cached=enc_h is None)
    return x, metrics


_DOTS = frozenset((torch.ops.aten.mm.default, torch.ops.aten.addmm.default))


def _dots_saveable(ctx, op, *args, **kwargs):
    """The reference's ``dots_with_no_batch_dims_saveable``: keep the
    outputs of matrix products without a batch axis (``aten.mm``/``addmm``:
    the weight products; the attention einsums and MoE expert products
    are batched, ``bmm``, and recomputed as the reference does)."""
    return CheckpointPolicy.MUST_SAVE if op in _DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def checkpointed(fn, policy: str = "nothing"):
    """``fn`` under ``torch.utils.checkpoint`` (non-reentrant): only its
    inputs (and, with ``policy="dots"``, its weight products) are kept for
    the backward, the rest recomputed.  Nothing on the LM path draws
    random numbers, so no RNG state is saved."""
    if policy not in ("nothing", "dots"):
        raise ValueError(f"unknown remat policy {policy!r}")
    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_saveable)

    def run(*args):
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False, **kw)

    return run


def _pick_group(L: int, max_group: int = 8) -> int:
    """Largest divisor of L that is <= max_group (two-level remat
    grouping)."""
    for g in range(min(max_group, L), 0, -1):
        if L % g == 0:
            return g
    return 1


def scan_layers(layers, cfg: ArchConfig, x, rope_cs, cache, pos, *,
                moe: bool = False, causal=True, enc_h=None,
                remat: bool = False):
    """One homogeneous layer stack: ``layers`` a stacked tree or a list of
    per-layer trees (``bake_lm_params``); ``cache`` the stack's cache tree
    of stacked (L, B, ...) leaves, or None.  Returns (x, metrics), each
    metric the mean over the stack's layers (the reference's).
    ``remat`` (uncached calls only): each layer checkpointed with
    ``cfg.remat_policy``, and with ``cfg.scan_layers`` the layers grouped
    into checkpointed groups of ``_pick_group(L)`` (module docstring)."""
    if isinstance(layers, dict):
        layers = unstack_layers(layers)
    if remat and cache is not None:
        raise ValueError("remat is for uncached (training) calls")

    def body(x, p, c=None):
        return layer_fwd(p, cfg, x, rope_cs, c, pos, moe=moe, causal=causal,
                         enc_h=enc_h)

    if remat:
        body = checkpointed(body, cfg.remat_policy)
    L = len(layers)
    G = _pick_group(L) if remat and cfg.scan_layers else 1
    per = []
    if G > 1:
        def group(x, i0):
            ms = []
            for p in layers[i0:i0 + G]:
                x, m = body(x, p)
                ms.append(m)
            return x, ms

        group = checkpointed(group)
        for i0 in range(0, L, G):
            x, ms = group(x, i0)
            per.extend(ms)
    else:
        for i, p in enumerate(layers):
            c = None if cache is None \
                else tree_map(lambda v, i=i: v[i], cache)
            x, m = body(x, p, c)
            per.append(m)
    metrics = {k: torch.stack([m[k] for m in per]).mean()
               for k in (per[0] if per else {})}
    return x, metrics


class _EmbedRows(torch.autograd.Function):
    """``F.embedding`` with a backward that sums each row's repeats in a
    fixed order on both devices: on CUDA ``index_put_`` with accumulate
    (it sorts the indices and walks a row's repeats in order), on the CPU
    ``embedding_dense_backward`` (threads split the rows, each walks the
    indices in order).  The library's own backwards each leave the order
    to the hardware on one device (``F.embedding``'s on CUDA, an index's
    on the CPU's threads), and a training step then gives other bits from
    run to run."""

    @staticmethod
    def forward(ctx, weight, idx):
        ctx.save_for_backward(idx)
        ctx.rows = weight.shape[0]
        return F.embedding(idx, weight)

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        if g.device.type == "cuda":
            flat = g.reshape(-1, g.shape[-1])
            dw = flat.new_zeros((ctx.rows, flat.shape[1])).index_put_(
                (idx.reshape(-1),), flat, accumulate=True)
        else:
            dw = torch.ops.aten.embedding_dense_backward(g, idx, ctx.rows,
                                                         -1, False)
        return dw, None


def _lookup(w, idx):
    if torch.is_grad_enabled() and w.requires_grad:
        return _EmbedRows.apply(w, idx)
    return F.embedding(idx, w)


def embed_tokens(params, cfg: ArchConfig, tokens):
    """The embedding rows of ``tokens`` in the activation dtype; under
    autograd through ``_EmbedRows`` (a backward that repeats bit for
    bit).  On a mesh the table is gathered whole (vocab over ``model``
    and ``embed`` over ``data`` cut every row) and each rank looks up
    its own lanes: the same rows, and the table's gradient a ``Partial``
    sum over the lane blocks."""
    w, idx = params["embed"], tokens.long()
    mesh = mesh_of(w, idx)
    if mesh is None:
        return _lookup(w, idx).to(act_dtype(cfg))
    lay = lane_layout(mesh, idx)
    return local_apply(_lookup, mesh, (w, idx), (replicated(mesh), lay),
                       lay).to(act_dtype(cfg))


def _rope(cfg: ArchConfig, positions, dim: int):
    return rope_angles(positions, int(dim * cfg.rotary_frac), cfg.rope_theta)


def rope_tables(cfg: ArchConfig, S: int, pos, dim: int, x):
    """(cos, sin) for ``S`` positions from ``pos`` (an int, or a tensor
    0-d or per lane (B,)).  On a mesh (``x`` a DTensor) the tables are
    replicated DTensors, built the same on every rank from the positions
    (a placed 0-d ``pos`` is replicated, so its value is every rank's);
    per-lane positions give per-lane tables, built on each rank's
    lanes."""
    ar = torch.arange(S, device=x.device)
    if is_dt(pos) and pos.dim():
        mesh = pos.device_mesh
        lay = lane_layout(mesh, pos)
        return local_apply(lambda p: _rope(cfg, ar + p.reshape(-1, 1), dim),
                           mesh, (pos,), (lay,), (lay, lay))
    if is_dt(pos):
        pos = pos.full_tensor()
    positions = ar + (pos.reshape(-1, 1) if isinstance(pos, torch.Tensor)
                      and pos.dim() else pos)
    return tuple(like(t, x) for t in _rope(cfg, positions, dim))


def backbone(params, cfg: ArchConfig, x, pos, cache, enc_h=None, *,
             remat: bool = False):
    """Run the decoder stacks (the dense ``layers``, then ``moe_layers``;
    the encoder-decoder's ``layers`` against ``cache["self"]`` and
    ``enc_h`` or the cached cross K/V) on embedded ``x`` (B, S, D) from
    position ``pos``; ``cache`` is the bundle's cache dict or None.
    ``remat`` (the loss's call) checkpoints the layers (``scan_layers``).
    Returns (the final normed hidden states, metrics: the MoE stack's
    means)."""
    rope = rope_tables(cfg, x.shape[1], pos,
                       cfg.qk_rope_dim if cfg.use_mla else cfg.dh, x)
    metrics = {}
    for name, part, moe in ENCDEC_STACKS if cfg.is_encdec else STACKS:
        if name in params:
            x, m = scan_layers(params[name], cfg, x, rope,
                               None if cache is None else cache[part], pos,
                               moe=moe, enc_h=enc_h, remat=remat)
            metrics.update(m)
    return apply_norm(cfg.norm_type, params, "final_norm", x), metrics


def run_encoder(params, cfg: ArchConfig, frames, *, remat: bool = False):
    """The non-causal encoder over the frame embeddings (B, S_enc, D):
    rope over positions 0..S_enc-1, the ``enc_layers``, ``enc_norm``."""
    x = frames.to(act_dtype(cfg))
    rope = rope_tables(cfg, x.shape[1], 0, cfg.dh, x)
    x, _ = scan_layers(params["enc_layers"], cfg, x, rope, None, 0,
                       causal=False, remat=remat)
    return apply_norm(cfg.norm_type, params, "enc_norm", x)


def _ce_chunk(hc, w_head, yc):
    """One sequence chunk of the loss: (sum of logsumexp - gold logit over
    the labels >= 0, their count, the argmax hits among them), fp32.  The
    gold logit's gather picks one column a row, so its backward writes
    each gradient entry once (no accumulation order to vary).  On a mesh
    the chunk's lanes stay where they are, the product runs against the
    vocab-sharded head and each rank sums its own lanes' rows whole
    over the vocab: three ``Partial`` sums."""
    hc = constrain(hc, ("batch", None, None))
    logits = linear(hc, use(w_head, hc.dtype)).float()
    mesh = mesh_of(logits)
    if mesh is not None:
        from torch.distributed.tensor import Partial, Replicate, Shard

        lay = lane_layout(mesh, logits)
        part = [Partial() if isinstance(q, Shard) else Replicate()
                for q in lay]
        return local_apply(_ce_sums, mesh, (logits, yc), (lay, lay),
                           (part, part, part))
    return _ce_sums(logits, yc)


def _ce_sums(logits, yc):
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, torch.clamp(yc, min=0)[..., None])[..., 0]
    mask = (yc >= 0).float()
    hits = (torch.argmax(logits, dim=-1) == yc).float()
    return ((lse - gold) * mask).sum(), mask.sum(), (hits * mask).sum()


def chunked_cross_entropy(hidden, w_head, labels, chunk: int):
    """The reference's memory-bounded LM loss: S padded to a multiple of
    ``chunk`` with label -1, each (B, chunk) slice's fp32 logits computed
    under its own checkpoint, so the (B, S, V) logits never exist at once
    (a chunk's are recomputed in the backward).  Labels < 0 are masked.
    Returns (mean loss over the unmasked labels, {"acc", "tokens"}); the
    count is at least 1."""
    B, S, _ = hidden.shape
    chunk = min(chunk, S)
    n = -(-S // chunk)
    pad = n * chunk - S
    h, y = hidden, labels.long()
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        y = F.pad(y, (0, pad), value=-1)
    body = checkpointed(_ce_chunk)
    loss_sum = cnt = correct = like(torch.zeros(
        (), dtype=torch.float32, device=hidden.device), hidden)
    for c in range(n):
        sl = slice(c * chunk, (c + 1) * chunk)
        l_c, n_c, r_c = body(h[:, sl], w_head, y[:, sl])
        loss_sum, cnt, correct = loss_sum + l_c, cnt + n_c, correct + r_c
    cnt = torch.clamp(cnt, min=1.0)
    return loss_sum / cnt, {"acc": correct / cnt, "tokens": cnt}


def logits_last(params, cfg: ArchConfig, hidden):
    """LM-head logits (fp32) at the last position: (B, V)."""
    h = hidden[:, -1, :]
    return linear(h, use(params["lm_head"], h.dtype)).float()


def logits_all(params, cfg: ArchConfig, hidden):
    """LM-head logits (fp32) at every position of a cached multi-token
    step: (B, S, V)."""
    return linear(hidden, use(params["lm_head"], hidden.dtype)).float()
