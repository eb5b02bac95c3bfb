"""Transformer assembly: the dense, MoE, vlm and encoder-decoder audio
families, forward only.

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
``scan_layers`` loops over it (nothing is differentiated, so there are no
remat groups).  A cache is a dict of (L, B, S_max, Hkv, Dh) tensors that
the layers update IN PLACE (a cached call returns the same dict): the
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

import torch

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
from repro_torch.utils.trees import tree_leaves, tree_map


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
    """Per-layer views of a stacked layer tree (no copy)."""
    n = tree_leaves(stacked)[0].shape[0]
    return [tree_map(lambda a, i=i: a[i], stacked) for i in range(n)]


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
    q = x @ p["wq"].to(x.dtype)
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
    q = q.view(B, S, H, Dh)
    if rope_cs is not None:
        cos, sin = rope_cs
        q = apply_rope(q, cos, sin)
    kv_len, q_offset = None, 0
    if cross_cached:
        k, v = cache["k"], cache["v"]
    else:
        src = x if kv_x is None else kv_x
        k = src @ p["wk"].to(x.dtype)
        v = src @ p["wv"].to(x.dtype)
        if "bk" in p:
            k = k + p["bk"].to(x.dtype)
            v = v + p["bv"].to(x.dtype)
        k, v = k.view(B, -1, Hkv, Dh), v.view(B, -1, Hkv, Dh)
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
        # the reference repeats KV to full heads for multi-token calls (a
        # sharding device there); decode (S == 1) attends grouped
        k = torch.repeat_interleave(k, H // Hkv, dim=2)
        v = torch.repeat_interleave(v, H // Hkv, dim=2)
    out = attention(q, k, v, causal=causal and kv_x is None
                    and not cross_cached, q_offset=q_offset, kv_len=kv_len,
                    chunked_threshold=cfg.attn_chunk_threshold)
    return out.reshape(B, S, H * Dh) @ p["wo"].to(x.dtype)


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
    q = (x @ p["wq"].to(x.dtype)).view(B, S, H, dn + dr)
    q_nope, q_rope = q[..., :dn], apply_rope(q[..., dn:], cos, sin)
    dkv = x @ p["w_dkv"].to(x.dtype)
    c_kv = rmsnorm(dkv[..., :r], p["kv_norm"])
    k_rope = apply_rope(dkv[..., None, r:], cos, sin)  # one shared head
    kv_len, q_offset = None, 0
    if cache is not None:
        _write_rows(cache["c_kv"], c_kv, pos)
        _write_rows(cache["k_rope"], k_rope, pos)
        c_kv, k_rope = cache["c_kv"].to(x.dtype), cache["k_rope"].to(x.dtype)
        kv_len, q_offset = pos + S, pos
    w_ukv = p["w_ukv"].to(x.dtype)
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
        ukv = (c_kv @ w_ukv).view(B, -1, H, dn + dv)
        k_nope, v = ukv[..., :dn], ukv[..., dn:]
        k = torch.cat([k_nope, k_rope.expand(B, k_nope.shape[1], H, dr)],
                      dim=-1)
        out = attention(torch.cat([q_nope, q_rope], dim=-1), k, v,
                        causal=True, q_offset=q_offset, kv_len=kv_len,
                        softmax_scale=(dn + dr) ** -0.5,
                        chunked_threshold=cfg.attn_chunk_threshold)
    return out.reshape(B, S, H * dv) @ p["wo"].to(x.dtype)


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
        x = x + a
        m, metrics = ffn(apply_norm(cfg.norm_type, p, "mlp_norm", x))
        x = x + m
    if enc_h is not None or (cache is not None and "cross" in cache):
        h = apply_norm(cfg.norm_type, p, "cross_norm", x)
        x = x + gqa_attn(p["cross"], cfg, h, None,
                         None if cache is None else cache["cross"], None,
                         causal=False, kv_x=enc_h,
                         cross_cached=enc_h is None)
    return x, metrics


def scan_layers(layers, cfg: ArchConfig, x, rope_cs, cache, pos, *,
                moe: bool = False, causal=True, enc_h=None):
    """One homogeneous layer stack: ``layers`` a stacked tree or a list of
    per-layer trees (``bake_lm_params``); ``cache`` the stack's cache tree
    of stacked (L, B, ...) leaves, or None.  Returns (x, metrics), each
    metric the mean over the stack's layers (the reference's)."""
    if isinstance(layers, dict):
        layers = unstack_layers(layers)
    per = []
    for i, p in enumerate(layers):
        c = None if cache is None else tree_map(lambda v, i=i: v[i], cache)
        x, m = layer_fwd(p, cfg, x, rope_cs, c, pos, moe=moe, causal=causal,
                         enc_h=enc_h)
        per.append(m)
    metrics = {k: torch.stack([m[k] for m in per]).mean()
               for k in (per[0] if per else {})}
    return x, metrics


def embed_tokens(params, cfg: ArchConfig, tokens):
    return params["embed"][tokens.long()].to(act_dtype(cfg))


def _rope(cfg: ArchConfig, positions, dim: int):
    return rope_angles(positions, int(dim * cfg.rotary_frac), cfg.rope_theta)


def backbone(params, cfg: ArchConfig, x, pos, cache, enc_h=None):
    """Run the decoder stacks (the dense ``layers``, then ``moe_layers``;
    the encoder-decoder's ``layers`` against ``cache["self"]`` and
    ``enc_h`` or the cached cross K/V) on embedded ``x`` (B, S, D) from
    position ``pos``; ``cache`` is the bundle's cache dict or None.
    Returns (the final normed hidden states, metrics: the MoE stack's
    means)."""
    S = x.shape[1]
    ar = torch.arange(S, device=x.device)
    positions = ar + (pos.reshape(-1, 1) if isinstance(pos, torch.Tensor)
                      and pos.dim() else pos)
    rope = _rope(cfg, positions, cfg.qk_rope_dim if cfg.use_mla else cfg.dh)
    metrics = {}
    for name, part, moe in ENCDEC_STACKS if cfg.is_encdec else STACKS:
        if name in params:
            x, m = scan_layers(params[name], cfg, x, rope,
                               None if cache is None else cache[part], pos,
                               moe=moe, enc_h=enc_h)
            metrics.update(m)
    return apply_norm(cfg.norm_type, params, "final_norm", x), metrics


def run_encoder(params, cfg: ArchConfig, frames):
    """The non-causal encoder over the frame embeddings (B, S_enc, D):
    rope over positions 0..S_enc-1, the ``enc_layers``, ``enc_norm``."""
    x = frames.to(act_dtype(cfg))
    rope = _rope(cfg, torch.arange(x.shape[1], device=x.device), cfg.dh)
    x, _ = scan_layers(params["enc_layers"], cfg, x, rope, None, 0,
                       causal=False)
    return apply_norm(cfg.norm_type, params, "enc_norm", x)


def logits_last(params, cfg: ArchConfig, hidden):
    """LM-head logits (fp32) at the last position: (B, V)."""
    h = hidden[:, -1, :]
    return (h @ params["lm_head"].to(h.dtype)).float()


def logits_all(params, cfg: ArchConfig, hidden):
    """LM-head logits (fp32) at every position of a cached multi-token
    step: (B, S, V)."""
    return (hidden @ params["lm_head"].to(hidden.dtype)).float()
