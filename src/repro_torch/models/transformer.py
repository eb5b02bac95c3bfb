"""Decoder-only transformer assembly, dense and MoE families, forward only.

The port of ``repro/models/transformer.py`` without the encoder-decoder (a
later slice): param declarations in the reference's names, shapes and init
kinds, GQA and MLA (DeepSeek-V2 multi-head latent) attention against an
optional cache, the layer body (sequential or ``parallel_block`` residual,
a dense MLP or the MoE FFN of ``models/moe.py``), the two layer stacks
(``layers``: the dense ones, then ``moe_layers``), embedding and the
LM-head logits.

The reference scans the stacked layer axis with ``jax.lax.scan``; here
``scan_layers`` loops over it (nothing is differentiated, so there are no
remat groups).  A cache is a dict of (L, B, S_max, Hkv, Dh) tensors that
the layers update IN PLACE (a cached call returns the same dict): the
session layer owns its cache grid, and copying it per step would move the
whole cache.  MLA caches the compressed latent instead: {"c_kv" (L, B,
S_max, r), "k_rope" (L, B, S_max, 1, dr)}.  ``pos`` is a Python int (the
uncached prefill, as in the reference) or a tensor, 0-d or per lane
(B,): each lane writes its K/V rows at its own position and attends over
its own length, which is how the session layer runs every slot at its
own position in one call.  As
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


def layer_param_defs(cfg: ArchConfig, *, moe: bool = False) -> dict:
    defs = {"attn_norm": norm_param_defs(cfg), "attn": attn_param_defs(cfg)}
    if not cfg.parallel_block:
        defs["mlp_norm"] = norm_param_defs(cfg)
    defs["mlp"] = moe_param_defs(cfg) if moe else mlp_param_defs(cfg)
    return defs


def stack_defs(defs, n: int):
    """Prepend the stacked ``layers`` dimension to every ParamDef."""
    return map_defs(lambda d: ParamDef((n,) + d.shape, ("layers",) + d.axes,
                                       d.init, d.dtype, d.scale), defs)


def model_param_defs(cfg: ArchConfig) -> dict:
    if cfg.family not in ("dense", "moe") or cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: only the dense and MoE decoder-only families are "
            "ported")
    D, V = cfg.d_model, cfg.vocab_size
    defs = {
        "embed": ParamDef((V, D), ("vocab", "embed"), init="embed"),
        "final_norm": norm_param_defs(cfg),
        "lm_head": ParamDef((D, V), ("embed", "vocab")),
    }
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


STACKS = (("layers", "dense", False), ("moe_layers", "moe", True))


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
    stacks = [name for name, _, _ in STACKS]
    out = {k: _bake(v, dtype) for k, v in params.items() if k not in stacks}
    for name in stacks:
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


def gqa_attn(p, cfg: ArchConfig, x, rope_cs, cache, pos, *, causal=True):
    """Self-attention with an optional KV cache (``cache`` = this layer's
    {"k", "v"} (B, S_max, Hkv, Dh) views, written in place)."""
    B, S, _ = x.shape
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q, k, v = q.view(B, S, H, Dh), k.view(B, S, Hkv, Dh), v.view(B, S, Hkv, Dh)
    if rope_cs is not None:
        cos, sin = rope_cs
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    kv_len, q_offset = None, 0
    if cache is not None:
        _write_rows(cache["k"], k, pos)
        _write_rows(cache["v"], v, pos)
        k, v = cache["k"], cache["v"]
        kv_len, q_offset = pos + S, pos
    if cfg.attn_kv_repeat and Hkv < H and S > 1:
        # the reference repeats KV to full heads for multi-token calls (a
        # sharding device there); decode (S == 1) attends grouped
        k = torch.repeat_interleave(k, H // Hkv, dim=2)
        v = torch.repeat_interleave(v, H // Hkv, dim=2)
    out = attention(q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len,
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
              moe: bool = False, causal=True):
    """One transformer layer; updates ``cache`` in place.  Returns (x,
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
        return x + a + m, metrics
    x = x + a
    m, metrics = ffn(apply_norm(cfg.norm_type, p, "mlp_norm", x))
    return x + m, metrics


def scan_layers(layers, cfg: ArchConfig, x, rope_cs, cache, pos, *,
                moe: bool = False, causal=True):
    """One homogeneous layer stack: ``layers`` a stacked tree or a list of
    per-layer trees (``bake_lm_params``); ``cache`` the stack's cache dict
    of stacked (L, B, ...) leaves, or None.  Returns (x, metrics), each
    metric the mean over the stack's layers (the reference's)."""
    if isinstance(layers, dict):
        layers = unstack_layers(layers)
    per = []
    for i, p in enumerate(layers):
        c = None if cache is None else {k: v[i] for k, v in cache.items()}
        x, m = layer_fwd(p, cfg, x, rope_cs, c, pos, moe=moe, causal=causal)
        per.append(m)
    metrics = {k: torch.stack([m[k] for m in per]).mean()
               for k in (per[0] if per else {})}
    return x, metrics


def embed_tokens(params, cfg: ArchConfig, tokens):
    return params["embed"][tokens.long()].to(act_dtype(cfg))


def backbone(params, cfg: ArchConfig, x, pos, cache):
    """Run the decoder stacks (the dense ``layers``, then ``moe_layers``)
    on embedded ``x`` (B, S, D) from position ``pos``; ``cache`` is the
    bundle's cache dict ({"dense", "moe"}) or None.  Returns (the final
    normed hidden states, metrics: the MoE stack's means)."""
    S = x.shape[1]
    ar = torch.arange(S, device=x.device)
    positions = ar + (pos.reshape(-1, 1) if isinstance(pos, torch.Tensor)
                      and pos.dim() else pos)
    rope_dim = int((cfg.qk_rope_dim if cfg.use_mla else cfg.dh)
                   * cfg.rotary_frac)
    cos, sin = rope_angles(positions, rope_dim, cfg.rope_theta)
    metrics = {}
    for name, part, moe in STACKS:
        if name in params:
            x, m = scan_layers(params[name], cfg, x, (cos, sin),
                               None if cache is None else cache[part], pos,
                               moe=moe)
            metrics.update(m)
    return apply_norm(cfg.norm_type, params, "final_norm", x), metrics


def logits_last(params, cfg: ArchConfig, hidden):
    """LM-head logits (fp32) at the last position: (B, V)."""
    h = hidden[:, -1, :]
    return (h @ params["lm_head"].to(h.dtype)).float()


def logits_all(params, cfg: ArchConfig, hidden):
    """LM-head logits (fp32) at every position of a cached multi-token
    step: (B, S, V)."""
    return (hidden @ params["lm_head"].to(hidden.dtype)).float()
