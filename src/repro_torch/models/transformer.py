"""Decoder-only transformer assembly, dense family, forward only.

The port of ``repro/models/transformer.py`` without MoE, MLA and the
encoder-decoder (later slices): param declarations in the reference's
names, shapes and init kinds, GQA attention against an optional KV cache,
the layer body (sequential or ``parallel_block`` residual), the layer
stack, embedding and the LM-head logits.

The reference scans the stacked layer axis with ``jax.lax.scan``; here
``scan_layers`` loops over it (nothing is differentiated, so there are no
remat groups).  A cache is a dict of (L, B, S_max, Hkv, Dh) tensors that
the layers update IN PLACE (a cached call returns the same dict): the
session layer owns its cache grid, and copying it per step would move the
whole cache.  ``pos`` is a Python int (the uncached prefill, as in the
reference) or a tensor, 0-d or per lane (B,): each lane writes its K/V
rows at its own position and attends over its own length, which is how
the session layer runs every slot at its own position in one call.  As
``jax.lax.dynamic_update_slice`` does, a write that would run past the
cache is moved back to end at its last row (only masked steps of a lane
at ``seq_cap`` reach it; their rows are never read).

``bake_lm_params`` casts every leaf to the activation dtype once and
splits the stacked layers into per-layer views: the reference casts each
fp32 weight at every use, which is the same bits, and on the card would
re-read the fp32 tree every step.
"""

from __future__ import annotations

import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (
    MLP_FNS,
    apply_norm,
    apply_rope,
    attention,
    rope_angles,
)
from repro_torch.models.params import ParamDef, map_defs
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


def layer_param_defs(cfg: ArchConfig) -> dict:
    defs = {"attn_norm": norm_param_defs(cfg), "attn": attn_param_defs(cfg)}
    if not cfg.parallel_block:
        defs["mlp_norm"] = norm_param_defs(cfg)
    defs["mlp"] = mlp_param_defs(cfg)
    return defs


def stack_defs(defs, n: int):
    """Prepend the stacked ``layers`` dimension to every ParamDef."""
    return map_defs(lambda d: ParamDef((n,) + d.shape, ("layers",) + d.axes,
                                       d.init, d.dtype, d.scale), defs)


def model_param_defs(cfg: ArchConfig) -> dict:
    if cfg.family != "dense" or cfg.is_encdec or cfg.n_experts \
            or cfg.use_mla:
        raise NotImplementedError(
            f"{cfg.name}: only the dense decoder-only family is ported")
    D, V = cfg.d_model, cfg.vocab_size
    return {
        "embed": ParamDef((V, D), ("vocab", "embed"), init="embed"),
        "final_norm": norm_param_defs(cfg),
        "lm_head": ParamDef((D, V), ("embed", "vocab")),
        "layers": stack_defs(layer_param_defs(cfg), cfg.n_layers),
    }


def unstack_layers(stacked) -> list:
    """Per-layer views of a stacked layer tree (no copy)."""
    n = tree_leaves(stacked)[0].shape[0]
    return [tree_map(lambda a, i=i: a[i], stacked) for i in range(n)]


def bake_lm_params(params: dict, cfg: ArchConfig) -> dict:
    """The serving tree: every leaf cast once to the activation dtype
    (bit-identical to the reference's cast at each use) and the stacked
    layers as a list of per-layer views.  Idempotent: a baked tree comes
    back as it is."""
    cast = lambda a: a.to(act_dtype(cfg))
    out = {k: tree_map(cast, v) for k, v in params.items() if k != "layers"}
    layers = params["layers"]
    if isinstance(layers, dict):
        layers = unstack_layers(tree_map(cast, layers))
    out["layers"] = [tree_map(cast, p) for p in layers]
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


# ---------------------------------------------------------------------------
# Layer body + stack
# ---------------------------------------------------------------------------

def layer_fwd(p, cfg: ArchConfig, x, rope_cs, cache, pos, *, causal=True):
    """One dense transformer layer; updates ``cache`` in place."""
    h = apply_norm(cfg.norm_type, p, "attn_norm", x)
    a = gqa_attn(p["attn"], cfg, h, rope_cs, cache, pos, causal=causal)
    mlp = MLP_FNS[cfg.mlp_type]
    if cfg.parallel_block:
        return x + a + mlp(p["mlp"], h)
    x = x + a
    h = apply_norm(cfg.norm_type, p, "mlp_norm", x)
    return x + mlp(p["mlp"], h)


def scan_layers(layers, cfg: ArchConfig, x, rope_cs, cache, pos, *,
                causal=True):
    """The layer stack: ``layers`` a stacked tree or a list of per-layer
    trees (``bake_lm_params``); ``cache`` {"k", "v"} stacked (L, B, ...)
    or None."""
    if isinstance(layers, dict):
        layers = unstack_layers(layers)
    for i, p in enumerate(layers):
        c = None if cache is None else {"k": cache["k"][i],
                                        "v": cache["v"][i]}
        x = layer_fwd(p, cfg, x, rope_cs, c, pos, causal=causal)
    return x


def embed_tokens(params, cfg: ArchConfig, tokens):
    return params["embed"][tokens.long()].to(act_dtype(cfg))


def backbone(params, cfg: ArchConfig, x, pos, cache):
    """Run the decoder stack on embedded ``x`` (B, S, D) from position
    ``pos``; ``cache`` is the bundle's cache dict or None."""
    S = x.shape[1]
    ar = torch.arange(S, device=x.device)
    positions = ar + (pos.reshape(-1, 1) if isinstance(pos, torch.Tensor)
                      and pos.dim() else pos)
    rope_dim = int(cfg.dh * cfg.rotary_frac)
    cos, sin = rope_angles(positions, rope_dim, cfg.rope_theta)
    x = scan_layers(params["layers"], cfg, x, (cos, sin),
                    None if cache is None else cache["dense"], pos)
    return apply_norm(cfg.norm_type, params, "final_norm", x)


def logits_last(params, cfg: ArchConfig, hidden):
    """LM-head logits (fp32) at the last position: (B, V)."""
    h = hidden[:, -1, :]
    return (h @ params["lm_head"].to(h.dtype)).float()


def logits_all(params, cfg: ArchConfig, hidden):
    """LM-head logits (fp32) at every position of a cached multi-token
    step: (B, S, V)."""
    return (hidden @ params["lm_head"].to(hidden.dtype)).float()
