"""Transformer building blocks of the LM family: norms (with their
backward), rotary embeddings, attention (dense and flash-chunked), MLPs.

The port of ``repro/models/layers.py``.  Pure functions of (params, x) in
the reference's layouts (activations (B, S, D), weights (D_in, D_out),
q/k/v (B, S, H, Dh)) and numerics:

  * the norms and the attention scores reduce in fp32 (the reference's
    ``preferred_element_type=jnp.float32`` on bf16 operands: the bf16
    products are exact in fp32, so the operands are upcast and multiplied
    in fp32), the softmax runs in fp32 and the probabilities are cast to
    q's dtype before the value product, masks first, then ``NEG_INF``;
  * every weight is used after a cast to the activation dtype
    (``w.to(x.dtype)``), which is a no-op on a tree baked to that dtype
    once (``models/transformer.bake_lm_params``).

No library attention kernel (``scaled_dot_product_attention``, flash) is
used: it is not the reference's formulation and rounds otherwise.  The
norms carry the reference's custom-VJP backward as a
``torch.autograd.Function`` (x-shaped tensors in the activation dtype,
statistics and parameter gradients in fp32), entered only when autograd
records the call; the forward is one helper for both paths.

``attention`` takes per-lane positions: ``q_offset`` and ``kv_len`` may be
Python ints (the prefill call, which may route to the chunked path, as in
the reference) or tensors, 0-d or (B,) (a cached step: each lane of a
batch attends over its own cache length, which is how the session layer
decodes every slot at its own position in one batched call).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.sharding.ctx import constrain
from repro_torch.sharding.placed import (
    is_dt,
    lane_layout,
    lane_local,
    linear,
    local_apply,
    mesh_of,
    use,
)

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def _sq_mean(xf: torch.Tensor) -> torch.Tensor:
    return (xf * xf).sum(-1) / xf.shape[-1]


def _f32_sum(a, b=None, *, keep_last: bool = False) -> torch.Tensor:
    """The reference's ``preferred_element_type=jnp.float32`` contraction:
    the operands upcast (bf16 products are exact in fp32) and summed in
    fp32, over the last axis (``keep_last`` False) or over every axis but
    the last (a parameter gradient)."""
    p = a.float() if b is None else a.float() * b.float()
    if not keep_last:
        return p.sum(-1)
    if is_dt(p):  # a row fold would merge sharded dims
        return p.sum(dim=tuple(range(p.dim() - 1)))
    return p.reshape(-1, p.shape[-1]).sum(0)


def _rms_fwd(x, w, eps):
    inv = torch.rsqrt(_sq_mean(x.float()) + eps)
    return x * inv[..., None].to(x.dtype) * w.to(x.dtype), inv


def _ln_fwd(x, w, b, eps):
    xf = x.float()
    mu = xf.sum(-1) / x.shape[-1]
    var = torch.clamp(_sq_mean(xf) - mu * mu, min=0.0)
    inv = torch.rsqrt(var + eps)
    xhat = (x - mu[..., None].to(x.dtype)) * inv[..., None].to(x.dtype)
    y = xhat
    if w is not None:
        y = y * w.to(x.dtype)
    if b is not None:
        y = y + b.to(x.dtype)
    return y, xhat, inv


class _RMSNorm(torch.autograd.Function):
    """rmsnorm with the reference's custom-VJP backward
    (``repro/models/layers.py`` ``_rms_bwd``): dx in the activation dtype,
    the statistics and dw accumulated in fp32."""

    @staticmethod
    def forward(ctx, x, w, eps):
        y, inv = _rms_fwd(x, w, eps)
        ctx.save_for_backward(x, w, inv)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, inv = ctx.saved_tensors
        wb, invb = w.to(x.dtype), inv[..., None].to(x.dtype)
        dw = _f32_sum(dy * invb, x, keep_last=True).to(w.dtype) \
            if ctx.needs_input_grad[1] else None
        s = _f32_sum(dy * wb, x) / x.shape[-1]
        coef = (inv ** 3 * s)[..., None].to(x.dtype)
        return dy * wb * invb - x * coef, dw, None


class _LayerNorm(torch.autograd.Function):
    """layernorm with the reference's custom-VJP backward (``_ln_bwd``):
    saves xhat (activation dtype) and the fp32 inverse deviation; dx in
    the activation dtype, dw, db and the row means in fp32.  ``w``/``b``
    None (the non-parametric form) get no gradient."""

    @staticmethod
    def forward(ctx, x, w, b, eps):
        y, xhat, inv = _ln_fwd(x, w, b, eps)
        ctx.save_for_backward(xhat, w, inv)
        ctx.has_b = b is not None
        return y

    @staticmethod
    def backward(ctx, dy):
        xhat, w, inv = ctx.saved_tensors
        dt, D = xhat.dtype, xhat.shape[-1]
        dyw = dy if w is None else dy * w.to(dt)
        dw = db = None
        if w is not None and ctx.needs_input_grad[1]:
            dw = _f32_sum(dy, xhat, keep_last=True).to(w.dtype)
        if ctx.has_b and ctx.needs_input_grad[2]:
            db = _f32_sum(dy, keep_last=True).to(
                torch.float32 if w is None else w.dtype)
        m1 = _f32_sum(dyw) / D
        m2 = _f32_sum(dyw, xhat) / D
        dx = (dyw - m1[..., None].to(dt) - xhat * m2[..., None].to(dt)) \
            * inv[..., None].to(dt)
        return dx, dw, db, None


def _differentiated(*ts) -> bool:
    """Whether autograd records this call: grad mode on and a tensor
    input that requires grad (decode and serving never enter the
    ``Function``)."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def rmsnorm(x, w, eps: float = 1e-6):
    w = use(w)
    if _differentiated(x, w):
        return _RMSNorm.apply(x, w, eps)
    return _rms_fwd(x, w, eps)[0]


def layernorm(x, w, b, eps: float = 1e-5):
    """LayerNorm with fp32 statistics.  ``w``/``b`` None is the
    non-parametric form (OLMo): the identity affine is skipped."""
    w, b = (None if t is None else use(t) for t in (w, b))
    if _differentiated(x, w, b):
        return _LayerNorm.apply(x, w, b, eps)
    return _ln_fwd(x, w, b, eps)[0]


def layernorm_np(x, eps: float = 1e-5):
    """Non-parametric LayerNorm (OLMo): no learnable scale or bias."""
    return layernorm(x, None, None, eps)


def apply_norm(norm_type: str, p: dict, name: str, x):
    if norm_type == "rmsnorm":
        return rmsnorm(x, p[name]["w"])
    if norm_type == "layernorm":
        return layernorm(x, p[name]["w"], p[name]["b"])
    if norm_type == "layernorm_np":
        return layernorm_np(x)
    raise ValueError(norm_type)


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------

def rope_angles(positions, dim: int, theta: float):
    """positions (...,) int -> (cos, sin) fp32 of shape (..., dim // 2)."""
    positions = torch.as_tensor(positions)
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=positions.device) / dim))
    ang = positions.to(torch.float32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin, rotary_frac: float = 1.0):
    """x: (B, S, H, Dh); cos/sin: (S, Dr/2) or (B, S, Dr/2).  Rotates the
    first Dr dims of every head (``rotary_frac`` is carried by cos's width,
    as in the reference)."""
    dr = cos.shape[-1] * 2
    xr, xp = x[..., :dr], x[..., dr:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    if cos.dim() < x.dim():  # broadcast over the head axis
        cos, sin = cos.unsqueeze(-2), sin.unsqueeze(-2)
    c, s = cos.to(x.dtype), sin.to(x.dtype)
    out = torch.stack([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    out = out.reshape(xr.shape)
    return torch.cat([out, xp], dim=-1) if xp.shape[-1] else out


# ---------------------------------------------------------------------------
# Attention cores.  q: (B, Sq, Hq, Dh); k/v: (B, Skv, Hkv, Dh); GQA through a
# grouped product (repeated KV heads are never materialized here).
# ---------------------------------------------------------------------------

def _group_q(q, n_kv: int):
    b, s, h, d = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, d)


def _lanes(v):
    """A position or length that broadcasts against (B, Hkv, G, Sq, Skv)
    scores: a Python int as it is (no host-to-device copy), a tensor, 0-d
    or per lane (B,), as (B|1, 1, 1, 1, 1)."""
    return v.reshape(-1, 1, 1, 1, 1) if isinstance(v, torch.Tensor) else v


def attention_dense(q, k, v, *, causal: bool, q_offset=0, kv_len=None,
                    softmax_scale=None):
    """Materialized-scores attention (fp32 softmax)."""
    b, sq, hq, dh = q.shape
    n_kv = k.shape[2]
    scale = softmax_scale if softmax_scale is not None else dh ** -0.5
    qg = _group_q(q, n_kv)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    skv = k.shape[1]
    kpos = torch.arange(skv, device=q.device)
    mask = None
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] \
            + _lanes(q_offset)
        mask = kpos <= qpos
    if kv_len is not None:  # cache rows past the lane's length
        live = kpos < _lanes(kv_len)
        mask = live if mask is None else mask & live
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(b, sq, hq, v.shape[-1])


def attention_chunked(q, k, v, *, causal: bool, kv_chunk: int = 1024,
                      softmax_scale=None):
    """Flash-style online-softmax attention over KV chunks: O(Sq * kv_chunk)
    live scores instead of O(Sq * Skv).  Fully masked (future) chunks still
    run and are numerically inert, as in the reference."""
    b, sq, hq, dh = q.shape
    skv, n_kv, dv = k.shape[1], k.shape[2], v.shape[-1]
    scale = softmax_scale if softmax_scale is not None else dh ** -0.5
    n_chunks = -(-skv // kv_chunk)
    pad = n_chunks * kv_chunk - skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    qg = _group_q(q, n_kv).float()
    g = hq // n_kv
    qpos = torch.arange(sq, device=q.device)[:, None]
    # the online-softmax carries in the layout of the heads (on a mesh
    # the core runs on each rank's block of lanes and heads, so they are
    # born there: ``attention``)
    m = constrain(torch.full((b, n_kv, g, sq), NEG_INF, dtype=torch.float32,
                             device=q.device),
                  ("batch", "heads_act", None, None))
    l = constrain(torch.zeros((b, n_kv, g, sq), dtype=torch.float32,
                              device=q.device),
                  ("batch", "heads_act", None, None))
    acc = constrain(torch.zeros((b, n_kv, g, sq, dv), dtype=torch.float32,
                                device=q.device),
                    ("batch", "heads_act", None, None, None))
    for idx in range(n_chunks):
        kb = k[:, idx * kv_chunk:(idx + 1) * kv_chunk]
        vb = v[:, idx * kv_chunk:(idx + 1) * kv_chunk]
        scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, kb.float()) * scale
        kpos = idx * kv_chunk + torch.arange(kv_chunk, device=q.device)[None]
        mask = kpos < skv
        if causal:
            mask = mask & (kpos <= qpos)
        scores = torch.where(mask, scores, NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        p = torch.exp(scores - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", p.to(q.dtype), vb).float()
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, dv).to(q.dtype)


def attention(q, k, v, *, causal: bool, q_offset=0, kv_len=None,
              softmax_scale=None, chunked_threshold: int = 8192):
    """The reference's dispatcher: multi-query attention over at least
    ``chunked_threshold`` keys takes the chunked path when no cache-length
    mask is needed (no cache, or a prefill: ``q_offset == 0`` and
    ``kv_len == Sq`` as Python ints); everything else, decode included,
    the dense path.

    On a mesh (DTensor q, k, v) the core runs on each rank's block: its
    lanes, and its heads where every head count divides the ``model``
    axis (``placed.lane_layout``); K/V sharded along the sequence (a
    context-parallel cache) are gathered first.  Each lane and head is
    computed as on one card."""
    mesh = mesh_of(q, k, v)
    if mesh is not None:
        lay = lane_layout(mesh, q, head_dim=2,
                          heads=(q.shape[2], k.shape[2]))
        q_offset, kv_len = (lane_local(t, mesh, lay)
                            for t in (q_offset, kv_len))
        return local_apply(
            lambda q_, k_, v_: attention(
                q_, k_, v_, causal=causal, q_offset=q_offset, kv_len=kv_len,
                softmax_scale=softmax_scale,
                chunked_threshold=chunked_threshold),
            mesh, (q, k, v), (lay, lay, lay), lay)
    prefill_like = (isinstance(q_offset, int) and q_offset == 0
                    and isinstance(kv_len, int) and kv_len == q.shape[1])
    long = q.shape[1] > 1 and k.shape[1] >= chunked_threshold
    if long and causal and (kv_len is None or prefill_like):
        return attention_chunked(q, k, v, causal=True,
                                 softmax_scale=softmax_scale)
    if long and kv_len is None:
        return attention_chunked(q, k, v, causal=causal,
                                 softmax_scale=softmax_scale)
    return attention_dense(q, k, v, causal=causal, q_offset=q_offset,
                           kv_len=kv_len, softmax_scale=softmax_scale)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_swiglu(p, x):
    h = linear(x, use(p["wg"], x.dtype))
    u = linear(x, use(p["wi"], x.dtype))
    h = constrain(F.silu(h) * u, ("batch", None, "ffn"))
    return linear(h, use(p["wd"], x.dtype))


def _mlp_act(p, x, act):
    h = linear(x, use(p["wi"], x.dtype))
    if "bi" in p:
        h = h + use(p["bi"], x.dtype)
    h = constrain(act(h), ("batch", None, "ffn"))
    h = linear(h, use(p["wd"], x.dtype))
    if "bd" in p:
        h = h + use(p["bd"], x.dtype)
    return h


def mlp_gelu(p, x):
    # jax.nn.gelu's default is the tanh approximation
    return _mlp_act(p, x, lambda h: F.gelu(h, approximate="tanh"))


def mlp_relu(p, x):
    return _mlp_act(p, x, F.relu)


MLP_FNS = {"swiglu": mlp_swiglu, "gelu": mlp_gelu, "relu": mlp_relu}
