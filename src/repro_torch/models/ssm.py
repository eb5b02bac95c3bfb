"""Mamba2 (SSD) blocks of the zamba2 hybrid, forward only.

The port of ``repro/models/ssm.py``.  The selective-state recurrence
    S_t = exp(dt_t * A_h) * S_{t-1} + dt_t * B_t x_t^T,   y_t = C_t . S_t + D_h x_t
(a scalar decay per head) runs one token at a time (``ssd_step``, every
decode step) or in chunks of ``CHUNK`` tokens (``ssd_chunked``, S > 1: a
masked (C, C) score matrix inside a chunk, the (N, P) state carried
across chunks; the recurrence reassociated, not the steps bit for bit).
The depthwise causal conv in front keeps a (K-1)-deep ring of the last
inputs per lane at decode: the reference's FIFO.  ``dt`` goes through an
fp32 softplus and ``A = -exp(a_log)``; the state is fp32, the conv ring
in the activation dtype.  A cached call returns new ring and state
tensors and leaves the cache it was given as it was (the session layer
masks these leaves by value).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import rmsnorm
from repro_torch.models.params import ParamDef
from repro_torch.sharding.placed import (
    lane_layout,
    like,
    linear,
    local_apply,
    merge_heads,
    mesh_of,
    split_heads,
    use,
)

CHUNK = 64

# leaves the reference casts to fp32 at their use (kept fp32 when baked)
FP32_KEYS = ("a_log", "dt_bias")


def _dims(cfg: ArchConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    return d_inner, n_heads, cfg.ssm_state, cfg.ssm_head_dim


def mamba_param_defs(cfg: ArchConfig) -> dict:
    D = cfg.d_model
    d_inner, H, N, P = _dims(cfg)
    conv_dim = d_inner + 2 * N  # x, B, C go through the depthwise conv
    proj_out = 2 * d_inner + 2 * N + H  # z, x, B, C, dt
    return {
        "norm": {"w": ParamDef((D,), ("embed",), init="ones")},
        "in_proj": ParamDef((D, proj_out), ("embed", "ffn")),
        "conv_w": ParamDef((cfg.ssm_conv_k, conv_dim), ("conv_k", "ffn"),
                           scale=0.2),
        "conv_b": ParamDef((conv_dim,), ("ffn",), init="zeros"),
        "a_log": ParamDef((H,), ("heads",), init="zeros"),
        "dt_bias": ParamDef((H,), ("heads",), init="zeros"),
        "d_skip": ParamDef((H,), ("heads",), init="ones"),
        "out_norm": {"w": ParamDef((d_inner,), ("ffn",), init="ones")},
        "out_proj": ParamDef((d_inner, D), ("ffn", "embed")),
    }


def _causal_conv(x, w, b, ring=None):
    """Depthwise causal conv1d + SiLU.  x: (B, S, C); w: (K, C); ring:
    (B, K-1, C), the last K-1 inputs before x, or None (zeros).  Returns
    (y, the new ring: the last K-1 inputs)."""
    K = w.shape[0]
    if ring is None:
        ring = like(torch.zeros((x.shape[0], K - 1, x.shape[2]),
                                dtype=x.dtype, device=x.device), x)
    xp = torch.cat([ring.to(x.dtype), x], dim=1)  # (B, S + K - 1, C)
    S = x.shape[1]
    w = use(w, x.dtype)
    y = 0
    for i in range(K):
        y = y + xp[:, i:i + S, :] * w[i]
    y = y + use(b, x.dtype)
    return F.silu(y), xp[:, -(K - 1):, :]


def ssd_chunked(x, dt, A, B, C, state):
    """Chunked SSD.  x: (B, T, H, P); dt: (B, T, H); A: (H,) (< 0); B, C:
    (B, T, N); state: (B, H, N, P).  A ragged tail is padded with dt = 0
    (decay 1, no update).  Returns (y in x's dtype, the new fp32 state)."""
    Bb, T, H, P = x.shape
    out_dtype = x.dtype
    Cl = min(CHUNK, T)
    n = -(-T // Cl)
    pad = n * Cl - T
    x, dt, B, C = (a.float() for a in (x, dt, B, C))
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt, B, C = (F.pad(a, (0, 0, 0, pad)) for a in (dt, B, C))
    A = A.float()
    mask = torch.tril(torch.ones((Cl, Cl), dtype=torch.bool,
                                 device=x.device))  # s <= t
    S = state.float()
    ys = []
    for c in range(n):
        sl = slice(c * Cl, (c + 1) * Cl)
        xb, dtb, Bc, Cc = x[:, sl], dt[:, sl], B[:, sl], C[:, sl]
        cum = torch.cumsum(dtb * A, dim=1)  # (B, C, H) inclusive, <= 0
        # scores[t, s] = (C_t . B_s) exp(cum_t - cum_s) dt_s for s <= t
        cb = torch.einsum("btn,bsn->bts", Cc, Bc)
        diff = cum[:, :, None, :] - cum[:, None, :, :]  # (B, t, s, H)
        diff = torch.where(mask[None, :, :, None], diff, 0.0)
        att = cb[..., None] * torch.exp(diff) * dtb[:, None, :, :]
        att = torch.where(mask[None, :, :, None], att, 0.0)
        y = torch.einsum("btsh,bshp->bthp", att, xb)
        # the carried state's share: y_t += C_t . (exp(cum_t) S)
        y = y + torch.einsum("btn,bhnp->bthp", Cc, S) \
            * torch.exp(cum)[..., None]
        # S' = exp(cum_C) S + sum_s exp(cum_C - cum_s) dt_s B_s x_s^T
        w_s = torch.exp(cum[:, -1:, :] - cum) * dtb  # (B, C, H)
        S = torch.exp(cum[:, -1])[..., None, None] * S \
            + torch.einsum("bsn,bshp->bhnp", Bc, w_s[..., None] * xb)
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :T]
    return y.to(out_dtype), S


def ssd_step(x, dt, A, B, C, state):
    """One token.  x: (B, H, P); dt: (B, H); B, C: (B, N); state: (B, H,
    N, P).  Returns (y (B, H, P) in x's dtype, the new fp32 state)."""
    dtf = dt.float()
    dec = torch.exp(dtf * A.float())  # (B, H)
    upd = B.float()[:, None, :, None] \
        * (dtf[..., None] * x.float())[:, :, None, :]
    new = dec[..., None, None] * state + upd
    y = torch.einsum("bn,bhnp->bhp", C.float(), new)
    return y.to(x.dtype), new


def _ssd_any(x, dt, A, B, C, state):
    """x (B, S, H, P) in, the S == 1 step or the chunked form."""
    if x.shape[1] == 1:
        y, state = ssd_step(x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0], state)
        return y[:, None], state
    return ssd_chunked(x, dt, A, B, C, state)


def _ssd(x, dt, A, B, C, state):
    """The recurrence; on a mesh on each rank's lanes and heads (heads
    over ``model`` when it divides them), each as on one card."""
    mesh = mesh_of(x, state)
    if mesh is None:
        return _ssd_any(x, dt, A, B, C, state)
    from torch.distributed.tensor import Replicate, Shard

    lay = lane_layout(mesh, x, head_dim=2, heads=(x.shape[2],))
    on = lambda d: [Shard(d) if isinstance(q, Shard) and q.dim == 2 else q
                    for q in lay]
    lanes = [q if isinstance(q, Shard) and q.dim == 0 else Replicate()
             for q in lay]
    heads = [Shard(0) if isinstance(q, Shard) and q.dim == 2
             else Replicate() for q in lay]
    return local_apply(_ssd_any, mesh, (x, dt, A, B, C, state),
                       (lay, lay, heads, lanes, lanes, on(1)), (lay, on(1)))


def mamba_layer(p, cfg: ArchConfig, x, cache):
    """Mamba2 block on x (B, S, D).  cache: this layer's {"conv" (B, K-1,
    conv_dim), "ssm" (B, H, N, P)}.  Returns (x + out, a new cache dict)."""
    B_, S, D = x.shape
    d_inner, H, N, P = _dims(cfg)
    h = rmsnorm(x, p["norm"]["w"])
    zxbcdt = linear(h, use(p["in_proj"], x.dtype))
    z, xbc, dt = torch.split(zxbcdt, [d_inner, d_inner + 2 * N, H], dim=-1)
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"], cache["conv"])
    xs, Bmat, Cmat = torch.split(xbc, [d_inner, N, N], dim=-1)
    dt = F.softplus(dt.float() + use(p["dt_bias"], torch.float32))
    A = -torch.exp(use(p["a_log"], torch.float32))
    xh = split_heads(xs, B_, S, H, P)
    y, new_ssm = _ssd(xh, dt, A, Bmat, Cmat, cache["ssm"])
    y = y + use(p["d_skip"], x.dtype)[None, None, :, None] * xh
    y = merge_heads(y, B_, S, d_inner)
    y = rmsnorm(y * F.silu(z), p["out_norm"]["w"])
    return x + linear(y, use(p["out_proj"], x.dtype)), {"conv": new_conv,
                                                "ssm": new_ssm}


def mamba_empty_cache(cfg: ArchConfig, n_layers: int, batch: int, dtype,
                      device="cuda") -> dict:
    """Zeroed Mamba cache: the conv ring (L, B, K-1, conv_dim) in the
    activation dtype, the ssm state (L, B, H, N, P) in fp32."""
    d_inner, H, N, P = _dims(cfg)
    conv_dim = d_inner + 2 * N
    return {"conv": torch.zeros((n_layers, batch, cfg.ssm_conv_k - 1,
                                 conv_dim), dtype=dtype, device=device),
            "ssm": torch.zeros((n_layers, batch, H, N, P),
                               dtype=torch.float32, device=device)}
