"""RWKV6 ("Finch"): attention-free time mixing with a data-dependent decay,
forward only.

The port of ``repro/models/rwkv.py``.  The per-token recurrence
S_t = diag(w_t) S_{t-1} + k_t v_t^T runs in one of two forms, as in the
reference:

  * ``wkv_step``, one token (S == 1, every decode step): the carried
    (Dh, Dh) state is read, decayed and updated;
  * ``wkv_chunked``, S > 1 (prefill, ``step_fn``, ``embed_fn``): chunks
    of ``CHUNK`` tokens, the token-token interaction inside a chunk a
    masked (C, C) score matrix with per-channel decay factors, the state
    carried across chunks.  It is the recurrence reassociated, not bit
    for bit the steps, which is why the session layer feeds a prompt of
    these families token by token.

Every ``exp`` argument of the chunked form is <= 0 where it is used: the
decay differences above the diagonal (never used) are replaced by 0
before the ``exp``, so no inf reaches the masked products.  Decays,
group-norm statistics, the bonus ``u`` and the state are fp32 (the
reference's casts).  A cached call returns NEW state tensors and leaves
the cache it was given as it was: the session layer selects per lane
between the two (masking by value).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import layernorm
from repro_torch.models.params import ParamDef
from repro_torch.sharding.placed import (
    lane_layout,
    linear,
    local_apply,
    merge_heads,
    mesh_of,
    split_heads,
    use,
)

CHUNK = 32
GN_EPS = 64e-5


def rwkv_layer_param_defs(cfg: ArchConfig) -> dict:
    D = cfg.d_model
    F_ = cfg.d_ff
    R = cfg.rwkv_decay_lora

    def mix():
        return ParamDef((D,), ("embed",), init="zeros")

    return {
        "ln1": {"w": ParamDef((D,), ("embed",), init="ones"),
                "b": ParamDef((D,), ("embed",), init="zeros")},
        "ln2": {"w": ParamDef((D,), ("embed",), init="ones"),
                "b": ParamDef((D,), ("embed",), init="zeros")},
        "time": {
            "mix_r": mix(), "mix_k": mix(), "mix_v": mix(), "mix_g": mix(),
            "mix_w": mix(),
            "wr": ParamDef((D, D), ("embed", "heads")),
            "wk": ParamDef((D, D), ("embed", "heads")),
            "wv": ParamDef((D, D), ("embed", "heads")),
            "wg": ParamDef((D, D), ("embed", "heads")),
            "w0": ParamDef((D,), ("embed",), init="zeros"),
            "wa": ParamDef((D, R), ("embed", None)),
            "wb": ParamDef((R, D), (None, "heads")),
            "u": ParamDef((D,), ("embed",), init="zeros"),
            "wo": ParamDef((D, D), ("heads", "embed")),
            "gn_w": ParamDef((D,), ("embed",), init="ones"),
            "gn_b": ParamDef((D,), ("embed",), init="zeros"),
        },
        "channel": {
            "mix_k": mix(), "mix_r": mix(),
            "wk": ParamDef((D, F_), ("embed", "ffn")),
            "wv": ParamDef((F_, D), ("ffn", "embed")),
            "wr": ParamDef((D, D), ("embed", "heads")),
        },
    }


# leaves the reference casts to fp32 at their use: a baked tree keeps them
# fp32 (a bf16 copy would round them first)
FP32_KEYS = ("w0", "u", "gn_w", "gn_b")


def _token_shift(x, x_prev):
    """x: (B, S, D); x_prev: (B, D), the carry from the previous step."""
    return torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)


def _decay(p, xw):
    """Log-decay (<= 0) of w_t = exp(-exp(w0 + tanh(x @ A) @ B)), fp32."""
    lora = linear(xw, use(p["wa"], xw.dtype))
    logw = use(p["w0"], torch.float32) \
        + linear(torch.tanh(lora), use(p["wb"], xw.dtype)).float()
    return -torch.exp(logw)


def wkv_chunked(r, k, v, log_w, u, state):
    """Chunked WKV6.  r, k, v, log_w: (B, T, H, Dh) (log_w <= 0); u: (H, Dh);
    state: (B, H, Dh, Dh) [k-dim x v-dim].  A ragged tail is padded with
    zero r/k/v and log_w = 0 (decay 1), which leave the state untouched.
    Returns (y (B, T, H, Dh) in r's dtype, the new fp32 state)."""
    B, T, H, Dh = r.shape
    out_dtype = r.dtype
    C = min(CHUNK, T)
    n = -(-T // C)
    pad = n * C - T
    r, k, v, log_w = (a.float() for a in (r, k, v, log_w))
    if pad:
        r, k, v, log_w = (F.pad(a, (0, 0, 0, 0, 0, pad))
                          for a in (r, k, v, log_w))
    mask = torch.tril(torch.ones((C, C), dtype=torch.bool, device=r.device),
                      diagonal=-1)  # strictly lower: s < t
    u = u.float()
    S = state.float()
    ys = []
    for c in range(n):
        sl = slice(c * C, (c + 1) * C)
        rb, kb, vb, wb = r[:, sl], k[:, sl], v[:, sl], log_w[:, sl]
        cum = torch.cumsum(wb, dim=1)  # L_t inclusive
        cum_prev = cum - wb            # L_{t-1}
        # att[t, s] = sum_i r[t, i] k[s, i] exp(L_{t-1, i} - L_{s, i}), s < t
        diff = cum_prev[:, :, None] - cum[:, None, :]  # (B, t, s, H, Dh)
        diff = torch.where(mask[None, :, :, None, None], diff, 0.0)
        att = (rb[:, :, None] * kb[:, None, :] * torch.exp(diff)).sum(-1)
        att = torch.where(mask[None, :, :, None], att, 0.0)  # (B, t, s, H)
        diag = (rb * u * kb).sum(-1)  # (B, t, H): the bonus weight of v_t
        y = torch.einsum("btsh,bshj->bthj", att, vb)
        y = y + diag[..., None] * vb
        # the carried state's share: r~_t = r_t * exp(L_{t-1})
        rt = rb * torch.exp(cum_prev)
        y = y + torch.einsum("bthi,bhij->bthj", rt, S)
        # S' = exp(L_C) (.) S + sum_s exp(L_C - L_s) k_s v_s^T
        kt = kb * torch.exp(cum[:, -1:] - cum)
        S = torch.exp(cum[:, -1])[..., None] * S \
            + torch.einsum("bshi,bshj->bhij", kt, vb)
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :T]
    return y.to(out_dtype), S


def wkv_step(r, k, v, log_w, u, state):
    """One token.  r, k, v, log_w: (B, H, Dh); state: (B, H, Dh, Dh).
    Returns (y (B, H, Dh) in r's dtype, the new fp32 state)."""
    rf, kf, vf = r.float(), k.float(), v.float()
    y = torch.einsum("bhi,bhij->bhj", rf, state) \
        + ((rf * u.float() * kf).sum(-1))[..., None] * vf
    new = torch.exp(log_w.float())[..., None] * state \
        + kf[..., :, None] * vf[..., None, :]
    return y.to(r.dtype), new


def _wkv_any(r, k, v, log_w, u, state):
    """(B, S, H, Dh) in, the S == 1 step or the chunked form."""
    if r.shape[1] == 1:
        y, state = wkv_step(r[:, 0], k[:, 0], v[:, 0], log_w[:, 0], u, state)
        return y[:, None], state
    return wkv_chunked(r, k, v, log_w, u, state)


def _wkv(r, k, v, log_w, u, state):
    """The recurrence; on a mesh on each rank's lanes and heads (heads
    over ``model`` when it divides them), each as on one card."""
    mesh = mesh_of(r, state)
    if mesh is None:
        return _wkv_any(r, k, v, log_w, u, state)
    from torch.distributed.tensor import Replicate, Shard

    lay = lane_layout(mesh, r, head_dim=2, heads=(r.shape[2],))
    heads = [Shard(q.dim - 2) if isinstance(q, Shard) and q.dim == 2
             else Replicate() for q in lay]
    st = [Shard(1) if isinstance(q, Shard) and q.dim == 2 else q
          for q in lay]
    return local_apply(_wkv_any, mesh, (r, k, v, log_w, u, state),
                       (lay, lay, lay, lay, heads, st), (lay, st))


def _group_norm(y, w, b, H):
    """Per-head LayerNorm of (B, T, H, Dh) (RWKV's ln_x), fp32, flattened
    to (B, T, H * Dh)."""
    B, T, _, Dh = y.shape
    yf = y.float()
    mu = yf.mean(-1, keepdim=True)
    var = ((yf - mu) ** 2).mean(-1, keepdim=True)
    yn = (yf - mu) * torch.rsqrt(var + GN_EPS)
    return merge_heads(yn, B, T, H * Dh) * use(w, torch.float32) \
        + use(b, torch.float32)


def time_mix(p, cfg: ArchConfig, x, x_prev, state):
    """RWKV6 time mixing of x (B, S, D).  Returns (out, (new x_prev,
    new state)); S == 1 takes ``wkv_step``, longer inputs the chunked
    form."""
    B, S, D = x.shape
    Dh = cfg.rwkv_head_dim
    H = D // Dh
    xs = _token_shift(x, x_prev)

    def lerp(m):
        return x + (xs - x) * use(p[m], x.dtype)

    xr, xk, xv, xg, xw = (lerp(m) for m in
                          ("mix_r", "mix_k", "mix_v", "mix_g", "mix_w"))
    r = split_heads(linear(xr, use(p["wr"], x.dtype)), B, S, H, Dh)
    k = split_heads(linear(xk, use(p["wk"], x.dtype)), B, S, H, Dh)
    v = split_heads(linear(xv, use(p["wv"], x.dtype)), B, S, H, Dh)
    g = F.silu(linear(xg, use(p["wg"], x.dtype)))
    log_w = split_heads(_decay(p, xw), B, S, H, Dh)
    y, state = _wkv(r, k, v, log_w, use(p["u"]).view(H, Dh), state)
    y = _group_norm(y, p["gn_w"], p["gn_b"], H).to(x.dtype) * g
    return linear(y, use(p["wo"], x.dtype)), (x[:, -1, :], state)


def channel_mix(p, cfg: ArchConfig, x, x_prev):
    xs = _token_shift(x, x_prev)
    xk = x + (xs - x) * use(p["mix_k"], x.dtype)
    xr = x + (xs - x) * use(p["mix_r"], x.dtype)
    k = torch.square(F.relu(linear(xk, use(p["wk"], x.dtype))))
    kv = linear(k, use(p["wv"], x.dtype))
    r = torch.sigmoid(linear(xr, use(p["wr"], x.dtype)))
    return r * kv, x[:, -1, :]


def rwkv_layer(p, cfg: ArchConfig, x, cache):
    """One layer.  cache: this layer's {"x_prev_t", "x_prev_c": (B, D),
    "state": (B, H, Dh, Dh)}; returns (x, a new cache dict)."""
    h = layernorm(x, p["ln1"]["w"], p["ln1"]["b"])
    dt, (xp_t, state) = time_mix(p["time"], cfg, h, cache["x_prev_t"],
                                 cache["state"])
    x = x + dt
    h = layernorm(x, p["ln2"]["w"], p["ln2"]["b"])
    dc, xp_c = channel_mix(p["channel"], cfg, h, cache["x_prev_c"])
    return x + dc, {"x_prev_t": xp_t, "x_prev_c": xp_c, "state": state}


def rwkv_empty_cache(cfg: ArchConfig, batch: int, dtype,
                     device="cuda") -> dict:
    """Zeroed cache: the token-shift rows (L, B, D) in the activation
    dtype, the wkv state (L, B, H, Dh, Dh) in fp32."""
    D, Dh, L = cfg.d_model, cfg.rwkv_head_dim, cfg.n_layers
    H = D // Dh
    z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=device)
    return {"x_prev_t": z((L, batch, D), dtype),
            "x_prev_c": z((L, batch, D), dtype),
            "state": z((L, batch, H, Dh, Dh), torch.float32)}
