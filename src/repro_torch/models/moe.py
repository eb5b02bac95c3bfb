"""Mixture-of-Experts FFN.

The port of ``repro/models/moe.py``: token-choice top-k routing with a
static capacity per expert, as scatter -> grouped expert SwiGLU -> gather,
dispatched per sequence (G = B buffers: capacity is allocated per sequence,
so a sequence's routing and its bits never depend on the other sequences
of the batch; the session layer's batched lanes rely on it).

The reference's numerics are kept step for step:

  * the router runs in fp32 whatever the activation dtype (the baked
    serving tree keeps ``router`` fp32: ``transformer.bake_lm_params``);
  * top-k comes from a stable descending sort of the probabilities, so
    ties take the lower expert index first, as ``jax.lax.top_k`` does
    (``torch.topk`` leaves the order of ties unspecified on CUDA);
  * a token's position in its expert's buffer comes from a stable sort of
    the flattened (S*K) expert ids, so the tokens past capacity, which are
    dropped, are the reference's;
  * dropped tokens are scattered into a trash row past the E*C buffer rows,
    which is sliced off (the reference's out-of-bounds ``mode="drop"``).

The expert products are batched matmuls over the (E, B*C, D) buffer; an
expert's zero-padded capacity rows are computed and discarded, as in the
reference.  The backward repeats bit for bit on CUDA: the dispatch's
scatter differentiates to a gather, and the combine's gather writes each
kept pair's gradient into its own buffer row (the dropped pairs, pointed
at row 0, add exact zeros).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import mlp_swiglu
from repro_torch.models.params import ParamDef
from repro_torch.sharding.ctx import constrain
from repro_torch.sharding.placed import (
    lane_layout,
    linear,
    local_apply,
    mesh_of,
    use,
)


def moe_param_defs(cfg: ArchConfig) -> dict:
    D, E, Fe = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    defs = {
        "router": ParamDef((D, E), ("embed", "experts"), scale=0.006),
        "wg": ParamDef((E, D, Fe), ("experts", "embed", None)),
        "wi": ParamDef((E, D, Fe), ("experts", "embed", None)),
        "wd": ParamDef((E, Fe, D), ("experts", None, "embed"),
                       scale=Fe ** -0.5),
    }
    if cfg.n_shared_experts:
        Fs = cfg.n_shared_experts * Fe
        defs["shared"] = {
            "wg": ParamDef((D, Fs), ("embed", "ffn")),
            "wi": ParamDef((D, Fs), ("embed", "ffn")),
            "wd": ParamDef((Fs, D), ("ffn", "embed"), scale=Fs ** -0.5),
        }
    return defs


def expert_capacity(n_tokens: int, cfg: ArchConfig) -> int:
    """Buffer rows per expert for a sequence of ``n_tokens``: the
    capacity factor's share, rounded up to a multiple of 8, at least 8."""
    cap = int(n_tokens * cfg.moe_topk / cfg.n_experts * cfg.capacity_factor)
    return max(8, -(-cap // 8) * 8)


def route(p: dict, cfg: ArchConfig, x):
    """The fp32 router: (probs (B, S, E), top_p (B, S, K) renormalized,
    top_e (B, S, K) int64), top-k ties to the lower expert index."""
    return _top_k(linear(x.float(), use(p["router"], torch.float32)),
                  cfg.moe_topk)


def _top_k(logits, K: int):
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., :K], top_e[..., :K]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return probs, top_p, top_e


def positions_in_expert(flat_e, n_experts: int):
    """Each (token, choice)'s row in its expert's buffer, per sequence:
    flat_e (B, S*K) expert ids in token-major order -> (B, S*K) int64, the
    count of earlier entries (in that order) that chose the same expert."""
    B, n = flat_e.shape
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    counts = torch.zeros((B, n_experts), dtype=torch.int64,
                         device=flat_e.device)
    counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, dim=-1) - counts
    pos_sorted = torch.arange(n, device=flat_e.device)[None] \
        - torch.gather(starts, 1, sorted_e)
    return torch.zeros_like(flat_e).scatter_(1, order, pos_sorted)


def _route_dispatch(logits, x, E: int, K: int, C: int):
    """Per sequence: the routing, each (token, choice)'s buffer row and
    the scattered expert buffers.  Returns (probs, top_p, the (B, S, E)
    one-hot counts of the choices, keep, dest, xbuf (B, E, C, D))."""
    B, S, D = x.shape
    probs, top_p, top_e = _top_k(logits, K)
    hot = F.one_hot(top_e, E).float().sum(dim=2)
    flat_e = top_e.reshape(B, S * K)
    pos = positions_in_expert(flat_e, E)
    keep = pos < C
    # dispatch: kept pairs to their unique (expert, row), dropped ones to
    # the trash row E*C
    dest = torch.where(keep, flat_e * C + pos, E * C)
    # (B, S*K, D): an expand, whose backward sums the K copies in a fixed
    # order (PyTorch lists repeat_interleave's backward among its CUDA ops
    # whose order is left to the hardware)
    x_rep = x[:, :, None].expand(B, S, K, D).reshape(B, S * K, D)
    xbuf = torch.zeros((B, E * C + 1, D), dtype=x.dtype, device=x.device)
    xbuf.scatter_(1, dest[..., None].expand(B, S * K, D), x_rep)
    return probs, top_p, hot, keep, dest, xbuf[:, :E * C].reshape(B, E, C, D)


def _gate_up(xbuf, wg, wi):
    """The grouped expert SwiGLU's first half, one batched product per
    weight over the experts: (B, E, C, D) -> (B, E, C, F)."""
    B, E, C, D = xbuf.shape
    xe = xbuf.transpose(0, 1).reshape(E, B * C, D)
    h = F.silu(torch.bmm(xe, wg)) * torch.bmm(xe, wi)
    return h.reshape(E, B, C, -1).transpose(0, 1)


def _down(h, wd):
    B, E, C, Fe = h.shape
    y = torch.bmm(h.transpose(0, 1).reshape(E, B * C, Fe), wd)
    return y.reshape(E, B, C, -1).transpose(0, 1)


def _combine(ybuf, keep, dest, top_p):
    """Each pair's expert output, weighted, summed over its K choices:
    (B, E, C, D) buffers -> (B, S, D)."""
    B, E, C, D = ybuf.shape
    n = keep.shape[1]
    K = top_p.shape[-1]
    ybuf = ybuf.reshape(B, E * C, D)
    safe = torch.where(keep, dest, 0)
    y_rep = torch.gather(ybuf, 1, safe[..., None].expand(B, n, D))
    y_rep = torch.where(keep[..., None], y_rep,
                        torch.zeros((), dtype=ybuf.dtype,
                                    device=ybuf.device))
    return (y_rep.reshape(B, n // K, K, D)
            * top_p[..., None].to(ybuf.dtype)).sum(dim=2)


def _experts(fn, mesh, bufs, weights):
    """``fn`` over expert buffers (B, E, C, ·) and expert weights: on a
    mesh each rank takes its lanes' rows of its experts (the
    ``("batch", "experts")`` layout) against its experts' weights."""
    if mesh is None:
        return fn(*bufs, *weights)
    pl = list(bufs[0].placements)
    return local_apply(fn, mesh, (*bufs, *weights),
                       (pl,) * len(bufs) + tuple(list(w.placements)
                                                 for w in weights), pl)


def moe_ffn(p: dict, cfg: ArchConfig, x):
    """x (B, S, D) -> (y (B, S, D), {"moe_aux", "moe_dropped"}): the
    Switch-style load-balancing loss and the share of (token, choice)
    pairs past capacity, both fp32 0-d tensors.  On a mesh the routing,
    the dispatch and the combine run on each rank's lanes (per sequence,
    the reference's drop mask), the expert products on its experts."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.moe_topk
    C = expert_capacity(S, cfg)
    logits = linear(x.float(), use(p["router"], torch.float32))
    mesh = mesh_of(logits)
    if mesh is None:
        probs, top_p, hot, keep, dest, xbuf = _route_dispatch(
            logits, x, E, K, C)
    else:
        lay = lane_layout(mesh, x)
        probs, top_p, hot, keep, dest, xbuf = local_apply(
            lambda lg, xx: _route_dispatch(lg, xx, E, K, C), mesh,
            (logits, x), (lay, lay), (lay,) * 6)
    me = probs.mean(dim=(0, 1))
    fe = hot.mean(dim=(0, 1)) / K
    aux = E * torch.sum(fe * me)
    dropped = 1.0 - keep.float().mean()

    xbuf = constrain(xbuf, ("batch", "experts", None, None))
    h = _experts(_gate_up, mesh, (xbuf,), (use(p["wg"], x.dtype),
                                           use(p["wi"], x.dtype)))
    h = constrain(h, ("batch", "experts", None, None))
    ybuf = _experts(_down, mesh, (h,), (use(p["wd"], x.dtype),))
    if mesh is None:
        y = _combine(ybuf, keep, dest, top_p)
    else:
        y = local_apply(_combine, mesh, (ybuf, keep, dest, top_p),
                        (lay,) * 4, lay)

    if cfg.n_shared_experts:
        y = y + mlp_swiglu(p["shared"], x)
    return y, {"moe_aux": aux, "moe_dropped": dropped}
