"""Mixture-of-Experts FFN, forward only.

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
reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import mlp_swiglu
from repro_torch.models.params import ParamDef


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
    logits = x.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., :cfg.moe_topk], top_e[..., :cfg.moe_topk]
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


def moe_ffn(p: dict, cfg: ArchConfig, x):
    """x (B, S, D) -> (y (B, S, D), {"moe_aux", "moe_dropped"}): the
    Switch-style load-balancing loss and the share of (token, choice)
    pairs past capacity, both fp32 0-d tensors."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.moe_topk
    C = expert_capacity(S, cfg)

    probs, top_p, top_e = route(p, cfg, x)
    me = probs.mean(dim=(0, 1))
    fe = F.one_hot(top_e, E).float().sum(dim=2).mean(dim=(0, 1)) / K
    aux = E * torch.sum(fe * me)

    flat_e = top_e.reshape(B, S * K)
    pos = positions_in_expert(flat_e, E)
    keep = pos < C
    dropped = 1.0 - keep.float().mean()

    # dispatch: kept pairs to their unique (expert, row), dropped ones to
    # the trash row E*C
    dest = torch.where(keep, flat_e * C + pos, E * C)
    x_rep = torch.repeat_interleave(x, K, dim=1)  # (B, S*K, D)
    xbuf = torch.zeros((B, E * C + 1, D), dtype=x.dtype, device=x.device)
    xbuf.scatter_(1, dest[..., None].expand(B, S * K, D), x_rep)
    xbuf = xbuf[:, :E * C].reshape(B, E, C, D).transpose(0, 1) \
        .reshape(E, B * C, D)

    # grouped expert SwiGLU: one batched product per weight over E
    g = F.silu(torch.bmm(xbuf, p["wg"].to(x.dtype)))
    u = torch.bmm(xbuf, p["wi"].to(x.dtype))
    ybuf = torch.bmm(g * u, p["wd"].to(x.dtype))  # (E, B*C, D)
    ybuf = ybuf.reshape(E, B, C, D).transpose(0, 1).reshape(B, E * C, D)

    # combine: each pair's expert output, weighted, summed over K
    safe = torch.where(keep, dest, 0)
    y_rep = torch.gather(ybuf, 1, safe[..., None].expand(B, S * K, D))
    y_rep = torch.where(keep[..., None], y_rep,
                        torch.zeros((), dtype=x.dtype, device=x.device))
    y = (y_rep.reshape(B, S, K, D) * top_p[..., None].to(x.dtype)).sum(dim=2)

    if cfg.n_shared_experts:
        y = y + mlp_swiglu(p["shared"], x)
    return y, {"moe_aux": aux, "moe_dropped": dropped}
