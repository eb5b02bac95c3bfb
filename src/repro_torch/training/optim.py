"""Optimizers on trees of tensors, the port of ``repro/training/optim.py``.

Functional API mirroring optax: an optimizer is ``(init_fn, update_fn)``
where ``update_fn(grads, state, params) -> (updates, new_state, metrics)``
and updates are *added* to params (``apply_updates``).  Every update makes
new tensors and writes into none it was given, so a caller's params are
never changed in place.  The order of operations is the reference's:
clip, step + 1, the moments, bias corrections in float32 of the
incremented step, ``lr_fn`` of the incremented step, then
``mhat / (sqrt(vhat) + eps) + wd * p`` on every leaf (BN scales and biases
included).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from repro_torch.utils.trees import tree_leaves, tree_map


class AdamState(NamedTuple):
    step: torch.Tensor
    mu: object
    nu: object


class SGDState(NamedTuple):
    step: torch.Tensor
    momentum: object


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: g * scale, tree), norm


def _step0(params) -> torch.Tensor:
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=dev)


def _zeros(params):
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def adamw(lr: float | Callable, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.01,
          grad_clip: float | None = 1.0):
    lr_fn = lr if callable(lr) else (lambda step: lr)

    def init_fn(params):
        return AdamState(step=_step0(params), mu=_zeros(params),
                         nu=_zeros(params))

    def update_fn(grads, state: AdamState, params):
        if grad_clip is not None:
            grads, gnorm = clip_by_global_norm(grads, grad_clip)
        else:
            gnorm = global_norm(grads)
        step = state.step + 1
        t = step.to(torch.float32)
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.to(torch.float32),
                      state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v
                      + (1 - b2) * torch.square(g.to(torch.float32)),
                      state.nu, grads)
        bc1 = 1 - torch.pow(b1, t)
        bc2 = 1 - torch.pow(b2, t)
        lr_t = lr_fn(step)

        def _upd(m, v, p):
            mhat = m / bc1
            vhat = v / bc2
            u = mhat / (torch.sqrt(vhat) + eps) \
                + weight_decay * p.to(torch.float32)
            return (-lr_t * u).to(p.dtype)

        updates = tree_map(_upd, mu, nu, params)
        return updates, AdamState(step=step, mu=mu, nu=nu), \
            {"grad_norm": gnorm}

    return init_fn, update_fn


def sgd(lr: float | Callable, momentum: float = 0.9,
        grad_clip: float | None = None):
    lr_fn = lr if callable(lr) else (lambda step: lr)

    def init_fn(params):
        return SGDState(step=_step0(params), momentum=_zeros(params))

    def update_fn(grads, state: SGDState, params):
        if grad_clip is not None:
            grads, gnorm = clip_by_global_norm(grads, grad_clip)
        else:
            gnorm = global_norm(grads)
        step = state.step + 1
        mom = tree_map(lambda m, g: momentum * m + g.to(torch.float32),
                       state.momentum, grads)
        lr_t = lr_fn(step)
        updates = tree_map(lambda m, p: (-lr_t * m).to(p.dtype), mom, params)
        return updates, SGDState(step=step, momentum=mom), \
            {"grad_norm": gnorm}

    return init_fn, update_fn


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u, params, updates)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1):
    """Linear warmup to ``peak_lr``, then cosine decay to
    ``min_ratio * peak_lr``.  ``step`` is an int or a tensor; the result
    is a float32 tensor on the step's device."""
    def schedule(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * step / max(warmup_steps, 1)
        frac = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5
                         * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup_steps, warm, cos)

    return schedule
