"""Parameter declaration and initialization of the LM trees.

The port of ``repro/sharding/rules.py``'s ``ParamDef`` and ``init_params``
(lines 25-151), the part that has a meaning on one card: every parameter
is declared once with its shape, its logical axis names (kept so a tree
declares the same model as the reference's; nothing here shards), an
init kind and an fp32 dtype.  ``init_params`` materializes a tree with a
seeded ``torch.Generator`` on an explicit device, leaves in sorted key
order (``jax.tree``'s), so one seed gives one tree on one device; the
values are not the reference's (its ``jax.random`` stream is not
reproduced), so parity tests carry the reference's params over through
``convert.params_from_jax``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.kernels.dispatch import require_device
from repro_torch.utils.trees import tree_leaves, tree_unflatten


@dataclass(frozen=True)
class ParamDef:
    shape: tuple
    axes: tuple  # logical axis names; len == len(shape); None = replicated
    init: str = "normal"  # normal | zeros | ones | embed
    dtype: torch.dtype = torch.float32
    scale: float | None = None  # stddev override for "normal" and "embed"

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def map_defs(fn, defs):
    """``fn`` over every ParamDef of a nested dict of them."""
    if isinstance(defs, dict):
        return {k: map_defs(fn, v) for k, v in defs.items()}
    return fn(defs)


def _init_leaf(d: ParamDef, generator, dev) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=d.dtype, device=dev)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=d.dtype, device=dev)
    if d.init == "embed":
        std = d.scale if d.scale is not None else 0.02
    elif d.init == "normal":
        # fan-in scaling on the second-to-last dim, as in the reference
        fan_in = d.shape[-2] if len(d.shape) >= 2 else max(d.shape[-1], 1)
        std = d.scale if d.scale is not None \
            else (1.0 / max(fan_in, 1)) ** 0.5
    else:
        raise ValueError(f"unknown init {d.init}")
    t = torch.randn(d.shape, generator=generator, device=dev,
                    dtype=torch.float32)
    return t.mul_(std).to(d.dtype)


def init_params(defs, generator: torch.Generator, device="cuda") -> dict:
    """Materialize a ParamDef tree on ``device``.  Random leaves are drawn
    from ``generator``, which must live on that device, in sorted key
    order."""
    dev = require_device(device)
    leaves = [_init_leaf(d, generator, dev) for d in tree_leaves(defs)]
    return tree_unflatten(defs, leaves)


def abstract_params(defs) -> dict:
    """A ParamDef tree's shapes and dtypes as tensors on the ``meta``
    device (no allocation): the reference's ShapeDtypeStruct tree."""
    return map_defs(lambda d: torch.empty(d.shape, dtype=d.dtype,
                                          device="meta"), defs)


def param_count(defs) -> int:
    n = 0
    for d in tree_leaves(defs):
        k = 1
        for s in d.shape:
            k *= s
        n += k
    return n
