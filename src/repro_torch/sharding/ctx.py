"""Ambient sharding context.

The port of ``repro/sharding/ctx.py``.  Model code annotates activations
with logical axis names via ``constrain(x, ("batch", "seq_act", None))``.
Inside ``with shard_ctx(mesh, rules): ...`` a DTensor is redistributed to
the placements those names give on the mesh (sharding/rules.placements);
a plain tensor is left as it is, and without a context ``constrain``
returns its input unchanged.  So one model definition serves one card and
a mesh unchanged.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

from repro_torch.sharding.rules import placements, pspec, resolve_rules

_state = threading.local()


def current_rules():
    return getattr(_state, "rules", None)


def current_mesh():
    return getattr(_state, "mesh", None)


@contextmanager
def shard_ctx(mesh, rules):
    """Activate (mesh, logical rules) for ``constrain`` calls inside."""
    resolved = resolve_rules(rules, mesh)
    prev = (getattr(_state, "rules", None), getattr(_state, "mesh", None))
    _state.rules, _state.mesh = resolved, mesh
    try:
        yield resolved
    finally:
        _state.rules, _state.mesh = prev


def constrain(x, logical_axes: tuple):
    """Redistribute a DTensor to its logical axes' placements (no-op
    without a context, and on a plain tensor)."""
    rules = current_rules()
    if rules is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    mesh = current_mesh()
    return x.redistribute(mesh, placements(pspec(logical_axes, rules), mesh))
