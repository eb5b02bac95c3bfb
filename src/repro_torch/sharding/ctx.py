"""Ambient sharding context.

The port of ``repro/sharding/ctx.py``.  Model code annotates activations
with logical axis names via ``constrain(x, ("batch", "seq_act", None))``.
Inside ``with shard_ctx(mesh, rules): ...`` a DTensor is redistributed to
the placements those names give on the mesh (sharding/rules.placements);
a plain tensor is left as it is, and without a context ``constrain``
returns its input unchanged.  So one model definition serves one card and
a mesh unchanged.  The rules are imported at the call: the models import
this module, and the rules import the models' ``ParamDef``.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager


_state = threading.local()


def current_rules():
    return getattr(_state, "rules", None)


def current_mesh():
    return getattr(_state, "mesh", None)


@contextmanager
def shard_ctx(mesh, rules):
    """Activate (mesh, logical rules) for ``constrain`` calls inside."""
    from repro_torch.sharding.rules import resolve_rules

    resolved = resolve_rules(rules, mesh)
    prev = (getattr(_state, "rules", None), getattr(_state, "mesh", None))
    _state.rules, _state.mesh = resolved, mesh
    try:
        yield resolved
    finally:
        _state.rules, _state.mesh = prev


def constrain(x, logical_axes: tuple):
    """Redistribute a DTensor to its logical axes' placements (no-op
    without a context, and on a plain tensor).  A dim that its mesh axes
    do not divide is replicated (``pspec_sized``: a decode step's one
    position over a 2-way ``model`` axis), where the reference's
    constraint would pad it, and so is a dim of one (DTensor's view rules
    refuse to fold a sharded dim of one, even over one rank)."""
    rules = current_rules()
    if rules is None:
        return x
    from torch.distributed.tensor import DTensor

    from repro_torch.sharding.rules import P, placements, pspec_sized

    if not isinstance(x, DTensor):
        return x
    mesh = current_mesh()
    spec = pspec_sized(logical_axes, rules, tuple(x.shape), mesh)
    spec = P(*(None if x.shape[d] == 1 else e for d, e in enumerate(spec)))
    want = placements(spec, mesh)
    if list(want) == list(x.placements):
        return x
    return x.redistribute(mesh, want)
