"""What a rank of an SPMD service needs to know about a sharded dim.

A service on a mesh (sessions/service.py, sessions/lm.py) runs in every
rank with the same calls and arguments, so every rank holds the same host
state.  Its device leaves are DTensors sharded on one dim (slots over
``data``, tenants over ``model``) and evenly divided, because the specs
are divisibility-gated (``pspec_sized``).  These helpers say which block
of that dim a rank holds, which rank owns an index, and move what one
rank computed to every rank: a host object (``from_owner``) or per-rank
rows (``gather``).  A spec entry is None (replicated: every rank holds the
whole dim), one mesh axis name, or a tuple of them, the first outermost.
A one-rank mesh takes the same path (its collectives move nothing).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.sharding.rules import P, placements

# torch 2.13 renamed all_gather_into_tensor (the old name warns there)
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _size(mesh, a: str) -> int:
    # not ``mesh.mesh.shape``: that builds the rank tensor on every read
    return mesh.size(mesh.mesh_dim_names.index(a))


def n_blocks(mesh, entry) -> int:
    """How many blocks ``entry`` cuts a dim into."""
    n = 1
    for a in _axes(entry):
        n *= _size(mesh, a)
    return n


def block_index(mesh, entry) -> int:
    """This rank's block of a dim sharded over ``entry``."""
    i = 0
    for a in _axes(entry):
        i = i * _size(mesh, a) + mesh.get_local_rank(a)
    return i


def local_range(mesh, entry, n: int) -> tuple[int, int]:
    """[lo, hi) of an ``n``-long dim that this rank holds."""
    per = n // n_blocks(mesh, entry)
    lo = block_index(mesh, entry) * per
    return lo, lo + per


def block_range(mesh, pls, dim: int, n: int) -> tuple[int, int]:
    """[lo, hi) of an ``n``-long dim ``dim`` that this rank holds under the
    DTensor placements ``pls``: the mesh axes that shard it, in mesh
    order (DTensor nests their blocks so)."""
    from torch.distributed.tensor import Shard

    entry = tuple(a for a, p in zip(mesh.mesh_dim_names, pls)
                  if isinstance(p, Shard) and p.dim == dim)
    return local_range(mesh, entry, n)


def owner(mesh, entry, i: int, n: int) -> int:
    """The global rank that packs index ``i`` of an ``n``-long dim: of the
    ranks holding its block, the one at coordinate 0 on every other mesh
    axis (rank 0's coordinates when the dim is replicated)."""
    names = mesh.mesh_dim_names
    coords = [0] * len(names)
    b = i // (n // n_blocks(mesh, entry))
    for a in reversed(_axes(entry)):
        k = names.index(a)
        coords[k] = b % _size(mesh, a)
        b //= _size(mesh, a)
    return int(mesh.mesh[tuple(coords)])


def from_owner(mesh, src: int, fn):
    """``fn()`` run on rank ``src``, its result sent to every rank (a host
    object: a parked blob, a bank row)."""
    box = [fn() if dist.get_rank() == src else None]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def wrap(local: torch.Tensor, mesh, spec: P):
    """A DTensor over ``mesh`` whose local shard is ``local`` (no copy: the
    DTensor and ``local`` share storage, so in-place writes to one show in
    the other)."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, mesh, placements(spec, mesh),
                              run_check=False)


def place_as(full: torch.Tensor, mesh, pls):
    """``full`` (the same on every rank) as a DTensor of placements
    ``pls``: each rank keeps a copy of its own block, and nothing is
    sent."""
    from torch.distributed.tensor import DTensor, Shard

    local = full
    for d in sorted({p.dim for p in pls if isinstance(p, Shard)}):
        lo, hi = block_range(mesh, pls, d, full.shape[d])
        local = local.narrow(d, lo, hi - lo)
    return DTensor.from_local(local.clone() if local is not full else full,
                              mesh, pls, run_check=False)


def place(full: torch.Tensor, mesh, spec: P):
    """``full`` as a DTensor of ``spec`` (``place_as`` its placements)."""
    return place_as(full, mesh, placements(spec, mesh))


def gather(local_rows: torch.Tensor, mesh, entry, dim: int = 0):
    """Every rank's block of dim ``dim`` (sharded over ``entry``) joined in
    block order, on every rank: one all-gather into one tensor over each
    mesh axis of ``entry``, the innermost first (plain process-group
    collectives: DTensor's ``full_tensor``, and ``all_gather`` into a
    list, cost more host time a call)."""
    if entry is None:
        return local_rows
    out = local_rows.movedim(dim, 0).contiguous()
    for a in reversed(_axes(entry)):
        full = out.new_empty((_size(mesh, a) * out.shape[0], *out.shape[1:]))
        _all_gather(full, out, group=mesh.get_group(a))
        out = full
    return out.movedim(0, dim)
