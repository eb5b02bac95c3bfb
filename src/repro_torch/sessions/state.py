"""Structure-of-arrays session state: the TCN slot grid, and the column
and pool helpers of the LM KV cache.

The port of ``repro/sessions/state.py``: a slot grid stacks ``n_slots``
single-session streaming states leaf-wise — rings (S, n, c), step counters
(S,) — and each slot keeps its own counter, so sessions admitted at
different times stay phase-correct.  ``grid_scan`` advances every slot
over a chunk with the per-step path; ``make_grid_fused`` is the fused
kernel executor over the same grid.  Inactive slots and steps past a
slot's length are frozen.

The parking lot moves one slot's column to host memory as a nested dict
of numpy arrays (the reference's blob layout, so blobs cross between the
packages).  With ``pack_u4=True`` ring leaves that sit exactly on the u4
grid are stored as packed nibbles; exactness is checked per leaf at pack
time and an off-grid leaf (block 0's raw-input ring) stays fp32, so
park/resume is bit-exact either way.  ``unpack_slot`` and ``reset_slot``
write the slot's column in place (the grid is owned by one service).

The LM half (``src/repro/sessions/state.py:249-456``) generalizes the
parking lot to trees whose per-session axis is not leading: a KV cache
stacks sessions on axis 1 of (L, B, S, Hkv, Dh) leaves.  ``leaf_axes``
finds each leaf's session and sequence axes by diffing two shape trees
(``bundle.cache_specs`` on the ``meta`` device, as the reference diffs
``eval_shape``); ``pack_column`` truncates a column to the session's live
positions (parked bytes are O(pos)), ``unpack_column`` zero-extends it
back.  The paged layout replaces each seq-axis leaf's (..., B, S, ...)
storage with a shared (..., n_blocks + 1, block_len, ...) pool read
through per-lane int32 block tables (block 0 is the NULL block):
``gather_column`` rebuilds the exact dense column of a table row, so the
decode programs run the dense code on it.  Host copies of bf16 leaves are
their bits (``utils/host.py``).  Device writes are in place.

``grid_pspecs`` and ``column_pspecs`` give the specs (sharding/rules.P)
that lay a grid over a device mesh: the session axis goes to the mesh
axis the "slots" rule names (``data`` by default), every other dim stays
replicated.  Both are divisibility-gated (``pspec_sized``), so a grid
that does not divide the axis stays replicated and the same service
construction works on any mesh, one device included.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.streaming import (
    _map,
    make_fused_chunk,
    ring_sizes,
    stream_init_single,
    stream_step,
)
from repro_torch.models.config import ArchConfig
from repro_torch.sharding.rules import DEFAULT_RULES, pspec_sized, resolve_rules
from repro_torch.utils.host import from_host, to_host


def grid_init(cfg: ArchConfig, n_slots: int, device="cuda") -> dict:
    """Stacked session state: every single-session leaf gains a leading
    (n_slots,) axis."""
    return _map(lambda a: torch.zeros((n_slots,) + tuple(a.shape),
                                      dtype=a.dtype, device=a.device),
                stream_init_single(cfg, device))


def grid_step(params, bn_state, cfg: ArchConfig, states: dict, x, active, *,
              quantize: bool = False):
    """Advance all S slots one sample.  x: (S, C_in); active: (S,) bool.
    Slots with active=False keep their state exactly."""
    stepped, emb, logits = stream_step(params, bn_state, cfg, states, x,
                                       quantize=quantize)

    def keep(new, old):
        return torch.where(active.reshape(active.shape + (1,) * (new.dim() - 1)),
                           new, old)

    return _map(keep, stepped, states), emb, logits


def lengths_to_valid(lengths, t_chunk: int) -> torch.Tensor:
    """Per-slot chunk lengths (S,) -> (S, T) step-validity mask."""
    lengths = torch.as_tensor(lengths)
    return torch.arange(t_chunk, device=lengths.device)[None, :] \
        < lengths[:, None]


def grid_scan(params, bn_state, cfg: ArchConfig, states: dict, x, valid, *,
              quantize: bool = False):
    """Advance all S slots over a T-sample chunk with the per-step path.
    x: (S, T, C_in); valid: (S, T) bool.  Returns (states, embs (S, T, V),
    logits (S, T, n_classes))."""
    embs, logits = [], []
    for i in range(x.shape[1]):
        states, e, lg = grid_step(params, bn_state, cfg, states, x[:, i],
                                  valid[:, i], quantize=quantize)
        embs.append(e)
        logits.append(lg)
    return states, torch.stack(embs, dim=1), torch.stack(logits, dim=1)


def make_grid_fused(cfg: ArchConfig, *, quantize: bool = False,
                    backend: str | None = None, device="cuda",
                    inplace: bool = False, tracer=None):
    """Fused-kernel twin of ``grid_scan``: ``fused(fused_params, states, x,
    lengths)`` with lengths (S,) valid-prefix lengths.  On baked params
    its outputs at valid positions and its end state equal grid_scan's.
    A plain alias of ``core.streaming.make_fused_chunk`` (``inplace`` and
    ``tracer`` included), kept so the name matches the reference's
    ``sessions/state.make_grid_fused``."""
    return make_fused_chunk(cfg, quantize=quantize, backend=backend,
                            device=device, inplace=inplace, tracer=tracer)


def grid_pspecs(cfg: ArchConfig, mesh, n_slots: int, rules: dict | None = None):
    """Spec tree for the slot grid: the leading slot axis goes to the mesh
    axis the "slots" logical rule names; all per-session dims stay
    replicated."""
    rules = resolve_rules(DEFAULT_RULES if rules is None else rules, mesh)

    def spec(leaf):
        shape = (n_slots,) + tuple(leaf.shape)
        axes = ("slots",) + (None,) * leaf.dim()
        return pspec_sized(axes, rules, shape, mesh)

    return _map(spec, stream_init_single(cfg, "meta"))


# ---------------------------------------------------------------------------
# Parking lot: host-side pack/unpack of one slot's column
# ---------------------------------------------------------------------------

_U4_KEY = "u4c"


def _is_packed(x) -> bool:
    return isinstance(x, dict) and _U4_KEY in x


def _pack_leaf_u4(a: np.ndarray, act_scale: float):
    """Pack one host leaf to nibbles IFF that is exactly invertible."""
    a = np.asarray(a)
    if a.ndim < 1 or a.shape[-1] % 2 != 0 or a.dtype != np.float32:
        return None
    s = np.float32(act_scale)
    q = np.round(a / s)
    if not ((q >= 0) & (q <= 15)).all():
        return None
    if not np.array_equal(q.astype(np.float32) * s, a):
        return None
    u = q.astype(np.uint8)
    return {_U4_KEY: (u[..., 0::2] | (u[..., 1::2] << 4)).astype(np.uint8),
            "scale": s}


def _unpack_leaf(p) -> np.ndarray:
    if not _is_packed(p):
        return np.asarray(p)
    packed = np.asarray(p[_U4_KEY])
    s = np.float32(p["scale"])
    q = np.stack([packed & 0xF, packed >> 4], axis=-1).reshape(
        *packed.shape[:-1], packed.shape[-1] * 2)
    return q.astype(np.float32) * s


def _map_parked(fn, tree):
    if isinstance(tree, dict) and not _is_packed(tree):
        return {k: _map_parked(fn, v) for k, v in tree.items()}
    return fn(tree)


def pack_slot(states: dict, slot: int, *, pack_u4: bool = False,
              act_scale: float = 0.25) -> dict:
    """Copy one slot's session state to host memory (the parking lot)."""
    parked = _map(lambda a: a[slot].to("cpu", copy=True).numpy(), states)
    if not pack_u4:
        return parked

    def enc(a):
        p = _pack_leaf_u4(a, act_scale)
        return a if p is None else p

    return {"t": parked["t"], "blocks": _map(enc, parked["blocks"])}


def decode_parked(parked: dict) -> dict:
    """Plain fp32-array view of a parked blob (nibble leaves expanded)."""
    return _map_parked(_unpack_leaf, parked)


def unpack_slot(states: dict, slot: int, parked: dict) -> dict:
    """Restore a parked session into ``slot`` (any free slot works — state
    is slot-position independent).  Accepts raw or nibble-packed blobs."""
    def put(a, p):
        a[slot] = torch.tensor(np.asarray(p)).to(a.device, a.dtype)
        return a

    return _map(put, states, decode_parked(parked))


def reset_slot(states: dict, slot: int) -> dict:
    """Zero one slot (fresh session: empty rings, t=0)."""
    def zero(a):
        a[slot] = 0
        return a

    return _map(zero, states)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def parked_bytes(parked: dict) -> int:
    """Host bytes of one parked session (packed leaves count packed)."""
    return int(sum(np.asarray(a).nbytes for a in _leaves(parked)))


def slot_park_bytes(cfg: ArchConfig, *, quantize: bool = False) -> int:
    """Structural parked footprint of one session (content-independent):
    quantized rings of even width pack to n*c/2 bytes + a 4-byte scale,
    except block 0's raw-input ring1; the step counter is int32."""
    total = 4
    for i, rs in enumerate(ring_sizes(cfg).values()):
        for ring, (n, c) in rs.items():
            packable = (quantize and c % 2 == 0
                        and not (i == 0 and ring == "ring1"))
            total += n * (c // 2) + 4 if packable else n * c * 4
    return total


def slot_state_bytes(states: dict) -> int:
    """Per-slot state footprint in bytes (host copy of one column)."""
    leaves = list(_leaves(states))
    n_slots = leaves[0].shape[0]
    return sum(a.numel() * a.element_size() for a in leaves) // n_slots


# ---------------------------------------------------------------------------
# Generalized columns: per-leaf session axes (LM KV caches)
# ---------------------------------------------------------------------------

def map_tree(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts, the other trees indexed by
    the first one's keys (a missing key raises ``KeyError``)."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def leaf_axes(make_a, make_b):
    """Per-leaf axis tree: the first axis whose extent differs between the
    trees ``make_a()`` and ``make_b()`` build (-1 where none does).  Build
    them with one structural parameter changed (B vs B + 1 for the session
    axis, S vs S + 1 for the sequence axis), on the ``meta`` device."""
    def axis_of(a, b):
        for i, (x, y) in enumerate(zip(a.shape, b.shape)):
            if x != y:
                return i
        return -1

    return map_tree(axis_of, make_a(), make_b())


def column_pspecs(tree_shapes, batch_axes, mesh, rules: dict | None = None):
    """Spec tree for an arbitrary-axis slot grid: each leaf's per-session
    axis (``batch_axes``, from ``leaf_axes``) goes to the mesh axis the
    "slots" rule names; every other dim stays replicated.  The LM cache's
    analog of ``grid_pspecs``: sessions there live on axis 1 of (L, B, S,
    H, Dh) leaves, not axis 0."""
    rules = resolve_rules(DEFAULT_RULES if rules is None else rules, mesh)

    def spec(leaf, bax):
        axes = tuple("slots" if i == bax else None for i in range(leaf.dim()))
        return pspec_sized(axes, rules, tuple(leaf.shape), mesh)

    return map_tree(spec, tree_shapes, batch_axes)


def _as_leaf(p, like: torch.Tensor) -> torch.Tensor:
    """A parked host array as a tensor of ``like``'s dtype and device: bf16
    bits and other same-width views are reinterpreted, not cast (an npz
    round trip may hand back raw bytes)."""
    t = from_host(p)
    if t.dtype != like.dtype and t.element_size() == like.element_size():
        t = t.view(like.dtype)
    return t.to(like.device, like.dtype)


def pack_column(tree, axes, slot: int, *, trunc_axes=None,
                trunc_len=None) -> dict:
    """Copy one session's column of a SoA tree to host memory.  With
    ``trunc_axes``/``trunc_len``, leaves with a sequence axis keep only
    their first ``trunc_len`` positions (a KV column is only written up to
    the session's position, so a parked blob costs O(pos) bytes)."""
    def enc(a, ax, tax):
        if ax < 0:
            raise ValueError("pack_column: leaf without a session axis")
        col = a.select(ax, slot)
        if tax >= 0 and trunc_len is not None:
            col = col.narrow(tax - (tax > ax), 0, int(trunc_len))
        return to_host(col)

    if trunc_axes is None:
        trunc_axes = map_tree(lambda _: -1, axes)
    return map_tree(enc, tree, axes, trunc_axes)


def unpack_column(tree, axes, slot: int, parked: dict) -> dict:
    """Restore a ``pack_column`` blob into ``slot`` (any free slot works),
    in place.  A truncated sequence axis is zero-extended: positions past
    the parked length were never written by the per-lane decode, so zero
    is the uninterrupted run's content."""
    def put(a, ax, p):
        col = a.select(ax, slot)
        t = _as_leaf(p, a)
        if tuple(t.shape) != tuple(col.shape):
            col.zero_()
            col = col[tuple(slice(0, n) for n in t.shape)]
        col.copy_(t)
        return a

    return map_tree(put, tree, axes, parked)


def zero_from_column(tree, axes, seq_axes, slot: int, start) -> dict:
    """Zero one session's sequence rows at positions >= ``start`` (an int
    or a 0-d tensor), in place: the position-range rollback that makes a
    column canonical, bit-identical to what park (truncation) + resume
    (zero-extension) would rebuild.  Leaves without a sequence axis are
    untouched."""
    def scrub(a, bax, sax):
        if sax < 0:
            return a
        col = a.select(bax, slot)
        t = sax - (sax > bax)
        pos = torch.arange(col.shape[t], device=a.device)
        keep = (pos < start).reshape((1,) * t + (-1,)
                                     + (1,) * (col.dim() - t - 1))
        col.copy_(torch.where(keep, col, torch.zeros((), dtype=a.dtype,
                                                     device=a.device)))
        return a

    return map_tree(scrub, tree, axes, seq_axes)


# ---------------------------------------------------------------------------
# Paged columns: shared block pools + per-lane block tables
# ---------------------------------------------------------------------------
#
# Only defined for leaves whose sequence axis follows the session axis
# (sax == bax + 1, true of every KV cache of models/build.py): swapping
# (B, S) -> (n_blocks, block_len) keeps every other axis in place, so a
# gather + reshape rebuilds the exact dense column.

PAGED_MARKER = "pv"  # paged park-blob marker: np.int32 [block_len, n_keep]


def paged_flags(batch_axes, seq_axes):
    """Per-leaf bool tree: True where the leaf pages (has a seq axis)."""
    return map_tree(lambda bax, sax: sax >= 0, batch_axes, seq_axes)


def make_pools(specs, batch_axes, seq_axes, extent: int, block_len: int,
               device) -> dict:
    """Pool tree from a cache shape tree (``cache_specs``, on ``meta``):
    every seq-axis leaf becomes a zeroed shared pool of ``extent``
    physical blocks of ``block_len`` rows (extent counts the NULL block)
    on ``device``; recurrent leaves get their dense zeroed storage."""
    def mk(a, bax, sax):
        shape = list(a.shape)
        if sax >= 0:
            if sax != bax + 1:
                raise ValueError(
                    f"paged layout needs the sequence axis adjacent to the "
                    f"session axis (got bax={bax}, sax={sax})")
            if a.shape[sax] % block_len:
                raise ValueError(f"seq_cap {a.shape[sax]} not divisible by "
                                 f"block_len {block_len}")
            shape[bax], shape[sax] = extent, block_len
        return torch.zeros(shape, dtype=a.dtype, device=device)

    return map_tree(mk, specs, batch_axes, seq_axes)


def gather_column(pool, rows, bax: int):
    """Dense column view of a pool through block-table ``rows``: (nb,)
    for one lane -> (..., nb * block_len, ...), or (B, nb) for every lane
    -> (..., B, nb * block_len, ...), merged at axis ``bax``.  Bit-identical
    to the dense layout's column at every live position."""
    g = pool.index_select(bax, rows.reshape(-1).long())
    bl = pool.shape[bax + 1]
    lead = tuple(rows.shape[:-1])
    return g.reshape(pool.shape[:bax] + lead + (rows.shape[-1] * bl,)
                     + pool.shape[bax + 2:])


def scatter_rows(pool, col, rows, positions, bax: int) -> None:
    """Write dense-column rows back into the pool, in place.  ``col``:
    (..., B, S, ...) columns at axis ``bax`` (as ``gather_column`` of
    ``rows`` (B, nb) gives them); ``positions`` (B, n) the rows of each
    lane to write, through its table row (unowned blocks map to the NULL
    block, which absorbs them)."""
    bl = pool.shape[bax + 1]
    positions = positions.long()
    blk = torch.gather(rows.long(), 1, positions // bl)
    lanes = torch.arange(positions.shape[0], device=pool.device)[:, None]
    lead = (slice(None),) * bax
    pool[lead + (blk, positions % bl)] = col[lead + (lanes, positions)]


def split_blocks(col, bax: int, block_len: int):
    """Inverse of the ``gather_column`` merge: (..., S, ...) ->
    (..., S // block_len, block_len, ...) at axis ``bax``."""
    nb = col.shape[bax] // block_len
    return col.reshape(col.shape[:bax] + (nb, block_len)
                       + col.shape[bax + 1:])


def pack_blocks(pool, bids, bax: int) -> np.ndarray:
    """Copy a session's owned blocks to host memory, (..., len(bids),
    block_len, ...): the paged form of pack_column's O(pos) truncation."""
    idx = torch.as_tensor(np.asarray(bids, np.int64), device=pool.device)
    return to_host(pool.index_select(bax, idx))


def unpack_blocks(pool, bids, blocks, bax: int):
    """Scatter a ``pack_blocks`` blob into freshly allocated blocks of the
    pool (any free blocks work), in place."""
    idx = torch.as_tensor(np.asarray(bids, np.int64), device=pool.device)
    pool.index_copy_(bax, idx, _as_leaf(blocks, pool))
    return pool


def copy_block(pool, src: int, dst: int, bax: int):
    """Device copy of one block (the copy-on-write clone), in place."""
    pool.select(bax, dst).copy_(pool.select(bax, src))
    return pool
