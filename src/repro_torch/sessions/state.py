"""Structure-of-arrays session state for the streaming slot grid (TCN half).

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
                    inplace: bool = False):
    """Fused-kernel twin of ``grid_scan``: ``fused(fused_params, states, x,
    lengths)`` with lengths (S,) valid-prefix lengths.  On baked params
    its outputs at valid positions and its end state equal grid_scan's.
    A plain alias of ``core.streaming.make_fused_chunk`` (``inplace``
    included), kept so the name matches the reference's
    ``sessions/state.make_grid_fused``."""
    return make_fused_chunk(cfg, quantize=quantize, backend=backend,
                            device=device, inplace=inplace)


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
