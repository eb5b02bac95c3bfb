"""Bounded rehearsal memory of u4 log2-quantized shot embeddings.

The port of ``repro/sessions/rehearsal.py``.  Running-mean prototypes
(Eq. 6) are exact but irreversible: once shots are folded into ``s_sums``
they cannot be re-weighted or replayed.  This buffer keeps, per (tenant,
way), a reservoir of shot embeddings as 4-bit signed log2 codes
(quant/log2.py, the paper's weight codebook) packed two to a byte with one
fp32 scale per shot (~V/2 + 4 bytes a shot against 4V for fp32), and
``rebuild`` re-sums a dequantized reservoir into (s_sum, count).

Codes, scales and the reservoir's choices are the reference's byte for
byte: the codes come from ``repro_torch.quant.log2`` on CPU tensors (the
one documented difference is a weight on a ``round(-log2 a)`` tie, see
quant/log2.py), the scale is the row's max |v| as an fp32 value, and the
reservoir draws from ``np.random.default_rng(seed)`` in the reference's
order.  The buffer is host state; the blobs of ``export_tenant`` are plain
Python/numpy values that either package adopts.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.quant.log2 import (
    compute_scale,
    dequantize_log2,
    pack_nibbles,
    quantize_log2,
    unpack_nibbles,
)


class RehearsalBuffer:
    """Per-(tenant, way) bounded reservoirs of quantized embeddings."""

    def __init__(self, cap_per_class: int = 8, seed: int = 0):
        if cap_per_class < 1:
            raise ValueError(
                f"cap_per_class must be >= 1, got {cap_per_class}")
        self.cap = int(cap_per_class)
        self._rng = np.random.default_rng(seed)
        # (tenant, way) -> list of (packed u4 codes (ceil(V/2),) u8, scale)
        self._mem: dict[tuple[int, int], list] = {}
        self._seen: dict[tuple[int, int], int] = {}  # shots ever offered
        # host bytes of every reservoir, kept up to date where shots come
        # and go: the service reads it after every enroll, where a sum
        # over the reservoirs would grow with the buffer
        self._nbytes = 0

    @staticmethod
    def _encode(row: np.ndarray):
        v = row.astype(np.float32)
        if v.shape[0] % 2:  # pack_nibbles needs an even last axis
            v = np.concatenate([v, np.zeros(1, np.float32)])
        t = torch.from_numpy(v)
        scale = compute_scale(t)
        return pack_nibbles(quantize_log2(t, scale)).numpy(), float(scale)

    @staticmethod
    def _decode(packed: np.ndarray, scale: float, dim: int) -> np.ndarray:
        codes = unpack_nibbles(torch.from_numpy(np.asarray(packed)))
        return dequantize_log2(codes, scale).numpy()[:dim]

    def add(self, tenant: int, way: int, embeddings) -> None:
        """Offer (k, V) shot embeddings to the (tenant, way) reservoir."""
        emb = np.asarray(embeddings, np.float32)
        key = (tenant, way)
        mem = self._mem.setdefault(key, [])
        for row in emb:
            seen = self._seen.get(key, 0)
            item = self._encode(row)
            if len(mem) < self.cap:
                mem.append(item)
                self._nbytes += _shot_bytes(item)
            else:  # reservoir: a uniform sample of all shots offered
                j = int(self._rng.integers(0, seen + 1))
                if j < self.cap:
                    self._nbytes += _shot_bytes(item) - _shot_bytes(mem[j])
                    mem[j] = item
            self._seen[key] = seen + 1

    def n_shots(self, tenant: int, way: int) -> int:
        return len(self._mem.get((tenant, way), ()))

    def rebuild(self, tenant: int, way: int, dim: int):
        """Dequantize the reservoir into prototype rows: (s_sum (V,) fp32,
        count).  Raises KeyError when the class has no buffered shots."""
        mem = self._mem.get((tenant, way))
        if not mem:
            raise KeyError(f"no rehearsal shots for tenant {tenant} "
                           f"way {way}")
        rows = np.stack([self._decode(p, s, dim) for p, s in mem])
        return rows.astype(np.float32).sum(axis=0), len(mem)

    def drop(self, tenant: int) -> None:
        for key in [k for k in self._mem if k[0] == tenant]:
            self._nbytes -= sum(map(_shot_bytes, self._mem.pop(key)))
            self._seen.pop(key, None)

    def export_tenant(self, tenant: int) -> dict:
        """One tenant's reservoirs (packed codes + scales + seen counters,
        keyed by way) for handoff to a peer buffer.  Non-destructive: the
        lists are copied and the packed arrays are never mutated."""
        out = {}
        for (t, way), mem in self._mem.items():
            if t == tenant:
                out[way] = {"shots": list(mem),
                            "seen": self._seen.get((t, way), len(mem))}
        return out

    def adopt_tenant(self, tenant: int, blob: dict) -> None:
        """Install reservoirs exported by a peer's ``export_tenant``;
        refuses a (tenant, way) that already holds shots here.  Sampling
        continues with this buffer's RNG."""
        for way in blob:
            if (tenant, int(way)) in self._mem:
                raise ValueError(f"tenant {tenant} way {way} already has "
                                 "rehearsal shots; refuse to overwrite")
        for way, ent in blob.items():
            key = (tenant, int(way))
            self._mem[key] = list(ent["shots"])
            self._seen[key] = int(ent["seen"])
            self._nbytes += sum(map(_shot_bytes, self._mem[key]))

    def nbytes(self, tenant: int | None = None) -> int:
        """Host bytes of the buffer (packed codes + one fp32 scale a shot),
        or of one tenant's reservoirs."""
        if tenant is None:
            return self._nbytes
        return sum(sum(map(_shot_bytes, mem))
                   for (t, _), mem in self._mem.items() if t == tenant)


def _shot_bytes(item) -> int:
    return np.asarray(item[0]).nbytes + 4
