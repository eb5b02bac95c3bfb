"""Host copies of tensors, bfloat16 included.

numpy has no bfloat16 (the reference gets it from ``ml_dtypes``, which the
port does not use), so on the host a bf16 leaf is its raw 2-byte bits in a
numpy array of dtype ``BF16_HOST`` (``|V2``, the bytes ``np.savez`` writes
for an ``ml_dtypes.bfloat16`` array).  The dtype is the tag:
``checkpoint/store.save_sessions`` writes the reference's ``__dtypes__``
sidecar ("bfloat16") for such leaves, and every path back to a tensor turns
them into ``torch.bfloat16`` bit for bit.  Other dtypes keep numpy's.

``StagingBuffer`` is the other way back: one reused host buffer, page-locked
on a CUDA service, that a tick's outputs are copied into in one wait.
"""

from __future__ import annotations

import math

import numpy as np
import torch

BF16_HOST = np.dtype("V2")


def to_host(x) -> np.ndarray:
    """A tensor (any device) or array as a numpy array; bf16 as bits.  A
    tensor is always copied, so the array never aliases a CPU tensor's
    storage (a parked column must not change with the grid)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).to("cpu", copy=True).numpy() \
                .view(BF16_HOST)
        return x.to("cpu", copy=True).numpy()
    return np.asarray(x)


def from_host(a, device=None, dtype: torch.dtype | None = None):
    """A numpy array (or tensor) as a tensor on ``device``: ``BF16_HOST``
    bits become ``torch.bfloat16``; ``dtype`` then casts, except that bits
    of one width are reinterpreted (a bf16 blob into a bf16 leaf)."""
    if isinstance(a, torch.Tensor):
        t = a
    else:
        a = np.asarray(a)
        if a.dtype == BF16_HOST:
            t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)) \
                .view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a, copy=True))
    if dtype is not None and t.dtype != dtype:
        t = t.to(dtype)
    return t if device is None else t.to(device)


class StagingBuffer:
    """One host buffer that device tensors are copied back through, reused
    by every copy and grown only when a copy needs more bytes than it holds.

    ``pinned=True`` page-locks it (CUDA), so each ``copy_(...,
    non_blocking=True)`` into a view is one DMA at the host link's rate,
    not CUDA's staged copy through its own bounce buffer into fresh
    pageable pages.  The buffer holds the power of two of bytes at or above
    what a copy needs: ``torch.empty(..., pin_memory=True)`` goes through
    the caching host allocator, which rounds a block up so (2.2 GB to 4 GiB),
    and the buffer keeps the whole block.  ``pinned=False`` is the same
    buffer pageable.

    Every ``fill`` hands out views of the same bytes, so a caller copies
    whatever it keeps past its next ``fill``.  ``nbytes_gauge`` and
    ``allocs_counter`` (obs/metrics) follow ``nbytes`` and ``allocs``."""

    ALIGN = 256  # each view starts on the device allocator's alignment

    def __init__(self, pinned: bool, *, nbytes_gauge=None,
                 allocs_counter=None):
        self.pinned = pinned
        self.nbytes = 0   # bytes held
        self.allocs = 0   # allocations, the first and each regrowth
        self._gauge, self._counter = nbytes_gauge, allocs_counter
        self._buf: torch.Tensor | None = None

    @classmethod
    def layout(cls, specs) -> tuple[list[int], int]:
        """Byte offsets of views of ``specs`` [(shape, dtype)] laid back to
        back, each rounded up to ``ALIGN``, and the bytes they span."""
        offsets, end = [], 0
        for shape, dtype in specs:
            start = -(-end // cls.ALIGN) * cls.ALIGN
            offsets.append(start)
            end = start + math.prod(shape) * dtype.itemsize
        return offsets, end

    def views(self, specs) -> list[torch.Tensor]:
        """Contiguous host tensors of ``specs`` [(shape, dtype)], carved from
        the buffer at ``layout``'s offsets; grows the buffer if they do not
        fit."""
        offsets, total = self.layout(specs)
        if total > self.nbytes:
            self._grow(total)
        return [self._buf[o:o + math.prod(shape) * dtype.itemsize]
                .view(dtype).view(shape)
                for o, (shape, dtype) in zip(offsets, specs)]

    def fill(self, tensors) -> list[np.ndarray]:
        """Copies of ``tensors`` (one device) as numpy views of the buffer:
        every copy is queued on the current stream, then one event recorded
        after them is waited for.  A non-contiguous tensor is made
        contiguous on its device first, so each copy is one DMA."""
        host = self.views([(t.shape, t.dtype) for t in tensors])
        for h, t in zip(host, tensors):
            h.copy_(t.contiguous(), non_blocking=True)
        dev = tensors[0].device
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).record_event().synchronize()
        return [h.numpy() for h in host]

    def _grow(self, nbytes: int) -> None:
        self.release()
        size = 1 << (nbytes - 1).bit_length()
        self._buf = torch.empty(size, dtype=torch.uint8,
                                pin_memory=self.pinned)
        self.nbytes = size
        self.allocs += 1
        if self._gauge is not None:
            self._gauge.inc(size)
        if self._counter is not None:
            self._counter.inc()

    def release(self) -> None:
        """Drops the buffer (a pinned block goes back to the caching host
        allocator once the copies into it have landed); the next ``views``
        allocates anew."""
        if self._gauge is not None:
            self._gauge.inc(-self.nbytes)
        self._buf, self.nbytes = None, 0
