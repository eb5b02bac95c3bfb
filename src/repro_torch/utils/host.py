"""Host copies of tensors, bfloat16 included.

numpy has no bfloat16 (the reference gets it from ``ml_dtypes``, which the
port does not use), so on the host a bf16 leaf is its raw 2-byte bits in a
numpy array of dtype ``BF16_HOST`` (``|V2``, the bytes ``np.savez`` writes
for an ``ml_dtypes.bfloat16`` array).  The dtype is the tag:
``checkpoint/store.save_sessions`` writes the reference's ``__dtypes__``
sidecar ("bfloat16") for such leaves, and every path back to a tensor turns
them into ``torch.bfloat16`` bit for bit.  Other dtypes keep numpy's.
"""

from __future__ import annotations

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
