"""Carry trees between the JAX reference and the port.

``params_from_jax`` takes a reference tree whose leaves are numpy arrays
(the caller maps ``np.asarray`` over the JAX tree) and returns the same
nesting with torch tensors on ``device``, dtypes kept.  It serves every
tree the two packages share, because their layouts are the same: raw
params (TCN and LM), the BN state, the baked/fused tree with its
``{"codes", "scale"}`` leaves, KV caches and parked session blobs.

bfloat16 leaves: numpy cannot name them without ``ml_dtypes``, which the
port does not use, so a caller hands them over as their bits, a ``uint16``
view (``a.view(np.uint16)``) or the ``|V2`` bytes ``np.savez`` writes, and
they become ``torch.bfloat16`` bit for bit (no port tree has a uint16
leaf).  ``numpy_bits`` is the reverse, for comparing a port tree or blob
with a reference one leaf by leaf: tensors to numpy, bf16 (tensor or host
bits) as a ``uint16`` view, the same view the reference's
``ml_dtypes.bfloat16`` leaves take.
"""

from __future__ import annotations

import numpy as np

from repro_torch.kernels.dispatch import require_device
from repro_torch.utils.host import BF16_HOST, from_host, to_host


def _walk(fn, node):
    if isinstance(node, dict):
        return {k: _walk(fn, v) for k, v in node.items()}
    return fn(node)


def params_from_jax(tree, device="cuda"):
    dev = require_device(device)

    def leaf(a):
        a = np.asarray(a)
        if a.dtype == np.uint16:
            a = a.view(BF16_HOST)
        return from_host(a, dev)

    return _walk(leaf, tree)


def numpy_bits(tree):
    """A port tree (tensors or host arrays) as numpy, bf16 as uint16."""
    def leaf(x):
        a = to_host(x)
        return a.view(np.uint16) if a.dtype == BF16_HOST else a

    return _walk(leaf, tree)


__all__ = ["params_from_jax", "numpy_bits"]
