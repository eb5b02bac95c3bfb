"""Carry the JAX reference's trees into the port.

``params_from_jax`` takes a reference tree whose leaves are numpy arrays
(the caller maps ``np.asarray`` over the JAX tree) and returns the same
nesting with torch tensors on ``device``, dtypes kept.  It serves every
tree the two packages share, because their layouts are the same: raw
params, the BN state, the baked/fused tree with its ``{"codes", "scale"}``
leaves, and parked session blobs' arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.dispatch import require_device


def params_from_jax(tree, device="cuda"):
    dev = require_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return torch.from_numpy(np.array(node, copy=True)).to(dev)

    return walk(tree)
