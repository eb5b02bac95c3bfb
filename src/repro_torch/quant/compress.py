"""Int8 error-feedback (EF) gradient compression, on tensors.

The port of ``repro/quant/compress.py``: each gradient leaf, plus the
error carried over from the last step, is quantized to int8 with a
per-leaf scale, and the quantization residual is kept for the next step.
EF makes the sum of transmitted updates track the sum of true gradients,
so SGD/Adam still converge.  ``torch.round`` rounds half to even like
``jnp.round``, so the codes equal the reference's for the same inputs.

The reference compresses inside a ``shard_map`` all-reduce over the
data-parallel axes; on one card there is no all-reduce, so the trainer
applies compress -> decompress to the local gradient
(``training/trainer.py``, ``grad_compression="int8_ef"``).
"""

from __future__ import annotations

import torch

from repro_torch.utils.trees import tree_leaves, tree_map, tree_unflatten


def init_error_state(params):
    return tree_map(torch.zeros_like, params)


def compress_int8(g: torch.Tensor, err: torch.Tensor):
    """Returns (codes int8, scale f32 scalar, new_err)."""
    x = g + err
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    codes = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    decoded = codes.to(g.dtype) * scale
    return codes, scale, x - decoded


def decompress_int8(codes: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32):
    return codes.to(dtype) * scale


def compress_tree(grads, err_state):
    """Tree-wise EF-int8 compression.  Returns (codes, scales, new_err)."""
    out = [compress_int8(g, e) for g, e in zip(tree_leaves(grads),
                                                tree_leaves(err_state))]
    return tuple(tree_unflatten(grads, [o[i] for o in out]) for i in range(3))


def decompress_tree(codes, scales, dtype=torch.float32):
    return tree_map(lambda c, s: decompress_int8(c, s, dtype), codes, scales)
