"""Matmul with nibble-packed 4-bit signed log2 weights (§III-C).

Replaces the Pallas kernel ``repro/kernels/log2_matmul.py::log2_matmul``
(body ``_kernel``) with the hand-written CUDA kernels in
``csrc/log2_matmul.cu``: the weights cross device memory packed two codes
a byte and are decoded in the kernel; x is fp32 or bf16, the output fp32.
That source's header says what bounds each path on an H100.

The bit contract.  A decoded weight is ``W = P * scale`` with ``P = ±2^(1-
|c|)`` or 0, exact in bf16.  The kernels compute ``scale * (x @ P)``: an
fp32 x is split exactly into three bf16 parts (hi + mid + lo == x for
finite |x| above 2^-102), each part multiplies P on the tensor cores with
fp32 accumulation, so every product is exact and only the sums round; a
bf16 x is one part.  The result keeps fp32 accuracy, ``I @ W`` is the
decoded W bit for bit, and TF32 is never used.

Two paths, chosen here from M, one launch each:

* tile path (M > ``DECODE_MAX_M``): 64x64 output tiles on the tensor
  cores (mma.sync bf16 -> fp32);
* decode path (M <= ``DECODE_MAX_M``, the decode shapes): bytes bound it.
  A CTA covers 16 columns and all of K: each lane sums its rows in fp32
  on the CUDA cores, and the lanes' and warps' sums are added in a fixed
  order (a shuffle butterfly, then warp order; no atomics, so the bits
  repeat from run to run).

``log2_matmul`` runs the plain version (``kernels/ref.log2_matmul_ref``)
for CPU tensors and launches a kernel for CUDA tensors.
``log2_matmul.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import log2_matmul_ref

_P, _I = _build.P, _build.I
_SIGNATURES = {"log2_matmul": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
               "log2_matmul_decode": [_P] * 4 + [_I] * 4 + [_P]}
_X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
DECODE_MAX_M = 4      # rows up to which the decode path runs
_GRID_MAX = 65535     # tile path: ceil(N/64) CTAs along grid y


def _launch(x: torch.Tensor, w_packed: torch.Tensor, scale: torch.Tensor):
    dev = x.device
    if x.dim() != 2 or w_packed.dim() != 2:
        raise ValueError("x must be (M, K) and w_packed (K, N/2)")
    M, K = x.shape
    N = w_packed.shape[1] * 2
    if w_packed.shape[0] != K or M < 1 or K < 1 or N < 2:
        raise ValueError(f"w_packed {tuple(w_packed.shape)} does not match "
                         f"x {tuple(x.shape)}")
    if x.dtype not in _X_DTYPES:
        raise ValueError(f"x: dtype {x.dtype}, expected float32 or bfloat16")
    if w_packed.dtype != torch.uint8:
        raise ValueError(f"w_packed: dtype {w_packed.dtype}, expected uint8")
    if scale.dtype != torch.float32 or scale.numel() != 1:
        raise ValueError("scale: needs one float32 value")
    for t, what in ((x, "x"), (w_packed, "w_packed"), (scale, "scale")):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{what}: needs a contiguous tensor on {dev}")
    decode = M <= DECODE_MAX_M
    if not decode and -(-N // 64) > _GRID_MAX:
        raise ValueError(f"N={N} exceeds the kernel's grid "
                         f"({_GRID_MAX} column tiles)")
    lib = _build.load("log2_matmul", _SIGNATURES)
    out = torch.empty((M, N), device=dev, dtype=torch.float32)
    entry = "log2_matmul_decode" if decode else "log2_matmul"
    with torch.cuda.device(dev):
        rc = getattr(lib, entry)(
            x.data_ptr(), w_packed.data_ptr(), scale.data_ptr(),
            out.data_ptr(), M, K, N, _X_DTYPES[x.dtype],
            torch.cuda.current_stream(dev).cuda_stream)
        _build.check(lib, "log2_matmul", entry, rc)
    log2_matmul.launches += 1
    return out


def log2_matmul(x: torch.Tensor, w_packed: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """x (M, K) fp32 or bf16, w_packed (K, N/2) uint8, scale () fp32 ->
    (M, N) fp32: the CUDA kernels for CUDA tensors, the plain version for
    CPU tensors."""
    if x.device.type == "cuda":
        return _launch(x, w_packed, scale)
    if x.device.type != "cpu":
        raise ValueError(f"log2_matmul: unsupported device {x.device}")
    return log2_matmul_ref(x, w_packed, scale)


log2_matmul.launches = 0
