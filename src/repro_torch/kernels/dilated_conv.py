"""Causal dilated conv1d (§III-B) as one kernel.

Replaces the Pallas kernel ``repro/kernels/dilated_conv.py::
dilated_causal_conv`` (body ``_kernel``) with the hand-written CUDA kernel
in ``csrc/dilated_conv.cu``: full-fp32 FMA on the CUDA cores over
dilation-strided tiles (a column of 8 positions d apart stages the K+7
rows its K taps read once), 256 positions x 24 or 32 output channels per
CTA, 8 positions x 6 or 8 channels per thread; taps before t = 0 read
zero, so the padded input is never built.  Each output sums its input channels in
order, its taps in order inside, so the conv is causal bit for bit and
repeats bit for bit.  That source's header says what bounds it on an
H100.

Layouts are the reference's: x (B, T, Cin), w (K, Cin, Cout), b (Cout,)
-> (B, T, Cout) fp32.  ``dilated_conv`` runs the plain version
(``kernels/ref.dilated_conv_ref``) for CPU tensors and launches the kernel
for CUDA tensors.  ``dilated_conv.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import dilated_conv_ref

_P, _I = _build.P, _build.I
_SIGNATURES = {"dilated_conv": [_P, _P, _P, _P] + [_I] * 6 + [_P]}
_GRID_MAX = 65535  # the kernel's grid: (ceil(T/8d)*d/32, Cout/24 or /32, B)
_MAX_K = 256       # taps whose rows fit the kernel's shared memory


def _launch(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            dilation: int):
    dev = x.device
    if x.dim() != 3 or w.dim() != 3 or b.dim() != 1:
        raise ValueError("x must be (B, T, Cin), w (K, Cin, Cout), b (Cout,)")
    B, T, Cin = x.shape
    K, _, Cout = w.shape
    if tuple(w.shape) != (K, Cin, Cout) or tuple(b.shape) != (Cout,):
        raise ValueError(f"w {tuple(w.shape)} / b {tuple(b.shape)} do not "
                         f"match x {tuple(x.shape)}")
    if min(B, T, Cin, Cout, K) < 1 or dilation < 1:
        raise ValueError(f"empty conv: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, dilation {dilation}")
    if (K + 8) * dilation + T >= 2 ** 31 or B > _GRID_MAX \
            or -(-Cout // 24) > _GRID_MAX or K > _MAX_K:
        raise ValueError("conv too large for the kernel's int32 rows, grid "
                         f"or {_MAX_K} taps")
    for t, what in ((x, "x"), (w, "w"), (b, "b")):
        if t.device != dev or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"{what}: needs contiguous float32 on {dev}")
    lib = _build.load("dilated_conv", _SIGNATURES)
    out = torch.empty((B, T, Cout), device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        rc = lib.dilated_conv(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
            B, T, Cin, Cout, K, int(dilation),
            torch.cuda.current_stream(dev).cuda_stream)
        _build.check(lib, "dilated_conv", "dilated_conv", rc)
    dilated_conv.launches += 1
    return out


def dilated_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 dilation: int) -> torch.Tensor:
    """Causal dilated conv: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if x.device.type == "cuda":
        return _launch(x, w, b, dilation)
    if x.device.type != "cpu":
        raise ValueError(f"dilated_conv: unsupported device {x.device}")
    return dilated_conv_ref(x, w, b, dilation)


dilated_conv.launches = 0
