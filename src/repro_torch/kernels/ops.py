"""Public op constructors of the port's kernels — the counterpart of
``repro/kernels/ops.py``.

Backend choice happens ONCE, at op construction, through
``dispatch.resolve``; the default device is the card, and without one a
constructor raises (pass ``device="cpu"`` for the plain versions):

    conv_op = make_dilated_conv_op()      # resolve once, on the card
    y = conv_op(x, w, b, dilation)        # hot loop

Each op is the kernel's wrapper itself: it launches the CUDA kernel for
CUDA tensors and runs the plain version for CPU tensors.
"""

from __future__ import annotations

from repro_torch.kernels import dispatch
from repro_torch.kernels.dilated_conv import dilated_conv
from repro_torch.kernels.log2_matmul import log2_matmul
from repro_torch.kernels.proto_extract import make_proto_extract_op

__all__ = ["make_dilated_conv_op", "make_log2_matmul_op",
           "make_proto_extract_op"]


def make_log2_matmul_op(backend: str | None = None, device="cuda"):
    """(x (M, K) fp32 or bf16, w_packed (K, N//2) u8, scale ()) -> (M, N)
    f32."""
    dispatch.resolve(backend, dispatch.require_device(device))
    return log2_matmul


def make_dilated_conv_op(backend: str | None = None, device="cuda"):
    """(x (B, T, Cin), w (K, Cin, Cout), b (Cout,), dilation) -> (B, T,
    Cout) f32."""
    dispatch.resolve(backend, dispatch.require_device(device))
    return dilated_conv
