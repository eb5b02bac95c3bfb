"""Fused prototypical parameter extraction (§III-A, Eq. 3+6).

Replaces the Pallas kernel ``repro/kernels/proto_extract.py::proto_extract``
(body ``_kernel``) with the hand-written CUDA kernel in
``csrc/proto_extract.cu``: W = onehot @ emb and b = -(1/2k)||W||^2 in one
pass, one block per way, threads over V, the one-hot matrix read as given.
At the main path's shapes (N=5 ways, up to 25 shots, V=64) it is bound by
launch latency, not by bytes or flops (see the source's header).

``proto_extract`` runs the plain version (``kernels/ref.proto_extract_ref``)
for CPU tensors and launches the kernel for CUDA tensors.
``proto_extract.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, dispatch
from repro_torch.kernels.ref import proto_extract_ref

_P, _I, _F = _build.P, _build.I, _build.F
_SIGNATURES = {"proto_extract": [_P, _P, _P, _P, _I, _I, _I, _F, _I, _P]}


def _launch(emb: torch.Tensor, onehot: torch.Tensor, k: int):
    dev = emb.device
    if emb.dim() != 2 or onehot.dim() != 2:
        raise ValueError("emb must be (Nk, V) and onehot (N, Nk)")
    Nk, V = emb.shape
    N = onehot.shape[0]
    if tuple(onehot.shape) != (N, Nk) or N < 1 or Nk < 1 or V < 1:
        raise ValueError(f"onehot {tuple(onehot.shape)} does not match "
                         f"emb {tuple(emb.shape)}")
    for t, what in ((emb, "emb"), (onehot, "onehot")):
        if t.device != dev or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"{what}: needs contiguous float32 on {dev}")
    threads = 32
    while threads < min(V, 1024):
        threads *= 2
    lib = _build.load("proto_extract", _SIGNATURES)
    w = torch.empty((N, V), device=dev, dtype=torch.float32)
    b = torch.empty((N,), device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        rc = lib.proto_extract(
            emb.data_ptr(), onehot.data_ptr(), w.data_ptr(), b.data_ptr(),
            N, Nk, V, 1.0 / (2.0 * k), threads,
            torch.cuda.current_stream(dev).cuda_stream)
        _build.check(lib, "proto_extract", "proto_extract", rc)
    proto_extract.launches += 1
    return w, b


def proto_extract(emb: torch.Tensor, onehot: torch.Tensor, k: int):
    """emb (Nk, V), onehot (N, Nk) -> (W (N, V), b (N,)): the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors."""
    if emb.device.type == "cuda":
        return _launch(emb, onehot, k)
    if emb.device.type != "cpu":
        raise ValueError(f"proto_extract: unsupported device {emb.device}")
    return proto_extract_ref(emb, onehot, k)


proto_extract.launches = 0


def make_proto_extract_op(backend: str | None = None, device="cuda"):
    """Resolve the backend ONCE for ops on ``device`` (raises without a
    card when ``device`` is CUDA) and return the op: (emb (Nk, V), onehot
    (N, Nk), k) -> (W (N, V), b (N,))."""
    dispatch.resolve(backend, dispatch.require_device(device))
    return proto_extract
