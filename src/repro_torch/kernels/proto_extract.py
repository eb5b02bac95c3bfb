"""Fused prototypical parameter extraction (§III-A, Eq. 3+6).

Replaces the Pallas kernel ``repro/kernels/proto_extract.py::proto_extract``
(body ``_kernel``) with the hand-written CUDA kernel in
``csrc/proto_extract.cu``: W = onehot @ emb and b = -(1/2k)||W||^2 in one
pass.  Way n's columns are split over a thread-block cluster of up to 8
CTAs along V, each CTA copies its slab of shots into shared memory with
all copies in flight, sums each column in shot order (W bit for bit the
plain version's) and b goes through a fixed-order reduction (see the
source's header).

Two entries launch the same kernel:

- ``proto_extract(emb, onehot, k)`` reads the (N, Nk) fp32 dispatch
  matrix as given: the op's contract, which the reference's kernel has;
- ``proto_extract_labels(emb, labels, n_ways, k)`` reads the (Nk,) int32
  or int64 labels: a shot counts for way n where its label is n, and a
  label outside [0, n_ways) counts for no way (``jax.nn.one_hot`` gives it
  a zero column).  ``core/protonet.adapt`` calls it, so an enrollment is
  one launch after the embedder.

Each runs its plain version (``kernels/ref``) for CPU tensors and launches
the kernel for CUDA tensors.  ``proto_extract.launches`` counts the
kernel's launches from either entry; ``proto_extract_labels.launches``
those of the label entry.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, dispatch
from repro_torch.kernels.ref import proto_extract_labels_ref, proto_extract_ref

_P, _I, _F = _build.P, _build.I, _build.F
_SIGNATURES = {
    "proto_extract": [_P, _P, _P, _P, _I, _I, _I, _F, _P],
    "proto_extract_labels": [_P, _P, _I, _P, _P, _I, _I, _I, _F, _P],
}
_LABEL_BYTES = {torch.int32: 4, torch.int64: 8}
MAX_WAYS = 65535  # the grid's y dimension


def _check_emb(emb: torch.Tensor, N: int):
    if emb.dim() != 2 or emb.dtype != torch.float32 \
            or not emb.is_contiguous():
        raise ValueError("emb must be a contiguous float32 (Nk, V) tensor")
    Nk, V = emb.shape
    if not (1 <= N <= MAX_WAYS and Nk >= 1 and V >= 1):
        raise ValueError(f"proto_extract: N={N} ways (at most {MAX_WAYS}) "
                         f"over emb {tuple(emb.shape)}")
    return Nk, V


def _run(fn: str, emb: torch.Tensor, N: int, args, k: int):
    """Launch ``fn`` on the current stream of emb's device into one
    allocation of N * (V + 1) floats; returns W (N, V) and b (N,) as
    contiguous views of it.  The host side is what a call costs at these
    shapes, so it makes one allocation, enters no device context when emb
    lies on the current device, and reads the raw stream handle (as
    PyTorch's generated kernels do) instead of building a Stream object."""
    dev = emb.device
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return _run(fn, emb, N, args, k)
    Nk, V = emb.shape
    lib = _build.load("proto_extract", _SIGNATURES)
    out = torch.empty(N * (V + 1), device=dev, dtype=torch.float32)
    ptr = out.data_ptr()
    rc = getattr(lib, fn)(
        emb.data_ptr(), *args, ptr, ptr + 4 * N * V, N, Nk, V,
        1.0 / (2.0 * k), torch._C._cuda_getCurrentRawStream(dev.index))
    _build.check(lib, "proto_extract", fn, rc)
    proto_extract.launches += 1
    return out.as_strided((N, V), (V, 1)), out.as_strided((N,), (1,), N * V)


def proto_extract(emb: torch.Tensor, onehot: torch.Tensor, k: int):
    """emb (Nk, V), onehot (N, Nk) -> (W (N, V), b (N,)): the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors."""
    if emb.device.type == "cpu":
        return proto_extract_ref(emb, onehot, k)
    if emb.device.type != "cuda":
        raise ValueError(f"proto_extract: unsupported device {emb.device}")
    N = onehot.shape[0] if onehot.dim() == 2 else 0
    Nk, _ = _check_emb(emb, N)
    if tuple(onehot.shape) != (N, Nk) or onehot.device != emb.device \
            or onehot.dtype != torch.float32 or not onehot.is_contiguous():
        raise ValueError(f"onehot {tuple(onehot.shape)} {onehot.dtype} on "
                         f"{onehot.device} does not fit emb "
                         f"{tuple(emb.shape)}: needs a contiguous float32 "
                         f"(N, Nk) tensor on {emb.device}")
    return _run("proto_extract", emb, N, (onehot.data_ptr(),), k)


proto_extract.launches = 0


def proto_extract_labels(emb: torch.Tensor, labels: torch.Tensor,
                         n_ways: int, k: int):
    """emb (Nk, V), labels (Nk,) int32 or int64 -> (W (n_ways, V), b
    (n_ways,)), shot i counting for way labels[i] when it lies in [0,
    n_ways): the CUDA kernel for CUDA tensors, the plain version (the
    one-hot by comparison, then ``proto_extract_ref``) for CPU tensors."""
    if emb.device.type == "cpu":
        return proto_extract_labels_ref(emb, labels, n_ways, k)
    if emb.device.type != "cuda":
        raise ValueError(f"proto_extract: unsupported device {emb.device}")
    Nk, _ = _check_emb(emb, n_ways)
    nbytes = _LABEL_BYTES.get(labels.dtype)
    if tuple(labels.shape) != (Nk,) or nbytes is None \
            or labels.device != emb.device or not labels.is_contiguous():
        raise ValueError(f"labels {tuple(labels.shape)} {labels.dtype} on "
                         f"{labels.device} do not fit emb {tuple(emb.shape)}:"
                         f" need a contiguous int32 or int64 (Nk,) tensor on "
                         f"{emb.device}")
    w, b = _run("proto_extract_labels", emb, n_ways,
                (labels.data_ptr(), nbytes), k)
    proto_extract_labels.launches += 1
    return w, b


proto_extract_labels.launches = 0


def make_proto_extract_op(backend: str | None = None, device="cuda"):
    """Resolve the backend ONCE for ops on ``device`` (raises without a
    card when ``device`` is CUDA) and return the op: (emb (Nk, V), onehot
    (N, Nk), k) -> (W (N, V), b (N,))."""
    dispatch.resolve(backend, dispatch.require_device(device))
    return proto_extract
