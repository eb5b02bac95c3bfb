"""Fused TCN residual block — the streaming slot-grid hot loop.

Replaces the Pallas kernel ``repro/kernels/tcn_block.py::tcn_block_pallas``
(body ``_block_kernel``) with the hand-written CUDA kernel in
``csrc/tcn_block.cu``.  That source's header says what bounds it on an
H100 and what the design does about it; in short: ``mid`` goes through
global memory between two launches (conv1 for all T, then conv2 over
[hist2 | mid] plus the residual), one thread per output element, a fixed
summation order so that chunk-size invariance and park/resume stay
bit-exact on the card.

Layout contract (the reference's):

    strip1: (S, n+T, Cin)  time-ordered [ring1 history | chunk], n=(k-1)*d
    hist2:  (S, n, C)      time-ordered ring2 history
    p:      {"conv1_w", "conv1_b", "conv2_w", "conv2_b"[, "down_w",
             "down_b"]} — fp32 (K, Cin, C) weights or nibble-packed log2
            ``{"codes": uint8 (K, Cin, C/2), "scale": ()}``
    -> (h (S, T, C), mid (S, T, C))

``tcn_block`` runs the plain version (``kernels/ref.tcn_block_fused``) for
CPU tensors and launches the kernel for CUDA tensors; there is no other
route.  ``tcn_block.launches`` counts wrapper calls that launched (each
call is the conv1 launch plus the conv2 launch).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, dispatch
from repro_torch.kernels.ref import tcn_block_fused

_P, _I, _F = _build.P, _build.I, _build.F
_SIGNATURES = {
    "tcn_block_conv1": [_P, _P, _P, _I, _P, _P] + [_I] * 8 + [_F, _P],
    "tcn_block_conv2": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _P, _P]
                       + [_I] * 9 + [_F, _P],
}


def _check(t: torch.Tensor, shape, dtype, device, what: str) -> None:
    if t.device != device:
        raise ValueError(f"{what}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: must be contiguous")


def _weight(w, shape, device, what: str):
    """(pointer, scale pointer, packed flag) of one checked weight operand."""
    if isinstance(w, dict):
        if shape[-1] % 2:
            raise ValueError(f"{what}: packed weights need an even last axis")
        _check(w["codes"], shape[:-1] + (shape[-1] // 2,), torch.uint8,
               device, f"{what}.codes")
        _check(w["scale"].reshape(()), (), torch.float32, device,
               f"{what}.scale")
        return w["codes"].data_ptr(), w["scale"].data_ptr(), 1
    _check(w, shape, torch.float32, device, what)
    return w.data_ptr(), None, 0


def _launch(strip1, hist2, p, d: int, k: int, act_scale: float,
            quantize: bool):
    dev = strip1.device
    if strip1.dim() != 3 or hist2.dim() != 3:
        raise ValueError("strip1 and hist2 must be (S, rows, channels)")
    S, L1, Cin = strip1.shape
    n = (k - 1) * d
    T = L1 - n
    C = hist2.shape[2]
    if S < 1 or T < 1:
        raise ValueError(f"empty block input: S={S}, T={T}")
    _check(strip1, (S, L1, Cin), torch.float32, dev, "strip1")
    _check(hist2, (S, n, C), torch.float32, dev, "hist2")
    w1, w1s, w1p = _weight(p["conv1_w"], (k, Cin, C), dev, "conv1_w")
    w2, w2s, w2p = _weight(p["conv2_w"], (k, C, C), dev, "conv2_w")
    for b in ("conv1_b", "conv2_b"):
        _check(p[b], (C,), torch.float32, dev, b)
    if "down_w" in p:
        dw, dws, dwp = _weight(p["down_w"], (1, Cin, C), dev, "down_w")
        _check(p["down_b"], (C,), torch.float32, dev, "down_b")
        db = p["down_b"].data_ptr()
    else:
        if Cin != C:
            raise ValueError(f"identity residual needs Cin == C ({Cin} != {C})")
        dw, dws, dwp, db = None, None, 0, None
    lib = _build.load("tcn_block", _SIGNATURES)
    mid = torch.empty((S, T, C), device=dev, dtype=torch.float32)
    h = torch.empty((S, T, C), device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tcn_block_conv1(
            strip1.data_ptr(), w1, w1s, w1p, p["conv1_b"].data_ptr(),
            mid.data_ptr(), S, L1, T, Cin, C, k, d, int(quantize),
            float(act_scale), stream)
        _build.check(lib, "tcn_block", "tcn_block_conv1", rc)
        rc = lib.tcn_block_conv2(
            strip1.data_ptr(), hist2.data_ptr(), mid.data_ptr(), w2, w2s, w2p,
            p["conv2_b"].data_ptr(), dw, dws, dwp, db, h.data_ptr(), S, L1, n,
            T, Cin, C, k, d, int(quantize), float(act_scale), stream)
        _build.check(lib, "tcn_block", "tcn_block_conv2", rc)
    tcn_block.launches += 1
    return h, mid


def tcn_block(strip1, hist2, p, *, dilation: int, k: int,
              act_scale: float = 0.25, quantize: bool = False):
    """One fused residual block: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.  Returns (h, mid)."""
    if strip1.device.type == "cuda":
        return _launch(strip1, hist2, p, dilation, k, act_scale, quantize)
    if strip1.device.type != "cpu":
        raise ValueError(f"tcn_block: unsupported device {strip1.device}")
    return tcn_block_fused(strip1, hist2, p, dilation=dilation, k=k,
                           act_scale=act_scale, quantize=quantize)


tcn_block.launches = 0


def make_block_fn(backend: str | None, device):
    """Resolve the block backend ONCE for ops on ``device`` (raises on a
    mismatch) and return the block function."""
    dispatch.resolve(backend, device)
    return tcn_block
