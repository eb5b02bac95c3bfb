"""Fused TCN residual blocks — the streaming slot-grid hot loop.

Replaces the Pallas kernel ``repro/kernels/tcn_block.py::tcn_block_pallas``
(body ``_block_kernel``) with the hand-written CUDA kernels in
``csrc/tcn_block.cu``, whose header says what bounds each on an H100 and
what the design does about it.  Two entry points, one for each way the
main path runs the block, both summing in the fixed order of
``kernels/ref.py`` so that chunk-size invariance, park/resume and fused ==
per-step stay bit-exact on the card:

``tcn_chunk`` — the serve path (``core/streaming.make_fused_chunk``).  One
launch advances the whole TCN body of a slot grid over a chunk: one CTA per
slot walks the blocks in order, reads the history taps in place from the
rings in the reference's circular layout and writes only the chunk's new
ring rows.  Layout contract:

    blocks: {"b<i>": baked block params}   (as for ``tcn_block``)
    states: {"t": (S,) int32, "blocks": {"b<i>": {"ring1": (S, n, Cin),
            "ring2": (S, n, C)}}}         block i's dilation is n/(k-1)
    x: (S, T, Cin) fp32, lengths: (S,) int32 in [0, T]
    -> (new_states, h (S, T, C))

The kernel updates rings and t in place.  By default the wrapper first
clones them (one copy per ring: a full pass over the rings) and returns
the clones, leaving ``states`` as it was; ``inplace=True`` hands the
kernel ``states``' own rings and t and returns ``states`` — for a caller
that owns the grid (the service).  A chunk longer than the kernel's shared
memory holds raises ``ValueError`` (``max_chunk_len``); there is no
fallback.  ``make_fused_chunk`` splits a longer serve chunk into spans
that fit.

``tcn_block`` — one block over a time-ordered strip: long sequences
(``models/tcn.make_fused_forward``: FSL episodes, enrollment).  Two
launches (conv1 writes ``mid`` for all T to global memory, conv2 reads
[hist2 | mid]), each tiled 64 positions × all C per CTA, positions
strided by the dilation so that a tile's taps overlap.  Layout contract:

    strip1: (S, n+T, Cin)  time-ordered [ring1 history | chunk], n=(k-1)*d
    hist2:  (S, n, C)      time-ordered ring2 history
    p:      {"conv1_w", "conv1_b", "conv2_w", "conv2_b"[, "down_w",
             "down_b"]} — fp32 (K, Cin, C) weights or nibble-packed log2
            ``{"codes": uint8 (K, Cin, C/2), "scale": ()}``
    -> (h (S, T, C), mid (S, T, C))

Both run their plain versions (``kernels/ref.tcn_chunk_plain``,
``tcn_block_fused``) for CPU tensors and launch the kernel for CUDA
tensors; there is no other route.  The kernels take C a multiple of 4.
``tcn_chunk.launches`` counts chunk launches, ``tcn_block.launches``
strip calls that launched (each the conv1 launch plus the conv2 launch).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, dispatch
from repro_torch.kernels.ref import tcn_block_fused, tcn_chunk_plain

_P, _I, _F = _build.P, _build.I, _build.F
_SIGNATURES = {
    "tcn_block_conv1": [_P, _P, _P, _I, _P, _P] + [_I] * 8 + [_F, _P],
    "tcn_block_conv2": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _P, _P]
                       + [_I] * 9 + [_F, _P],
    "tcn_chunk": [_P, _I, _P, _P, _P, _P] + [_I] * 4 + [_F, _I, _P],
}
MAX_SMEM = 232_448  # shared memory one block may use on an H100
MAX_BLOCKS = 16     # blocks one tcn_chunk launch walks


class _BlockDesc(ctypes.Structure):
    """One block of a tcn_chunk launch (csrc/tcn_block.cu BlockDesc)."""
    _fields_ = ([(f, ctypes.c_void_p) for f in (
        "ring1", "ring2", "w1", "w1_scale", "w2", "w2_scale", "dw",
        "dw_scale", "b1", "b2", "db")]
        + [(f, ctypes.c_int) for f in (
            "n", "d", "cin", "c", "w1_packed", "w2_packed", "dw_packed",
            "pad")])


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
        if w["codes"].data_ptr() % 4:
            raise ValueError(f"{what}.codes: must be 4-byte aligned")
        _check(w["scale"].reshape(()), (), torch.float32, device,
               f"{what}.scale")
        return w["codes"].data_ptr(), w["scale"].data_ptr(), 1
    _check(w, shape, torch.float32, device, what)
    return w.data_ptr(), None, 0


def _block_params(p, cin: int, C: int, k: int, device):
    """Checked pointers of one block's params: ((w1, s, packed), (w2, s,
    packed), (dw, s, packed), b1, b2, db); dw and db are None for an
    identity residual."""
    if C % 4:
        raise ValueError(f"the tcn_block kernels need C % 4 == 0, got C={C}")
    w1 = _weight(p["conv1_w"], (k, cin, C), device, "conv1_w")
    w2 = _weight(p["conv2_w"], (k, C, C), device, "conv2_w")
    for b in ("conv1_b", "conv2_b"):
        _check(p[b], (C,), torch.float32, device, b)
    if "down_w" in p:
        dw = _weight(p["down_w"], (1, cin, C), device, "down_w")
        _check(p["down_b"], (C,), torch.float32, device, "down_b")
        db = p["down_b"].data_ptr()
    else:
        if cin != C:
            raise ValueError(f"identity residual needs Cin == C ({cin} != {C})")
        dw, db = (None, None, 0), None
    return w1, w2, dw, p["conv1_b"].data_ptr(), p["conv2_b"].data_ptr(), db


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
    w1, w2, dw, b1, b2, db = _block_params(p, Cin, C, k, dev)
    lib = _build.load("tcn_block", _SIGNATURES)
    mid = torch.empty((S, T, C), device=dev, dtype=torch.float32)
    h = torch.empty((S, T, C), device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tcn_block_conv1(
            strip1.data_ptr(), *w1, b1, mid.data_ptr(), S, L1, T, Cin, C, k,
            d, int(quantize), float(act_scale), stream)
        _build.check(lib, "tcn_block", "tcn_block_conv1", rc)
        rc = lib.tcn_block_conv2(
            strip1.data_ptr(), hist2.data_ptr(), mid.data_ptr(), *w2, b2,
            *dw, db, h.data_ptr(), S, L1, n, T, Cin, C, k, d, int(quantize),
            float(act_scale), stream)
        _build.check(lib, "tcn_block", "tcn_block_conv2", rc)
    tcn_block.launches += 1
    return h, mid


def tcn_block(strip1, hist2, p, *, dilation: int, k: int,
              act_scale: float = 0.25, quantize: bool = False):
    """One fused residual block over a strip: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors.  Returns (h, mid)."""
    if strip1.device.type == "cuda":
        return _launch(strip1, hist2, p, dilation, k, act_scale, quantize)
    if strip1.device.type != "cpu":
        raise ValueError(f"tcn_block: unsupported device {strip1.device}")
    return tcn_block_fused(strip1, hist2, p, dilation=dilation, k=k,
                           act_scale=act_scale, quantize=quantize)


tcn_block.launches = 0


def chunk_smem_bytes(widths, T: int, k: int) -> int:
    """Shared memory of one tcn_chunk CTA, as csrc/tcn_block.cu lays it out:
    the largest block's decoded weights and biases, the history rows one
    conv's taps touch ((k-1)*min(d_max, T)), and the block input, ``mid``
    and the block output (T rows each), rows padded to an odd stride.
    widths: one (n, Cin, C, has_down) per block."""
    ld = max(max(cin, c) for _, cin, c, _ in widths) | 1
    w = max(k * cin * c + k * c * c + (cin * c if down else 0) + 3 * c
            for _, cin, c, down in widths)
    m = min(max(n // (k - 1) for n, *_ in widths), T)
    return 4 * ((w + 3) // 4 * 4 + ((k - 1) * m + 3 * T) * ld)


def max_chunk_len(widths, k: int) -> int:
    """The longest chunk tcn_chunk takes for these block widths."""
    T = 0
    while chunk_smem_bytes(widths, T + 1, k) <= MAX_SMEM:
        T += 1
    return T


def _launch_chunk(blocks, states, x, lengths, k: int, act_scale: float,
                  quantize: bool, inplace: bool):
    dev = x.device
    if x.dim() != 3:
        raise ValueError("x must be (S, T, Cin)")
    S, T, cin = x.shape
    t = states["t"]
    _check(x, (S, T, cin), torch.float32, dev, "x")
    _check(t, (S,), torch.int32, dev, "t")
    _check(lengths, (S,), torch.int32, dev, "lengths")
    nb = len(states["blocks"])
    if not 1 <= nb <= MAX_BLOCKS:
        raise ValueError(f"tcn_chunk walks 1..{MAX_BLOCKS} blocks, got {nb}")
    if k < 2:
        raise ValueError(f"tcn_chunk needs k >= 2, got {k}")
    if not inplace:  # the kernel works in place on copies
        states = {"t": t.clone(), "blocks": {
            name: {r: v.clone() for r, v in rings.items()}
            for name, rings in states["blocks"].items()}}
        t = states["t"]
    descs = (_BlockDesc * nb)()
    widths = []
    for i in range(nb):
        name = f"b{i}"
        r1, r2 = (states["blocks"][name][r] for r in ("ring1", "ring2"))
        if r1.dim() != 3 or r2.dim() != 3:
            raise ValueError(f"{name}: rings must be (S, n, channels)")
        n, C = r1.shape[1], r2.shape[2]
        if n < 1 or n % (k - 1):
            raise ValueError(f"{name}: ring depth {n} is not (k-1)*d")
        _check(r1, (S, n, cin), torch.float32, dev, f"{name}.ring1")
        _check(r2, (S, n, C), torch.float32, dev, f"{name}.ring2")
        p = blocks[name]
        w1, w2, dw, b1, b2, db = _block_params(p, cin, C, k, dev)
        descs[i] = _BlockDesc(
            r1.data_ptr(), r2.data_ptr(), w1[0], w1[1], w2[0], w2[1], dw[0],
            dw[1], b1, b2, db, n, n // (k - 1), cin, C, w1[2], w2[2], dw[2], 0)
        widths.append((n, cin, C, "down_w" in p))
        cin = C
    smem = chunk_smem_bytes(widths, T, k)
    if smem > MAX_SMEM:
        raise ValueError(
            f"tcn_chunk: a chunk of T={T} needs {smem} bytes of shared memory "
            f"per CTA, above the card's {MAX_SMEM}; these widths take T <= "
            f"{max_chunk_len(widths, k)}")
    h = torch.empty((S, T, cin), device=dev, dtype=torch.float32)
    lib = _build.load("tcn_block", _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tcn_chunk(
            ctypes.addressof(descs), nb, t.data_ptr(), x.data_ptr(),
            lengths.data_ptr(), h.data_ptr(), S, T, k, int(quantize),
            float(act_scale), smem, stream)
        _build.check(lib, "tcn_block", "tcn_chunk", rc)
    tcn_chunk.launches += 1
    return states, h


def tcn_chunk(blocks, states, x, lengths, *, k: int, act_scale: float = 0.25,
              quantize: bool = False, inplace: bool = False):
    """The whole TCN body of a slot grid over one chunk: one kernel launch
    for CUDA tensors, the plain version for CPU tensors.  Returns
    (new_states, h); ``inplace`` updates ``states``' rings and t."""
    if x.device.type == "cuda":
        return _launch_chunk(blocks, states, x, lengths, k, act_scale,
                             quantize, inplace)
    if x.device.type != "cpu":
        raise ValueError(f"tcn_chunk: unsupported device {x.device}")
    return tcn_chunk_plain(blocks, states, x, lengths, k=k,
                           act_scale=act_scale, quantize=quantize,
                           inplace=inplace)


tcn_chunk.launches = 0


def make_block_fn(backend: str | None, device):
    """Resolve the block backend ONCE for ops on ``device`` (raises on a
    mismatch) and return the strip entry."""
    dispatch.resolve(backend, device)
    return tcn_block


def make_chunk_fn(backend: str | None, device):
    """As ``make_block_fn``, for the chunk entry."""
    dispatch.resolve(backend, device)
    return tcn_chunk
