#!/usr/bin/env python3
"""Build the PyTorch/CUDA port's kernels and drive its main path on one
NVIDIA GPU, checking every result.

    python3 chip_smoke.py

Phases, each raising on failure (nothing is caught; any failure exits
non-zero):

  kernels  each kernel against its plain PyTorch version on the card at
           every main-path shape (TF32 off): tcn_block's strip entry per
           block, and its chunk entry (tcn_chunk, every block in one
           launch) over a 64-slot grid whose step counters sit just before,
           at and after every ring's wrap, ragged lengths from 0 to T,
           functional and in place, bit for bit (h, rings, t);
  serve    StreamSessionService(fused=True) at the full chameleon-tcn width:
           64 sessions, 8 tenants, ragged 784-sample streams, 5-way 5-shot
           enrollment, poll (one tcn_chunk launch per tick and no plain ring
           bookkeeping, counted); then chunk-size invariance (t_chunk 16 vs
           1) and park/resume, bit-exact, for fp32 and quantized services;
           then one 784-sample tick (t_chunk=784, split into
           ceil(784/max_chunk_len) tcn_chunk launches) bit for bit equal to
           t_chunk=16;
  fsl      5-way 1-shot and 5-shot episodes through protonet.adapt;
  ops      log2_matmul (both paths: tensor-core tiles, and the decode path
           for M <= 4) and dilated_conv (repro_torch.kernels.ops) against
           their plain versions at every listed shape (TF32 off), the
           identity decode and the conv's causality bit for bit, their
           times beside torch.matmul / F.conv1d, then the ops entry point
           driven as a user calls it (kernel_bench's matmul workloads and a
           decode-shaped one, the chameleon-tcn-audio forward with every
           conv through the op);
  audio    chameleon-tcn-audio (12 blocks, d up to 2048): tcn_block at its
           serve and enrollment shapes, 64 sessions streaming 1 s clips
           16 samples per tick (every ring wraps) with 5-way 5-shot
           enrollment, chunk-size invariance (t_chunk 16 vs 160 over
           another ragged schedule) and park/resume bit-exact for fp32 and
           quantized services, a 5-shot episode through protonet.adapt,
           cone_eval against the dense forward, the Fig. 8(c) accounting,
           the push tick's latency and profile, and one 784-sample tick
           (ceil(784/max_chunk_len) launches) equal to t_chunk=16.

    python3 chip_smoke.py --compare-with DIR

also builds the log2_matmul.cu and dilated_conv.cu of another tree's
csrc/ directory DIR (e.g. a parent commit unpacked with git archive) and
times those kernels beside this tree's at every op shape, in the same
process on the same card.

Launch counters are zeroed just before each main-path drive and read just
after.  Each phase prints its wall seconds.  Timings are medians of
CUDA-event timed, warmed runs; a kernel's ``ms`` and its library call's
``library_ms`` are device time per call, from 20 calls captured in a
CUDA graph and replayed (no host work between the kernels), while
``wrapper_ms`` and ``plain_ms`` time one Python call each.  A push
tick's breakdown comes from torch.profiler.  The second-to-last line is
the kernels JSON, the last the device JSON.  Exits with code 2 and prints
no result when no CUDA device is present.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# published peaks of one H100 SXM (NVIDIA data sheet): fp32 outside the
# tensor cores, bf16 on the tensor cores (dense), and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_TC_FLOPS = 989e12
PEAK_BYTES = 3.35e12
PEAK_NAMES = {PEAK_FP32_FLOPS: "fp32 CUDA cores 67 TFLOP/s",
              PEAK_BF16_TC_FLOPS: "bf16 tensor cores 989 TFLOP/s"}

RTOL, ATOL = 1e-5, 1e-6
QUANT_STEP = 0.25  # one u4 step at the fixed activation scale
N_SLOTS, T_CHUNK, N_TENANTS, STREAM_LEN = 64, 16, 8, 784
# chunk lengths the service gives tcn_chunk: t_chunk 16 or 160 and the
# power-of-two buckets of ragged remainders
CHUNK_TS = (1, 2, 4, 8, 16, 160)
N_WAYS, K_SHOTS = 5, 5


def log(*a) -> None:
    print(*a, flush=True)


def bound(nbytes: float, flops: float,
          peak: float = PEAK_FP32_FLOPS) -> tuple[float, str]:
    """Least time (ms) for the work, and what bounds it: the bytes at the
    HBM rate or the operations at ``peak`` (the units that run them)."""
    tb, tf = nbytes / PEAK_BYTES * 1e3, flops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_ms(fn, dev, n: int = 20, warmup: int = 3) -> float:
    """Median wall time of ``fn`` in ms: CUDA events on the card."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        if dev.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_ms(fn, dev, n: int = 20, reps: int = 5) -> float:
    """Device time (ms) per call of ``fn``, which launches kernels and does
    no host sync: ``n`` calls captured in one CUDA graph, the graph replayed
    between CUDA events (no host work between its kernels), the median of
    ``reps`` replays over ``n``."""
    import torch

    if dev.type != "cuda":
        return float("nan")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    del graph
    return statistics.median(times)


# ---------------------------------------------------------------------------
# shapes and inputs
# ---------------------------------------------------------------------------

def block_shapes(cfg):
    """(block, dilation, Cin, C, has_down) along the main path."""
    out, c_in = [], cfg.tcn_in_channels
    for i, c in enumerate(cfg.tcn_channels):
        out.append((i, 2 ** i, c_in, c, c_in != c))
        c_in = c
    return out


def block_inputs(g, S, T, d, Cin, C, k, has_down, packed, dev):
    """Random strips and one block's weights (fp32 or packed log2), drawn on
    the device from the torch.Generator ``g``."""
    import torch
    from repro_torch.models.tcn import _bake_weight

    n = (k - 1) * d
    t = lambda *shape: torch.randn(shape, generator=g, device=dev)
    strip1 = t(S, n + T, Cin)
    hist2 = t(S, n, C)
    p = {"conv1_w": t(k, Cin, C) * (Cin * k) ** -0.5,
         "conv1_b": t(C) * 0.1,
         "conv2_w": t(k, C, C) * (C * k) ** -0.5,
         "conv2_b": t(C) * 0.1}
    if has_down:
        p["down_w"] = t(1, Cin, C) * Cin ** -0.5
        p["down_b"] = t(C) * 0.1
    if packed:
        for w in ("conv1_w", "conv2_w", "down_w"):
            if w in p:
                p[w] = _bake_weight(p[w], True)[1]
    return strip1, hist2, p


def block_work(S, T, d, Cin, C, k, has_down, packed):
    """(bytes, flops) one block call must move and do."""
    n = (k - 1) * d
    wbytes = 0.5 if packed else 4.0
    w_elems = k * Cin * C + k * C * C + (Cin * C if has_down else 0)
    nbytes = (S * (n + T) * Cin + S * n * C + 2 * S * T * C) * 4 \
        + w_elems * wbytes + (3 if has_down else 2) * C * 4
    flops = S * T * (2 * k * Cin * C + 2 * k * C * C
                     + (2 * Cin * C if has_down else 0))
    return nbytes, flops


def chunk_inputs(g, cfg, S, T, packed, dev, full=False):
    """A slot grid at ``cfg``'s widths with random rings, step counters just
    before, at and after every ring's wrap (and 0), one chunk, ragged
    lengths in [0, T] with 0 and T among them (all T when ``full``), and
    random block weights (fp32 or packed log2)."""
    import torch

    k = cfg.tcn_kernel
    blocks, rings, times = {}, {}, [0]
    for (i, d, Cin, C, has_down) in block_shapes(cfg):
        n = (k - 1) * d
        blocks[f"b{i}"] = block_inputs(g, 1, 1, d, Cin, C, k, has_down,
                                       packed, dev)[2]
        rings[f"b{i}"] = {
            "ring1": torch.randn((S, n, Cin), generator=g, device=dev),
            "ring2": torch.randn((S, n, C), generator=g, device=dev)}
        times += [n - 1, n, n + 1]
    t = torch.tensor([times[i % len(times)] for i in range(S)],
                     dtype=torch.int32, device=dev)
    if full:
        lengths = torch.full((S,), T, dtype=torch.int32, device=dev)
    else:
        lengths = torch.randint(0, T + 1, (S,), generator=g, device=dev,
                                dtype=torch.int32)
        lengths[0], lengths[1] = 0, T
    x = torch.randn((S, T, cfg.tcn_in_channels), generator=g, device=dev)
    return blocks, {"t": t, "blocks": rings}, x, lengths


def chunk_work(cfg, S, T, packed):
    """(bytes, flops) one in-place tcn_chunk call must move and do: the
    weights, x in and h out, t and the lengths, and per conv of every slot
    the (k-1)*min(d, T) history rows its taps read and the min(T, n) ring
    rows it writes."""
    k = cfg.tcn_kernel
    wbytes = 0.5 if packed else 4.0
    nbytes = S * T * (cfg.tcn_in_channels + cfg.tcn_channels[-1]) * 4 \
        + 3 * S * 4
    flops = 0
    for (_, d, Cin, C, has_down) in block_shapes(cfg):
        n = (k - 1) * d
        w_elems = k * Cin * C + k * C * C + (Cin * C if has_down else 0)
        nbytes += w_elems * wbytes + (3 if has_down else 2) * C * 4
        nbytes += S * ((k - 1) * min(d, T) + min(T, n)) * (Cin + C) * 4
        flops += S * T * (2 * k * Cin * C + 2 * k * C * C
                          + (2 * Cin * C if has_down else 0))
    return nbytes, flops


def same_grid(a, b) -> bool:
    import torch

    return torch.equal(a["t"], b["t"]) and all(
        torch.equal(a["blocks"][n][r], b["blocks"][n][r])
        for n in a["blocks"] for r in ("ring1", "ring2"))


def clone_grid(g):
    return {"t": g["t"].clone(), "blocks": {
        n: {r: v.clone() for r, v in d.items()} for n, d in g["blocks"].items()}}


class counting:
    """Within the block, count calls of the named functions of ``module``
    (looked up through the module, as their callers do)."""

    def __init__(self, module, names):
        self.module, self.names = module, names
        self.calls = dict.fromkeys(names, 0)

    def __enter__(self):
        self.saved = {n: getattr(self.module, n) for n in self.names}
        for n, fn in self.saved.items():
            def wrapped(*a, _n=n, _fn=fn, **kw):
                self.calls[_n] += 1
                return _fn(*a, **kw)
            setattr(self.module, n, wrapped)
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.module, n, fn)


def allclose(name, got, want, rtol, atol) -> float:
    """Raise unless |got-want| <= atol + rtol*|want| everywhere; returns
    the max abs error."""
    import torch

    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    err = (got.float() - want.float()).abs()
    if not (err <= atol + rtol * want.abs()).all():
        raise AssertionError(f"{name}: max abs err {err.max().item():.3g}")
    return err.max().item()


def compare(name, got, want, quantized: bool) -> float:
    """Raise unless ``got`` matches ``want``; returns the max abs error.
    fp32: |got-want| <= ATOL + RTOL*|want|.  Quantized: >= 99.9% of the
    elements bit-equal and the rest within one u4 step."""
    import torch

    if not quantized:
        return allclose(name, got, want, RTOL, ATOL)
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    err = (got - want).abs()
    eq = (got == want).float().mean().item()
    if eq < 0.999 or err.max().item() > QUANT_STEP * (1 + 1e-6):
        raise AssertionError(f"{name}: {eq:.5f} bit-equal, max err "
                             f"{err.max().item():.3g}")
    return err.max().item()


# ---------------------------------------------------------------------------
# phase: kernels
# ---------------------------------------------------------------------------

def phase_kernels(cfg, dev, seed: int = 0, embed_t: int = STREAM_LEN,
                  ts=(1, 2, 4, 8, T_CHUNK, STREAM_LEN)):
    """Every shape the main path gives a kernel: serve ticks of T_CHUNK and
    the power-of-two buckets of ragged remainders (S=64), the enrollment
    embeds of one way's shots (S=5) and a 5-shot episode (S=25), whose
    clips are ``embed_t`` long."""
    import numpy as np
    import torch
    from repro_torch.kernels.proto_extract import proto_extract
    from repro_torch.kernels.ref import proto_extract_ref, tcn_block_fused
    from repro_torch.kernels.tcn_block import tcn_block

    rng = np.random.default_rng(seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    k, errs = cfg.tcn_kernel, {"tcn_block": 0.0, "proto_extract": 0.0}
    n_cases = 0
    for (i, d, Cin, C, has_down) in block_shapes(cfg):
        for (S, T) in [(s, t) for t in ts for s in (
                (K_SHOTS, N_WAYS * K_SHOTS) if t == embed_t
                else (N_SLOTS,))]:
            for packed in (False, True):
                for quantize in (False, True):
                    strip1, hist2, p = block_inputs(
                        g, S, T, d, Cin, C, k, has_down, packed, dev)
                    h, mid = tcn_block(strip1, hist2, p, dilation=d, k=k,
                                       act_scale=cfg.act_scale,
                                       quantize=quantize)
                    hr, mr = tcn_block_fused(strip1, hist2, p, dilation=d,
                                             k=k, act_scale=cfg.act_scale,
                                             quantize=quantize)
                    sync(dev)
                    tag = (f"tcn_block b{i} d={d} S={S} T={T} packed={packed}"
                           f" quantize={quantize}")
                    errs["tcn_block"] = max(
                        errs["tcn_block"],
                        compare(tag + " h", h, hr, quantize),
                        compare(tag + " mid", mid, mr, quantize))
                    n_cases += 1
    from repro_torch.kernels.ref import tcn_chunk_plain
    from repro_torch.kernels.tcn_block import tcn_chunk

    for T in CHUNK_TS:
        for packed in (False, True):
            for quantize in (False, True):
                blocks, grid, x, lengths = chunk_inputs(g, cfg, N_SLOTS, T,
                                                        packed, dev)
                kw = dict(k=k, act_scale=cfg.act_scale, quantize=quantize)
                want, hr = tcn_chunk_plain(blocks, grid, x, lengths, **kw)
                before = clone_grid(grid)
                got, h = tcn_chunk(blocks, grid, x, lengths, **kw)
                sync(dev)
                tag = (f"tcn_chunk S={N_SLOTS} T={T} packed={packed} "
                       f"quantize={quantize}")
                if not same_grid(grid, before):
                    raise AssertionError(f"{tag}: the functional call changed "
                                         "its input grid")
                if not (torch.equal(h, hr) and same_grid(got, want)):
                    raise AssertionError(f"{tag}: differs from the plain "
                                         "version")
                out, h2 = tcn_chunk(blocks, grid, x, lengths, inplace=True,
                                    **kw)
                sync(dev)
                if not (out is grid and torch.equal(h2, hr)
                        and same_grid(grid, want)):
                    raise AssertionError(f"{tag} in place: differs from the "
                                         "plain version")
                n_cases += 2
    V = cfg.embed_dim
    for (N, shots) in ((N_WAYS, [1] * N_WAYS), (N_WAYS, [K_SHOTS] * N_WAYS),
                       (37, [1 + (j % 4) for j in range(37)])):
        labels = np.repeat(np.arange(N), shots)
        emb = torch.from_numpy(
            rng.normal(size=(len(labels), V)).astype("float32")).to(dev)
        onehot = torch.from_numpy(
            (labels[None, :] == np.arange(N)[:, None]).astype("float32")).to(dev)
        kk = max(shots)
        w, b = proto_extract(emb, onehot, kk)
        wr, br = proto_extract_ref(emb, onehot, kk)
        sync(dev)
        tag = f"proto_extract N={N} Nk={len(labels)}"
        errs["proto_extract"] = max(errs["proto_extract"],
                                    compare(tag + " W", w, wr, False),
                                    compare(tag + " b", b, br, False))
        n_cases += 1
    log(f"kernels {cfg.name}: {n_cases} cases agree with the plain versions "
        f"(tcn_chunk bit for bit at T in {CHUNK_TS}, functional and in place);"
        f" max abs err tcn_block={errs['tcn_block']:.3g} "
        f"proto_extract={errs['proto_extract']:.3g}")
    return errs


def phase_timings(cfg, dev, seed: int = 1, embed_t: int = STREAM_LEN):
    """Per-shape kernel / plain / library times at the main-path shapes:
    the serve tick (S=64, T=16) through tcn_chunk (in place, as the service
    calls it, and functional), the strip entry per block at the serve
    tick's and a 5-shot episode's embed shapes (S=25, T=``embed_t``), and
    one proto_extract.  The tcn_block JSON entry gets the chunk's numbers:
    the serve path's launch."""
    import numpy as np
    import torch
    from repro_torch.kernels.proto_extract import proto_extract
    from repro_torch.kernels.ref import proto_extract_ref, tcn_block_fused
    from repro_torch.kernels.tcn_block import tcn_block

    rng = np.random.default_rng(seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    k = cfg.tcn_kernel
    tick = {"ms": 0.0, "wrapper_ms": 0.0, "plain_ms": 0.0, "bytes": 0.0,
            "flops": 0.0}
    for (i, d, Cin, C, has_down) in block_shapes(cfg):
        for (S, T) in ((N_SLOTS, T_CHUNK), (N_WAYS * K_SHOTS, embed_t)):
            strip1, hist2, p = block_inputs(g, S, T, d, Cin, C, k,
                                            has_down, False, dev)
            call = lambda: tcn_block(strip1, hist2, p, dilation=d, k=k)
            wrapper = time_ms(call, dev)
            ms = device_ms(call, dev)
            plain = time_ms(lambda: tcn_block_fused(
                strip1, hist2, p, dilation=d, k=k), dev)
            nb, fl = block_work(S, T, d, Cin, C, k, has_down, False)
            bms, by = bound(nb, fl)
            log(f"timing tcn_block {cfg.name} b{i} d={d} Cin={Cin} S={S} "
                f"T={T} fp32: "
                f"ms={ms:.4f} wrapper_ms={wrapper:.4f} "
                f"plain_ms={plain:.4f} bound_ms={bms:.6f} "
                f"bound_by={by} library_ms=null")
            if T == T_CHUNK:
                tick["ms"] += ms
                tick["wrapper_ms"] += wrapper
                tick["plain_ms"] += plain
                tick["bytes"] += nb
                tick["flops"] += fl
    tb_bound, tb_by = bound(tick["bytes"], tick["flops"])
    log(f"timing tcn_block {cfg.name} serve tick through the strip entry "
        f"({len(cfg.tcn_channels)} blocks, S={N_SLOTS}, T={T_CHUNK}): "
        f"ms={tick['ms']:.4f} wrapper_ms={tick['wrapper_ms']:.4f} "
        f"plain_ms={tick['plain_ms']:.4f} bound_ms={tb_bound:.6f} "
        f"bound_by={tb_by}")
    from repro_torch.kernels.ref import tcn_chunk_plain
    from repro_torch.kernels.tcn_block import tcn_chunk

    blocks, grid, x, lengths = chunk_inputs(g, cfg, N_SLOTS, T_CHUNK, False,
                                            dev, full=True)
    call = lambda: tcn_chunk(blocks, grid, x, lengths, k=k, inplace=True)
    functional = lambda: tcn_chunk(blocks, grid, x, lengths, k=k)
    ch = {"ms": device_ms(call, dev), "wrapper_ms": time_ms(call, dev),
          "plain_ms": time_ms(lambda: tcn_chunk_plain(blocks, grid, x,
                                                      lengths, k=k), dev),
          "library_ms": None}
    functional_ms = device_ms(functional, dev)
    nb, fl = chunk_work(cfg, N_SLOTS, T_CHUNK, False)
    ch["bound_ms"], ch["bound_by"] = bound(nb, fl)
    per_t = []
    for T in CHUNK_TS:
        b_, g_, x_, l_ = chunk_inputs(g, cfg, N_SLOTS, T, False, dev, full=True)
        ms_t = device_ms(lambda: tcn_chunk(b_, g_, x_, l_, k=k, inplace=True),
                         dev)
        per_t.append(f"T={T}:{ms_t:.4f}/{bound(*chunk_work(cfg, N_SLOTS, T, False))[0]:.6f}")
    log(f"timing tcn_chunk {cfg.name} S={N_SLOTS} in place, device ms/bound "
        f"ms per chunk length: {' '.join(per_t)}")
    log(f"timing tcn_chunk {cfg.name} serve tick ({len(cfg.tcn_channels)} "
        f"blocks in one launch, S={N_SLOTS}, T={T_CHUNK}, in place): "
        f"ms={ch['ms']:.4f} wrapper_ms={ch['wrapper_ms']:.4f} "
        f"plain_ms={ch['plain_ms']:.4f} bound_ms={ch['bound_ms']:.6f} "
        f"bound_by={ch['bound_by']} (bytes={nb:.0f} flops={fl:.0f}; "
        f"fixed-order fp32 ceiling {fl / (PEAK_FP32_FLOPS / 2) * 1e3:.6f} "
        f"ms); functional call ms={functional_ms:.4f}")
    V = cfg.embed_dim
    labels = np.repeat(np.arange(N_WAYS), K_SHOTS)
    emb = torch.from_numpy(
        rng.normal(size=(len(labels), V)).astype("float32")).to(dev)
    onehot = torch.from_numpy(
        (labels[None, :] == np.arange(N_WAYS)[:, None]).astype("float32")).to(dev)
    call = lambda: proto_extract(emb, onehot, K_SHOTS)
    pe = {
        "ms": device_ms(call, dev),
        "wrapper_ms": time_ms(call, dev),
        "plain_ms": time_ms(lambda: proto_extract_ref(emb, onehot, K_SHOTS),
                            dev),
    }

    def library():  # one PyTorch call per output; never used by the port
        w = torch.matmul(onehot, emb)
        return w, -(w * w).sum(-1) * (1.0 / (2.0 * K_SHOTS))

    pe["library_ms"] = device_ms(library, dev)
    nb = (emb.numel() + onehot.numel() + N_WAYS * V + N_WAYS) * 4
    fl = 2 * N_WAYS * len(labels) * V + 2 * N_WAYS * V
    pe["bound_ms"], pe["bound_by"] = bound(nb, fl)
    log(f"timing proto_extract N={N_WAYS} Nk={len(labels)} V={V}: "
        f"ms={pe['ms']:.4f} wrapper_ms={pe['wrapper_ms']:.4f} "
        f"plain_ms={pe['plain_ms']:.4f} "
        f"library_ms={pe['library_ms']:.4f} bound_ms={pe['bound_ms']:.8f} "
        f"bound_by={pe['bound_by']}")
    return ch, pe


# ---------------------------------------------------------------------------
# phase: serve
# ---------------------------------------------------------------------------

def make_model(cfg, dev, seed: int = 0):
    """Bundle, random params (the FC head too, which the model's init
    zeroes) and a non-trivial BN state, from a seed."""
    import torch
    from repro_torch.models import build_tcn_bundle
    from repro_torch.models.tcn import tcn_empty_state

    bundle = build_tcn_bundle(cfg, dev)
    g = torch.Generator().manual_seed(seed)
    params = bundle.init(g)
    fc = params["fc"]
    fc["w"] = (torch.randn(fc["w"].shape, generator=g)
               * cfg.embed_dim ** -0.5).to(dev)
    fc["b"] = (0.1 * torch.randn(fc["b"].shape, generator=g)).to(dev)
    bn = tcn_empty_state(cfg, dev)
    for st in bn.values():
        for key, v in st.items():
            noise = torch.rand(v.shape, generator=g).to(dev)
            st[key] = v + 0.1 * noise if key.endswith("var") else 0.1 * noise
    return bundle, params, bn


def make_schedule(rng, n_sessions: int, length: int, max_chunk: int = 48,
                  min_chunk: int = 1):
    """Ragged push rounds: per round, each unfinished session gets a chunk
    of min_chunk..max_chunk samples, until every stream has ``length``."""
    pos = [0] * n_sessions
    rounds = []
    while min(pos) < length:
        r = {}
        for s in range(n_sessions):
            if pos[s] < length:
                n = int(min(rng.integers(min_chunk, max_chunk + 1),
                             length - pos[s]))
                r[s] = (pos[s], pos[s] + n)
                pos[s] += n
        rounds.append(r)
    return rounds


def drive(svc, audio, schedule, shots, *, park_every: int = 0,
          enroll_round: int = 1):
    """open 64 sessions over 8 tenants, stream the schedule, enroll 5-way
    5-shot on tenant 0 before round ``enroll_round``, poll; returns every
    session's outputs.
    ``park_every`` > 0 parks a rotating fifth of the sessions every that
    many rounds and fills the freed slots with short-lived sessions, so
    parked sessions resume through evictions, in other slots."""
    import numpy as np

    sids = [svc.open_session(tenant=s % N_TENANTS)
            for s in range(audio.shape[0])]
    outs = {s: [] for s in range(audio.shape[0])}
    fillers = []
    for r, rnd in enumerate(schedule):
        if r == enroll_round:
            for way in range(N_WAYS):
                svc.enroll_shots(sids[0], shots[way])
        if park_every and r % park_every == park_every - 1:
            parked = [s for s in range(len(sids)) if s % 5 == r % 5]
            for s in parked:
                svc.park(sids[s])
            for _ in parked:
                f = svc.open_session()
                svc.push_audio({f: audio[0, :3]})
                fillers.append(f)
        res = svc.push_audio({sids[s]: audio[s, a:b]
                              for s, (a, b) in rnd.items()})
        for s in rnd:
            o = res[sids[s]]
            outs[s].append((o["emb"], o["logits"], o["tenant_logits"]))
    polls = [svc.poll(sid) for sid in sids]
    for f in fillers:
        svc.close(f)
    cat = {}
    for s, seq in outs.items():
        tl = [x[2] for x in seq if x[2] is not None]
        cat[s] = (np.concatenate([x[0] for x in seq]),
                  np.concatenate([x[1] for x in seq]),
                  np.concatenate(tl) if tl else None)
    return cat, polls


def same_outputs(a: dict, b: dict) -> bool:
    import numpy as np

    for s in a:
        for x, y in zip(a[s], b[s]):
            if (x is None) != (y is None):
                return False
            if x is not None and not np.array_equal(x, y):
                return False
    return True


# the plain ring bookkeeping and block of the chunk's plain version: a CUDA
# grid must never reach them
PLAIN_CHUNK = ("ordered_history", "ring_advance", "tcn_block_fused")


def check_drive_launches(name, svc, cfg, plain_calls) -> tuple[int, int]:
    """After a drive: one tcn_chunk launch per tick, the strip entry only
    for the N_WAYS enrollment embeds (one call per block each), and no
    call of the plain chunk path.  Returns (chunk, strip) launches."""
    from repro_torch.kernels.tcn_block import tcn_block, tcn_chunk

    chunk, strip = tcn_chunk.launches, tcn_block.launches
    if chunk != svc.dispatches:
        raise AssertionError(f"{name}: {chunk} tcn_chunk launches in "
                             f"{svc.dispatches} ticks")
    if strip != N_WAYS * len(cfg.tcn_channels):
        raise AssertionError(f"{name}: {strip} strip launches, expected "
                             f"{N_WAYS} enrollment embeds")
    if any(plain_calls.values()):
        raise AssertionError(f"{name}: the plain chunk path ran {plain_calls}")
    return chunk, strip


def time_tick(name, svc, x, dev) -> float:
    """One push_audio tick: exactly one tcn_chunk launch and no strip
    launch; then its end-to-end latency and, on the card, its profile."""
    from repro_torch.kernels.tcn_block import tcn_block, tcn_chunk

    tcn_block.launches = tcn_chunk.launches = 0
    svc.push_audio(x)
    if (tcn_chunk.launches, tcn_block.launches) != (1, 0):
        raise AssertionError(f"{name}: a tick launched tcn_chunk "
                             f"{tcn_chunk.launches} and the strip entry "
                             f"{tcn_block.launches} times")
    ms = time_ms(lambda: svc.push_audio(x), dev)
    log(f"timing {name} tick ({len(x)}x{T_CHUNK} samples, end to end, one "
        f"tcn_chunk launch): ms={ms:.4f}")
    if dev.type == "cuda":
        profile_tick(lambda: svc.push_audio(x))
    return ms


def check_long_tick(name, service, audio, cfg) -> int:
    """One push of STREAM_LEN samples to every session of a
    t_chunk=STREAM_LEN service: one tick, split by the fused chunk into
    ceil(STREAM_LEN / max_chunk_len) tcn_chunk launches, counted, and bit
    for bit equal (outputs and slot grid) to the same push through a
    t_chunk=T_CHUNK service.  Returns the long tick's launches."""
    import numpy as np
    from repro_torch.core.streaming import ring_sizes
    from repro_torch.kernels.tcn_block import max_chunk_len, tcn_block, tcn_chunk

    limit = max_chunk_len([(rs["ring1"][0], rs["ring1"][1], rs["ring2"][1],
                            rs["ring1"][1] != rs["ring2"][1])
                           for rs in ring_sizes(cfg).values()], cfg.tcn_kernel)
    runs = []
    for t_chunk in (STREAM_LEN, T_CHUNK):
        svc = service(False, t_chunk)
        sids = [svc.open_session() for _ in range(audio.shape[0])]
        x = {sid: audio[i, :STREAM_LEN] for i, sid in enumerate(sids)}
        tcn_block.launches = tcn_chunk.launches = 0
        res = svc.push_audio(x)
        runs.append(([res[sid] for sid in sids], svc.states, svc.dispatches,
                     tcn_chunk.launches, tcn_block.launches))
    (long, lgrid, lticks, llaunch, lstrip), (short, sgrid, sticks, slaunch, _) \
        = runs
    want = -(-STREAM_LEN // limit)
    if (lticks, llaunch, lstrip) != (1, want, 0):
        raise AssertionError(f"{name} t_chunk={STREAM_LEN}: {lticks} ticks, "
                             f"{llaunch} tcn_chunk and {lstrip} strip "
                             f"launches, expected 1 tick of {want}")
    for a, b in zip(long, short):
        if not all(np.array_equal(a[k], b[k]) for k in ("emb", "logits")):
            raise AssertionError(f"{name}: t_chunk {STREAM_LEN} and {T_CHUNK}"
                                 " differ")
    if not same_grid(lgrid, sgrid):
        raise AssertionError(f"{name}: t_chunk {STREAM_LEN} and {T_CHUNK} "
                             "leave different slot grids")
    log(f"{name} t_chunk={STREAM_LEN}: {audio.shape[0]} sessions x "
        f"{STREAM_LEN} samples in one tick of {llaunch} tcn_chunk launches "
        f"(max_chunk_len {limit}; launches per tick {llaunch}), bit for bit "
        f"equal to t_chunk={T_CHUNK} ({slaunch} launches in {sticks} ticks)")
    return llaunch


def phase_serve(cfg, dev, seed: int = 0, stream_len: int = STREAM_LEN,
                n_sessions: int = N_SLOTS):
    import numpy as np
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.proto_extract import proto_extract
    from repro_torch.kernels.tcn_block import tcn_block, tcn_chunk
    from repro_torch.models.tcn import bake_stream_params, make_fused_forward
    from repro_torch.sessions import StreamSessionService

    rng = np.random.default_rng(seed)
    bundle, params, bn = make_model(cfg, dev, seed)
    audio = rng.normal(size=(n_sessions, stream_len, cfg.tcn_in_channels)
                       ).astype(np.float32)
    shots = rng.normal(size=(N_WAYS, K_SHOTS, stream_len,
                             cfg.tcn_in_channels)).astype(np.float32)
    schedule = make_schedule(rng, n_sessions, stream_len)

    def service(quantize, t_chunk):
        return StreamSessionService(
            bundle, params, bn, n_slots=n_sessions, max_tenants=N_TENANTS,
            max_ways=8, t_chunk=t_chunk, quantize=quantize, fused=True)

    result = {}
    for quantize in (False, True):
        svc = service(quantize, T_CHUNK)
        tcn_block.launches = tcn_chunk.launches = proto_extract.launches = 0
        with counting(ref, PLAIN_CHUNK) as plain:
            main, polls = drive(svc, audio, schedule, shots)
        chunk, strip = check_drive_launches(f"serve quantize={quantize}", svc,
                                            cfg, plain.calls)
        if not quantize:
            result["launches"] = chunk + strip
        for s, (e, lg, tl) in main.items():
            if e.shape != (stream_len, cfg.embed_dim) or \
                    lg.shape != (stream_len, cfg.n_classes):
                raise AssertionError(f"serve: session {s} shapes {e.shape}, "
                                     f"{lg.shape}")
            # unlearned ways carry bias -inf by design: check learned ones
            for a in (e, lg) + ((tl[:, :N_WAYS],) if tl is not None else ()):
                if not np.isfinite(a).all():
                    raise AssertionError(f"serve: session {s} non-finite")
        if not any(np.abs(lg).max() > 0 for _, lg, _ in main.values()):
            raise AssertionError("serve: all logits are zero")
        if polls[0]["n_ways"] != N_WAYS or main[0][2] is None:
            raise AssertionError("serve: enrollment did not reach tenant 0")
        if any(p["steps"] != stream_len for p in polls):
            raise AssertionError("serve: a session lost steps")
        log(f"serve quantize={quantize}: {n_sessions} sessions x {stream_len}"
            f" samples in {len(schedule)} ragged rounds, {svc.dispatches} "
            f"ticks, tcn_chunk launches={chunk} (one a tick), strip "
            f"launches={strip} (enrollment), plain chunk calls 0, enrolled "
            f"{polls[0]['n_ways']} ways; outputs finite")
        one, _ = drive(service(quantize, 1), audio, schedule, shots)
        if not same_outputs(main, one):
            raise AssertionError(f"serve quantize={quantize}: t_chunk "
                                 f"{T_CHUNK} and 1 differ")
        parked_svc = service(quantize, T_CHUNK)
        parked, _ = drive(parked_svc, audio, schedule, shots, park_every=4)
        if not same_outputs(main, parked):
            raise AssertionError(f"serve quantize={quantize}: park/resume "
                                 "changed the outputs")
        log(f"serve quantize={quantize}: chunk-size invariance (t_chunk "
            f"{T_CHUNK} vs 1) and park/resume ({parked_svc.evictions} "
            "evictions) bit-exact")
        if not quantize:
            sids = [svc.open_session() for _ in range(n_sessions)]
            x = {sid: audio[i, :T_CHUNK] for i, sid in enumerate(sids)}
            result["tick_ms"] = time_tick("push_audio", svc, x, dev)
    result["launches"] += check_long_tick("serve", service, audio, cfg)
    # small-input reference: the fused forward on the card against the
    # plain versions on the CPU
    _, _, fp = bake_stream_params(params, bn, cfg)
    x = shots[0, :2]
    fwd_dev = make_fused_forward(cfg, device=dev)
    fwd_cpu = make_fused_forward(cfg, device="cpu")
    fp_cpu = _to(fp, "cpu")
    e_dev, _ = fwd_dev(fp, torch.from_numpy(x).to(dev))
    e_cpu, _ = fwd_cpu(fp_cpu, torch.from_numpy(x))
    err = compare("serve: fused forward card vs CPU", e_dev.cpu(), e_cpu,
                  False)
    log("serve: fused forward on the card agrees with the CPU plain "
        f"versions (max abs err {err:.3g}, values up to "
        f"{e_cpu.abs().max().item():.3g})")
    return result


def profile_tick(fn, ticks: int = 10, top: int = 10) -> None:
    """Where a tick's time goes: torch.profiler over ``ticks`` calls,
    device busy time per tick against the profiled wall time, and the ops
    that take the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / ticks
    events = prof.key_averages()
    # device-side events only (kernels, copies): the CPU ops that launched
    # them report the same device time again
    on_dev = [e for e in events if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in on_dev) / 1e3 / ticks
    launches = sum(e.count for e in events
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                "cudaLaunchKernelExC")) / ticks
    log(f"profile push_audio tick: wall_ms={wall:.4f} (profiled) "
        f"device_busy_ms={busy:.4f} device_idle_share="
        f"{1 - busy / wall:.4f} kernel_launches_per_tick={launches:.1f}")
    for e in sorted(on_dev, key=lambda e: e.self_device_time_total,
                    reverse=True)[:top]:
        log(f"  profile device op {e.key[:70]!r}: device_ms_per_tick="
            f"{e.self_device_time_total / 1e3 / ticks:.4f} calls_per_tick="
            f"{e.count / ticks:.1f}")


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


# ---------------------------------------------------------------------------
# phase: fsl
# ---------------------------------------------------------------------------

def phase_fsl(cfg, dev, seed: int = 2, stream_len: int = STREAM_LEN):
    import numpy as np
    import torch
    from repro_torch.core.protonet import adapt, pn_fc_from_sums, support_sums
    from repro_torch.kernels.proto_extract import proto_extract
    from repro_torch.kernels.tcn_block import tcn_block
    from repro_torch.models.tcn import bake_stream_params, make_fused_forward

    rng = np.random.default_rng(seed)
    bundle, params, bn = make_model(cfg, dev, seed)
    _, _, fp = bake_stream_params(params, bn, cfg)
    fwd = make_fused_forward(cfg, device=dev)
    embed_fn = lambda p, x: fwd(p, x)[0]
    counts = {}
    for k in (1, K_SHOTS):
        support = torch.from_numpy(rng.normal(
            size=(N_WAYS * k, stream_len, cfg.tcn_in_channels)
        ).astype(np.float32)).to(dev)
        labels = torch.arange(N_WAYS, device=dev).repeat_interleave(k)
        tcn_block.launches = proto_extract.launches = 0
        w, b = adapt(embed_fn, fp, support, labels, N_WAYS, k)
        sync(dev)
        counts[k] = (proto_extract.launches, tcn_block.launches)
        if 0 in counts[k]:
            raise AssertionError("fsl: a kernel was not launched "
                                 f"(proto_extract, tcn_block) = {counts[k]}")
        ws, bs = pn_fc_from_sums(support_sums(embed_fn(fp, support), labels,
                                              N_WAYS), k)
        err = max(compare(f"fsl {k}-shot W", w, ws, False),
                  compare(f"fsl {k}-shot b", b, bs, False))
        log(f"fsl 5-way {k}-shot: W {tuple(w.shape)} b {tuple(b.shape)} "
            f"match support_sums+pn_fc_from_sums (max abs err {err:.3g}, "
            f"|b| up to {bs.abs().max().item():.3g}); "
            f"proto_extract launches={counts[k][0]} tcn_block "
            f"launches={counts[k][1]}")
    return counts


# ---------------------------------------------------------------------------
# phase: ops (log2_matmul and dilated_conv, repro_torch.kernels.ops)
# ---------------------------------------------------------------------------

# (M, K, N): benchmarks/kernel_bench.py's full and smoke sizes, decode
# shapes (M = 1 and 4 take the decode path), and tests/test_kernels.py's
# shapes with ragged tiles
MATMUL_SHAPES = ((256, 2048, 2048), (64, 256, 256), (1, 2048, 2048),
                 (16, 2048, 8192), (100, 64, 130), (1, 256, 64), (8, 32, 16),
                 (4, 2048, 8192))
# tests/test_kernels.py's tolerances: log2_matmul fp32 (bf16 x is upcast
# exactly on both sides, so the fp32 one applies), dilated_conv
MATMUL_RTOL, MATMUL_ATOL = 1e-4, 1e-3
CONV_RTOL = CONV_ATOL = 1e-4
# tests/test_kernels.py's conv shapes (B, T, Cin, Cout, K, d); the last has
# T < (K-1)*d
CONV_TEST_SHAPES = ((2, 37, 4, 8, 3, 1), (3, 128, 16, 32, 7, 4),
                    (1, 200, 8, 100, 2, 16), (2, 64, 28, 24, 3, 2),
                    (2, 20, 4, 100, 7, 8))
AUDIO_B, AUDIO_LEN = 8, 16_000  # whole 1 s clips at 16 kHz


def packed_weight(rng, K, N, dev):
    """(codes (K, N/2) uint8, scale ()) of a random (K, N) weight."""
    import torch
    from repro_torch.models.tcn import _bake_weight

    w = torch.from_numpy((rng.normal(size=(K, N)) * 0.05).astype("float32"))
    p = _bake_weight(w, True)[1]
    return p["codes"].to(dev), p["scale"].to(dev)


def conv_shapes(cfg, B, T):
    """(name, B, T, Cin, Cout, K, d) of every conv of the TCN forward."""
    out, c_in, k = [], cfg.tcn_in_channels, cfg.tcn_kernel
    for i, c in enumerate(cfg.tcn_channels):
        d = 2 ** i
        out.append((f"b{i}.conv1", B, T, c_in, c, k, d))
        out.append((f"b{i}.conv2", B, T, c, c, k, d))
        if c_in != c:
            out.append((f"b{i}.down", B, T, c_in, c, 1, 1))
        c_in = c
    return out


def conv_inputs(rng, B, T, Cin, Cout, K, dev):
    import torch

    t = lambda a: torch.from_numpy(a.astype("float32")).to(dev)
    return (t(rng.normal(size=(B, T, Cin))),
            t(rng.normal(size=(K, Cin, Cout)) * (K * Cin) ** -0.5),
            t(rng.normal(size=(Cout,)) * 0.1))


def matmul_work(M, K, N, x_bytes):
    """(bytes, flops) of one log2_matmul: x, packed W and the scale in,
    the fp32 output out."""
    return M * K * x_bytes + K * N // 2 + 4 + M * N * 4, 2 * M * K * N


def matmul_bound(M, K, N, x_bytes) -> tuple[float, str, str]:
    """(bound ms, what bounds it, the peak used) of one log2_matmul: the
    tile path runs parts * 2MKN bf16 operations on the tensor cores (an
    fp32 x is three bf16 parts, a bf16 x one), the decode path 2MKN fp32
    operations on the CUDA cores."""
    from repro_torch.kernels.log2_matmul import DECODE_MAX_M

    nb, fl = matmul_work(M, K, N, x_bytes)
    if M <= DECODE_MAX_M:
        peak = PEAK_FP32_FLOPS
    else:
        peak, fl = PEAK_BF16_TC_FLOPS, fl * (3 if x_bytes == 4 else 1)
    return (*bound(nb, fl, peak), PEAK_NAMES[peak])


def conv_work(B, T, Cin, Cout, K):
    """(bytes, flops) of one dilated_conv."""
    return ((B * T * (Cin + Cout) + K * Cin * Cout + Cout) * 4,
            2 * B * T * K * Cin * Cout)


def phase_ops(dev, audio_cfg, fsl_cfg, seed: int = 3):
    """log2_matmul and dilated_conv against their plain versions at every
    listed shape, the identity decode and the conv's causality bit for
    bit."""
    import numpy as np
    import torch
    from repro_torch.kernels.dilated_conv import dilated_conv
    from repro_torch.kernels.log2_matmul import log2_matmul
    from repro_torch.kernels.ref import dilated_conv_ref, log2_matmul_ref
    from repro_torch.quant.log2 import dequantize_log2, unpack_nibbles

    rng = np.random.default_rng(seed)
    errs = {"log2_matmul": 0.0, "dilated_conv": 0.0}
    n_cases = 0
    for (M, K, N) in MATMUL_SHAPES:
        codes, scale = packed_weight(rng, K, N, dev)
        x32 = torch.from_numpy(rng.normal(size=(M, K)).astype("float32")).to(dev)
        for x in (x32, x32.to(torch.bfloat16)):
            got = log2_matmul(x, codes, scale)
            want = log2_matmul_ref(x, codes, scale)
            sync(dev)
            errs["log2_matmul"] = max(errs["log2_matmul"], allclose(
                f"log2_matmul {M}x{K}x{N} {x.dtype}", got, want,
                MATMUL_RTOL, MATMUL_ATOL))
            n_cases += 1
    codes, scale = packed_weight(rng, 256, 256, dev)
    got = log2_matmul(torch.eye(256, device=dev), codes, scale)
    if not torch.equal(got, dequantize_log2(unpack_nibbles(codes), scale)):
        raise AssertionError("log2_matmul: I @ W is not the decoded W bit "
                             "for bit")
    shapes = (conv_shapes(audio_cfg, AUDIO_B, AUDIO_LEN)
              + conv_shapes(fsl_cfg, N_WAYS * K_SHOTS, STREAM_LEN)
              + [("test", *sh) for sh in CONV_TEST_SHAPES])
    for (name, B, T, Cin, Cout, K, d) in shapes:
        x, w, b = conv_inputs(rng, B, T, Cin, Cout, K, dev)
        got = dilated_conv(x, w, b, d)
        want = dilated_conv_ref(x, w, b, d)
        sync(dev)
        errs["dilated_conv"] = max(errs["dilated_conv"], allclose(
            f"dilated_conv {name} B={B} T={T} {Cin}->{Cout} K={K} d={d}",
            got, want, CONV_RTOL, CONV_ATOL))
        n_cases += 1
    for (B, T, C, K, d, t0) in ((1, 32, 4, 3, 2, 20),
                                (AUDIO_B, AUDIO_LEN, 24, 7, 2048,
                                 AUDIO_LEN * 3 // 4)):
        x, w, b = conv_inputs(rng, B, T, C, C, K, dev)
        y1 = dilated_conv(x, w, b, d)
        x2 = x.clone()
        x2[:, t0:] = 123.0
        y2 = dilated_conv(x2, w, b, d)
        sync(dev)
        if not torch.equal(y1[:, :t0], y2[:, :t0]):
            raise AssertionError(f"dilated_conv d={d}: x[:, {t0}:] changed "
                                 f"out[:, :{t0}]")
        if torch.equal(y1[:, t0:], y2[:, t0:]):
            raise AssertionError(f"dilated_conv d={d}: x[:, {t0}:] changed "
                                 "nothing")
    log(f"ops: {n_cases} cases agree with the plain versions (max abs err "
        f"log2_matmul={errs['log2_matmul']:.3g}, dilated_conv="
        f"{errs['dilated_conv']:.3g}); I @ W decodes bit for bit; the conv "
        "is causal bit for bit (d=2 and d=2048)")
    return errs


def phase_ops_timings(dev, audio_cfg, seed: int = 4):
    """Kernel / wrapper / plain / library times of log2_matmul at every
    listed shape and of dilated_conv at every conv of the audio preset over
    8 whole clips; the JSON gets the kernel_bench size and the sum over the
    audio forward's convs."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.dilated_conv import dilated_conv
    from repro_torch.kernels.log2_matmul import log2_matmul
    from repro_torch.kernels.ref import dilated_conv_ref, log2_matmul_ref
    from repro_torch.quant.log2 import dequantize_log2, unpack_nibbles

    rng = np.random.default_rng(seed)
    mm = None
    for (M, K, N) in MATMUL_SHAPES:
        codes, scale = packed_weight(rng, K, N, dev)
        w = dequantize_log2(unpack_nibbles(codes), scale)
        x32 = torch.from_numpy(rng.normal(size=(M, K)).astype("float32")).to(dev)
        for x in (x32, x32.to(torch.bfloat16)):
            call = lambda: log2_matmul(x, codes, scale)
            row = {"ms": device_ms(call, dev),
                   "wrapper_ms": time_ms(call, dev),
                   "plain_ms": time_ms(
                       lambda: log2_matmul_ref(x, codes, scale), dev),
                   "library_ms": None}
            if x.dtype == torch.float32:
                # one PyTorch call on the decoded W; never used by the port
                row["library_ms"] = device_ms(lambda: torch.matmul(x, w), dev)
            row["bound_ms"], row["bound_by"], row["bound_peak"] = \
                matmul_bound(M, K, N, x.element_size())
            lib = "null" if row["library_ms"] is None \
                else f"{row['library_ms']:.4f}"
            log(f"timing log2_matmul {M}x{K}x{N} x={str(x.dtype)[6:]}: "
                f"ms={row['ms']:.4f} wrapper_ms={row['wrapper_ms']:.4f} "
                f"plain_ms={row['plain_ms']:.4f} library_ms={lib} "
                f"bound_ms={row['bound_ms']:.6f} bound_by={row['bound_by']} "
                f"(peak: {row['bound_peak']})")
            if mm is None:  # the kernel_bench size, fp32 x
                mm = row
    tot = {"ms": 0.0, "wrapper_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
           "bytes": 0.0, "flops": 0.0}
    convs = conv_shapes(audio_cfg, AUDIO_B, AUDIO_LEN)
    for (name, B, T, Cin, Cout, K, d) in convs:
        x, w, b = conv_inputs(rng, B, T, Cin, Cout, K, dev)
        pad = (K - 1) * d
        # the library call's operands, already padded and laid out
        # (B, Cin, T+pad) and (Cout, Cin, K)
        xl = F.pad(x, (0, 0, pad, 0)).transpose(1, 2).contiguous()
        wl = w.permute(2, 1, 0).contiguous()
        library = lambda: F.conv1d(xl, wl, b, dilation=d)
        allclose(f"conv1d library call {name}",
                 library().transpose(1, 2), dilated_conv(x, w, b, d),
                 CONV_RTOL, CONV_ATOL)
        call = lambda: dilated_conv(x, w, b, d)
        row = {"ms": device_ms(call, dev),
               "wrapper_ms": time_ms(call, dev),
               "plain_ms": time_ms(lambda: dilated_conv_ref(x, w, b, d), dev),
               "library_ms": device_ms(library, dev)}
        nb, fl = conv_work(B, T, Cin, Cout, K)
        bms, by = bound(nb, fl)
        log(f"timing dilated_conv {audio_cfg.name} {name} B={B} T={T} "
            f"{Cin}->{Cout} K={K} d={d}: ms={row['ms']:.4f} "
            f"wrapper_ms={row['wrapper_ms']:.4f} "
            f"plain_ms={row['plain_ms']:.4f} "
            f"library_ms={row['library_ms']:.4f} bound_ms={bms:.6f} "
            f"bound_by={by} (peak: {PEAK_NAMES[PEAK_FP32_FLOPS]})")
        for key in row:
            tot[key] += row[key]
        tot["bytes"] += nb
        tot["flops"] += fl
    cb, cby = bound(tot.pop("bytes"), tot.pop("flops"))
    tot["bound_ms"], tot["bound_by"] = cb, cby
    tot["bound_peak"] = PEAK_NAMES[PEAK_FP32_FLOPS]
    log(f"timing dilated_conv {audio_cfg.name} forward ({len(convs)} convs, "
        f"B={AUDIO_B}, T={AUDIO_LEN}): ms={tot['ms']:.4f} "
        f"wrapper_ms={tot['wrapper_ms']:.4f} plain_ms={tot['plain_ms']:.4f} "
        f"library_ms={tot['library_ms']:.4f} bound_ms={cb:.6f} "
        f"bound_by={cby}")
    return mm, tot


def conv_forward(params, bn, cfg, x, conv_op):
    """models/tcn.tcn_forward (eval, fp32) with every conv through
    ``conv_op``: the ops entry point driven as a whole network."""
    import torch
    from repro_torch.models.tcn import _bn

    h = x
    for i in range(len(cfg.tcn_channels)):
        p, st, d = params["blocks"][f"b{i}"], bn[f"b{i}"], 2 ** i
        y = conv_op(h, p["conv1_w"], p["conv1_b"], d)
        y = torch.relu(_bn(y, p["bn1"]["scale"], p["bn1"]["bias"],
                           st["bn1_mean"], st["bn1_var"]))
        y = conv_op(y, p["conv2_w"], p["conv2_b"], d)
        y = _bn(y, p["bn2"]["scale"], p["bn2"]["bias"], st["bn2_mean"],
                st["bn2_var"])
        res = conv_op(h, p["down_w"], p["down_b"], 1) if "down_w" in p else h
        h = torch.relu(y + res)
    emb = torch.relu(h[:, -1, :] @ params["head_w"] + params["head_b"])
    return emb, emb @ params["fc"]["w"] + params["fc"]["b"]


def scaled_close(name, got, want, rtol=2e-4, atol=2e-5) -> float:
    """allclose at the repo's fp32 precedent with atol scaled by the
    largest |want| (at least 1): the seeded, untrained nets' activations
    reach far above 1, and two fp32 summation orders then differ by a few
    ulps of that scale."""
    return allclose(name, got, want, rtol,
                    atol * max(1.0, want.abs().max().item()))


def phase_ops_main(dev, audio_cfg, seed: int = 5):
    """The ops entry point as a user calls it: kernel_bench's log2_matmul
    workloads (bf16 x, the tile path) and a decode-shaped one (the decode
    path), and the audio preset's forward over 8 whole clips with every
    conv through the conv op.  Counters are zeroed just before and read
    just after."""
    import numpy as np
    import torch
    from repro_torch.kernels import make_dilated_conv_op, make_log2_matmul_op
    from repro_torch.kernels.dilated_conv import dilated_conv
    from repro_torch.kernels.log2_matmul import log2_matmul
    from repro_torch.kernels.ref import log2_matmul_ref
    from repro_torch.models.tcn import tcn_forward

    rng = np.random.default_rng(seed)
    mm_op, conv_op = make_log2_matmul_op(), make_dilated_conv_op()
    work = []
    for (M, K, N) in MATMUL_SHAPES[:3]:
        codes, scale = packed_weight(rng, K, N, dev)
        x = torch.from_numpy(rng.normal(size=(M, K)).astype("float32")).to(
            dev, torch.bfloat16)
        work.append((x, codes, scale))
    _, params, bn = make_model(audio_cfg, dev, seed)
    clips = torch.from_numpy(rng.normal(
        size=(AUDIO_B, AUDIO_LEN, audio_cfg.tcn_in_channels)
    ).astype("float32")).to(dev)
    log2_matmul.launches = dilated_conv.launches = 0
    outs = [mm_op(*args) for args in work]
    emb, logits = conv_forward(params, bn, audio_cfg, clips, conv_op)
    sync(dev)
    launches = {"log2_matmul": log2_matmul.launches,
                "dilated_conv": dilated_conv.launches}
    if 0 in launches.values():
        raise AssertionError(f"ops: a kernel was not launched {launches}")
    for out, args in zip(outs, work):
        allclose("ops log2_matmul workload", out, log2_matmul_ref(*args),
                 MATMUL_RTOL, MATMUL_ATOL)
    de, dl = tcn_forward(params, bn, audio_cfg, clips)
    err = max(scaled_close("ops conv forward emb", emb, de),
              scaled_close("ops conv forward logits", logits, dl))
    log(f"ops main path: {len(work)} log2_matmul workloads (both paths) and the "
        f"{audio_cfg.name} forward over {AUDIO_B}x{AUDIO_LEN} samples "
        f"through the conv op agree with the plain versions (forward max "
        f"abs err {err:.3g}, |emb| up to {de.abs().max().item():.3g}); "
        f"launches {launches}")
    return launches


def build_other_ops(csrc: Path):
    """Compile another tree's log2_matmul.cu and dilated_conv.cu (its csrc/
    directory) with this tree's nvcc flags into build/compare/ and bind
    their C entries, which take the arguments this tree's tile-path and
    conv entries take.  Returns (log2_matmul, dilated_conv)."""
    import ctypes
    from repro_torch.kernels import _build

    out = ROOT / "build" / "compare"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in ("log2_matmul", "dilated_conv"):
        so = out / f"lib{name}.so"
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o", str(so),
             str(csrc / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = []
    for name, (so, p) in procs.items():
        text, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {csrc / name}.cu:\n{text}")
        fn = getattr(ctypes.CDLL(str(so)), name)
        fn.argtypes = [_build.P] * 4 + [_build.I] * (4 if name == "log2_matmul"
                                                     else 6) + [_build.P]
        fn.restype = ctypes.c_int
        fns.append(fn)
    return tuple(fns)


def phase_compare(dev, audio_cfg, fsl_cfg, csrc: Path, seed: int = 7):
    """The other tree's log2_matmul and dilated_conv kernels beside this
    tree's, on the same inputs in this process: device ms of both (and of
    the library call) at every listed op shape; the other kernel's output
    is held to this tree's at the ops tolerance.  Returns the shapes where
    this tree's kernel is slower."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.dilated_conv import dilated_conv
    from repro_torch.kernels.log2_matmul import log2_matmul
    from repro_torch.quant.log2 import dequantize_log2, unpack_nibbles

    old_mm, old_conv = build_other_ops(csrc)
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream
    rng = np.random.default_rng(seed)
    slower = []

    def one(tag, old, new, library):
        row = [device_ms(f, dev, n=40, reps=9) for f in (old, new, library)]
        log(f"compare {tag}: other_ms={row[0]:.5f} this_ms={row[1]:.5f} "
            f"library_ms={row[2]:.5f}")
        if row[1] > row[0]:
            slower.append(tag)

    for (M, K, N) in MATMUL_SHAPES:
        codes, scale = packed_weight(rng, K, N, dev)
        w = dequantize_log2(unpack_nibbles(codes), scale)
        x32 = torch.from_numpy(rng.normal(size=(M, K)).astype("float32")).to(dev)
        for x in (x32, x32.to(torch.bfloat16)):
            o = torch.empty((M, N), device=dev)
            old = lambda: old_mm(x.data_ptr(), codes.data_ptr(), scale.data_ptr(),
                                 o.data_ptr(), M, K, N,
                                 int(x.dtype == torch.bfloat16), stream())
            if old() != 0:
                raise RuntimeError("the other log2_matmul did not launch")
            allclose(f"compare log2_matmul {M}x{K}x{N}", o,
                     log2_matmul(x, codes, scale), MATMUL_RTOL, MATMUL_ATOL)
            one(f"log2_matmul {M}x{K}x{N} x={str(x.dtype)[6:]}", old,
                lambda: log2_matmul(x, codes, scale),
                lambda: torch.matmul(x32, w))
    shapes = (conv_shapes(audio_cfg, AUDIO_B, AUDIO_LEN)
              + conv_shapes(fsl_cfg, N_WAYS * K_SHOTS, STREAM_LEN)
              + [("test", *sh) for sh in CONV_TEST_SHAPES])
    for (name, B, T, Cin, Cout, K, d) in shapes:
        x, w, b = conv_inputs(rng, B, T, Cin, Cout, K, dev)
        o = torch.empty((B, T, Cout), device=dev)
        old = lambda: old_conv(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                               o.data_ptr(), B, T, Cin, Cout, K, d, stream())
        if old() != 0:
            raise RuntimeError("the other dilated_conv did not launch")
        allclose(f"compare dilated_conv {name}", o, dilated_conv(x, w, b, d),
                 CONV_RTOL, CONV_ATOL)
        xl = F.pad(x, (0, 0, (K - 1) * d, 0)).transpose(1, 2).contiguous()
        wl = w.permute(2, 1, 0).contiguous()
        one(f"dilated_conv {name} B={B} T={T} {Cin}->{Cout} K={K} d={d}", old,
            lambda: dilated_conv(x, w, b, d),
            lambda: F.conv1d(xl, wl, b, dilation=d))
    log(f"compare with {csrc}: this tree's kernel is slower at "
        f"{len(slower)} shapes{': ' + '; '.join(slower) if slower else ''}")
    return slower


# ---------------------------------------------------------------------------
# phase: audio (chameleon-tcn-audio served, enrolled and cone-evaluated)
# ---------------------------------------------------------------------------

AUDIO_BIG_CHUNK, AUDIO_PARK_EVERY = 160, 20


def phase_audio(cfg, dev, seed: int = 6):
    import numpy as np
    import torch
    from repro_torch.core.protonet import adapt, pn_fc_from_sums, support_sums
    from repro_torch.core.streaming import (
        cone_eval,
        cone_stats,
        ring_sizes,
        stream_state_bytes,
        ws_inference_stats,
    )
    from repro_torch.kernels import ref
    from repro_torch.kernels.proto_extract import proto_extract
    from repro_torch.kernels.tcn_block import tcn_block, tcn_chunk
    from repro_torch.models.tcn import (
        bake_stream_params,
        make_fused_forward,
        tcn_forward,
    )
    from repro_torch.sessions import StreamSessionService

    rng = np.random.default_rng(seed)
    bundle, params, bn = make_model(cfg, dev, seed)
    c_in = cfg.tcn_in_channels
    audio = rng.normal(size=(N_SLOTS, AUDIO_LEN, c_in)).astype(np.float32)
    shots = rng.normal(size=(N_WAYS, K_SHOTS, AUDIO_LEN, c_in)
                       ).astype(np.float32)
    deepest = max(n for rs in ring_sizes(cfg).values()
                  for (n, _) in rs.values())
    if AUDIO_LEN <= deepest:
        raise AssertionError(f"a {AUDIO_LEN}-sample stream does not wrap "
                             f"the {deepest}-row ring")
    # 9..16 samples a session per push, so one tick of 16 a round; then
    # 1..320-sample pushes served in ticks of 160
    small = make_schedule(rng, N_SLOTS, AUDIO_LEN, max_chunk=T_CHUNK,
                          min_chunk=9)
    big = make_schedule(rng, N_SLOTS, AUDIO_LEN,
                        max_chunk=2 * AUDIO_BIG_CHUNK)

    def service(quantize, t_chunk):
        return StreamSessionService(
            bundle, params, bn, n_slots=N_SLOTS, max_tenants=N_TENANTS,
            max_ways=8, t_chunk=t_chunk, quantize=quantize, fused=True)

    result = {"launches": 0}
    for quantize in (False, True):
        svc = service(quantize, T_CHUNK)
        tcn_block.launches = tcn_chunk.launches = proto_extract.launches = 0
        t0 = time.perf_counter()
        with counting(ref, PLAIN_CHUNK) as plain:
            main, polls = drive(svc, audio, small, shots, enroll_round=0)
        secs = time.perf_counter() - t0
        chunk, strip = check_drive_launches(f"audio quantize={quantize}", svc,
                                            cfg, plain.calls)
        result["launches"] += chunk + strip
        for s, (e, lg, tl) in main.items():
            if e.shape != (AUDIO_LEN, cfg.embed_dim) or \
                    lg.shape != (AUDIO_LEN, cfg.n_classes):
                raise AssertionError(f"audio: session {s} shapes {e.shape}, "
                                     f"{lg.shape}")
            for a in (e, lg) + ((tl[:, :N_WAYS],) if tl is not None else ()):
                if not np.isfinite(a).all():
                    raise AssertionError(f"audio: session {s} non-finite")
        if not any(np.abs(lg).max() > 0 for _, lg, _ in main.values()):
            raise AssertionError("audio: all logits are zero")
        if polls[0]["n_ways"] != N_WAYS or main[0][2] is None \
                or main[0][2].shape[0] != AUDIO_LEN:
            raise AssertionError("audio: enrollment did not reach tenant 0")
        if any(p["steps"] != AUDIO_LEN for p in polls):
            raise AssertionError("audio: a session lost steps")
        log(f"audio quantize={quantize}: {N_SLOTS} sessions x {AUDIO_LEN} "
            f"samples in {len(small)} ragged rounds, {svc.dispatches} ticks "
            f"of <= {T_CHUNK} in {secs:.1f} s, every ring wrapped (deepest "
            f"{deepest} rows), tcn_chunk launches={chunk} (one a tick), strip "
            f"launches={strip} (enrollment), plain chunk calls 0, enrolled "
            f"{polls[0]['n_ways']} ways; outputs finite")
        other_svc = service(quantize, AUDIO_BIG_CHUNK)
        other, _ = drive(other_svc, audio, big, shots, enroll_round=0)
        if not same_outputs(main, other):
            raise AssertionError(f"audio quantize={quantize}: t_chunk "
                                 f"{T_CHUNK} and {AUDIO_BIG_CHUNK} differ")
        parked_svc = service(quantize, AUDIO_BIG_CHUNK)
        parked, _ = drive(parked_svc, audio, big, shots, enroll_round=0,
                          park_every=AUDIO_PARK_EVERY)
        if not same_outputs(main, parked) or parked_svc.evictions == 0:
            raise AssertionError(f"audio quantize={quantize}: park/resume "
                                 f"changed the outputs ({parked_svc.evictions}"
                                 " evictions)")
        log(f"audio quantize={quantize}: chunk-size invariance (t_chunk "
            f"{T_CHUNK} in {len(small)} rounds vs {AUDIO_BIG_CHUNK} in "
            f"{len(big)} other ragged rounds, {other_svc.dispatches} ticks) "
            f"and park/resume ({parked_svc.evictions} evictions) bit-exact")
        del svc, other_svc, parked_svc
        if not quantize:
            tsvc = service(False, T_CHUNK)
            sids = [tsvc.open_session() for _ in range(N_SLOTS)]
            x = {sid: audio[i, :T_CHUNK] for i, sid in enumerate(sids)}
            result["tick_ms"] = time_tick("audio push_audio", tsvc, x, dev)
            del tsvc
    result["launches"] += check_long_tick("audio", service, audio, cfg)
    # 5-way 5-shot enrollment of whole clips through protonet.adapt
    _, _, fp = bake_stream_params(params, bn, cfg)
    fwd = make_fused_forward(cfg, device=dev)
    embed_fn = lambda p, x: fwd(p, x)[0]
    support = torch.from_numpy(shots.reshape(-1, AUDIO_LEN, c_in)).to(dev)
    labels = torch.arange(N_WAYS, device=dev).repeat_interleave(K_SHOTS)
    tcn_block.launches = proto_extract.launches = 0
    w, b = adapt(embed_fn, fp, support, labels, N_WAYS, K_SHOTS)
    sync(dev)
    counts = (proto_extract.launches, tcn_block.launches)
    result["launches"] += counts[1]
    result["proto_launches"] = counts[0]
    if 0 in counts:
        raise AssertionError("audio fsl: a kernel was not launched "
                             f"(proto_extract, tcn_block) = {counts}")
    ws_, bs = pn_fc_from_sums(support_sums(embed_fn(fp, support), labels,
                                           N_WAYS), K_SHOTS)
    err = max(compare("audio fsl W", w, ws_, False),
              compare("audio fsl b", b, bs, False))
    enroll_ms = time_ms(lambda: adapt(embed_fn, fp, support, labels, N_WAYS,
                                      K_SHOTS), dev, n=5, warmup=1)
    log(f"audio fsl 5-way {K_SHOTS}-shot of {AUDIO_LEN}-sample clips: W "
        f"{tuple(w.shape)} matches support_sums+pn_fc_from_sums (max abs err "
        f"{err:.3g}); proto_extract launches={counts[0]} tcn_block "
        f"launches={counts[1]}; timing adapt (embed S={N_WAYS * K_SHOTS} + "
        f"extract, end to end): ms={enroll_ms:.4f}")
    # greedy cone evaluation against the dense forward's last step
    clips = torch.from_numpy(audio[:AUDIO_B]).to(dev)
    for quantize in (False, True):
        e_c, l_c, evals = cone_eval(params, bn, cfg, clips, quantize=quantize)
        e_d, l_d = tcn_forward(params, bn, cfg, clips, quantize=quantize)
        sync(dev)
        err = max(scaled_close(f"cone_eval quantize={quantize} emb", e_c, e_d),
                  scaled_close(f"cone_eval quantize={quantize} logits", l_c,
                               l_d))
        dense = AUDIO_LEN * 2 * len(cfg.tcn_channels)
        if evals >= dense:
            raise AssertionError(f"cone_eval: {evals} evaluations, dense "
                                 f"{dense}")
        log(f"audio cone_eval quantize={quantize}: {AUDIO_B} clips x "
            f"{AUDIO_LEN} samples match tcn_forward's last step (max abs err "
            f"{err:.3g}, |emb| up to {e_d.abs().max().item():.3g}); "
            f"{evals} node evaluations against {dense} dense")
    ws, g = ws_inference_stats(cfg, AUDIO_LEN), cone_stats(cfg, AUDIO_LEN)
    ratios = (ws["act_entries"] / g["act_entries"], ws["macs"] / g["macs"])
    kb = g["act_entries"] * 0.5 / 1024
    if ratios[0] <= 50 or ratios[1] <= 5 or kb >= 2.5:
        raise AssertionError(f"audio accounting: {ratios}, {kb} kB")
    log(f"audio accounting at T={AUDIO_LEN}: weight-stationary / greedy cone "
        f"= {ratios[0]:.1f}x activation entries, {ratios[1]:.2f}x MACs; "
        f"cone FIFO state {kb:.3f} kB at u4; ring state "
        f"{stream_state_bytes(cfg) / 1024:.1f} kB per stream at u4, "
        f"{stream_state_bytes(cfg, 4) / 2**20:.2f} MiB at fp32")
    return result


# ---------------------------------------------------------------------------

def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--compare-with", type=Path, metavar="DIR",
                    help="another tree's csrc/ directory: time its "
                         "log2_matmul and dilated_conv beside this tree's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi)  # the card's name and power limit, as nvidia-smi gives them
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"build: {len(libs)} kernel libraries in "
        f"{time.perf_counter() - t0:.1f} s into {_build.build_dir()}")
    for name, text in _build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    dev = torch.device("cuda")
    cfg = get_config("chameleon-tcn")
    audio_cfg = get_config("chameleon-tcn-audio")

    def phase(name, fn, *args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        log(f"phase {name}: {time.perf_counter() - t:.1f} s")
        return out

    errs = phase("kernels", phase_kernels, cfg, dev)
    tb_time, pe_time = phase("timings", phase_timings, cfg, dev)
    serve = phase("serve", phase_serve, cfg, dev)
    fsl = phase("fsl", phase_fsl, cfg, dev)
    op_errs = phase("ops", phase_ops, dev, audio_cfg, cfg)
    mm_time, conv_time = phase("ops timings", phase_ops_timings, dev,
                               audio_cfg)
    op_launches = phase("ops main path", phase_ops_main, dev, audio_cfg)
    audio_errs = phase("audio kernels", phase_kernels, audio_cfg, dev,
                       embed_t=AUDIO_LEN,
                       ts=(1, 2, 4, 8, T_CHUNK, AUDIO_LEN))
    phase("audio timings", phase_timings, audio_cfg, dev, embed_t=AUDIO_LEN)
    audio = phase("audio", phase_audio, audio_cfg, dev)
    if args.compare_with is not None:
        phase("compare", phase_compare, dev, audio_cfg, cfg,
              args.compare_with.resolve())
    kernels = [
        # launches of both entries (tcn_chunk and the strip entry); the
        # times are the serve tick's tcn_chunk launch
        {"name": "tcn_block", "route": "cuda",
         "source": "src/repro_torch/csrc/tcn_block.cu",
         "replaces": "src/repro/kernels/tcn_block.py:166",
         "launches": serve["launches"] + sum(c[1] for c in fsl.values())
         + audio["launches"],
         "max_abs_err": max(errs["tcn_block"], audio_errs["tcn_block"]),
         "bound_peak": PEAK_NAMES[PEAK_FP32_FLOPS], **tb_time},
        {"name": "proto_extract", "route": "cuda",
         "source": "src/repro_torch/csrc/proto_extract.cu",
         "replaces": "src/repro/kernels/proto_extract.py:31",
         "launches": sum(c[0] for c in fsl.values())
         + audio["proto_launches"],
         "max_abs_err": errs["proto_extract"],
         "bound_peak": PEAK_NAMES[PEAK_FP32_FLOPS], **pe_time},
        {"name": "log2_matmul", "route": "cuda",
         "source": "src/repro_torch/csrc/log2_matmul.cu",
         "replaces": "src/repro/kernels/log2_matmul.py:43",
         "launches": op_launches["log2_matmul"],
         "max_abs_err": op_errs["log2_matmul"], **mm_time},
        {"name": "dilated_conv", "route": "cuda",
         "source": "src/repro_torch/csrc/dilated_conv.cu",
         "replaces": "src/repro/kernels/dilated_conv.py:35",
         "launches": op_launches["dilated_conv"],
         "max_abs_err": op_errs["dilated_conv"], **conv_time},
    ]
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
