#!/usr/bin/env python3
"""Build the PyTorch/CUDA port's kernels and drive its main path on one
NVIDIA GPU, checking every result.

    python3 chip_smoke.py

Phases, each raising on failure (nothing is caught; any failure exits
non-zero):

  kernels  each kernel against its plain PyTorch version on the card at
           every main-path shape (TF32 off);
  serve    StreamSessionService(fused=True) at the full chameleon-tcn width:
           64 sessions, 8 tenants, ragged 784-sample streams, 5-way 5-shot
           enrollment, poll; then chunk-size invariance (t_chunk 16 vs 1)
           and park/resume, bit-exact, for fp32 and quantized services;
  fsl      5-way 1-shot and 5-shot episodes through protonet.adapt.

Launch counters are zeroed just before each main-path drive and read just
after.  Timings are medians of CUDA-event timed, warmed runs, except a
kernel's ``ms``: its own device time per call, from torch.profiler (the
event-timed wrapper call is ``wrapper_ms``).  The
second-to-last line is the kernels JSON, the last the device JSON.  Exits
with code 2 and prints no result when no CUDA device is present.
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
# tensor cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

RTOL, ATOL = 1e-5, 1e-6
QUANT_STEP = 0.25  # one u4 step at the fixed activation scale
N_SLOTS, T_CHUNK, N_TENANTS, STREAM_LEN = 64, 16, 8, 784
N_WAYS, K_SHOTS = 5, 5


def log(*a) -> None:
    print(*a, flush=True)


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """Least time (ms) for the work, and what bounds it."""
    tb, tf = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FP32_FLOPS * 1e3
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


def device_ms(fn, kernels: tuple[str, ...], n: int = 20) -> float:
    """Device time (ms) per call of ``fn`` spent in the named CUDA kernels,
    from torch.profiler's device events over ``n`` warmed calls.  Raises
    unless each named kernel ran exactly once per call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for name in kernels:
        evs = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and f"{name}(" in e.key]
        count = sum(e.count for e in evs)
        if count != n:
            raise AssertionError(f"profiler saw {name} {count} times in "
                                 f"{n} calls")
        total += sum(e.self_device_time_total for e in evs)
    return total / 1e3 / n


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


def block_inputs(rng, S, T, d, Cin, C, k, has_down, packed, dev):
    """Random strips and one block's weights (fp32 or packed log2)."""
    import torch
    from repro_torch.models.tcn import _bake_weight

    n = (k - 1) * d
    t = lambda a: torch.from_numpy(a.astype("float32")).to(dev)
    strip1 = t(rng.normal(size=(S, n + T, Cin)))
    hist2 = t(rng.normal(size=(S, n, C)))
    p = {"conv1_w": t(rng.normal(size=(k, Cin, C)) * (Cin * k) ** -0.5),
         "conv1_b": t(rng.normal(size=(C,)) * 0.1),
         "conv2_w": t(rng.normal(size=(k, C, C)) * (C * k) ** -0.5),
         "conv2_b": t(rng.normal(size=(C,)) * 0.1)}
    if has_down:
        p["down_w"] = t(rng.normal(size=(1, Cin, C)) * Cin ** -0.5)
        p["down_b"] = t(rng.normal(size=(C,)) * 0.1)
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


def compare(name, got, want, quantized: bool) -> float:
    """Raise unless ``got`` matches ``want``; returns the max abs error.
    fp32: |got-want| <= ATOL + RTOL*|want|.  Quantized: >= 99.9% of the
    elements bit-equal and the rest within one u4 step."""
    import torch

    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    err = (got - want).abs()
    if quantized:
        eq = (got == want).float().mean().item()
        if eq < 0.999 or err.max().item() > QUANT_STEP * (1 + 1e-6):
            raise AssertionError(f"{name}: {eq:.5f} bit-equal, max err "
                                 f"{err.max().item():.3g}")
    elif not (err <= ATOL + RTOL * want.abs()).all():
        raise AssertionError(f"{name}: max abs err {err.max().item():.3g}")
    return err.max().item()


# ---------------------------------------------------------------------------
# phase: kernels
# ---------------------------------------------------------------------------

def phase_kernels(cfg, dev, seed: int = 0,
                  ts=(1, 2, 4, 8, T_CHUNK, STREAM_LEN)):
    """Every shape the main path gives a kernel: serve ticks of T_CHUNK and
    the power-of-two buckets of ragged remainders (S=64), the enrollment
    embeds of one way's shots (S=5) and a 5-shot episode (S=25)."""
    import numpy as np
    import torch
    from repro_torch.kernels.proto_extract import proto_extract
    from repro_torch.kernels.ref import proto_extract_ref, tcn_block_fused
    from repro_torch.kernels.tcn_block import tcn_block

    rng = np.random.default_rng(seed)
    k, errs = cfg.tcn_kernel, {"tcn_block": 0.0, "proto_extract": 0.0}
    n_cases = 0
    for (i, d, Cin, C, has_down) in block_shapes(cfg):
        for (S, T) in [(s, t) for t in ts for s in (
                (K_SHOTS, N_WAYS * K_SHOTS) if t == STREAM_LEN
                else (N_SLOTS,))]:
            for packed in (False, True):
                for quantize in (False, True):
                    strip1, hist2, p = block_inputs(
                        rng, S, T, d, Cin, C, k, has_down, packed, dev)
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
    log(f"kernels: {n_cases} cases agree with the plain versions; "
        f"max abs err tcn_block={errs['tcn_block']:.3g} "
        f"proto_extract={errs['proto_extract']:.3g}")
    return errs


def phase_timings(cfg, dev, seed: int = 1):
    """Per-shape kernel / plain / library times at the main-path shapes."""
    import numpy as np
    import torch
    from repro_torch.kernels.proto_extract import proto_extract
    from repro_torch.kernels.ref import proto_extract_ref, tcn_block_fused
    from repro_torch.kernels.tcn_block import tcn_block

    rng = np.random.default_rng(seed)
    k = cfg.tcn_kernel
    tick = {"ms": 0.0, "wrapper_ms": 0.0, "plain_ms": 0.0, "bytes": 0.0,
            "flops": 0.0}
    for (i, d, Cin, C, has_down) in block_shapes(cfg):
        for (S, T) in ((N_SLOTS, T_CHUNK), (N_WAYS * K_SHOTS, STREAM_LEN)):
            strip1, hist2, p = block_inputs(rng, S, T, d, Cin, C, k,
                                            has_down, False, dev)
            call = lambda: tcn_block(strip1, hist2, p, dilation=d, k=k)
            wrapper = time_ms(call, dev)
            ms = device_ms(call, ("conv1_kernel", "conv2_kernel"))
            plain = time_ms(lambda: tcn_block_fused(
                strip1, hist2, p, dilation=d, k=k), dev)
            nb, fl = block_work(S, T, d, Cin, C, k, has_down, False)
            bms, by = bound(nb, fl)
            log(f"timing tcn_block b{i} d={d} Cin={Cin} S={S} T={T} fp32: "
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
    log(f"timing tcn_block serve tick (7 blocks, S={N_SLOTS}, T={T_CHUNK}): "
        f"ms={tick['ms']:.4f} wrapper_ms={tick['wrapper_ms']:.4f} "
        f"plain_ms={tick['plain_ms']:.4f} bound_ms={tb_bound:.6f} "
        f"bound_by={tb_by}")
    V = cfg.embed_dim
    labels = np.repeat(np.arange(N_WAYS), K_SHOTS)
    emb = torch.from_numpy(
        rng.normal(size=(len(labels), V)).astype("float32")).to(dev)
    onehot = torch.from_numpy(
        (labels[None, :] == np.arange(N_WAYS)[:, None]).astype("float32")).to(dev)
    call = lambda: proto_extract(emb, onehot, K_SHOTS)
    pe = {
        "ms": device_ms(call, ("proto_extract_kernel",)),
        "wrapper_ms": time_ms(call, dev),
        "plain_ms": time_ms(lambda: proto_extract_ref(emb, onehot, K_SHOTS),
                            dev),
    }

    def library():  # one PyTorch call per output; never used by the port
        w = torch.matmul(onehot, emb)
        return w, -(w * w).sum(-1) * (1.0 / (2.0 * K_SHOTS))

    pe["library_ms"] = time_ms(library, dev)
    nb = (emb.numel() + onehot.numel() + N_WAYS * V + N_WAYS) * 4
    fl = 2 * N_WAYS * len(labels) * V + 2 * N_WAYS * V
    pe["bound_ms"], pe["bound_by"] = bound(nb, fl)
    log(f"timing proto_extract N={N_WAYS} Nk={len(labels)} V={V}: "
        f"ms={pe['ms']:.4f} wrapper_ms={pe['wrapper_ms']:.4f} "
        f"plain_ms={pe['plain_ms']:.4f} "
        f"library_ms={pe['library_ms']:.4f} bound_ms={pe['bound_ms']:.8f} "
        f"bound_by={pe['bound_by']}")
    return ({"ms": tick["ms"], "wrapper_ms": tick["wrapper_ms"],
             "plain_ms": tick["plain_ms"],
             "bound_ms": tb_bound, "bound_by": tb_by, "library_ms": None}, pe)


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


def make_schedule(rng, n_sessions: int, length: int, max_chunk: int = 48):
    """Ragged push rounds: per round, each unfinished session gets a chunk
    of 1..max_chunk samples, until every stream has ``length``."""
    pos = [0] * n_sessions
    rounds = []
    while min(pos) < length:
        r = {}
        for s in range(n_sessions):
            if pos[s] < length:
                n = int(min(rng.integers(1, max_chunk + 1), length - pos[s]))
                r[s] = (pos[s], pos[s] + n)
                pos[s] += n
        rounds.append(r)
    return rounds


def drive(svc, audio, schedule, shots, *, park_every: int = 0):
    """open 64 sessions over 8 tenants, stream the schedule, enroll 5-way
    5-shot on tenant 0 after the first round, poll; returns every session's outputs.
    ``park_every`` > 0 parks a rotating fifth of the sessions every that
    many rounds and fills the freed slots with short-lived sessions, so
    parked sessions resume through evictions, in other slots."""
    import numpy as np

    sids = [svc.open_session(tenant=s % N_TENANTS)
            for s in range(audio.shape[0])]
    outs = {s: [] for s in range(audio.shape[0])}
    fillers = []
    for r, rnd in enumerate(schedule):
        if r == 1:
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


def phase_serve(cfg, dev, seed: int = 0, stream_len: int = STREAM_LEN,
                n_sessions: int = N_SLOTS):
    import numpy as np
    import torch
    from repro_torch.kernels.proto_extract import proto_extract
    from repro_torch.kernels.tcn_block import tcn_block
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
        tcn_block.launches = proto_extract.launches = 0
        main, polls = drive(svc, audio, schedule, shots)
        launches = tcn_block.launches
        if not quantize:
            result["launches"] = launches
        if launches == 0:
            raise AssertionError("serve: the main path launched no tcn_block")
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
            f"ticks, tcn_block launches={launches}, enrolled "
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
            result["tick_ms"] = time_ms(lambda: svc.push_audio(x), dev)
            log(f"timing push_audio tick ({n_sessions}x{T_CHUNK} samples, "
                f"end to end): ms={result['tick_ms']:.4f}")
            if dev.type == "cuda":
                profile_tick(lambda: svc.push_audio(x))
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

def main() -> int:
    import torch

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
    errs = phase_kernels(cfg, dev)
    tb_time, pe_time = phase_timings(cfg, dev)
    serve = phase_serve(cfg, dev)
    fsl = phase_fsl(cfg, dev)
    kernels = [
        {"name": "tcn_block", "route": "cuda",
         "source": "src/repro_torch/csrc/tcn_block.cu",
         "replaces": "src/repro/kernels/tcn_block.py:166",
         "launches": serve["launches"] + sum(c[1] for c in fsl.values()),
         "max_abs_err": errs["tcn_block"], **tb_time},
        {"name": "proto_extract", "route": "cuda",
         "source": "src/repro_torch/csrc/proto_extract.cu",
         "replaces": "src/repro/kernels/proto_extract.py:31",
         "launches": sum(c[0] for c in fsl.values()),
         "max_abs_err": errs["proto_extract"], **pe_time},
    ]
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
