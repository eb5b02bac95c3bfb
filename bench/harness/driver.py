"""One run of a cell: set-up, the measured window, the traced cycles and
the check.

The driver is one closed loop of cycles; the cell's traffic generator
(bench/harness/traffic.py) decides what a cycle calls, and every call goes
through the :class:`Recorder`, which times it and records what the check
needs.  The first ``warmup_cycles`` cycles belong to set-up: they use every
shape the window uses.  The window then runs cycles until ``seconds`` have
passed.  With ``trace``, ``trace_cycles`` cycles after the window's first
run under torch.profiler, and the service's tracer times its dispatch
spans in the others.
"""

from __future__ import annotations

import contextlib
import gc
import time
import traceback
from dataclasses import dataclass, field

import numpy as np
import torch

from bench.harness import check, profile
from bench.harness.loader import Cell, make_generator, metric_reader
from bench.harness.model import make_weights
from bench.reference import tcn as ref

SIZE_KEYS = ("tcn_kernel", "tcn_channels", "tcn_in_channels", "embed_dim",
             "n_classes", "act_scale")


@dataclass
class Result:
    correct: bool
    attempted: int
    failed: int
    metrics: dict
    device: dict
    checks: list                 # (name, value, limit)
    breakdown: dict | None = None
    notes: list = field(default_factory=list)   # lines for standard error


@dataclass
class MetricContext:
    """What a per-layer metric reads (bench/metrics/*.py)."""
    trace: profile.Trace | None
    sizes: dict
    ways: int             # banked logits a personalized step computes
    walls: dict           # kind -> seconds of the window's calls outside
                          # the profiler ("push", "enroll", ...)
    push_shapes: list     # (streams, steps, personalized) of each of those
                          # pushes, in order
    traced_push_shapes: list   # the same of each traced push
    enroll_shapes: list   # (shots, steps) of each untraced enrollment
    push_dispatch: list   # seconds of dispatch spans in each untraced push


def port_config(sizes: dict):
    """The program's preset named by the configuration file, which must
    carry the file's sizes."""
    from repro_torch.configs import get_config

    cfg = get_config(sizes["preset"])
    for key in SIZE_KEYS:
        have = getattr(cfg, key)
        have = list(have) if isinstance(have, tuple) else have
        if have != sizes[key]:
            raise ValueError(f"the program's {sizes['preset']} has {key}="
                             f"{have}, the configuration file {sizes[key]}")
    return cfg


class Recorder(check.Recording):
    """The calls of a generator, made on the service: each is timed (by
    kind, inside the window and outside the profiler), annotated for the
    profiler in the traced cycles, and recorded for the check."""

    def __init__(self, svc, gen, workload: dict, seed: int, dim: int,
                 tracer):
        super().__init__(gen, workload, seed, dim)
        self.svc, self.tracer = svc, tracer
        self.sids: dict = {}                  # stream -> session id
        self.prog = check.Outputs()
        self.enrolled: set = set()
        self.walls: dict = {}
        self.counts: dict = {}                # kind -> calls in the window
        self.push_shapes: list = []
        self.traced_push_shapes: list = []
        self.enroll_shapes: list = []
        self.dispatch: list = []
        self.steps_done = 0                   # stream-steps in the window
        self.timing = self.traced = False
        self._personal = np.array([gen.tenant_of(s) is not None
                                   for s in range(gen.sessions)], bool)

    def call(self, kind: str, fn, *args, **kwargs):
        """``fn(*args, **kwargs)``, timed as a call of ``kind``."""
        mark = torch.profiler.record_function(f"bench.{kind}") \
            if self.traced else contextlib.nullcontext()
        with mark:
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            dt = time.perf_counter() - t0
        if self.timing:
            self.counts[kind] = self.counts.get(kind, 0) + 1
            if not self.traced:
                self.walls.setdefault(kind, []).append(dt)
        return out

    def adopt(self, tenant: int, blob: dict) -> None:
        super().adopt(tenant, blob)
        self.svc.adopt_tenant(tenant, blob)

    def open(self, stream: int, tenant) -> None:
        self.sids[stream] = self.svc.open_session(tenant=tenant) \
            if tenant is not None else self.svc.open_session()

    def push(self, x: np.ndarray, streams=None):
        streams = range(len(x)) if streams is None else streams
        super().push(x, streams)
        chunks = {self.sids[s]: x[i] for i, s in enumerate(streams)}
        tracing = self.tracer.enabled
        if tracing:
            self.tracer.clear()
        out = self.call("push", self.svc.push_audio, chunks)
        if self.timing:
            self.steps_done += x.shape[0] * x.shape[1]
            shape = (x.shape[0], x.shape[1],
                     int(self._personal[np.asarray(streams)].sum()))
            if self.traced:
                self.traced_push_shapes.append(shape)
            else:
                self.push_shapes.append(shape)
                if tracing:
                    self.dispatch.append(1e-6 * sum(
                        e["dur"] for e in self.tracer.events()
                        if e["name"] == "dispatch"))
        for _, s in self.sampled(streams):
            r = out[self.sids[s]]
            self.prog.emb.setdefault(s, []).append(r["emb"])
            self.prog.logits.setdefault(s, []).append(r["logits"])
            if self.gen.tenant_of(s) is not None:
                self.prog.tenant_logits.setdefault(s, []).append(
                    r["tenant_logits"])
        return out

    def enroll(self, stream: int, label, shots: np.ndarray):
        super().enroll(stream, label, shots)
        way = self.call("enroll", self.svc.enroll_shots, self.sids[stream],
                        shots, label=label)
        if self.timing and not self.traced:
            self.enroll_shapes.append(shots.shape[:2])
        self.prog.ways.append(way)
        self.enrolled.add(self.gen.tenant_of(stream))
        return way


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, *, max_cycles: int | None = None) -> Result:
    from repro_torch.models.build import build_tcn_bundle
    from repro_torch.obs.trace import Tracer
    from repro_torch.sessions.service import StreamSessionService

    sizes, wl = cell.config, cell.workload
    geom = dict(wl["service"])
    cuda = torch.device(device).type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    notes: list = []

    # -- set-up ---------------------------------------------------------------
    marks = [("start", t_start), ("imports", time.perf_counter())]
    cfg = port_config(sizes)
    bundle = build_tcn_bundle(cfg, device)
    raw, bn = make_weights(sizes, seed, device)
    sync()
    marks.append(("weights", time.perf_counter()))
    gen = make_generator(cell, seed)
    marks.append(("traffic", time.perf_counter()))
    tracer = Tracer(enabled=False)
    svc = StreamSessionService(bundle, raw, bn, quantize=sizes["quantize"],
                               tracer=tracer, **geom)
    sync()
    marks.append(("service", time.perf_counter()))
    rec = Recorder(svc, gen, wl, seed, sizes["embed_dim"], tracer)
    gen.setup(rec)
    sync()
    marks.append(("tenants and sessions", time.perf_counter()))
    warm = int(wl["warmup_cycles"])
    for p in range(warm):
        gen.cycle(p, rec)
        sync()
        marks.append((f"warm-up cycle {p}", time.perf_counter()))
    notes.append("set-up s: " + ", ".join(
        f"{name} {b - a:.3f}" for (_, a), (name, b) in zip(marks, marks[1:])))

    # -- the window -------------------------------------------------------------
    traced = range(warm + 1, warm + 1 + int(wl["trace_cycles"])) if trace \
        else range(0)
    prof, profiling = None, False
    failed = 0
    setup_s = time.perf_counter() - t_start
    gc0 = [g["collections"] for g in gc.get_stats()]
    rec.timing = True
    w0 = time.perf_counter()
    p = warm
    try:
        while True:
            if p in traced and prof is None:
                from torch.profiler import ProfilerActivity
                acts = [ProfilerActivity.CPU] + \
                    ([ProfilerActivity.CUDA] if cuda else [])
                prof = torch.profiler.profile(activities=acts)
                prof.__enter__()
                profiling = True
                tracer.disable()
            elif trace and p not in traced:
                tracer.enable()
            rec.traced = p in traced
            gen.cycle(p, rec)
            if p in traced and p == traced[-1]:
                sync()
                prof.__exit__(None, None, None)
                profiling = False
            p += 1
            now = time.perf_counter()
            done = now - w0 >= seconds or \
                (max_cycles is not None and p - warm >= max_cycles)
            if done and p > (traced[-1] if traced else -1):
                break
    except Exception:  # the program failed a call: report, then judge
        failed += 1
        notes.append("a call failed in the window:\n" + traceback.format_exc())
        now = time.perf_counter()
        if profiling:
            prof.__exit__(None, None, None)
    window_s = now - w0
    rec.timing = rec.traced = False
    gcs = [g["collections"] - c for g, c in zip(gc.get_stats(), gc0)]
    tracer.disable()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    # -- the check, with the program's state freed ----------------------------
    inp, prog = rec.inp, rec.prog
    for t in sorted(rec.enrolled):
        if rec.is_checked(t):
            blob = svc.export_tenant(t)
            prog.banks[t] = {"s_sums": blob["s_sums"],
                             "counts": blob["counts"]}
    del svc, rec.svc
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    served = ref.prepare(raw, bn, len(sizes["tcn_channels"]),
                         quantize=sizes["quantize"])
    want = check.reference_outputs(inp, served, sizes,
                                   quantize=sizes["quantize"],
                                   precision="fp32", device=device,
                                   block=int(wl["reference_block"]))
    nums = check.compare(prog, want, inp.max_ways,
                         sizes["act_scale"] if sizes["quantize"] else None)
    ok, rows = check.judge(nums, wl["checks"])
    notes.append(f"numbers: {nums}")
    notes.append(f"reference and comparison: {time.perf_counter() - t0:.1f} s"
                 f" over {len(inp.x)} streams x {p} cycles and "
                 f"{len(inp.enrolls)} enrollments "
                 f"({sum(e[2] is not None for e in inp.enrolls)} replayed)")

    # -- metrics ------------------------------------------------------------------
    metrics: dict = {}
    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                "count": 1, "memory_peak_bytes": int(peak)}
    breakdown = None
    walls = rec.walls
    if not trace:
        e2e = {"steps_per_s": rec.steps_done / window_s
               if rec.steps_done else None,
               "push_p50_ms": _pct(walls.get("push"), 50),
               "enrolls_per_s": rec.counts.get("enroll", 0) / window_s
               if rec.counts.get("enroll") else None,
               "setup_s": setup_s}
        for m in cell.end_to_end:
            if e2e.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    elif prof is not None:
        tr = profile.read(prof)
        a, b = tr.window
        spans = [(a, b)]
        dev_info["busy_s"] = profile.busy_us(tr, spans) * 1e-6
        dev_info["window_s"] = (b - a) * 1e-6
        breakdown = {"device_ops": profile.top_device_ops(tr, spans),
                     "idle_gaps": profile.idle_gaps(tr, spans)}
        ctx = MetricContext(trace=tr, sizes=sizes,
                            ways=geom.get("max_ways", 0), walls=walls,
                            push_shapes=rec.push_shapes,
                            traced_push_shapes=rec.traced_push_shapes,
                            enroll_shapes=rec.enroll_shapes,
                            push_dispatch=rec.dispatch)
        for m in cell.per_layer:
            v = metric_reader(cell, m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    notes.append(f"window: {window_s:.3f} s, {p - warm} cycles, calls "
                 f"{rec.counts}; set-up {setup_s:.3f} s")
    for kind, ws in walls.items():
        notes.append(f"{kind} ms: " + " ".join(f"{w * 1e3:.2f}" for w in
                                               ws[:400]))
    notes.append(f"garbage collections in the window, by generation: {gcs}")
    attempted = sum(rec.counts.values()) + failed
    return Result(correct=ok and failed == 0, attempted=attempted,
                  failed=failed, metrics=metrics, device=dev_info,
                  checks=rows, breakdown=breakdown, notes=notes)


def _pct(xs, q: float):
    return float(np.percentile(np.asarray(xs) * 1e3, q)) if xs else None
