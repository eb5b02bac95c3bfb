"""Reading a torch.profiler trace of the traced cycles.

The trace is exported in the Trace Event Format and reduced to intervals
(microseconds on one clock): the device's operations (kernels, copies,
sets), the host's CUDA runtime calls, its ATen ops and the benchmark's own
``bench.<kind>`` annotations around each call of the service
(bench/harness/driver.py ``Recorder.call``).
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")
CALL = "bench."


@dataclass
class Trace:
    device: list = field(default_factory=list)   # (name, t0, t1)
    runtime: list = field(default_factory=list)  # (name, t0, t1)
    host: list = field(default_factory=list)     # (name, t0, t1): ATen ops
    calls: dict = field(default_factory=dict)    # kind -> [(t0, t1)]

    @property
    def pushes(self) -> list:
        return self.calls.get("push", [])

    @property
    def enrolls(self) -> list:
        return self.calls.get("enroll", [])

    @property
    def window(self) -> tuple[float, float]:
        spans = [iv for ivs in self.calls.values() for iv in ivs]
        return min(a for a, _ in spans), max(b for _, b in spans)


def read(prof) -> Trace:
    """The intervals of a finished ``torch.profiler.profile``."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    tr = Trace()
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        iv = (e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            tr.device.append(iv)
        elif cat == "cuda_runtime" or cat == "cuda_driver":
            tr.runtime.append(iv)
        elif cat == "user_annotation" and e["name"].startswith(CALL):
            tr.calls.setdefault(e["name"][len(CALL):], []).append(iv[1:])
        elif cat == "cpu_op":
            tr.host.append(iv)
    for lst in [tr.device, tr.runtime, tr.host, *tr.calls.values()]:
        lst.sort(key=lambda iv: iv[-2])
    return tr


def union(intervals) -> list[tuple[float, float]]:
    """Merged, sorted (t0, t1) intervals."""
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def clip(intervals, spans) -> list[tuple[float, float]]:
    """The parts of ``intervals`` that lie inside any of ``spans``."""
    out = []
    for a, b in intervals:
        for s0, s1 in spans:
            lo, hi = max(a, s0), min(b, s1)
            if hi > lo:
                out.append((lo, hi))
    return out


def busy_us(tr: Trace, spans, name_has: str | None = None) -> float:
    """Microseconds in which a device operation (whose name contains
    ``name_has``, if given) ran inside ``spans``."""
    ivs = [(a, b) for n, a, b in tr.device
           if name_has is None or name_has in n]
    return sum(b - a for a, b in union(clip(ivs, spans)))


def count_in(events, spans, names) -> int:
    """Events named in ``names`` that start inside one of ``spans``."""
    return sum(1 for n, a, _ in events if n in names
               and any(s0 <= a < s1 for s0, s1 in spans))


def top_device_ops(tr: Trace, spans, n: int = 10) -> list:
    """[name, seconds] of the device operations that took most time inside
    ``spans``, summed by name."""
    tot: dict = {}
    for name, a, b in tr.device:
        for lo, hi in clip([(a, b)], spans):
            tot[name[:120]] = tot.get(name[:120], 0.0) + (hi - lo) * 1e-6
    return sorted(([k, v] for k, v in tot.items()), key=lambda kv: -kv[1])[:n]


def idle_gaps(tr: Trace, spans, n: int = 10) -> list:
    """[what the host was doing, seconds] summed over the gaps in which no
    device operation ran inside ``spans``: each gap is named by the
    innermost ATen op that holds its midpoint, or by the benchmark's call
    when the host ran Python between ops."""
    busy = union(clip([(a, b) for _, a, b in tr.device], spans))
    gaps = []
    for s0, s1 in spans:
        t = s0
        for a, b in busy:
            if b <= s0 or a >= s1:
                continue
            if a > t:
                gaps.append((0.5 * (t + a), a - t))
            t = max(t, b)
        if s1 > t:
            gaps.append((0.5 * (t + s1), s1 - t))
    # sweep the midpoints in time order with a stack of open host ops: the
    # top is the innermost op still running at the midpoint
    tot: dict = {}
    stack: list = []
    i = 0
    for mid, dur in sorted(gaps):
        while i < len(tr.host) and tr.host[i][1] <= mid:
            while stack and stack[-1][2] < tr.host[i][1]:
                stack.pop()
            stack.append(tr.host[i])
            i += 1
        while stack and stack[-1][2] < mid:
            stack.pop()
        name = stack[-1][0] if stack else "python (no ATen op)"
        tot[name] = tot.get(name, 0.0) + dur * 1e-6
    return sorted(([k, v] for k, v in tot.items()), key=lambda kv: -kv[1])[:n]
