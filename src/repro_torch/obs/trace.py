"""Chrome-trace / Perfetto span tracer of the services' calls.

The port of ``repro/obs/trace.py``, pure Python.  Records the layers of a
call as nested spans: the TCN service's push (packing, the slot FC rows,
each tick's dispatch with its upload, fused chunk, head, banked logits and
copies back, the results) and its enrollment (upload, embedder, bank
update, sync), with their counts as args; the LM's dispatch, prefill and
verify; which bind evicted which victim, park/resume and the plane's
batches.  Events are ring-buffered (the newest ``capacity`` win;
``dropped`` counts the rest) and exported as Trace Event Format JSON for
https://ui.perfetto.dev or chrome://tracing:

    from repro_torch.obs import trace
    with trace.call_scope(7):     # spans inside carry args call=7
        with trace.span("dispatch", cat="tcn", shape="T16", lanes=12) as sp:
            ...                   # complete event "X" with measured dur
            sp.set(bytes=4096)    # a count known only inside the span
    trace.instant("evict", sid=3)
    trace.counter("parking", parked=7, bound=16)
    trace.export("trace.json")

A service numbers its pushes and enrollments and opens each inside
``call_scope``, so the spans of one call share its ``call`` id; nesting is
by time on one thread.  While ``torch.profiler`` records, an enabled
tracer's span also opens ``record_function("repro_torch.<name>")`` for its
extent, so the span lands on the profiler's clock beside the ATen ops and
the device's kernels it launched; the span's own event keeps the
``time.perf_counter_ns`` clock.

A disabled tracer (the default) costs one attribute load and a truthiness
check per call: ``span()`` and ``call_scope()`` return a shared no-op
context manager, and no profiler range is opened.  The process-global
tracer is enabled by ``REPRO_TORCH_TRACE=/path/trace.json`` at import
time, with an export to that path at exit; services take a ``tracer=``
argument and default to the global one.  A span times the host: a span
that ends in a copy to the host (the TCN service's ``readback``, so its
``dispatch``) covers the device work queued before it too.
"""

from __future__ import annotations

import atexit
import json
import os
import sys
import threading
import time
from collections import deque

ENV_VAR = "REPRO_TORCH_TRACE"
PREFIX = "repro_torch."  # the profiler ranges' names: PREFIX + span name


def _profiling() -> bool:
    """Whether torch.profiler is recording.  Read without importing torch:
    a process that never loaded the profiler is not recording."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and prof._is_profiler_enabled


class _NullSpan:
    """Shared no-op context manager — the disabled tracer's span()."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args) -> None:
        pass


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "name", "cat", "args", "_t0", "_range")

    def __init__(self, tracer, name, cat, args):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args

    def set(self, **args) -> None:
        """Add counts known only inside the span to its args."""
        self.args.update(args)

    def __enter__(self):
        call = getattr(self._tracer._local, "call", None)
        if call is not None:
            self.args["call"] = call
        self._range = None
        if _profiling():
            from torch.autograd.profiler import record_function

            self._range = record_function(PREFIX + self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
        self._tracer._push({
            "name": self.name, "ph": "X", "cat": self.cat or "repro",
            "ts": self._t0 / 1e3, "dur": (t1 - self._t0) / 1e3,
            "pid": self._tracer.pid, "tid": self._tracer._tid(),
            "args": self.args})
        return False


class _CallScope:
    """Sets the thread's current call id for the spans opened inside."""

    __slots__ = ("_local", "_call", "_outer")

    def __init__(self, local, call):
        self._local = local
        self._call = call

    def __enter__(self):
        self._outer = getattr(self._local, "call", None)
        self._local.call = self._call
        return self

    def __exit__(self, *exc):
        self._local.call = self._outer
        return False


class Tracer:
    """Ring-buffered Trace Event Format recorder.

    ``ts``/``dur`` are microseconds on the ``time.perf_counter_ns`` clock
    (monotonic; one clock for every event, so spans nest correctly in the
    viewer).  Thread identity comes from ``threading.get_native_id``, so
    events of different threads land on separate rows."""

    def __init__(self, *, enabled: bool = False, capacity: int = 65536,
                 pid: int | None = None):
        self.enabled = enabled
        self.pid = os.getpid() if pid is None else pid
        self._events: deque = deque(maxlen=capacity)
        self.dropped = 0  # events that fell off the ring
        self._local = threading.local()  # .call, .tid of this thread

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def _tid(self) -> int:
        # a system call (~10 us in a sandboxed host): read once a thread
        tid = getattr(self._local, "tid", None)
        if tid is None:
            tid = self._local.tid = threading.get_native_id()
        return tid

    def _push(self, ev: dict) -> None:
        if len(self._events) == self._events.maxlen:
            self.dropped += 1
        self._events.append(ev)

    # -- recording ----------------------------------------------------------
    def span(self, name: str, cat: str = "", **args):
        """Context manager for a complete ("X") event: duration measured
        between __enter__ and __exit__."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, cat, args)

    def call_scope(self, call: int):
        """Context manager: the spans this thread opens inside it carry
        ``call`` in their args (a service's running number of the push or
        enrollment they belong to)."""
        if not self.enabled:
            return _NULL_SPAN
        return _CallScope(self._local, call)

    def instant(self, name: str, cat: str = "", **args) -> None:
        """Zero-duration marker ("i" event) — scheduler decisions (evict,
        retire, admit) that have a moment, not an extent."""
        if not self.enabled:
            return
        self._push({"name": name, "ph": "i", "s": "t",
                    "cat": cat or "repro", "ts": time.perf_counter_ns() / 1e3,
                    "pid": self.pid, "tid": self._tid(), "args": args})

    def counter(self, name: str, **values) -> None:
        """Chrome "C" counter event — renders as a stacked area track
        (e.g. bound vs parked session counts over the run)."""
        if not self.enabled:
            return
        self._push({"name": name, "ph": "C",
                    "ts": time.perf_counter_ns() / 1e3,
                    "pid": self.pid, "tid": self._tid(), "args": values})

    # -- export -------------------------------------------------------------
    def events(self) -> list[dict]:
        return list(self._events)

    def clear(self) -> None:
        self._events.clear()
        self.dropped = 0

    def export(self, path: str) -> str:
        """Write Trace Event Format JSON ({"traceEvents": [...]}) —
        loadable by Perfetto and chrome://tracing as-is."""
        doc = {"traceEvents": self.events(),
               "displayTimeUnit": "ms",
               "otherData": {"producer": "repro_torch.obs.trace",
                             "dropped_events": self.dropped}}
        with open(path, "w") as f:
            json.dump(doc, f)
        return path


# -- the process-global tracer ----------------------------------------------
# REPRO_TORCH_TRACE=path enables it at import time and exports on process
# exit; services default to this tracer, so the variable alone instruments
# a whole run.

TRACE_PATH = os.environ.get(ENV_VAR, "").strip()
trace = Tracer(enabled=bool(TRACE_PATH))

if TRACE_PATH:  # pragma: no cover
    atexit.register(lambda: trace.export(TRACE_PATH))


def get_tracer() -> Tracer:
    return trace
