"""Deterministic fault injection for the serving plane.

The port of ``repro/serving/faults.py``, pure Python: for the same spec or
seed, ``FaultPlan.parse``/``seeded`` give the reference's events.  A
``FaultPlan`` is a seeded, fully deterministic
schedule of faults indexed by per-worker protocol-verb invocation count
(NOT wall clock — the chaos suite's assertions must be independent of
event-loop interleaving), and a ``FaultInjector`` wraps any
``SessionService`` to act it out:

    crash   the worker process "dies": the wrapped service is swapped for
            a FRESH one from the factory (every slot column, block table,
            tenant bank, and rehearsal buffer is gone; on the card the
            dead service's tensors are released with it) and
            ``WorkerCrashed`` propagates to the plane, which recovers the
            worker from its last spill epoch (serving/plane.py).
    slow    the verb stalls for a fixed interval before executing —
            deadline-enforcement fuel.
    storm   ``open_session`` raises ``PoolExhausted`` for a span of ops
            (admission back-pressure storm); other verbs pass through.
    flake   one ``push``/``enroll`` raises ``TransientError`` BEFORE any
            state advances — an honest retryable failure.

Plan spec format (``FaultPlan.parse``), comma-separated events::

    crash@40            crash on the 40th verb invocation (0-based)
    slow@10x5:0.002     stall 2ms on ops [10, 15)
    storm@60x20         PoolExhausted opens on ops [60, 80)
    flake@25            TransientError on op 25 (push/enroll only)

``FaultPlan.seeded(seed, horizon, ...)`` draws a jittered periodic
schedule from rates — same seed, same plan, byte for byte.

Activation is config-level: ``RuntimeConfig(chaos="crash@40,...")`` (env
``REPRO_TORCH_CHAOS``) makes ``ServingPlane`` wrap its workers itself; with the
field unset no injector exists anywhere on the call path — production is
untouched by construction, not by an ``if`` per verb.
"""

from __future__ import annotations

import random
import re
import time
from dataclasses import dataclass
from typing import Callable

from repro_torch.configs.runtime import ENV_CHAOS
from repro_torch.sessions.paging import PoolExhausted

ENV_VAR = ENV_CHAOS


class WorkerCrashed(RuntimeError):
    """The worker's in-memory state is GONE (simulated process death).
    The plane must not retry against the fresh service — every session it
    held has to be re-adopted from the last spill epoch first."""


class TransientError(RuntimeError):
    """A one-shot failure that did NOT advance any state; safe to retry
    verbatim (surfaced to clients as ``Rejected(reason="transient")``)."""


_EVENT_RE = re.compile(
    r"^(?P<kind>crash|slow|storm|flake)@(?P<at>\d+)"
    r"(?:x(?P<span>\d+))?(?::(?P<seconds>[0-9.]+))?$")


@dataclass(frozen=True)
class FaultEvent:
    at: int              # 0-based verb-invocation index on the worker
    kind: str            # crash | slow | storm | flake
    span: int = 1        # ops covered: [at, at + span)
    seconds: float = 0.0  # slow: injected stall per op

    def active(self, i: int) -> bool:
        return self.at <= i < self.at + self.span

    def spec(self) -> str:
        s = f"{self.kind}@{self.at}"
        if self.span != 1:
            s += f"x{self.span}"
        if self.seconds:
            s += f":{self.seconds:g}"
        return s


class FaultPlan:
    """An immutable, order-normalized schedule of ``FaultEvent``s."""

    def __init__(self, events=()):
        self.events = tuple(sorted(events, key=lambda e: (e.at, e.kind)))
        self._horizon = max((e.at + e.span for e in self.events), default=0)

    def __bool__(self) -> bool:
        return bool(self.events)

    def __eq__(self, other) -> bool:
        return isinstance(other, FaultPlan) and self.events == other.events

    def __repr__(self) -> str:
        return f"FaultPlan({self.spec()!r})"

    def spec(self) -> str:
        """Round-trips through ``parse``, so a printed plan reproduces a
        failure."""
        return ",".join(e.spec() for e in self.events)

    def at(self, i: int) -> list[FaultEvent]:
        if i >= self._horizon:
            return []
        return [e for e in self.events if e.active(i)]

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        events = []
        for part in filter(None, (p.strip() for p in spec.split(","))):
            m = _EVENT_RE.match(part)
            if m is None:
                raise ValueError(
                    f"bad fault event {part!r}; expected "
                    "kind@at[xspan][:seconds] with kind in "
                    "crash|slow|storm|flake")
            events.append(FaultEvent(
                at=int(m["at"]), kind=m["kind"],
                span=int(m["span"] or 1),
                seconds=float(m["seconds"] or 0.0)))
        return cls(events)

    @classmethod
    def seeded(cls, seed: int, horizon: int, *, crash_every: int = 0,
               slow_every: int = 0, slow_s: float = 0.002,
               storm_every: int = 0, storm_span: int = 8,
               flake_every: int = 0) -> "FaultPlan":
        """Jittered-periodic schedule over ``horizon`` ops: each enabled
        kind fires roughly every N ops, with the phase drawn from a
        seeded RNG (uniform over the period) so plans differ across
        workers/seeds but are bit-reproducible for a given seed."""
        rng = random.Random(seed)
        events = []

        def lay(kind, every, **kw):
            if not every:
                return
            start = rng.randrange(max(1, every))
            for base in range(start, horizon, every):
                at = base + rng.randrange(max(1, every // 4 + 1))
                if at < horizon:
                    events.append(FaultEvent(at=at, kind=kind, **kw))

        lay("crash", crash_every)
        lay("slow", slow_every, seconds=slow_s)
        lay("storm", storm_every, span=storm_span)
        lay("flake", flake_every)
        return cls(events)


class FaultInjector:
    """Wrap a ``SessionService`` and act out a ``FaultPlan``.

    Only the protocol verbs are intercepted and counted; every other
    attribute (``n_slots``, ``stats``, the handoff/journal hooks the
    plane itself drives — ``export_session``, ``adopt_session``, ...)
    delegates straight to the wrapped service, so the plane's OWN
    recovery machinery can never trip a fault while repairing one.

    A crash swaps in ``factory()`` — a fresh service with the same
    geometry — and raises ``WorkerCrashed`` before any delegation, so the
    fault is atomic: an op either fully happened or not at all.
    """

    VERBS = ("open_session", "push", "enroll", "park", "resume",
             "close", "poll")

    def __init__(self, service=None, plan: FaultPlan | None = None, *,
                 factory: Callable[[], object] | None = None,
                 sleep: Callable[[float], None] = time.sleep):
        if service is None:
            if factory is None:
                raise ValueError("need a service or a factory")
            service = factory()
        plan = plan or FaultPlan()
        if any(e.kind == "crash" for e in plan.events) and factory is None:
            raise ValueError(
                "plan injects crashes but no factory= was given to rebuild "
                "the worker's service; crash recovery needs one")
        self.service = service
        self.plan = plan
        self.factory = factory
        self._sleep = sleep
        self.ops = 0          # verb invocations seen (the plan's clock)
        self.crashes = 0
        self.faults: list[tuple[int, str]] = []  # (op index, kind) fired

    # -- the faulting gate --------------------------------------------------
    def _gate(self, verb: str) -> None:
        i = self.ops
        self.ops += 1
        for ev in self.plan.at(i):
            if ev.kind == "slow":
                self.faults.append((i, "slow"))
                self._sleep(ev.seconds)
            elif ev.kind == "crash":
                self.faults.append((i, "crash"))
                self.crashes += 1
                self.service = self.factory()
                raise WorkerCrashed(
                    f"injected crash at op {i} ({verb}); in-memory state "
                    "dropped")
            elif ev.kind == "storm" and verb == "open_session":
                self.faults.append((i, "storm"))
                raise PoolExhausted(
                    f"injected admission storm at op {i}")
            elif ev.kind == "flake" and verb in ("push", "enroll"):
                self.faults.append((i, "flake"))
                raise TransientError(
                    f"injected transient failure at op {i} ({verb})")

    # -- counted protocol verbs --------------------------------------------
    def open_session(self, *a, **kw):
        self._gate("open_session")
        return self.service.open_session(*a, **kw)

    def push(self, *a, **kw):
        self._gate("push")
        return self.service.push(*a, **kw)

    def enroll(self, *a, **kw):
        self._gate("enroll")
        return self.service.enroll(*a, **kw)

    def park(self, *a, **kw):
        self._gate("park")
        return self.service.park(*a, **kw)

    def resume(self, *a, **kw):
        self._gate("resume")
        return self.service.resume(*a, **kw)

    def close(self, *a, **kw):
        self._gate("close")
        return self.service.close(*a, **kw)

    def poll(self, *a, **kw):
        self._gate("poll")
        return self.service.poll(*a, **kw)

    # -- everything else is the wrapped service -----------------------------
    def __getattr__(self, name):
        return getattr(self.service, name)
