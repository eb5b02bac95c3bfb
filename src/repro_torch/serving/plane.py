"""Async continuous-batching request plane over SessionService workers.

The port of ``repro/serving/plane.py``, pure Python over the port's
session services.  ``ServingPlane`` is an asyncio facade that accepts
ragged per-session pushes, accumulates whatever arrived while the grid
was busy into the next continuous batch, and drives one or more
slot-grid workers (any ``sessions.SessionService``) with tenant-affinity
routing.

Bit-identity contract
---------------------
The plane NEVER changes what a session computes — only when its work is
grouped with other sessions' work.  This rides directly on the services'
chunk-invariance guarantee: absent lanes in a ``push`` dispatch stay
bit-frozen and every lane's computation depends only on its own state
and payload, so ``push({a: wa, b: wb})`` gives each of a and b exactly
the bits of ``push({a: wa})`` / ``push({b: wb})`` run alone.  On the card
this needs each row's bits to be independent of its slot, of which lanes
are masked and of the service instance, which the port's fixed-order
contractions give; chip_smoke.py's plane phase holds it end to end
against a synchronous control replay.

Concurrency model
-----------------
One asyncio worker task per service owns ALL mutation of that service —
there are no locks because there is no cross-task sharing.  A dispatch
runs synchronously inside the worker task: ``push_audio`` returns host
arrays, so every dispatch synchronizes with the card there, and no thread
or stream of the plane's own touches the card.  Each
cycle the worker takes the longest FIFO prefix of its queue that fits
one grid dispatch: control ops (open/enroll/park/resume/close/poll)
execute inline — admission and bank updates happen BETWEEN chunk
dispatches, never inside one —
and pushes accumulate into a ragged batch, cut at the first op that
cannot join (duplicate session in batch, or batch already n_slots wide).
Strict-prefix cutting makes ordering per worker global-FIFO, which is
stronger than the per-session FIFO clients rely on.

Back-pressure
-------------
Bounded resources surface as ``Rejected`` (retryable) instead of
unbounded queueing: a full per-worker op queue (``reason="queue_full"``),
service admission failure — ``AdmissionError`` / ``PoolExhausted``
(``reason="admission"``, original exception chained) — and, with
deadlines enabled, ops that expired while queued (``reason="deadline"``).
Every retryable rejection carries a ``retry_after`` hint derived from the
worker's queue depth and an EMA of its per-op service time, so clients
back off proportionally to actual congestion instead of blindly.

Fault tolerance
---------------
Workers move through an explicit health state machine, exported as the
``plane_worker_health`` gauge::

    healthy ──drain()──> draining ──> drained ──undrain()──> healthy
       │
       └─WorkerCrashed─> crashed ──recover()──> recovering ──> healthy

*Spill journal.*  With ``checkpoint_every=1`` the plane snapshots every
session it touched after each completed op (``export_session`` — the
park/spill pack path, so snapshots are bit-exact; on the card one
device-to-host copy per ring leaf, and a host-to-device copy when the
session binds again) plus the owning
tenant's bank/rehearsal state after each enroll.  A completed op is
journaled before the worker can execute the next one, so the journal
always equals the state clients have observed: an op that dies with the
worker was never acknowledged, its retry replays from the journaled
pre-op state, and the retried stream is bit-identical.  Larger values
trade journal traffic for a bounded loss window; ``0`` (default)
disables journaling entirely.

*Crash / recover.*  ``WorkerCrashed`` (serving/faults.py) marks the
worker crashed, fails everything queued with retryable
``Rejected(reason="crash")``, and — by default — schedules ``recover``:
adopt the worker's journaled tenants, then its journaled sessions, onto
the replacement service, rebuild the plane registry, and record MTTR in
the ``plane_mttr_us`` histogram.  Sessions with no spill epoch are
counted in ``lost_sessions`` (zero under ``checkpoint_every=1`` — the
chaos suite's ratchet).

*Drain / handoff.*  ``drain(worker)`` stops new ops (retryable
``Rejected(reason="draining")``), lets the accepted queue finish, then
migrates every owned session AND every tenant's learned state (prototype
banks, label registry, rehearsal reservoirs) to healthy peers via
``detach_session``/``export_tenant`` → ``adopt_*``.  The plane registry
is updated in the same step, so ``resume``/``push`` on a handed-off
session land on the new worker — handoff and resume compose.

*Work stealing.*  With ``steal_threshold=N``, a worker whose queue runs
N ops deeper than the coldest healthy peer sheds sessions that have no
queued ops (whole tenant groups only, so banks never split) to the
peers.

Faults are injected — never emergent — via serving/faults.py, activated
by ``RuntimeConfig(chaos=...)`` / ``REPRO_TORCH_CHAOS``; with the field
unset no injector exists on the call path.  Routing hashes a tenant with
crc32 over the healthy workers, as the reference does, so a tenant lands
on the same worker index in both packages.  The plane reports to the
port's process-default registry unless ``metrics=`` is given.
"""

from __future__ import annotations

import asyncio
import math
import random
import time
import zlib
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable

from repro_torch.configs.runtime import RuntimeConfig
from repro_torch.obs import default_registry, get_tracer
from repro_torch.serving.faults import (FaultInjector, FaultPlan,
                                        TransientError, WorkerCrashed)
from repro_torch.sessions import AdmissionError, SessionService

__all__ = ["Rejected", "RetryPolicy", "ServingPlane",
           "HEALTHY", "DRAINING", "DRAINED", "CRASHED", "RECOVERING"]

# worker health states (gauge codes in _HEALTH_CODE)
HEALTHY = "healthy"
DRAINING = "draining"
DRAINED = "drained"
CRASHED = "crashed"
RECOVERING = "recovering"
_HEALTH_CODE = {HEALTHY: 0, DRAINING: 1, DRAINED: 2, CRASHED: 3,
                RECOVERING: 4}

_REJECT_REASONS = ("queue_full", "admission", "deadline", "crash",
                   "draining", "transient", "no_worker")


class Rejected(RuntimeError):
    """A request the plane refused under load or failure.  ``retryable``
    is True for transient conditions (full queue, admission
    back-pressure, expired deadline, crashed/draining worker, transient
    worker fault): retry with backoff.  ``reason`` is a stable label
    ("queue_full" | "admission" | "deadline" | "crash" | "draining" |
    "transient" | "no_worker" | "closed").  ``retry_after`` (seconds),
    when set, is the plane's congestion-derived hint for the MINIMUM
    useful backoff — ``RetryPolicy.delay`` honors it."""

    def __init__(self, msg: str, *, reason: str, retryable: bool = True,
                 retry_after: float | None = None):
        super().__init__(msg)
        self.reason = reason
        self.retryable = retryable
        self.retry_after = retry_after


@dataclass
class RetryPolicy:
    """Seeded exponential backoff with jitter, floored by the server's
    ``retry_after`` hint — THE retry discipline for plane clients.
    Deterministic for a given seed, like every other component."""

    base_s: float = 0.0002
    cap_s: float = 0.05
    factor: float = 2.0
    jitter: float = 0.5     # +- fraction of the computed delay
    seed: int = 0

    def __post_init__(self) -> None:
        self._rng = random.Random(self.seed)

    def delay(self, attempt: int, retry_after: float | None = None) -> float:
        """Backoff before retry number ``attempt`` (0-based).  A server
        ``retry_after`` hint acts as a floor: backing off less than the
        server's own congestion estimate just re-feeds the storm."""
        d = min(self.cap_s, self.base_s * self.factor ** attempt)
        d *= 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        if retry_after is not None:
            d = max(d, retry_after)
        return d

    async def sleep(self, attempt: int,
                    retry_after: float | None = None) -> None:
        await asyncio.sleep(self.delay(attempt, retry_after))


@dataclass
class _Op:
    kind: str          # open | push | enroll | park | resume | close | poll
    fut: asyncio.Future
    sid: int | None = None       # worker-local sid (None for open)
    psid: int | None = None      # plane-level sid (known for every kind)
    work: Any = None             # push payload / enroll shots
    args: tuple = ()             # open_session positional args
    kwargs: dict = field(default_factory=dict)
    deadline: float | None = None  # absolute monotonic; checked at dequeue


class _Worker:
    """One service + its op queue + the task that owns both."""

    def __init__(self, idx: int, service: SessionService, max_queue: int):
        self.idx = idx
        self.service = service
        self.max_queue = max_queue
        self.queue: deque[_Op] = deque()
        self.wake = asyncio.Event()
        self.task: asyncio.Task | None = None
        self.live = 0  # plane-tracked open sessions (routing load signal)
        self.health = HEALTHY
        self.psid_of: dict[int, int] = {}  # local sid -> plane sid
        self.crashed_at: float | None = None
        self.ema_op_s = 1e-3       # EMA of per-op service time (retry hints)
        self.dirty: set[int] = set()          # psids awaiting a journal epoch
        self.dirty_tenants: set[int] = set()  # service tids awaiting one
        self.ops_since_ckpt = 0
        self.steal_pending = False

    @property
    def load(self) -> int:
        return len(self.queue) + self.live


class ServingPlane:
    """Asyncio front-end multiplexing sessions over SessionService workers.

    ::

        plane = ServingPlane([svc_a, svc_b])
        async with plane:
            psid = await plane.open_session(prompt, tenant="alice")
            toks = await plane.push(psid, 4)      # payload per service kind
            await plane.close(psid)

    Session ids returned here (``psid``) are plane-level: the plane maps
    them to (worker, local sid) internally, so two workers can hand out
    colliding local ids safely — and so sessions can MOVE between
    workers (drain handoff, work stealing, crash recovery) without
    clients noticing.  ``tenant=`` pins a tenant's sessions to one
    worker (stable crc32 hash over the currently-healthy workers) so
    per-tenant state — prototype banks, CoW prefix blocks — stays where
    it is warm; tenantless sessions go to the least-loaded worker.

    Fault-tolerance knobs (all off by default; see module docstring):
    ``checkpoint_every`` enables the spill journal (1 = exact recovery),
    ``default_deadline_s`` bounds queue wait per op, ``steal_threshold``
    enables work stealing, ``auto_recover`` controls whether a crashed
    worker is rebuilt immediately, and ``worker_factory`` supplies fresh
    services when ``runtime.chaos`` wraps the workers in FaultInjectors.
    """

    def __init__(self, workers: list[SessionService] | SessionService, *,
                 max_queue: int = 1024, runtime: RuntimeConfig | None = None,
                 metrics=None, tracer=None, checkpoint_every: int = 0,
                 default_deadline_s: float | None = None,
                 steal_threshold: int = 0, auto_recover: bool = True,
                 worker_factory: Callable[[], SessionService] | None = None):
        if not isinstance(workers, (list, tuple)):
            workers = [workers]
        if not workers:
            raise ValueError("ServingPlane needs at least one worker")
        self.runtime = runtime if runtime is not None else RuntimeConfig.resolve()
        self.workers = [_Worker(i, svc, max_queue)
                        for i, svc in enumerate(workers)]
        if self.runtime.chaos:
            # config-level activation: wrap each worker in a FaultInjector
            # acting out the plan.  Workers already wrapped (a test built
            # its own injectors) are left alone.
            plan = FaultPlan.parse(self.runtime.chaos)
            for w in self.workers:
                if not isinstance(w.service, FaultInjector):
                    w.service = FaultInjector(w.service, plan,
                                              factory=worker_factory)
        self.checkpoint_every = int(checkpoint_every)
        self.default_deadline_s = default_deadline_s
        self.steal_threshold = int(steal_threshold)
        self.auto_recover = bool(auto_recover)
        self.metrics_registry = metrics if metrics is not None \
            else default_registry()
        self.tracer = tracer if tracer is not None else get_tracer()
        reg = self.metrics_registry
        self._c_batches = reg.counter("plane_batches_total")
        self._c_enrolls = reg.counter("plane_enrolls_total")
        self._c_rejected = {r: reg.counter("plane_rejected_total", reason=r)
                            for r in _REJECT_REASONS}
        self._c_crashes = reg.counter("plane_crashes_total")
        self._c_recoveries = reg.counter("plane_recoveries_total")
        self._c_handoffs = reg.counter("plane_handoffs_total")
        self._c_steals = reg.counter("plane_steals_total")
        self._h_mttr = reg.histogram("plane_mttr_us")
        self._h_lanes = reg.histogram("plane_batch_lanes")
        self._g_depth = [reg.gauge("plane_queue_depth", worker=str(w.idx))
                         for w in self.workers]
        self._g_health = [reg.gauge("plane_worker_health", worker=str(w.idx))
                          for w in self.workers]
        self._sessions: dict[int, tuple[_Worker, int]] = {}  # psid -> (w, sid)
        self._next_psid = 0
        self._running = False
        # fault-tolerance state: the per-session spill journal, the
        # per-(worker, service tid) tenant-state journal, and explicit
        # tenant -> worker pins created by handoffs (consulted by _route
        # before the affinity hash, so moved tenants stay moved)
        self._journal: dict[int, dict] = {}
        self._tenant_journal: dict[tuple[int, int], dict] = {}
        self._tenant_home: dict[Any, int] = {}
        self._lost = 0

    # -- lifecycle -----------------------------------------------------------
    async def __aenter__(self) -> "ServingPlane":
        self.start()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.aclose()

    def start(self) -> None:
        if self._running:
            return
        self._running = True
        for w in self.workers:
            w.task = asyncio.ensure_future(self._run_worker(w))

    async def aclose(self) -> None:
        """Stop the workers.  Queued ops are failed with a non-retryable
        ``Rejected`` rather than silently dropped."""
        if not self._running:
            return
        self._running = False
        for w in self.workers:
            w.wake.set()
        await asyncio.gather(*(w.task for w in self.workers if w.task),
                             return_exceptions=True)
        for w in self.workers:
            while w.queue:
                op = w.queue.popleft()
                if not op.fut.done():
                    op.fut.set_exception(Rejected(
                        "plane closed", reason="closed", retryable=False))
        if self.runtime.trace_path:
            self.tracer.export(self.runtime.trace_path)

    # -- public async surface ------------------------------------------------
    async def open_session(self, *args, tenant=None,
                           deadline_s: float | None = None, **kwargs) -> int:
        """Admit a session; returns a plane-level session id.  Raises
        ``Rejected(retryable=True)`` when the target worker's queue is full
        or its service refuses admission (``AdmissionError`` — including
        ``PoolExhausted`` under the paged layout).

        ``tenant`` picks the worker (stable affinity hash over healthy
        workers, overridden by handoff pins), and for tenant-aware
        services (``service.tenant_aware``, e.g. the TCN slot grid's
        per-tenant prototype banks) it is ALSO forwarded to
        ``open_session`` so the session binds to that tenant's bank —
        every later ``enroll``/``push`` then lands on the worker holding
        the tenant's rows.  For affinity-only services (LM) it routes
        without being forwarded."""
        w = self._route(tenant)
        if tenant is not None and getattr(w.service, "tenant_aware", False):
            kwargs = {**kwargs, "tenant": tenant}
            # the tenant's state will live on w: pin it there, so a later
            # change of the healthy set cannot route its next session to a
            # worker without its bank (handoffs move the pin with the state)
            self._tenant_home.setdefault(tenant, w.idx)
        psid = self._next_psid
        self._next_psid += 1
        op = _Op("open", self._fut(), psid=psid, args=args, kwargs=kwargs)
        self._enqueue(w, op, deadline_s)
        return await op.fut

    async def push(self, psid: int, work, *,
                   deadline_s: float | None = None) -> Any:
        """Advance one session by one service-specific work item (TCN: an
        audio chunk; LM: a token budget).  The plane groups concurrent
        pushes into one grid dispatch; the result is bit-identical to
        pushing alone."""
        w, sid = self._lookup(psid)
        op = _Op("push", self._fut(), sid=sid, psid=psid, work=work)
        self._enqueue(w, op, deadline_s)
        return await op.fut

    async def enroll(self, psid: int, shots, *,
                     deadline_s: float | None = None, **kwargs) -> int:
        """Streaming enrollment: fold shots into the session's tenant bank
        (sessions.SessionService.enroll).  Tenant affinity is free — the
        session already lives on its tenant's worker, so the bank update
        lands where the rows are warm.  Ordered FIFO with the session's
        pushes: a push enqueued after an enroll classifies against the
        updated bank."""
        w, sid = self._lookup(psid)
        op = _Op("enroll", self._fut(), sid=sid, psid=psid, work=shots,
                 kwargs=kwargs)
        self._enqueue(w, op, deadline_s)
        self._c_enrolls.inc()
        return await op.fut

    async def park(self, psid: int) -> None:
        await self._control(psid, "park")

    async def resume(self, psid: int) -> None:
        """Bind a parked session back onto a slot.  Composes with
        handoff: the registry tracks each session's CURRENT worker, and
        a session whose worker crashed before recovery ran is re-homed
        from its last spill epoch onto a healthy peer first."""
        w, _ = self._lookup(psid)
        if w.health in (CRASHED, RECOVERING):
            self._rehome(psid)
        await self._control(psid, "resume")

    async def poll(self, psid: int) -> dict:
        return await self._control(psid, "poll")

    async def close(self, psid: int) -> None:
        return await self._control(psid, "close")

    # -- worker lifecycle ----------------------------------------------------
    def undrain(self, worker: int) -> None:
        """Return a drained worker to rotation (rolling-restart exit)."""
        w = self.workers[worker]
        if w.health != DRAINED:
            raise RuntimeError(f"worker {worker} is {w.health}, not drained")
        self._set_health(w, HEALTHY)
        w.wake.set()

    async def drain(self, worker: int) -> dict:
        """Gracefully take a worker out of rotation: stop accepting ops
        (new ones get retryable ``Rejected(reason="draining")``), finish
        everything already queued, then hand EVERY owned session — and
        every tenant's learned state — to healthy peers.  Clients keep
        their psids; the registry re-points them.  Returns a summary
        dict.  Raises if no healthy peer exists or peer capacity cannot
        take the load (the worker returns to healthy in that case)."""
        w = self.workers[worker]
        if w.health != HEALTHY:
            raise RuntimeError(f"worker {worker} is {w.health}; only a "
                               "healthy worker can drain")
        if not any(p.health == HEALTHY for p in self.workers if p is not w):
            raise RuntimeError("no healthy peer to drain to")
        self._set_health(w, DRAINING)
        try:
            while w.queue:          # accepted ops finish normally
                w.wake.set()
                await asyncio.sleep(0)
            if w.health != DRAINING:
                raise RuntimeError(f"worker {worker} crashed while draining")
            extra = list(w.service.live_tenants()) \
                if getattr(w.service, "tenant_aware", False) else []
            n_sess, n_ten = self._migrate(w, sorted(w.psid_of.values()),
                                          extra_tenants=extra)
            self._c_handoffs.inc(n_sess)
        except BaseException:
            if w.health == DRAINING:
                self._set_health(w, HEALTHY)
                w.wake.set()
            raise
        self._set_health(w, DRAINED)
        return {"worker": worker, "moved_sessions": n_sess,
                "moved_tenants": n_ten}

    async def recover(self, worker: int) -> dict:
        """Rebuild a crashed worker from the spill journal: adopt its
        journaled tenants, then its journaled sessions, onto the
        replacement service and re-point the registry.  Sessions without
        a spill epoch are dropped and counted in ``lost_sessions`` (zero
        when ``checkpoint_every=1``).  Runs automatically on crash unless
        ``auto_recover=False``.  Records MTTR in ``plane_mttr_us``."""
        w = self.workers[worker]
        if w.health != CRASHED:
            return {"worker": worker, "recovered": 0, "lost": 0,
                    "skipped": f"worker is {w.health}"}
        self._set_health(w, RECOVERING)
        svc = w.service          # the fresh replacement service
        for (wi, tid), blob in sorted(self._tenant_journal.items()):
            if wi == w.idx:
                svc.adopt_tenant(tid, blob)
        w.psid_of.clear()
        mine = sorted(psid for psid, (ww, _) in self._sessions.items()
                      if ww is w)
        recovered = lost = 0
        for psid in mine:
            ent = self._journal.get(psid)
            if ent is None:
                self._sessions.pop(psid)
                lost += 1
                continue
            sid = svc.adopt_session(ent["blob"], ent["meta"])
            self._sessions[psid] = (w, sid)
            w.psid_of[sid] = psid
            recovered += 1
        w.live = recovered
        self._lost += lost
        self._set_health(w, HEALTHY)
        mttr = time.monotonic() - (w.crashed_at or time.monotonic())
        w.crashed_at = None
        self._h_mttr.record(mttr * 1e6)
        self._c_recoveries.inc()
        w.wake.set()
        return {"worker": worker, "recovered": recovered, "lost": lost,
                "mttr_s": mttr}

    # -- sync introspection --------------------------------------------------
    def metrics(self) -> dict:
        return self.metrics_registry.snapshot()

    def stats(self) -> dict:
        return {"n_workers": len(self.workers),
                "live_sessions": len(self._sessions),
                "queue_depths": [len(w.queue) for w in self.workers],
                "health": [w.health for w in self.workers],
                "lost_sessions": self._lost,
                "journal_sessions": len(self._journal),
                "workers": [w.service.stats() for w in self.workers]}

    # -- internals -----------------------------------------------------------
    def _fut(self) -> asyncio.Future:
        return asyncio.get_running_loop().create_future()

    def _lookup(self, psid: int) -> tuple[_Worker, int]:
        try:
            return self._sessions[psid]
        except KeyError:
            raise KeyError(f"unknown plane session {psid}") from None

    def _set_health(self, w: _Worker, health: str) -> None:
        w.health = health
        self._g_health[w.idx].set(_HEALTH_CODE[health])

    def _retry_hint(self, w: _Worker) -> float:
        """Congestion-derived backoff floor: what the worker's current
        queue will take to clear at its recent per-op pace."""
        return min(1.0, max(1e-3, len(w.queue) * w.ema_op_s))

    def _reject(self, reason: str, msg: str, *, retryable: bool = True,
                retry_after: float | None = None,
                cause: BaseException | None = None) -> Rejected:
        if reason in self._c_rejected:
            self._c_rejected[reason].inc()
        rej = Rejected(msg, reason=reason, retryable=retryable,
                       retry_after=retry_after)
        if cause is not None:
            rej.__cause__ = cause
        return rej

    def _route(self, tenant) -> _Worker:
        home = self._tenant_home.get(tenant) if tenant is not None else None
        if home is not None and getattr(self.workers[home].service,
                                        "tenant_aware", False):
            # the worker holding the tenant's state, healthy or not: an
            # unhealthy one makes _enqueue reject retryably (the reference
            # re-hashes over the healthy workers here, and an open there
            # claims an empty row for a tenant whose bank is elsewhere)
            return self.workers[home]
        healthy = [w for w in self.workers if w.health == HEALTHY]
        if not healthy:
            raise self._reject("no_worker", "no healthy worker available",
                               retry_after=0.01)
        if tenant is not None:
            if home is not None and self.workers[home].health == HEALTHY:
                return self.workers[home]
            # stable across processes (hash() is salted; crc32 is not)
            h = zlib.crc32(str(tenant).encode())
            return healthy[h % len(healthy)]
        return min(healthy, key=lambda w: w.load)

    def _enqueue(self, w: _Worker, op: _Op,
                 deadline_s: float | None = None) -> None:
        if not self._running:
            raise Rejected("plane is not running", reason="closed",
                           retryable=False)
        if w.health != HEALTHY:
            if w.health in (CRASHED, RECOVERING):
                raise self._reject(
                    "crash", f"worker {w.idx} crashed; recovering from "
                    "last spill epoch", retry_after=self._retry_hint(w))
            raise self._reject(
                "draining", f"worker {w.idx} is {w.health}",
                retry_after=self._retry_hint(w))
        if len(w.queue) >= w.max_queue:
            raise self._reject(
                "queue_full",
                f"worker {w.idx} queue full ({w.max_queue} ops)",
                retry_after=self._retry_hint(w))
        deadline_s = deadline_s if deadline_s is not None \
            else self.default_deadline_s
        if deadline_s is not None:
            op.deadline = time.monotonic() + deadline_s
        w.queue.append(op)
        self._g_depth[w.idx].set(len(w.queue))
        w.wake.set()
        self._maybe_steal(w)

    async def _control(self, psid: int, kind: str):
        w, sid = self._lookup(psid)
        op = _Op(kind, self._fut(), sid=sid, psid=psid)
        self._enqueue(w, op)
        return await op.fut

    async def _run_worker(self, w: _Worker) -> None:
        while self._running:
            if not w.queue:
                w.wake.clear()
                await w.wake.wait()
                continue
            # batching window: yield one loop tick so coroutines scheduled
            # in the same tick can enqueue before the batch is cut
            await asyncio.sleep(0)
            self._cycle(w)
            self._g_depth[w.idx].set(len(w.queue))
            await asyncio.sleep(0)  # let clients consume results / enqueue

    def _cycle(self, w: _Worker) -> None:
        """One scheduling cycle: execute the longest FIFO prefix of the
        queue that fits a single grid dispatch (see module docstring)."""
        svc = w.service
        t0 = time.monotonic()
        n_ops = 0
        batch: dict[int, Any] = {}
        futs: dict[int, asyncio.Future] = {}
        psids: dict[int, int] = {}
        while w.queue:
            op = w.queue[0]
            if op.fut.done():        # client cancelled while queued
                w.queue.popleft()
                continue
            if op.deadline is not None and time.monotonic() > op.deadline:
                w.queue.popleft()    # expired while queued: retryable
                op.fut.set_exception(self._reject(
                    "deadline",
                    f"op {op.kind} missed its deadline in worker {w.idx} "
                    f"queue", retry_after=self._retry_hint(w)))
                continue
            if op.kind == "push":
                if op.sid in batch or len(batch) >= svc.n_slots:
                    break            # cut: would break FIFO or overflow grid
                w.queue.popleft()
                batch[op.sid] = op.work
                futs[op.sid] = op.fut
                psids[op.sid] = op.psid
            else:
                if op.sid is not None and op.sid in batch:
                    break            # control on a batched sid: after dispatch
                w.queue.popleft()
                self._do_control(w, op)
                n_ops += 1
                if w.health == CRASHED:
                    # the queue was failed by _on_crash; lanes already cut
                    # into this cycle's batch must fail too, not hang
                    for sid, fut in futs.items():
                        if not fut.done():
                            fut.set_exception(self._reject(
                                "crash", f"worker {w.idx} crashed before "
                                "dispatch; retry after recovery",
                                retry_after=w.ema_op_s * 4))
                    return
        if batch:
            self._dispatch(w, batch, futs, psids)
            n_ops += len(batch)
        if n_ops:
            dt = (time.monotonic() - t0) / n_ops
            w.ema_op_s += 0.2 * (dt - w.ema_op_s)

    def _do_control(self, w: _Worker, op: _Op) -> None:
        svc = w.service
        try:
            if op.kind == "open":
                res = svc.open_session(*op.args, **op.kwargs)
            elif op.kind == "enroll":
                res = svc.enroll(op.sid, op.work, **op.kwargs)
            else:
                res = getattr(svc, op.kind)(op.sid)
        except WorkerCrashed as e:
            if not op.fut.done():
                op.fut.set_exception(self._reject(
                    "crash", f"worker {w.idx} crashed during {op.kind}; "
                    "retry after recovery", retry_after=self._retry_hint(w),
                    cause=e))
            self._on_crash(w)
            return
        except TransientError as e:
            if not op.fut.done():
                op.fut.set_exception(self._reject(
                    "transient", f"transient worker failure: {e}",
                    retry_after=self._retry_hint(w), cause=e))
            return
        except AdmissionError as e:
            if not op.fut.done():
                op.fut.set_exception(self._reject(
                    "admission", f"admission refused: {e}",
                    retry_after=self._retry_hint(w), cause=e))
            return
        except Exception as e:
            if not op.fut.done():
                op.fut.set_exception(e)
            return
        if op.kind == "open":
            sid = res
            if op.fut.done():
                # client cancelled while queued: the service session must
                # not leak — close it (best effort; a fault here is a
                # normal crash)
                try:
                    svc.close(sid)
                except WorkerCrashed:
                    self._on_crash(w)
                except Exception:
                    pass
                return
            self._sessions[op.psid] = (w, sid)
            w.psid_of[sid] = op.psid
            w.live += 1
            op.fut.set_result(op.psid)
            self._mark_dirty(w, op.psid, tenant=self._tid_of(w, sid))
            return
        if op.kind == "close":
            self._forget(w, op.sid, op.psid)
        elif op.kind == "enroll":
            self._mark_dirty(w, op.psid, tenant=self._tid_of(w, op.sid))
        if not op.fut.done():
            op.fut.set_result(res)

    def _forget(self, w: _Worker, sid: int, psid: int) -> None:
        w.psid_of.pop(sid, None)
        if self._sessions.pop(psid, None) is not None:
            w.live -= 1
        self._journal.pop(psid, None)
        w.dirty.discard(psid)

    def _dispatch(self, w: _Worker, batch: dict[int, Any],
                  futs: dict[int, asyncio.Future],
                  psids: dict[int, int]) -> None:
        # drop lanes whose client cancelled between enqueue and dispatch:
        # their session must NOT advance (the client saw no result)
        live = {sid: wk for sid, wk in batch.items()
                if not futs[sid].done()}
        if not live:
            return
        self._c_batches.inc()
        self._h_lanes.record(len(live))
        try:
            with self.tracer.span("plane_batch", cat="plane",
                                  worker=w.idx, lanes=len(live)):
                out = w.service.push(live)
        except WorkerCrashed:
            for sid in live:
                if not futs[sid].done():
                    futs[sid].set_exception(self._reject(
                        "crash", f"worker {w.idx} crashed mid-batch; "
                        "retry after recovery",
                        retry_after=self._retry_hint(w)))
            self._on_crash(w)
            return
        except TransientError as e:
            # injected BEFORE any state advanced: every lane is safe to
            # retry verbatim
            for sid in live:
                if not futs[sid].done():
                    futs[sid].set_exception(self._reject(
                        "transient", f"transient worker failure: {e}",
                        retry_after=self._retry_hint(w), cause=e))
            return
        except Exception:
            # one lane's failure must not poison its batchmates: re-run
            # each lane alone (bit-identical by chunk invariance) so only
            # the offending session sees its exception
            rest = list(live.items())
            for i, (sid, wk) in enumerate(rest):
                if futs[sid].done():
                    continue
                try:
                    res = w.service.push({sid: wk})[sid]
                except WorkerCrashed:
                    for s, _ in rest[i:]:
                        if not futs[s].done():
                            futs[s].set_exception(self._reject(
                                "crash", f"worker {w.idx} crashed "
                                "mid-batch; retry after recovery",
                                retry_after=self._retry_hint(w)))
                    self._on_crash(w)
                    return
                except TransientError as e:
                    futs[sid].set_exception(self._reject(
                        "transient", f"transient worker failure: {e}",
                        retry_after=self._retry_hint(w), cause=e))
                    continue
                except Exception as e:
                    futs[sid].set_exception(e)
                    continue
                futs[sid].set_result(res)
                self._mark_dirty(w, psids[sid])
            return
        for sid, res in out.items():
            if not futs[sid].done():
                futs[sid].set_result(res)
            self._mark_dirty(w, psids[sid])

    # -- spill journal -------------------------------------------------------
    def _tid_of(self, w: _Worker, sid: int) -> int | None:
        """The service-side tenant id a session's state references, or
        None for tenantless/LM sessions.  Reads the spill meta directly
        (NOT a protocol verb, so the fault clock never ticks for the
        plane's own bookkeeping)."""
        if not getattr(w.service, "tenant_aware", False):
            return None
        t = w.service._session_spill_meta(sid).get("tenant")
        return int(t) if t is not None and int(t) >= 0 else None

    def _mark_dirty(self, w: _Worker, psid: int,
                    tenant: int | None = None) -> None:
        if not self.checkpoint_every or psid is None:
            return
        w.dirty.add(psid)
        if tenant is not None:
            w.dirty_tenants.add(tenant)
        w.ops_since_ckpt += 1
        if w.ops_since_ckpt >= self.checkpoint_every:
            self._flush_journal(w)

    def _flush_journal(self, w: _Worker) -> None:
        """One spill epoch: snapshot every touched tenant and session.
        With ``checkpoint_every=1`` this runs synchronously after EACH
        completed op — before the worker can take another — so the
        journal never lags an acknowledged result."""
        for tid in sorted(w.dirty_tenants):
            try:
                self._tenant_journal[(w.idx, tid)] = \
                    w.service.export_tenant(tid)
            except KeyError:
                self._tenant_journal.pop((w.idx, tid), None)
        for psid in sorted(w.dirty):
            ent = self._sessions.get(psid)
            if ent is None or ent[0] is not w:
                continue
            try:
                blob, meta = w.service.export_session(ent[1])
            except (KeyError, RuntimeError):
                continue    # retired/stateless: keep the previous epoch
            self._journal[psid] = {"blob": blob, "meta": meta}
        w.dirty.clear()
        w.dirty_tenants.clear()
        w.ops_since_ckpt = 0

    # -- crash handling ------------------------------------------------------
    def _on_crash(self, w: _Worker) -> None:
        """The worker's in-memory state is gone (WorkerCrashed surfaced).
        Fail everything it had accepted — none of it can run against the
        fresh service — and schedule recovery."""
        if w.health in (CRASHED, RECOVERING):
            return
        self._set_health(w, CRASHED)
        w.crashed_at = time.monotonic()
        self._c_crashes.inc()
        while w.queue:
            op = w.queue.popleft()
            if not op.fut.done():
                op.fut.set_exception(self._reject(
                    "crash", f"worker {w.idx} crashed; queued op dropped, "
                    "retry after recovery", retry_after=w.ema_op_s * 4))
        self._g_depth[w.idx].set(0)
        w.dirty.clear()
        w.dirty_tenants.clear()
        w.ops_since_ckpt = 0
        if self.auto_recover and self._running:
            asyncio.ensure_future(self.recover(w.idx))

    def _rehome(self, psid: int) -> None:
        """Re-adopt a session — and, for tenant-aware services, its whole
        journaled tenant group, so a bank is never split — from the spill
        journal onto a healthy peer while its old worker is still down
        (``auto_recover=False`` or recovery not yet scheduled)."""
        w, sid = self._sessions[psid]
        ent = self._journal.get(psid)
        if ent is None:
            raise self._reject(
                "crash", f"worker {w.idx} crashed and session {psid} has "
                "no spill epoch to re-home from", retryable=False)
        peers = [p for p in self.workers
                 if p is not w and p.health == HEALTHY]
        if not peers:
            raise self._reject("no_worker",
                               "no healthy worker to re-home onto",
                               retry_after=0.01)
        p = min(peers, key=lambda q: q.load)
        tid = ent["meta"].get("tenant")
        tid = int(tid) if tid is not None and int(tid) >= 0 else None
        group = [psid]
        new_tid = None
        if tid is not None:
            group = sorted(
                q for q, (ww, _) in self._sessions.items()
                if ww is w and q in self._journal
                and self._journal[q]["meta"].get("tenant") == tid)
            tblob = self._tenant_journal.get((w.idx, tid))
            if tblob is None:
                raise self._reject(
                    "crash", f"tenant {tid} has no journaled bank state to "
                    "re-home with", retryable=False)
            try:
                new_tid = p.service.adopt_tenant(tid, tblob)
            except ValueError:
                new_tid = p.service.adopt_tenant(None, tblob)
            del self._tenant_journal[(w.idx, tid)]
            self._tenant_journal[(p.idx, new_tid)] = tblob
            if any(not self._journal[q]["meta"].get("dedicated", False)
                   for q in group):
                self._tenant_home[tid] = p.idx
        for q in group:
            e = self._journal[q]
            meta = e["meta"]
            if new_tid is not None and new_tid != tid:
                meta = {**meta, "tenant": new_tid}
                self._journal[q] = {"blob": e["blob"], "meta": meta}
            sid2 = p.service.adopt_session(e["blob"], meta)
            old_sid = self._sessions[q][1]
            w.psid_of.pop(old_sid, None)
            w.live -= 1
            self._sessions[q] = (p, sid2)
            p.psid_of[sid2] = q
            p.live += 1
            self._c_handoffs.inc()

    # -- handoff / stealing --------------------------------------------------
    def _migrate(self, w: _Worker, psids: list[int],
                 extra_tenants: list[int] = ()) -> tuple[int, int]:
        """Move the given plane sessions — and every affected tenant's
        learned state — from ``w`` onto healthy peers, updating the
        registry so clients never notice.  The caller must pass tenant
        groups WHOLE (all of a tenant's sessions on ``w`` or none);
        ``extra_tenants`` moves enrolled-but-idle tenant rows too (full
        drain).  Capacity is planned before the first mutation, so a
        refused migration leaves everything in place."""
        svc = w.service
        tenant_aware = getattr(svc, "tenant_aware", False)
        peers = [p for p in self.workers
                 if p is not w and p.health == HEALTHY]
        if not peers:
            raise RuntimeError("no healthy peer to migrate to")
        groups: dict[int, list[int]] = {}
        singles: list[int] = []
        for psid in psids:
            ww, sid = self._sessions[psid]
            if ww is not w:
                raise ValueError(f"session {psid} is not on worker {w.idx}")
            tid = self._tid_of(w, sid) if tenant_aware else None
            if tid is None:
                singles.append(psid)
            else:
                groups.setdefault(tid, []).append(psid)
        for tid in extra_tenants:
            groups.setdefault(int(tid), [])
        # plan placement against peer admission capacity BEFORE mutating
        def _cap(p: _Worker) -> float:
            sched = getattr(p.service, "sched", None)
            ms = getattr(sched, "max_sessions", None)
            return math.inf if ms is None else ms - sched.live_sessions
        avail = {p.idx: _cap(p) for p in peers}
        t_plan: dict[int, _Worker] = {}
        s_plan: dict[int, _Worker] = {}

        def _place(n: int) -> _Worker:
            ok = [p for p in peers if avail[p.idx] >= n]
            if not ok:
                raise RuntimeError(
                    f"no healthy peer has capacity for {n} migrating "
                    "sessions")
            p = min(ok, key=lambda q: q.load)
            avail[p.idx] -= n
            return p

        for tid, members in sorted(groups.items(),
                                   key=lambda kv: -len(kv[1])):
            t_plan[tid] = _place(len(members))
        for psid in singles:
            s_plan[psid] = _place(1)
        # execute: per tenant group, then tenantless singles
        n_sessions = 0
        for tid, members in sorted(groups.items()):
            p = t_plan[tid]
            detached = [(psid,) + svc.detach_session(self._sessions[psid][1])
                        for psid in members]
            for psid, _, _ in detached:
                old_sid = self._sessions[psid][1]
                w.psid_of.pop(old_sid, None)
            tblob = svc.export_tenant(tid)
            svc.close_tenant(tid)
            try:
                new_tid = p.service.adopt_tenant(tid, tblob)
            except ValueError:
                new_tid = p.service.adopt_tenant(None, tblob)
            jkey = (w.idx, tid)
            if jkey in self._tenant_journal:
                del self._tenant_journal[jkey]
            if self.checkpoint_every:
                self._tenant_journal[(p.idx, new_tid)] = tblob
            dedicated_only = True
            for psid, blob, meta in detached:
                if new_tid != tid:
                    meta = {**meta, "tenant": new_tid}
                if not meta.get("dedicated", False):
                    dedicated_only = False
                sid2 = p.service.adopt_session(blob, meta)
                self._sessions[psid] = (p, sid2)
                p.psid_of[sid2] = psid
                p.live += 1
                w.live -= 1
                if self.checkpoint_every:
                    self._journal[psid] = {"blob": blob, "meta": meta}
                n_sessions += 1
            if not (dedicated_only and detached):
                # pin explicit plane tenants to the new worker; dedicated
                # rows have service-local ids no client routes by
                self._tenant_home[tid] = p.idx
        for psid in singles:
            p = s_plan[psid]
            blob, meta = svc.detach_session(self._sessions[psid][1])
            old_sid = self._sessions[psid][1]
            w.psid_of.pop(old_sid, None)
            sid2 = p.service.adopt_session(blob, meta)
            self._sessions[psid] = (p, sid2)
            p.psid_of[sid2] = psid
            p.live += 1
            w.live -= 1
            if self.checkpoint_every:
                self._journal[psid] = {"blob": blob, "meta": meta}
            n_sessions += 1
        return n_sessions, len(groups)

    def _maybe_steal(self, w: _Worker) -> None:
        """Queue-skew trigger (called on every enqueue): when this
        worker's queue runs ``steal_threshold`` ops deeper than the
        coldest healthy peer's, shed idle sessions to the peers."""
        if not self.steal_threshold or w.steal_pending \
                or w.health != HEALTHY:
            return
        peers = [p for p in self.workers
                 if p is not w and p.health == HEALTHY]
        if not peers:
            return
        cold = min(peers, key=lambda p: len(p.queue))
        if len(w.queue) - len(cold.queue) < self.steal_threshold:
            return
        w.steal_pending = True
        asyncio.ensure_future(self._steal(w))

    async def _steal(self, w: _Worker) -> None:
        try:
            if w.health != HEALTHY:
                return
            queued = {op.sid for op in w.queue if op.sid is not None}
            # a queued open of a tenant would claim an empty row here after
            # its group left: such a tenant stays (the reference moves it)
            opening = {op.kwargs.get("tenant") for op in w.queue
                       if op.kind == "open"}
            tenant_aware = getattr(w.service, "tenant_aware", False)
            # candidates: sessions with nothing queued, in groups that move
            # whole (one tenant's sessions, or one tenantless session), so
            # a bank never splits across workers
            sids_of_tid: dict[int, list[int]] = {}
            groups: list[list[int]] = []
            for sid, psid in w.psid_of.items():
                tid = self._tid_of(w, sid) if tenant_aware else None
                if tid is None:
                    if sid not in queued:
                        groups.append([psid])
                else:
                    sids_of_tid.setdefault(tid, []).append(sid)
            for tid, sids in sids_of_tid.items():
                if tid not in opening and all(s not in queued for s in sids):
                    groups.append(sorted(w.psid_of[s] for s in sids))
            if not groups:
                return
            # about half of the candidates, whole groups in psid order (the
            # reference slices the sorted psids and can cut a tenant group,
            # whose migration then fails after detaching its first members)
            want = max(1, sum(map(len, groups)) // 2)
            take: list[int] = []
            for g in sorted(groups):
                if len(take) >= want:
                    break
                take += g
            n, _ = self._migrate(w, take)
            self._c_steals.inc(n)
        except RuntimeError:
            pass      # no peer capacity right now; the trigger will refire
        finally:
            w.steal_pending = False
