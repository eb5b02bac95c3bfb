"""The port's serving layer on the CPU: every TCN test of
tests/test_chaos.py and the assertions of tests/test_serving_plane.py
(LM-only in the reference) re-run against the port's TCN service, the
fault plans and retry delays equal to the reference's, tenant routing to
the same worker index, and TCNStreamServer with its shims
(tests/test_serving.py).  The invariants: zero lost sessions, and every
stream bit-identical to a fault-free synchronous control on a service of
the same geometry, each session replayed alone."""

import asyncio
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_pair import RTOL, ATOL, close, same_result, setup, svc  # noqa: E402
from repro import serving as jserving  # noqa: E402
from repro_torch.configs import RuntimeConfig  # noqa: E402
from repro_torch.configs import runtime as rt  # noqa: E402
from repro_torch.obs import MetricsRegistry  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    CRASHED,
    DRAINED,
    HEALTHY,
    FaultInjector,
    FaultPlan,
    Rejected,
    RetryPolicy,
    ServingPlane,
    TCNStreamServer,
    TransientError,
    WorkerCrashed,
)
from repro_torch.serving import faults as faults_mod  # noqa: E402
from repro_torch.sessions import AdmissionError, SessionService  # noqa: E402
from repro_torch.sessions import StreamSessionService  # noqa: E402
from repro_torch.sessions.paging import PoolExhausted  # noqa: E402


def _tcn(**kw):
    return svc(**kw)


def _plane(workers, **kw):
    # a fresh registry per plane: the default one is process-global
    kw.setdefault("metrics", MetricsRegistry())
    return ServingPlane(workers, **kw)


def _chunks(i, rounds, n=3):
    rng = np.random.default_rng(100 + i)
    return [rng.normal(size=(n + (r + i) % 3, 2)).astype(np.float32)
            for r in range(rounds)]


def _solo(i, chunks, **kw):
    """Session i's chunks pushed alone, in order, on a fresh fault-free
    service of the plane's geometry (kwargs passed to open_session)."""
    s = _tcn()
    sid = s.open_session(**kw)
    return [s.push({sid: c})[sid] for c in chunks]


def _same_stream(got: list, want: list):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        same_result(a, b, exact=True)


async def _persist(op, max_attempts=300):
    """Drive one plane verb through retryable rejections."""
    for attempt in range(max_attempts):
        try:
            return await op()
        except Rejected as e:
            if not e.retryable:
                raise
            await asyncio.sleep(min(0.0005 * (attempt + 1), 0.005))
    raise AssertionError("op did not complete within the retry budget")


# ---------------------------------------------------------------------------
# the harness: plans, retries and routing equal to the reference's
# ---------------------------------------------------------------------------

def _events(plan):
    return [(e.at, e.kind, e.span, e.seconds) for e in plan.events]


@pytest.mark.parametrize("spec", [
    "crash@40, slow@10x5:0.002,storm@60x20,flake@25",
    "crash@40,flake@25,storm@60x2", "", "flake@0,flake@0,crash@7x3"])
def test_fault_plan_parse_equal_reference(spec):
    got, want = FaultPlan.parse(spec), jserving.FaultPlan.parse(spec)
    assert _events(got) == _events(want) and got.spec() == want.spec()
    assert FaultPlan.parse(got.spec()) == got
    for i in range(0, 90, 7):
        assert [e.kind for e in got.at(i)] == [e.kind for e in want.at(i)]
    with pytest.raises(ValueError, match="bad fault event"):
        FaultPlan.parse("explode@3")


@pytest.mark.parametrize("seed", [0, 7, 8, 123])
def test_fault_plan_seeded_equal_reference(seed):
    kw = dict(crash_every=50, slow_every=17, storm_every=60, flake_every=30)
    got = FaultPlan.seeded(seed, 400, **kw)
    want = jserving.FaultPlan.seeded(seed, 400, **kw)
    assert _events(got) == _events(want) and got.spec() == want.spec()
    assert got == FaultPlan.seeded(seed, 400, **kw)
    assert got != FaultPlan.seeded(seed + 1, 400, **kw)


def test_retry_policy_equal_reference_and_floored_by_hint():
    a, b = RetryPolicy(seed=3), jserving.RetryPolicy(seed=3)
    assert [a.delay(i) for i in range(8)] == [b.delay(i) for i in range(8)]
    p = RetryPolicy(seed=0, base_s=0.001, cap_s=0.01, jitter=0.5)
    for i in range(8):
        assert 0 < p.delay(i) <= 0.015
    assert p.delay(0, retry_after=0.5) == 0.5   # the server hint is a floor


def test_tenant_routing_lands_on_the_reference_worker_index():
    class _Stub:
        n_slots = 1

    got = _plane([_Stub() for _ in range(3)])
    want = jserving.ServingPlane([_Stub() for _ in range(3)],
                                 metrics=MetricsRegistry())
    for t in [f"tenant-{i}" for i in range(40)] + list(range(20)):
        assert got._route(t).idx == want._route(t).idx \
            == zlib.crc32(str(t).encode()) % 3


def test_injector_counts_verbs_swaps_service_on_crash():
    s = _tcn()
    inj = FaultInjector(s, FaultPlan.parse("crash@2"), factory=_tcn)
    sid = inj.open_session()                                   # op 0
    x = _chunks(0, 1)[0]
    assert inj.push({sid: x})[sid]["step"] == len(x)           # op 1
    with pytest.raises(WorkerCrashed):
        inj.push({sid: x})                                     # op 2
    assert inj.service is not s and inj.crashes == 1
    assert (2, "crash") in inj.faults
    assert inj.service.stats()["live_sessions"] == 0           # state gone
    ops = inj.ops
    assert inj.n_slots == 2 and inj.stats()["service"] == "tcn"
    assert inj.ops == ops  # attributes do not tick the fault clock
    with pytest.raises(ValueError, match="factory"):
        FaultInjector(_tcn(), FaultPlan.parse("crash@0"))


def test_tcn_export_adopt_tenant_carries_bank_labels_rehearsal():
    rng = np.random.default_rng(3)
    shots = rng.normal(size=(2, 10, 2)).astype(np.float32)
    x = rng.normal(size=(6, 2)).astype(np.float32)
    ctrl = _tcn(rehearsal_cap=4)
    csid = ctrl.open_session(tenant=1)
    ctrl.enroll_shots(csid, shots, label="cat")
    want = ctrl.push_audio({csid: x})[csid]["tenant_logits"]

    src, dst = _tcn(rehearsal_cap=4), _tcn(rehearsal_cap=4)
    sid = src.open_session(tenant=1)
    src.enroll_shots(sid, shots, label="cat")
    blob, meta = src.detach_session(sid)
    tblob = src.export_tenant(1)
    src.close_tenant(1)
    assert 1 not in src.live_tenants()
    with pytest.raises(ValueError, match="adopt_tenant first"):
        dst.adopt_session(blob, meta)
    assert dst.adopt_tenant(1, tblob) == 1
    sid2 = dst.adopt_session(blob, meta)
    got = dst.push_audio({sid2: x})[sid2]["tenant_logits"]
    np.testing.assert_array_equal(got, want)
    assert dst._tenant_labels[1] == {"cat": 0}
    assert dst.rehearsal.export_tenant(1)
    with pytest.raises(ValueError, match="already in use"):
        dst.adopt_tenant(1, tblob)


# ---------------------------------------------------------------------------
# crash recovery: zero lost, bit-identical
# ---------------------------------------------------------------------------

def test_crash_mid_batch_recovers_all_sessions_bit_identical():
    """Crashes land during opens and during batched pushes; every client
    retries through, no session is lost, and every stream equals its solo
    fault-free control."""
    N, ROUNDS = 6, 3
    data = {i: _chunks(i, ROUNDS) for i in range(N)}

    async def main():
        inj = FaultInjector(_tcn(), FaultPlan.parse("crash@2,crash@12"),
                            factory=_tcn)
        plane = _plane([inj], checkpoint_every=1)
        async with plane:
            psids = [await _persist(lambda: plane.open_session())
                     for _ in range(N)]

            async def client(i):
                return [await _persist(lambda c=c: plane.push(psids[i], c))
                        for c in data[i]]

            outs = await asyncio.gather(*(client(i) for i in range(N)))
            for p in psids:
                await _persist(lambda p=p: plane.close(p))
            return outs, plane.stats(), plane.metrics(), inj.crashes

    outs, stats, m, crashes = asyncio.run(main())
    assert crashes == 2 and stats["lost_sessions"] == 0
    assert stats["health"] == [HEALTHY]
    assert m["plane_crashes_total"][0]["value"] == 2
    assert m["plane_recoveries_total"][0]["value"] == 2
    assert m["plane_mttr_us"][0]["count"] == 2
    for i in range(N):
        _same_stream(outs[i], _solo(i, data[i]))


def test_crash_during_enroll_lands_bank_after_recovery():
    rng = np.random.default_rng(11)
    shots = rng.normal(size=(2, 10, 2)).astype(np.float32)
    x = rng.normal(size=(6, 2)).astype(np.float32)
    ctrl = _tcn()
    csid = ctrl.open_session(tenant=0)
    ctrl.enroll_shots(csid, shots)
    want = ctrl.push_audio({csid: x})[csid]

    async def main():
        inj = FaultInjector(_tcn(), FaultPlan.parse("crash@1"), factory=_tcn)
        plane = _plane([inj], checkpoint_every=1)
        async with plane:
            psid = await _persist(lambda: plane.open_session(tenant=0))
            way = await _persist(lambda: plane.enroll(psid, shots))
            res = await _persist(lambda: plane.push(psid, x))
            return way, res, inj.crashes, plane.stats()

    way, res, crashes, stats = asyncio.run(main())
    assert crashes == 1 and way == 0 and stats["lost_sessions"] == 0
    same_result(res, want, exact=True)


def test_resume_rehomes_from_journal_when_worker_is_down():
    x = _chunks(2, 1)[0]

    async def main():
        inj = FaultInjector(_tcn(), FaultPlan.parse("crash@1"), factory=_tcn)
        plane = _plane([inj, _tcn()], checkpoint_every=1, auto_recover=False)
        async with plane:
            psid = await plane.open_session()
            w0 = plane._sessions[psid][0]
            if w0.idx != 0:     # the least-loaded pick: make it the injector
                return None
            with pytest.raises(Rejected) as ei:
                await plane.push(psid, x)        # op 1: injected crash
            assert ei.value.reason == "crash" and ei.value.retryable
            assert plane.stats()["health"][0] == CRASHED
            await plane.resume(psid)             # re-homes, then binds
            assert plane._sessions[psid][0] is not w0
            res = await plane.push(psid, x)
            rec = await plane.recover(0)
            assert rec["recovered"] == 0 and rec["lost"] == 0
            return res, plane.stats()

    out = asyncio.run(main())
    assert out is not None, "the first session was not placed on worker 0"
    res, stats = out
    assert stats["lost_sessions"] == 0 and stats["health"] == [HEALTHY] * 2
    _same_stream([res], _solo(2, [x]))  # the crashed push never happened


# ---------------------------------------------------------------------------
# drain / handoff
# ---------------------------------------------------------------------------

def test_drain_hands_sessions_to_peer_bit_identical():
    N = 4
    data = {i: _chunks(i, 2) for i in range(N)}

    async def main():
        plane = _plane([_tcn(), _tcn()], checkpoint_every=1)
        async with plane:
            psids = [await plane.open_session() for _ in range(N)]
            firsts = await asyncio.gather(
                *(plane.push(p, data[i][0]) for i, p in enumerate(psids)))
            victim = plane._sessions[psids[0]][0]
            moved = [p for p in psids if plane._sessions[p][0] is victim]
            summary = await plane.drain(victim.idx)
            assert summary["moved_sessions"] == len(moved)
            assert plane.stats()["health"][victim.idx] == DRAINED
            assert all(plane._sessions[p][0] is not victim for p in psids)
            with pytest.raises(RuntimeError, match="not drained"):
                plane.undrain(1 - victim.idx)
            plane.undrain(victim.idx)
            assert plane.stats()["health"] == [HEALTHY, HEALTHY]
            rests = await asyncio.gather(
                *(plane.push(p, data[i][1]) for i, p in enumerate(psids)))
            polls = [await plane.poll(p) for p in psids]
            return firsts, rests, polls, plane.metrics()

    firsts, rests, polls, m = asyncio.run(main())
    for i in range(N):
        _same_stream([firsts[i], rests[i]], _solo(i, data[i]))
        assert polls[i]["steps"] == sum(len(c) for c in data[i])
    assert m["plane_handoffs_total"][0]["value"] >= 1


def test_drain_refuses_without_healthy_peer():
    async def main():
        plane = _plane([_tcn()])
        async with plane:
            with pytest.raises(RuntimeError, match="no healthy peer"):
                await plane.drain(0)
            assert plane.stats()["health"] == [HEALTHY]

    asyncio.run(main())


def test_tenant_bank_mutated_during_drain_lands_on_peer():
    """An enroll accepted just before drain() applies on the old worker,
    and the handoff carries the post-enroll bank (tests/test_cl_service)."""
    rng = np.random.default_rng(12)
    shots1 = rng.normal(size=(2, 10, 2)).astype(np.float32)
    shots2 = rng.normal(size=(1, 10, 2)).astype(np.float32)
    x = rng.normal(size=(6, 2)).astype(np.float32)
    ctrl = _tcn()
    csid = ctrl.open_session(tenant=0)
    ctrl.enroll_shots(csid, shots1)
    ctrl.enroll_shots(csid, shots2)
    want = ctrl.push_audio({csid: x})[csid]

    async def main():
        plane = _plane([_tcn(), _tcn()])
        async with plane:
            psid = await plane.open_session(tenant=0)
            assert await plane.enroll(psid, shots1) == 0
            victim = plane._sessions[psid][0]
            fe = asyncio.ensure_future(plane.enroll(psid, shots2))
            await asyncio.sleep(0)  # the enroll op is now queued
            way, summary = await asyncio.gather(fe, plane.drain(victim.idx))
            assert way == 1 and summary["moved_sessions"] == 1
            assert summary["moved_tenants"] == 1
            assert plane._sessions[psid][0] is not victim
            assert (await plane.poll(psid))["n_ways"] == 2
            res = await plane.push(psid, x)
            assert await plane.enroll(psid, shots2) == 2
            return res

    same_result(asyncio.run(main()), want, exact=True)


def test_tenant_opens_follow_the_bank_through_drain_and_crash():
    """A tenant's sessions open where its bank is: while its worker drains
    or is down, an open is rejected retryably (the reference re-hashes it
    onto a healthy worker, where it claims an empty row); after the drain
    it opens on the peer that holds the bank, and after a recovery on the
    rebuilt worker."""
    shots = np.random.default_rng(8).normal(size=(2, 10, 2)).astype(
        np.float32)
    assert zlib.crc32(b"1") % 2 == 1  # tenant 1 starts on worker 1

    async def main():
        inj = FaultInjector(_tcn(), FaultPlan.parse("crash@3"), factory=_tcn)
        plane = _plane([_tcn(), inj], checkpoint_every=1, auto_recover=False)
        async with plane:
            a = await plane.open_session(tenant=1)          # worker 1, op 0
            assert plane._sessions[a][0].idx == 1
            assert await plane.enroll(a, shots) == 0        # op 1
            await plane.push(a, _chunks(0, 1)[0])           # op 2
            with pytest.raises(Rejected) as ei:
                await plane.push(a, _chunks(0, 1)[0])       # op 3: crash
            assert ei.value.reason == "crash"
            with pytest.raises(Rejected) as ei:
                await plane.open_session(tenant=1)
            assert ei.value.reason == "crash" and ei.value.retryable
            await plane.recover(1)
            b = await plane.open_session(tenant=1)
            assert plane._sessions[b][0].idx == 1
            assert (await plane.poll(b))["n_ways"] == 1
            busy = [asyncio.ensure_future(plane.push(a, c))
                    for c in _chunks(1, 3)]
            await asyncio.sleep(0)
            drain = asyncio.ensure_future(plane.drain(1))
            await asyncio.sleep(0)
            with pytest.raises(Rejected) as ei:
                await plane.open_session(tenant=1)
            assert ei.value.reason == "draining" and ei.value.retryable
            await asyncio.gather(drain, *busy)
            c = await plane.open_session(tenant=1)
            assert plane._sessions[c][0].idx == 0
            return [(await plane.poll(p))["n_ways"] for p in (a, b, c)]

    assert asyncio.run(main()) == [1, 1, 1]


# ---------------------------------------------------------------------------
# deadlines, storms, flakes
# ---------------------------------------------------------------------------

def test_deadline_expiry_rejects_with_retry_after():
    x = _chunks(1, 1)[0]

    async def main():
        plane = _plane(_tcn(), default_deadline_s=30.0)
        async with plane:
            psid = await plane.open_session()
            with pytest.raises(Rejected) as ei:
                await plane.push(psid, x, deadline_s=-1.0)
            assert ei.value.reason == "deadline" and ei.value.retryable
            assert ei.value.retry_after is not None
            assert ei.value.retry_after > 0
            res = await plane.push(psid, x)
            rej = plane.metrics()["plane_rejected_total"]
            return res, {e["labels"]["reason"]: e["value"] for e in rej}

    res, reasons = asyncio.run(main())
    _same_stream([res], _solo(1, [x]))  # the expired push never ran
    assert reasons.get("deadline") == 1


def test_admission_storm_is_retryable_then_clears():
    x = _chunks(0, 1)[0]

    async def main():
        inj = FaultInjector(_tcn(), FaultPlan.parse("storm@0x2"))
        plane = _plane([inj])
        async with plane:
            with pytest.raises(Rejected) as ei:
                await plane.open_session()
            assert ei.value.reason == "admission" and ei.value.retryable
            assert isinstance(ei.value.__cause__, PoolExhausted)
            psid = await _persist(lambda: plane.open_session())
            return await plane.push(psid, x)

    _same_stream([asyncio.run(main())], _solo(0, [x]))


def test_transient_flake_rejects_push_then_retry_is_bit_identical():
    x = _chunks(5, 1)[0]

    async def main():
        inj = FaultInjector(_tcn(), FaultPlan.parse("flake@1"))
        plane = _plane([inj])
        async with plane:
            psid = await plane.open_session()
            with pytest.raises(Rejected) as ei:
                await plane.push(psid, x)
            assert ei.value.reason == "transient" and ei.value.retryable
            assert isinstance(ei.value.__cause__, TransientError)
            return await plane.push(psid, x)   # nothing advanced

    _same_stream([asyncio.run(main())], _solo(5, [x]))


# ---------------------------------------------------------------------------
# work stealing
# ---------------------------------------------------------------------------

def test_queue_skew_steals_whole_tenant_groups_bit_identical():
    """One busy session of tenant 0 skews its worker's queue; the idle
    tenant 1 (three sessions and an enrolled way) moves to the peer as a
    whole group, bank included.  (The reference slices the candidates and
    could cut such a group: its migration then fails after detaching
    the first members.)"""
    busy_x = _chunks(0, 8, n=1)
    data = {i: _chunks(i, 1) for i in range(1, 4)}
    shots = np.random.default_rng(9).normal(size=(2, 10, 2)).astype(
        np.float32)
    # tenants 0 and 1 both hash to worker 1 of 2
    assert {zlib.crc32(str(t).encode()) % 2 for t in (0, 1)} == {1}

    async def main():
        plane = _plane([_tcn(), _tcn()], steal_threshold=2,
                       checkpoint_every=1)
        async with plane:
            psids = [await plane.open_session(tenant=min(i, 1))
                     for i in range(4)]
            await plane.enroll(psids[1], shots)
            hot = plane._sessions[psids[0]][0]
            assert hot.idx == 1
            assert all(plane._sessions[p][0] is hot for p in psids)
            busy = [asyncio.ensure_future(plane.push(psids[0], c))
                    for c in busy_x]
            await asyncio.gather(*busy)
            for _ in range(100):
                if not hot.steal_pending:
                    break
                await asyncio.sleep(0.001)
            homes = [plane._sessions[p][0].idx for p in psids]
            outs = {i: await plane.push(psids[i], data[i][0])
                    for i in range(1, 4)}
            return ([f.result() for f in busy], outs, homes, plane.stats(),
                    plane.metrics())

    busy, outs, homes, stats, m = asyncio.run(main())
    assert homes == [1, 0, 0, 0], homes
    assert stats["lost_sessions"] == 0 and stats["live_sessions"] == 4
    assert m["plane_steals_total"][0]["value"] == 3
    _same_stream(busy, _solo(0, busy_x, tenant=0))
    for i in range(1, 4):
        s = _tcn()
        sid = s.open_session(tenant=1)
        s.enroll_shots(sid, shots)
        same_result(outs[i], s.push({sid: data[i][0]})[sid], exact=True)


# ---------------------------------------------------------------------------
# config activation + health surface
# ---------------------------------------------------------------------------

def test_runtime_chaos_field_wraps_workers_and_is_env_pinned():
    assert rt.ENV_CHAOS == faults_mod.ENV_VAR
    plane = _plane(_tcn(), runtime=RuntimeConfig(chaos="flake@3"))
    assert isinstance(plane.workers[0].service, FaultInjector)
    assert plane.workers[0].service.plan == FaultPlan.parse("flake@3")
    plain = _plane(_tcn(), runtime=RuntimeConfig())
    assert isinstance(plain.workers[0].service, StreamSessionService)
    with pytest.raises(ValueError, match="factory"):
        _plane(_tcn(), runtime=RuntimeConfig(chaos="crash@5"))


def test_worker_health_gauges_track_state_machine():
    async def main():
        plane = _plane([_tcn(), _tcn()])
        async with plane:
            await plane.drain(0)
            codes = {e["labels"]["worker"]: e["value"]
                     for e in plane.metrics()["plane_worker_health"]}
            assert codes == {"0": 2, "1": 0}  # drained, healthy
            assert plane.stats()["health"] == [DRAINED, HEALTHY]
            psids = [await plane.open_session() for _ in range(4)]
            assert all(plane._sessions[p][0].idx == 1 for p in psids)
            plane.undrain(0)
            assert plane.stats()["health"] == [HEALTHY, HEALTHY]

    asyncio.run(main())


# ---------------------------------------------------------------------------
# tests/test_serving_plane.py against the TCN service
# ---------------------------------------------------------------------------

def test_concurrent_pushes_bit_identical_to_sync_facade():
    """8 interleaved clients over a 2-slot worker: whatever batches the
    plane forms, every stream equals its solo synchronous run."""
    N, ROUNDS = 8, 3
    data = {i: _chunks(i, ROUNDS) for i in range(N)}

    async def main():
        async with _plane(_tcn(max_sessions=N)) as plane:
            psids = [await plane.open_session() for _ in range(N)]

            async def client(i):
                return [await plane.push(psids[i], c) for c in data[i]]

            outs = await asyncio.gather(*(client(i) for i in range(N)))
            m = plane.metrics()
            return (outs, m["plane_batches_total"][0]["value"],
                    m["plane_batch_lanes"][0])

    outs, batches, lanes = asyncio.run(main())
    for i in range(N):
        _same_stream(outs[i], _solo(i, data[i]))
    assert batches < N * ROUNDS and lanes["max"] > 1


def test_multi_worker_tenant_affinity():
    async def main():
        workers = [_tcn(max_sessions=8, max_tenants=3) for _ in range(3)]
        async with _plane(workers, max_queue=64) as plane:
            psids = {i: await plane.open_session(tenant=i % 3)
                     for i in range(6)}
            outs = await asyncio.gather(
                *(plane.push(psids[i], _chunks(i, 1)[0]) for i in range(6)))
            homes = {}
            for i in range(6):
                homes.setdefault(i % 3, set()).add(
                    plane._sessions[psids[i]][0].idx)
            return outs, homes

    outs, homes = asyncio.run(main())
    assert all(len(ws) == 1 for ws in homes.values()), homes
    for t, ws in homes.items():
        assert ws == {zlib.crc32(str(t).encode()) % 3}
    for i in range(6):
        s = _tcn(max_tenants=3)
        sid = s.open_session(tenant=i % 3)
        same_result(outs[i], s.push({sid: _chunks(i, 1)[0]})[sid],
                    exact=True)


def test_client_cancellation_leaves_batchmates_bit_identical():
    x = {i: _chunks(i, 1)[0] for i in range(3)}

    async def main():
        async with _plane(_tcn(n_slots=4, max_sessions=4)) as plane:
            psids = [await plane.open_session() for _ in range(3)]
            victim = asyncio.ensure_future(plane.push(psids[0], x[0]))
            survivors = [asyncio.ensure_future(plane.push(psids[i], x[i]))
                         for i in (1, 2)]
            await asyncio.sleep(0)   # all three are queued
            victim.cancel()          # before the batch is cut
            res = await asyncio.gather(*survivors)
            with pytest.raises(asyncio.CancelledError):
                await victim
            return res, [await plane.poll(p) for p in psids]

    res, polls = asyncio.run(main())
    for i in (1, 2):
        s = _tcn(n_slots=4)
        sid = s.open_session()
        same_result(res[i - 1], s.push({sid: x[i]})[sid], exact=True)
    assert polls[0]["steps"] == 0  # the cancelled session never ran
    assert polls[1]["steps"] == len(x[1]) and polls[2]["steps"] == len(x[2])


def test_admission_rejection_is_retryable():
    x = _chunks(2, 1)[0]

    async def main():
        async with _plane(_tcn(max_sessions=2)) as plane:
            await plane.open_session()
            b = await plane.open_session()
            with pytest.raises(Rejected) as ei:
                await plane.open_session()
            assert ei.value.retryable and ei.value.reason == "admission"
            assert isinstance(ei.value.__cause__, AdmissionError)
            await plane.close(b)
            c = await plane.open_session()   # the retry succeeds
            return await plane.push(c, x)

    _same_stream([asyncio.run(main())], _solo(2, [x]))


def test_queue_full_rejection_then_retry():
    x = _chunks(0, 1)[0]

    async def main():
        async with _plane(_tcn(max_sessions=2), max_queue=2) as plane:
            p = await plane.open_session()
            f1 = asyncio.ensure_future(plane.push(p, x))
            f2 = asyncio.ensure_future(plane.push(p, x))
            await asyncio.sleep(0)   # both enqueued: the queue is at its cap
            with pytest.raises(Rejected) as ei:
                await plane.push(p, x)
            assert ei.value.retryable and ei.value.reason == "queue_full"
            await asyncio.gather(f1, f2)
            res = await plane.push(p, x)
            rej = plane.metrics()["plane_rejected_total"]
            return res, {e["labels"]["reason"]: e["value"] for e in rej}

    res, reasons = asyncio.run(main())
    assert res["step"] == 3 * len(x)
    assert reasons.get("queue_full", 0) >= 1


def test_park_under_load_bit_identical():
    N = 6
    data = {i: _chunks(i, 2) for i in range(N)}

    async def main():
        async with _plane(_tcn(max_sessions=N)) as plane:
            psids = [await plane.open_session() for _ in range(N)]

            async def churner(i):
                p = psids[i]
                out = [await plane.push(p, data[i][0])]
                await plane.park(p)
                await plane.resume(p)
                out.append(await plane.push(p, data[i][1]))
                return out

            return await asyncio.gather(*(churner(i) for i in range(N)))

    outs = asyncio.run(main())
    for i in range(N):
        _same_stream(outs[i], _solo(i, data[i]))


def test_close_fails_queued_ops_and_refuses_new_ones():
    async def main():
        plane = _plane(_tcn())
        async with plane:
            p = await plane.open_session()
        with pytest.raises(Rejected) as ei:
            await plane.push(p, _chunks(0, 1)[0])
        assert not ei.value.retryable and ei.value.reason == "closed"

    asyncio.run(main())


def test_plane_stats_shape_and_enroll_counter():
    shots = np.random.default_rng(1).normal(size=(2, 10, 2)).astype(
        np.float32)

    async def main():
        reg = MetricsRegistry()
        async with _plane([_tcn(), _tcn()], metrics=reg) as plane:
            p = await plane.open_session(tenant=1)
            assert (await plane.poll(p))["tenant"] == 1  # forwarded
            assert await plane.enroll(p, shots) == 0
            st = plane.stats()
            assert st["n_workers"] == 2 and st["live_sessions"] == 1
            assert [w["service"] for w in st["workers"]] == ["tcn", "tcn"]
            return reg.snapshot()

    snap = asyncio.run(main())
    assert snap["plane_enrolls_total"][0]["value"] == 1


# ---------------------------------------------------------------------------
# TCNStreamServer (tests/test_serving.py)
# ---------------------------------------------------------------------------

def _server(n_streams=2, **kw):
    _, _, _, bundle, p, bnt = setup()
    return TCNStreamServer(bundle, p, bnt, n_streams=n_streams, **kw)


def test_tcn_stream_server_matches_full_sequence():
    """Pushing a clip sample by sample through the server ends where the
    reference's full-sequence forward does, and the stream equals the bare
    service's bit for bit."""
    from repro.models.tcn import tcn_forward

    jbundle, params, bn, bundle, p, bnt = setup()
    T = 25
    x = np.random.default_rng(3).normal(size=(2, T, 2)).astype(np.float32)
    srv = _server()
    with pytest.warns(DeprecationWarning, match="push"):
        for t in range(T):
            emb, logits = srv.push(x[:, t])
    emb_full, logits_full, _ = tcn_forward(params, bn, jbundle.cfg,
                                           jnp.asarray(x), train=False)
    np.testing.assert_allclose(emb, np.asarray(emb_full), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(logits, np.asarray(logits_full), rtol=RTOL,
                               atol=ATOL)
    bare = StreamSessionService(bundle, p, bnt, n_slots=2, max_tenants=1,
                                max_ways=1)
    sids = [bare.open_session() for _ in range(2)]
    res = bare.push({sid: x[i] for i, sid in enumerate(sids)})
    for i, sid in enumerate(sids):
        np.testing.assert_array_equal(res[sid]["emb"][-1], emb[i])
        np.testing.assert_array_equal(res[sid]["logits"][-1], logits[i])
    assert srv.stats()["dispatches"] == T
    assert srv.metrics()["dispatches_total"][0]["value"] == T


def test_tcn_server_protocol_push_and_shims_agree():
    a, b, c = _server(), _server(), _server()
    assert isinstance(a, SessionService) and a.n_slots == 2
    x = np.random.default_rng(5).normal(size=(2, 8, 2)).astype(np.float32)
    res = a.push({sid: x[i] for i, sid in enumerate(a.sids)})
    with pytest.warns(DeprecationWarning, match="push"):
        embs, logits = b.push_chunk(x)
    for i, sid in enumerate(a.sids):
        np.testing.assert_array_equal(res[sid]["emb"], embs[i])
        np.testing.assert_array_equal(res[sid]["logits"], logits[i])
    with pytest.warns(DeprecationWarning, match="push"):
        emb1, _ = c.push(x[:, 0])
    np.testing.assert_array_equal(emb1[0], res[a.sids[0]]["emb"][0])
    a.park(a.sids[0])
    assert a.poll(a.sids[0])["state"] == "parked"
    a.resume(a.sids[0])
    a.close(a.sids[1])
    assert a.stats()["live_sessions"] == 1
    # the reference server on the same params agrees within tolerance
    jbundle, params, bn = setup()[:3]
    j = jserving.TCNStreamServer(jbundle, params, bn, n_streams=2)
    jres = j.push({sid: x[i] for i, sid in enumerate(j.sids)})
    for sa, sj in zip(b.sids, j.sids):
        close(res[sa]["emb"], jres[sj]["emb"])
        close(res[sa]["logits"], jres[sj]["logits"])
