"""The port's LMServer and the LM service behind the SessionService
protocol and the ServingPlane, on the CPU: the LM cases of
tests/test_serving.py (slots and outputs, slot reuse, mid-decode
admission, reused slots, oversubscription, the protocol adapter and the
deprecation shims), ``speculative > 0`` decoding through the speculative
decoder in both verify modes (an unknown mode refused), the lifecycle
matrix and
the STATS_SCHEMA/METRICS_SCHEMA conformance of tests/test_service_protocol
.py for LMSessionService, and the port's ServingPlane over two port LM
services (tests/test_serving_plane.py, tests/test_chaos.py): concurrent
clients, a FaultInjector crash and a drain, 0 lost sessions and every
session's tokens equal to a synchronous control."""

import asyncio
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_bundle  # noqa: E402
from repro_torch.obs import MetricsRegistry  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    DRAINED,
    HEALTHY,
    FaultInjector,
    FaultPlan,
    LMServer,
    Rejected,
    ServeConfig,
    ServingPlane,
)
from repro_torch.sessions import (  # noqa: E402
    METRICS_SCHEMA,
    STATS_SCHEMA,
    LMSessionService,
    SessionService,
)


@functools.lru_cache(maxsize=None)
def _tiny_lm(n_layers=2, d_model=32, d_ff=64, vocab_size=64, head_dim=16):
    cfg = get_config("olmo-1b").smoke().replace(
        n_layers=n_layers, d_model=d_model, d_ff=d_ff, vocab_size=vocab_size,
        head_dim=head_dim)
    bundle = build_bundle(cfg, "cpu")
    return cfg, bundle, bundle.init(torch.Generator().manual_seed(0))


def _srv(**kw):
    _, bundle, params = _tiny_lm()
    return LMServer(bundle, params, ServeConfig(**kw))


# ---------------------------------------------------------------------------
# LMServer (tests/test_serving.py's LM cases)
# ---------------------------------------------------------------------------

def test_lm_server_slots_and_outputs():
    cfg, _, _ = _tiny_lm()
    srv = _srv(max_batch=4, seq_cap=32)
    with pytest.warns(DeprecationWarning):
        r1 = srv.add_request(np.array([1, 2, 3], np.int32))
        r2 = srv.add_request(np.array([4, 5], np.int32))
    for _ in range(6):
        srv.step()
    assert len(srv.outputs[r1]) == 6 and len(srv.outputs[r2]) == 6
    assert all(0 <= t < cfg.vocab_size for t in srv.outputs[r1])
    with pytest.warns(DeprecationWarning):
        srv.finish(r1)
    r3 = srv.open_session(np.array([7], np.int32))
    srv.step()
    assert len(srv.outputs[r3]) >= 1


def test_dual_mode_batch_sizing():
    assert ServeConfig(max_batch=8, mode="throughput").effective_batch() == 8
    assert ServeConfig(max_batch=8, mode="low-power").effective_batch() == 2
    assert _srv(max_batch=8, mode="low-power", seq_cap=16).n_slots == 2


def test_lm_server_slot_reused_after_finish():
    srv = _srv(max_batch=2, seq_cap=32)
    r1 = srv.open_session(np.array([1, 2], np.int32))
    r2 = srv.open_session(np.array([3], np.int32))
    slot1 = srv.sched.slot_of[r1]
    with pytest.raises(RuntimeError):  # grid full: back-pressure
        srv.open_session(np.array([4], np.int32))
    srv.close(r1)
    assert not srv.sched.is_bound(r1)
    assert srv.pos[slot1] == 0
    r3 = srv.open_session(np.array([5], np.int32))
    assert srv.sched.slot_of[r3] == slot1
    srv.step()
    assert len(srv.outputs[r3]) == 1 and len(srv.outputs[r2]) >= 1


def test_lm_server_mid_decode_admission_preserves_live_requests():
    ctl = _srv(max_batch=2, seq_cap=48)
    c = ctl.open_session(np.array([7, 9, 4], np.int32))
    for _ in range(8):
        ctl.step()
    srv = _srv(max_batch=2, seq_cap=48)
    r = srv.open_session(np.array([7, 9, 4], np.int32))
    for _ in range(3):
        srv.step()
    srv.open_session(np.array([1, 2], np.int32))
    for _ in range(5):
        srv.step()
    assert srv.outputs[r] == ctl.outputs[c]


def test_lm_server_reused_slot_decodes_like_fresh_slot():
    fresh = _srv(max_batch=2, seq_cap=32)
    rf = fresh.open_session(np.array([5], np.int32))
    fresh.step()
    srv = _srv(max_batch=2, seq_cap=32)
    r1 = srv.open_session(np.array([1, 2], np.int32))
    srv.step()
    srv.close(r1)
    r2 = srv.open_session(np.array([5], np.int32))
    srv.step()
    assert srv.outputs[r2][0] == fresh.outputs[rf][0]


@pytest.mark.parametrize("paged", [False, True])
def test_lm_server_oversubscription_parks_and_resumes(paged):
    ctl = _srv(max_batch=2, seq_cap=32)
    c = ctl.open_session(np.array([5, 1], np.int32))
    for _ in range(6):
        ctl.step()
    _, bundle, params = _tiny_lm()
    srv = LMServer(bundle, params, ServeConfig(max_batch=2, seq_cap=32,
                                               max_sessions=3), paged=paged)
    r1 = srv.open_session(np.array([5, 1], np.int32))
    for _ in range(2):
        srv.step()
    srv.open_session(np.array([7], np.int32))
    r3 = srv.open_session(np.array([9], np.int32))
    assert srv.poll(r1)["state"] == "parked"
    for _ in range(4):
        srv.step()
    assert srv.outputs[r1] == ctl.outputs[c]
    assert len(srv.outputs[r3]) == 4
    assert srv.stats()["evictions"] >= 2
    assert srv.service.paged == paged


def test_lm_server_is_protocol_adapter():
    srv = _srv(max_batch=2, seq_cap=32)
    assert isinstance(srv, SessionService)
    sid = srv.open_session(np.array([1, 2], np.int32))
    toks = srv.push({sid: 3})[sid]
    assert len(toks) == 3 and srv.outputs[sid] == toks
    assert srv.poll(sid)["generated"] == 3
    assert srv.stats()["service"] == "lm" and srv.n_slots == 2
    assert "dispatches_total" in srv.metrics()
    srv.park(sid)
    srv.resume(sid)
    assert srv.poll(sid)["state"] == "active"
    with pytest.raises(NotImplementedError):
        srv.enroll(sid, np.zeros((1, 2), np.float32))
    srv.close(sid)
    assert srv.stats()["live_sessions"] == 0


def test_lm_server_shims_warn_and_delegate():
    srv = _srv(max_batch=2, seq_cap=32)
    with pytest.warns(DeprecationWarning, match="open_session"):
        rid = srv.add_request(np.array([1, 2], np.int32))
    srv.step()
    assert len(srv.outputs[rid]) == 1
    with pytest.warns(DeprecationWarning, match="close"):
        srv.finish(rid)
    assert srv.service.stats()["live_sessions"] == 0


@pytest.mark.parametrize("k", [1, 4])
def test_speculative_decoding_is_refused(k):
    """A server asked to speculate with an unknown verify mode raises
    instead of decoding some other way."""
    with pytest.raises(ValueError, match="verify"):
        _srv(max_batch=2, seq_cap=32, speculative=k, spec_verify="teleport")


@pytest.mark.parametrize("verify", ["scan", "parallel"])
@pytest.mark.parametrize("k", [1, 4])
def test_lm_server_speculates(k, verify):
    """``ServeConfig(speculative=k)`` decodes through the server's
    SpeculativeDecoder: every request gains exactly n tokens a step; scan
    mode's streams are a plain server's bit for bit."""
    plain = _srv(max_batch=2, seq_cap=32)
    srv = _srv(max_batch=2, seq_cap=32, speculative=k, spec_verify=verify)
    assert srv.spec is not None and srv.spec.k == k
    assert srv.spec.verify == verify
    prompts = [np.array([1, 2, 1, 2, 1], np.int32), np.array([7], np.int32)]
    for s in (plain, srv):
        for p in prompts:
            s.open_session(p)
        s.step(1)
        s.step(9)
    assert all(len(o) == 10 for o in srv.outputs.values())
    if verify == "scan":
        assert srv.outputs == plain.outputs
    assert srv.spec.drafted > 0
    assert srv.metrics()["spec_drafted_total"][0]["value"] == \
        srv.spec.drafted


# ---------------------------------------------------------------------------
# protocol conformance (tests/test_service_protocol.py's LM case)
# ---------------------------------------------------------------------------

def _lm_svc(**kw):
    _, bundle, params = _tiny_lm()
    return LMSessionService(bundle, params, n_slots=2, seq_cap=32,
                            t_chunk=4, max_sessions=8, **kw)


@pytest.mark.parametrize("paged", [False, True])
def test_conforms_and_lifecycle_matrix(paged):
    svc = _lm_svc(paged=paged)
    assert isinstance(svc, SessionService)
    for verb in ("open_session", "push", "park", "resume", "close",
                 "poll", "metrics", "stats", "enroll"):
        assert callable(getattr(svc, verb)), verb
    sid = svc.open_session(np.array([3, 1], np.int32))
    assert svc.stats()["live_sessions"] == 1 and svc.stats()["bound"] == 1
    assert sid in svc.push({sid: 2})
    svc.park(sid)
    st = svc.stats()
    assert st["bound"] == 0 and st["parked"] == 1
    assert st["parked_blob_bytes"] > 0
    svc.resume(sid)
    st = svc.stats()
    assert st["bound"] == 1 and st["parked"] == 0
    assert sid in svc.push({sid: 2})
    svc.close(sid)
    st = svc.stats()
    assert st["live_sessions"] == 0 and st["bound"] == 0 and st["parked"] == 0
    with pytest.raises(KeyError):
        svc.resume(999)


def test_resume_is_bit_identical_to_lazy_rebind():
    eager, lazy = _lm_svc(), _lm_svc()
    a = eager.open_session(np.array([3, 1], np.int32))
    b = lazy.open_session(np.array([3, 1], np.int32))
    eager.push({a: 2}), lazy.push({b: 2})
    eager.park(a), lazy.park(b)
    eager.resume(a)
    assert eager.push({a: 2})[a] == lazy.push({b: 2})[b]


@pytest.mark.parametrize("paged", [False, True])
def test_stats_and_metrics_schema(paged):
    svc = _lm_svc(paged=paged)
    for _ in range(2):  # fresh and exercised
        st = svc.stats()
        assert not [k for k in STATS_SCHEMA if k not in st]
        assert st["service"] == "lm" and st["slot_state_bytes"] > 0
        assert st["slot_state_bytes"] == svc.kv_park_bytes(32)
        sid = svc.open_session(np.array([3, 1], np.int32))
        svc.push({sid: 2})
    snap = _lm_svc(paged=paged).metrics()
    for k in METRICS_SCHEMA:
        assert any(e["labels"].get("service") == "lm" for e in snap[k]), k
    if paged:
        assert "pool_blocks_live" in snap and "pool_blocks_total" in snap


def test_device_counters_leave_tokens_unchanged():
    a, b = _lm_svc(), _lm_svc(device_counters=True)
    sa = a.open_session(np.array([3, 1, 2], np.int32))
    sb = b.open_session(np.array([3, 1, 2], np.int32))
    assert a.push({sa: 5})[sa] == b.push({sb: 5})[sb]
    m = b.metrics()
    assert m["device_live_steps_total"][0]["value"] > 0
    assert "device_live_steps_total" not in a.metrics()


# ---------------------------------------------------------------------------
# the ServingPlane over two port LM services
# ---------------------------------------------------------------------------

def _plane_svc(n_slots=4, max_sessions=8):
    _, bundle, params = _tiny_lm(1, 16, 32, 32, 8)
    return LMSessionService(bundle, params, n_slots=n_slots, seq_cap=32,
                            t_chunk=4, max_sessions=max_sessions)


def _prompt(i):
    return np.array([(i % 7) + 1, ((3 * i) % 7) + 1], np.int32)


def _reference(n, want):
    """Each session decoded alone on a fresh fault-free service."""
    out = {}
    for i in range(n):
        svc = _plane_svc(n_slots=1, max_sessions=1)
        sid = svc.open_session(_prompt(i))
        out[i] = svc.decode({sid: want})[sid]
    return out


async def _persist(op, max_attempts=300):
    for attempt in range(max_attempts):
        try:
            return await op()
        except Rejected as e:
            if not e.retryable:
                raise
            await asyncio.sleep(min(0.0005 * (attempt + 1), 0.005))
    raise AssertionError("op did not complete within the retry budget")


def test_plane_over_lm_services_crash_and_drain():
    """Two LM workers behind the plane, journal on every op: worker 0
    crashes twice (opens and batched pushes), clients retry through, then
    the worker holding session 0 drains to its peer and comes back; no
    session is lost and every stream equals its solo synchronous run."""
    N, CHUNK, ROUNDS = 6, 2, 3

    async def main():
        inj = FaultInjector(_plane_svc(), FaultPlan.parse("crash@2,crash@9"),
                            factory=_plane_svc)
        plane = ServingPlane([inj, _plane_svc()], checkpoint_every=1,
                             metrics=MetricsRegistry())
        async with plane:
            psids = [await _persist(lambda i=i: plane.open_session(
                _prompt(i), tenant=f"t{i % 3}")) for i in range(N)]

            async def client(i, rounds):
                toks = []
                for _ in range(rounds):
                    toks += await _persist(
                        lambda: plane.push(psids[i], CHUNK))
                return toks

            first = await asyncio.gather(*(client(i, ROUNDS - 1)
                                           for i in range(N)))
            victim = plane._sessions[psids[0]][0]
            summary = await plane.drain(victim.idx)
            assert plane.stats()["health"][victim.idx] == DRAINED
            assert all(plane._sessions[p][0] is not victim for p in psids)
            plane.undrain(victim.idx)
            rest = await asyncio.gather(*(client(i, 1) for i in range(N)))
            polls = [await _persist(lambda p=p: plane.poll(p))
                     for p in psids]
            for p in psids:
                await _persist(lambda p=p: plane.close(p))
            return (first, rest, polls, summary, plane.stats(),
                    plane.metrics(), inj.crashes)

    first, rest, polls, summary, stats, m, crashes = asyncio.run(main())
    assert crashes == 2
    assert stats["lost_sessions"] == 0
    assert stats["health"] == [HEALTHY, HEALTHY]
    assert m["plane_crashes_total"][0]["value"] == 2
    assert m["plane_recoveries_total"][0]["value"] == 2
    assert summary["moved_sessions"] >= 1
    ref = _reference(N, CHUNK * ROUNDS)
    for i in range(N):
        assert first[i] + rest[i] == ref[i], f"session {i} diverged"
        assert polls[i]["generated"] == CHUNK * ROUNDS


def test_plane_continuous_batching_bit_identical():
    N, WANT = 8, 6

    async def main():
        plane = ServingPlane(_plane_svc(n_slots=4, max_sessions=N),
                             metrics=MetricsRegistry())
        async with plane:
            psids = [await plane.open_session(_prompt(i)) for i in range(N)]

            async def client(i):
                toks = []
                for _ in range(3):
                    toks += await plane.push(psids[i], WANT // 3)
                return toks

            outs = await asyncio.gather(*(client(i) for i in range(N)))
            return outs, plane.metrics()

    outs, m = asyncio.run(main())
    ref = _reference(N, WANT)
    assert all(outs[i] == ref[i] for i in range(N))
    assert m["plane_batches_total"][0]["value"] < N * 3
