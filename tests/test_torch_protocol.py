"""The port's SessionService protocol: the TCN cases of
tests/test_service_protocol.py (conformance, the lifecycle matrix, resume
== lazy rebind, the frozen stats()/metrics() schemas, equal to the
reference's tuples) and its RuntimeConfig (precedence, truthiness, and
each ENV_* equal to its owning module's ENV_VAR).  Inside the port the
checks are bit-exact; the lifecycle also runs through the reference's
service, allclose."""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_pair import same_result, svc  # noqa: E402
from repro import sessions as jsessions  # noqa: E402
from repro_torch.configs import RuntimeConfig  # noqa: E402
from repro_torch.configs import runtime as rt  # noqa: E402
from repro_torch.sessions import (  # noqa: E402
    METRICS_SCHEMA,
    STATS_SCHEMA,
    SessionService,
    StreamSessionService,
)


def _make(**kw):
    return svc(paged=False, max_ways=2, t_chunk=4, max_sessions=8, **kw)


def _work(rng):
    return rng.normal(size=(4, 2)).astype(np.float32)


def test_schemas_equal_reference():
    assert STATS_SCHEMA == jsessions.STATS_SCHEMA
    assert METRICS_SCHEMA == jsessions.METRICS_SCHEMA


def test_conforms_to_protocol():
    s = _make()
    assert isinstance(s, SessionService)
    for verb in ("open_session", "push", "park", "resume", "close",
                 "poll", "metrics", "stats", "enroll"):
        assert callable(getattr(s, verb)), verb
    assert StreamSessionService.push is StreamSessionService.push_audio
    assert StreamSessionService.enroll is StreamSessionService.enroll_shots
    assert s.tenant_aware


def test_lifecycle_matrix():
    """open -> push -> park -> resume -> push -> close through the
    protocol verbs only, with stats() tracking every transition, in both
    packages on the same work."""
    results = []
    for ref in (False, True):
        rng = np.random.default_rng(0)
        s = _make(ref=ref)
        sid = s.open_session()
        st = s.stats()
        assert st["live_sessions"] == 1 and st["bound"] == 1
        r1 = s.push({sid: _work(rng)})[sid]
        s.park(sid)
        st = s.stats()
        assert st["bound"] == 0 and st["parked"] == 1
        assert st["parked_blob_bytes"] > 0
        assert s.metrics()["parked_bytes"][0]["value"] \
            == st["parked_blob_bytes"]
        s.resume(sid)
        st = s.stats()
        assert st["bound"] == 1 and st["parked"] == 0
        assert st["parked_blob_bytes"] == 0
        r2 = s.push({sid: _work(rng)})[sid]
        s.close(sid)
        st = s.stats()
        assert (st["live_sessions"], st["bound"], st["parked"]) == (0, 0, 0)
        results.append((r1, r2, {k: st[k] for k in STATS_SCHEMA}))
    for a, b in zip(results[0][:2], results[1][:2]):
        same_result(a, b, exact=False)
    assert results[0][2] == results[1][2]


def test_resume_is_bit_identical_to_lazy_rebind():
    rng = np.random.default_rng(1)
    eager, lazy = _make(), _make()
    a, b = eager.open_session(), lazy.open_session()
    w = _work(rng)
    eager.push({a: w}), lazy.push({b: w})
    eager.park(a), lazy.park(b)
    eager.resume(a)
    w2 = _work(rng)
    same_result(eager.push({a: w2})[a], lazy.push({b: w2})[b], exact=True)


def test_resume_unknown_session_raises():
    with pytest.raises(KeyError):
        _make().resume(999)


def test_stats_schema():
    s = _make()
    rng = np.random.default_rng(2)
    for _ in range(2):  # fresh and exercised
        st = s.stats()
        missing = [k for k in STATS_SCHEMA if k not in st]
        assert not missing, f"stats() missing schema keys: {missing}"
        assert st["service"] == "tcn" and st["slot_state_bytes"] > 0
        sid = s.open_session()
        s.push({sid: _work(rng)})
    assert s.stats()["slot_state_bytes"] \
        == _make(ref=True).stats()["slot_state_bytes"]


def test_metrics_schema():
    snap = _make().metrics()
    missing = [k for k in METRICS_SCHEMA if k not in snap]
    assert not missing, f"metrics() missing schema series: {missing}"
    for k in METRICS_SCHEMA:
        assert any(e["labels"].get("service") == "tcn" for e in snap[k]), k
    assert snap == _make(ref=True).metrics()  # a fresh service's, equal


# ---------------------------------------------------------------------------
# RuntimeConfig
# ---------------------------------------------------------------------------

def test_runtime_env_names_match_owning_modules():
    from repro_torch.kernels import dispatch
    from repro_torch.obs import device
    from repro_torch.serving import faults

    trace = importlib.import_module("repro_torch.obs.trace")
    assert rt.ENV_KERNEL_BACKEND == dispatch.ENV_VAR
    assert rt.ENV_DEVICE_COUNTERS == device.ENV_VAR
    assert rt.ENV_TRACE == trace.ENV_VAR
    assert rt.ENV_CHAOS == faults.ENV_VAR
    # the port's own prefix: a shared name would switch the reference
    from repro.configs import runtime as jrt
    for name in ("ENV_PAGED", "ENV_FUSED", "ENV_KERNEL_BACKEND", "ENV_TRACE",
                 "ENV_DEVICE_COUNTERS", "ENV_CHAOS"):
        assert getattr(rt, name).startswith("REPRO_TORCH_"), name
        assert getattr(rt, name) != getattr(jrt, name)


def test_runtime_precedence(monkeypatch):
    """explicit kwarg > env > default, field by field."""
    for name in (rt.ENV_PAGED, rt.ENV_FUSED, rt.ENV_KERNEL_BACKEND,
                 rt.ENV_CHAOS):
        monkeypatch.delenv(name, raising=False)
    assert RuntimeConfig.resolve().paged is False        # default
    assert RuntimeConfig.resolve().fused is True         # the port's default
    monkeypatch.setenv(rt.ENV_PAGED, "yes")
    assert RuntimeConfig.resolve().paged is True         # env
    assert RuntimeConfig.resolve(paged=False).paged is False  # kwarg wins
    monkeypatch.setenv(rt.ENV_FUSED, "0")
    assert RuntimeConfig.resolve().fused is False
    assert RuntimeConfig.resolve(fused=True).fused is True
    monkeypatch.setenv(rt.ENV_KERNEL_BACKEND, "ref")
    assert RuntimeConfig.resolve().kernel_backend == "ref"
    assert RuntimeConfig.resolve(kernel_backend="cuda").kernel_backend \
        == "cuda"
    monkeypatch.setenv(rt.ENV_CHAOS, "crash@3")
    assert RuntimeConfig.resolve().chaos == "crash@3"
    # a directly constructed config never reads the environment
    assert RuntimeConfig().paged is False and RuntimeConfig().fused is True
    assert RuntimeConfig().kernel_backend is None
    with pytest.raises(TypeError):
        RuntimeConfig.resolve(nonsense=1)


@pytest.mark.parametrize("raw,want", [("1", True), ("true", True),
                                      ("YES ", True), ("0", False),
                                      ("no", False), ("2", False),
                                      ("", None), ("  ", None)])
def test_runtime_truthiness_matches_reference(monkeypatch, raw, want):
    """Set values parse as the reference's; an unset or empty variable
    leaves each field's default."""
    from repro.configs import RuntimeConfig as JRuntimeConfig
    from repro.configs import runtime as jrt

    for name in ("ENV_PAGED", "ENV_FUSED", "ENV_DEVICE_COUNTERS"):
        monkeypatch.setenv(getattr(rt, name), raw)
        monkeypatch.setenv(getattr(jrt, name), raw)
    got, ref = RuntimeConfig.resolve(), JRuntimeConfig.resolve()
    default = RuntimeConfig()
    for field in ("paged", "fused", "device_counters"):
        expect = getattr(default, field) if want is None else want
        assert getattr(got, field) is expect, field
        if want is not None:
            assert getattr(ref, field) is want, field


def test_services_honor_runtime_config(monkeypatch):
    monkeypatch.delenv(rt.ENV_FUSED, raising=False)
    monkeypatch.delenv(rt.ENV_DEVICE_COUNTERS, raising=False)
    assert _make().fused is True
    assert _make(fused=None, runtime=RuntimeConfig(fused=False)).fused \
        is False
    assert _make(fused=True, runtime=RuntimeConfig(fused=False)).fused \
        is True
    assert _make(runtime=RuntimeConfig(device_counters=True)) \
        .device_counters is True
    monkeypatch.setenv(rt.ENV_FUSED, "0")
    assert _make(fused=None).fused is False  # env through the default
    monkeypatch.setenv(rt.ENV_DEVICE_COUNTERS, "1")
    assert _make().device_counters is True
