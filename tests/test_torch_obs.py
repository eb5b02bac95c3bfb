"""The port's telemetry (repro_torch.obs) against the reference's: the
metrics registry, histogram quantiles and Prometheus text equal for the
same calls, byte for byte; tracer spans, instants and ring-buffer drops;
the device occupancy and acceptance counters equal to the jnp versions;
and, inside the port, the instrumented tick bit-identical to the plain
one, per-shape dispatch latency and the counter properties."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_pair import grids_equal, svc  # noqa: E402
from repro import obs as jobs  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.obs.metrics import Histogram  # noqa: E402


def _calls(reg, rng):
    """One fixed sequence of registry calls, with values from ``rng``."""
    reg.counter("evictions_total", service="tcn").inc(2)
    reg.counter("plane_rejected_total", reason="crash").inc()
    reg.gauge("parked_bytes", service="tcn").set(1892)
    reg.gauge("device_pad_waste", service="tcn").set(0.375)
    g = reg.gauge("sessions_bound", service="tcn")
    g.inc(3)
    g.dec()
    for shape in ("T16", "T1", "T4"):
        h = reg.histogram("dispatch_latency_us", service="tcn", shape=shape)
        for v in rng.lognormal(5.0, 2.0, size=37):
            h.record(float(v))
    reg.histogram("plane_mttr_us")  # registered, never recorded
    reg.histogram("enroll_latency_us", service="tcn").record(0.5)


def test_registry_snapshot_and_exposition_equal_reference():
    got, want = obs.MetricsRegistry(), jobs.MetricsRegistry()
    _calls(got, np.random.default_rng(0))
    _calls(want, np.random.default_rng(0))
    assert got.snapshot() == want.snapshot()
    assert got.to_json(sort_keys=True) == want.to_json(sort_keys=True)
    assert got.prometheus() == want.prometheus()
    text = got.prometheus()
    assert "# TYPE evictions_total counter" in text
    assert 'evictions_total{service="tcn"} 2' in text
    assert 'plane_mttr_us_bucket{le="+Inf"} 0' in text
    rows = got.snapshot()["dispatch_latency_us"]
    assert obs.latency_summary(rows, by="shape") == \
        jobs.latency_summary(rows, by="shape")
    m, jm = obs.merge_histogram_rows(rows), jobs.merge_histogram_rows(rows)
    assert m.to_dict() == jm.to_dict()
    got.reset()
    want.reset()
    assert got.prometheus() == want.prometheus()


@pytest.mark.parametrize("q", [0, 1, 25, 50, 90, 99, 99.9, 100])
def test_histogram_quantiles_equal_reference(q):
    rng = np.random.default_rng(3)
    h, jh = Histogram(), jobs.Histogram()
    for v in np.concatenate([rng.uniform(0, 1, 50),
                             rng.uniform(10, 10000, 2000)]):
        h.record(float(v))
        jh.record(float(v))
    assert h.percentile(q) == jh.percentile(q)
    assert h.to_dict() == jh.to_dict()
    with pytest.raises(ValueError):
        h.percentile(101)


def test_counter_gauge_and_kind_conflict():
    reg = obs.MetricsRegistry()
    c = reg.counter("reqs_total", service="tcn")
    c.inc()
    c.inc(4)
    assert c.value == 5 and reg.counter("reqs_total", service="tcn") is c
    assert reg.counter("reqs_total", service="lm") is not c
    with pytest.raises(ValueError):
        c.inc(-1)
    with pytest.raises(TypeError):
        reg.gauge("reqs_total", service="tcn")
    assert obs.default_registry() is obs.default_registry()
    assert obs.default_registry() is not jobs.default_registry()


# ---------------------------------------------------------------------------
# trace
# ---------------------------------------------------------------------------

def test_tracer_spans_instants_counters_and_export(tmp_path):
    off = obs.Tracer()
    with off.span("dispatch", cat="tcn"):
        pass
    off.instant("evict")
    assert off.events() == []
    t = obs.Tracer(enabled=True)
    with t.span("dispatch", cat="tcn", shape="T16", lanes=3):
        pass
    t.instant("evict", cat="tcn", victim=7)
    t.counter("sessions", bound=2, parked=1)
    evs = t.events()
    assert [e["ph"] for e in evs] == ["X", "i", "C"]
    assert evs[0]["args"] == {"shape": "T16", "lanes": 3}
    assert evs[0]["dur"] >= 0 and evs[1]["args"]["victim"] == 7
    # the event records carry the reference's keys
    jt = jobs.Tracer(enabled=True)
    with jt.span("dispatch", cat="tcn", shape="T16", lanes=3):
        pass
    jt.instant("evict", cat="tcn", victim=7)
    jt.counter("sessions", bound=2, parked=1)
    for a, b in zip(evs, jt.events()):
        assert a.keys() == b.keys()
        assert {k: a[k] for k in ("name", "ph", "cat", "args") if k in a} \
            == {k: b[k] for k in ("name", "ph", "cat", "args") if k in b}
    doc = json.load(open(t.export(str(tmp_path / "trace.json"))))
    assert doc["traceEvents"] == evs
    assert doc["otherData"]["dropped_events"] == 0


def test_trace_ring_buffer_drops_oldest():
    t = obs.Tracer(enabled=True, capacity=4)
    for i in range(10):
        t.instant(f"e{i}")
    assert [e["name"] for e in t.events()] == ["e6", "e7", "e8", "e9"]
    assert t.dropped == 6
    t.clear()
    assert t.events() == [] and t.dropped == 0


# ---------------------------------------------------------------------------
# device counters against the jnp versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lengths,t_pad", [([5, 0, 3, 8], 8), ([0, 0], 4),
                                           ([16] * 64, 16), ([1], 1)])
def test_occupancy_stats_equal_reference(lengths, t_pad):
    got = obs.occupancy_stats(torch.tensor(lengths, dtype=torch.int32), t_pad)
    want = np.asarray(jobs.occupancy_stats(jnp.asarray(lengths), t_pad))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert obs.decode_occupancy(got) == jobs.decode_occupancy(want)
    valid = np.arange(t_pad)[None, :] < np.asarray(lengths)[:, None]
    np.testing.assert_array_equal(
        obs.valid_stats(torch.from_numpy(valid)).numpy(),
        np.asarray(jobs.valid_stats(valid)))


def test_acceptance_stats_equal_reference():
    rng = np.random.default_rng(4)
    draft = rng.integers(0, 3, size=(32, 5))
    ys = np.concatenate([draft, rng.integers(0, 3, size=(32, 1))], axis=1)
    flip = rng.random(size=ys.shape) < 0.2
    ys = np.where(flip, (ys + 1) % 3, ys)
    n_draft = rng.integers(0, 6, size=32)
    got = obs.acceptance_stats(torch.from_numpy(ys), torch.from_numpy(draft),
                               torch.from_numpy(n_draft))
    want = np.asarray(jobs.acceptance_stats(ys, draft, n_draft))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32


# ---------------------------------------------------------------------------
# the instrumented service
# ---------------------------------------------------------------------------

def test_instrumented_tick_bit_identical_and_ingested():
    """device_counters=True adds the tick's occupancy; outputs and every
    state leaf stay the same bits.  Port and reference ingest the same
    counts."""
    x = np.random.default_rng(0).normal(size=(2, 21, 2)).astype(np.float32)
    outs, svcs = [], []
    for dev, ref in ((False, False), (True, False), (True, True)):
        s = svc(ref=ref, t_chunk=8, device_counters=dev)
        sids = [s.open_session() for _ in range(2)]
        outs.append(s.push({sid: x[i] for i, sid in enumerate(sids)}))
        svcs.append(s)
    for a, b in zip(outs[0].values(), outs[1].values()):
        np.testing.assert_array_equal(a["emb"], b["emb"])
        np.testing.assert_array_equal(a["logits"], b["logits"])
    assert grids_equal(svcs[0].states, svcs[1].states)
    got, want = svcs[1].metrics(), svcs[2].metrics()
    assert got["device_live_steps_total"][0]["value"] == 2 * 21
    for name in ("device_live_steps_total", "device_masked_steps_total",
                 "device_lane_occupancy", "device_pad_waste",
                 "device_live_step_ratio"):
        assert got[name] == want[name], name
    assert svcs[0].metrics().get("device_live_steps_total") is None


def test_dispatch_latency_histograms_per_shape():
    """Each tick lands one sample in its shape's histogram; the counts
    equal the reference's for the same pushes."""
    counts = []
    for ref in (False, True):
        s = svc(ref=ref, t_chunk=8)
        sid = s.open_session()
        s.push_audio({sid: np.zeros((11, 2), np.float32)})  # T8 + T4
        s.push_audio({sid: np.zeros((2,), np.float32)})     # T1
        hists = {h["labels"]["shape"]: h
                 for h in s.metrics()["dispatch_latency_us"]}
        assert set(hists) == {"T8", "T4", "T1"}
        assert sum(h["count"] for h in hists.values()) == s.dispatches == 3
        for h in hists.values():
            assert h["p50"] <= h["p99"] <= h["max"]
        counts.append({k: h["count"] for k, h in hists.items()})
    assert counts[0] == counts[1]


def test_tracer_records_service_lifecycle():
    t = obs.Tracer(enabled=True)
    s = svc(n_slots=1, max_sessions=4, tracer=t)
    a = s.open_session()
    s.push_audio({a: np.zeros((2,), np.float32)})
    s.open_session()                                  # grid of 1: evicts a
    s.push_audio({a: np.zeros((2,), np.float32)})     # resumes a
    names = [e["name"] for e in t.events()]
    for expected in ("bind", "dispatch", "pack", "evict", "unpack", "resume"):
        assert expected in names, f"missing {expected!r} in {names}"
    evict = next(e for e in t.events() if e["name"] == "evict")
    assert evict["args"]["victim"] == a
    dispatch = next(e for e in t.events() if e["name"] == "dispatch")
    assert dispatch["args"] == {"shape": "T1", "lanes": 1, "fused": True,
                                "call": 1}


def test_counter_properties_route_through_the_registry():
    s = svc()
    assert s.dispatches == 0
    s.dispatches += 5
    assert s.metrics()["dispatches_total"][0]["value"] == 5
    s.evictions = 2
    assert s.stats()["evictions"] == 2
    assert s.metrics()["evictions_total"][0]["value"] == 2
    sid = s.open_session()
    with pytest.raises(KeyError):
        s.park(sid + 999)
    s.park(sid)
    s.park(sid)  # already parked: no-op
    assert s.poll(sid)["state"] == "parked"
