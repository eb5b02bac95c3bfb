"""The spans of the TCN service's push and enrollment (sessions/service.py,
core/streaming.py, obs/trace.py): one per layer of a call, nested, each
with the call's id; nothing recorded and no profiler range opened by a
disabled tracer; the same bits with tracing on and off; the ranges on
torch.profiler's clock; and the counts the spans carry."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_pair import grids_equal, svc  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.obs.trace import _NULL_SPAN, PREFIX  # noqa: E402

PUSH_SPANS = {"push.pack", "slot_fc", "tick.pack", "dispatch", "upload",
              "chunk", "head", "banked", "readback", "tick.scatter",
              "push.results"}
# the enrollment's sync runs on a card only
ENROLL_SPANS = {"enroll", "enroll.upload", "enroll.embed", "enroll.bank"}
# span -> the span it nests in
PARENT = {"upload": "dispatch", "chunk": "dispatch", "head": "dispatch",
          "banked": "dispatch", "readback": "dispatch",
          "enroll.upload": "enroll", "enroll.embed": "enroll",
          "enroll.bank": "enroll"}


def _drive(s, rng):
    """Two streams, one with a tenant: an enrollment, then a push of 11
    steps (ticks of 8 and 4), then a single sample.  Returns the results
    of the pushes and the two sids."""
    a, b = s.open_session(tenant=None), s.open_session()
    shots = rng.normal(size=(2, 6, 2)).astype(np.float32)
    outs = [s.enroll_shots(a, shots)]
    x = rng.normal(size=(2, 11, 2)).astype(np.float32)
    outs.append(s.push_audio({a: x[0], b: x[1]}))
    outs.append(s.push_audio({a: x[0, 0]}))
    return outs, (a, b)


def _holds(outer, inner) -> bool:
    return outer["ts"] <= inner["ts"] and \
        inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def test_push_and_enrollment_emit_nested_spans_with_their_call():
    t = obs.Tracer(enabled=True)
    s = svc(tracer=t, t_chunk=8)
    _drive(s, np.random.default_rng(0))
    spans = [e for e in t.events() if e["ph"] == "X"]
    by_call: dict = {}
    for e in spans:
        if "call" in e["args"]:
            by_call.setdefault(e["args"]["call"], []).append(e)
    assert sorted(by_call) == [1, 2, 3] and s.calls == 3
    assert {e["name"] for e in by_call[1]} == ENROLL_SPANS
    assert {e["name"] for e in by_call[2]} >= PUSH_SPANS
    assert {e["name"] for e in by_call[3]} >= PUSH_SPANS
    # two ticks (8 + 4 steps), one span per layer a tick, none per step
    names = [e["name"] for e in by_call[2]]
    for name in ("tick.pack", "dispatch", "upload", "chunk", "head",
                 "banked", "readback", "tick.scatter"):
        assert names.count(name) == 2, (name, names)
    for name in ("push.pack", "slot_fc", "push.results"):
        assert names.count(name) == 1, (name, names)
    for call, evs in by_call.items():
        for e in evs:
            if e["name"] in PARENT:
                parents = [p for p in evs if p["name"] == PARENT[e["name"]]
                           and _holds(p, e)]
                assert len(parents) == 1, (call, e["name"])
    # the calls follow each other: no span of one lies inside another's
    ends = [(min(e["ts"] for e in by_call[c]),
             max(e["ts"] + e["dur"] for e in by_call[c])) for c in (1, 2, 3)]
    assert ends[0][1] <= ends[1][0] and ends[1][1] <= ends[2][0]
    # the counts
    first = {e["name"]: e["args"] for e in by_call[2]}
    assert first["push.pack"]["streams"] == 2
    assert first["push.pack"]["steps"] == 11
    assert first["slot_fc"]["paged"] is True
    assert [e["args"]["t_pad"] for e in by_call[2]
            if e["name"] == "tick.pack"] == [8, 4]
    assert [e["args"]["steps"] for e in by_call[2]
            if e["name"] == "head"] == [8, 4]
    assert first["chunk"]["spans"] == 1
    assert first["banked"]["ways"] >= s.max_ways
    assert first["upload"]["bytes"] == s.n_slots * 4 * (2 * 4 + 1)
    enroll = {e["name"]: e["args"] for e in by_call[1]}
    assert enroll["enroll.upload"]["bytes"] == 2 * 6 * 2 * 4
    assert enroll["enroll.embed"] == {"shots": 2, "steps": 6, "call": 1}
    assert enroll["enroll.bank"]["new_way"] is True


def test_disabled_tracer_records_nothing_and_opens_no_profiler_range(
        tmp_path):
    t = obs.Tracer()
    assert t.span("push.pack", streams=2) is _NULL_SPAN
    assert t.call_scope(1) is _NULL_SPAN
    s = svc(tracer=t, t_chunk=8)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _drive(s, np.random.default_rng(1))
    assert t.events() == [] and s.calls == 3
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    events = json.load(open(tmp_path / "t.json"))["traceEvents"]
    assert not [e for e in events
                if str(e.get("name", "")).startswith(PREFIX)]


def test_outputs_rings_and_banks_are_the_same_bits_traced_or_not():
    runs = []
    for enabled in (False, True):
        s = svc(tracer=obs.Tracer(enabled=enabled), t_chunk=8)
        if enabled:  # the profiler's ranges too
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU]):
                outs, sids = _drive(s, np.random.default_rng(2))
        else:
            outs, sids = _drive(s, np.random.default_rng(2))
        runs.append((s, outs, sids))
    (s0, o0, (a0, _)), (s1, o1, (a1, _)) = runs
    assert o0[0] == o1[0]  # the way
    for p0, p1 in zip(o0[1:], o1[1:]):
        assert p0.keys() == p1.keys()
        for r0, r1 in zip(p0.values(), p1.values()):
            for key in ("emb", "logits", "tenant_logits"):
                np.testing.assert_array_equal(r0[key], r1[key])
            assert r0["pred"] == r1["pred"] and r0["step"] == r1["step"]
    assert grids_equal(s0.states, s1.states)
    t0 = s0.sessions[a0].tenant
    b0, b1 = s0.export_tenant(t0), s1.export_tenant(s1.sessions[a1].tenant)
    for key in ("s_sums", "counts"):
        np.testing.assert_array_equal(b0[key], b1[key])


def test_spans_are_profiler_ranges_on_its_clock(tmp_path):
    t = obs.Tracer(enabled=True)
    s = svc(tracer=t, t_chunk=8)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _drive(s, np.random.default_rng(3))
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    events = json.load(open(tmp_path / "t.json"))["traceEvents"]
    ranges = [e for e in events if e.get("ph") == "X"
              and e["name"].startswith(PREFIX)]
    assert all(e["cat"] == "user_annotation" for e in ranges)
    names = [e["name"][len(PREFIX):] for e in ranges]
    assert set(names) >= PUSH_SPANS | ENROLL_SPANS
    # every span, the binds of open_session outside any call too
    assert sorted(names) == sorted(e["name"] for e in t.events()
                                   if e["ph"] == "X")
    # the ATen ops of the fused chunk's head run inside its range
    heads = [e for e in ranges if e["name"] == PREFIX + "head"]
    ops = [e for e in events if e.get("cat") == "cpu_op"
           and any(_holds(h, e) for h in heads)]
    assert any(e["name"] in ("aten::mm", "aten::matmul") for e in ops)


def test_readback_bytes_are_the_bytes_returned():
    t = obs.Tracer(enabled=True)
    s = svc(tracer=t, t_chunk=8)
    sids = [s.open_session(tenant=None) for _ in range(s.n_slots)]
    rng = np.random.default_rng(4)
    for sid in sids:
        s.enroll_shots(sid, rng.normal(size=(2, 6, 2)).astype(np.float32))
    t.clear()
    x = rng.normal(size=(len(sids), 8, 2)).astype(np.float32)
    # one tick, every slot pushed and personalized: what is copied back
    # is what is returned
    out = s.push_audio({sid: x[i] for i, sid in enumerate(sids)})
    got = [e["args"]["bytes"] for e in t.events() if e["name"] == "readback"]
    assert got == [sum(r[key].nbytes for r in out.values()
                       for key in ("emb", "logits", "tenant_logits"))]
