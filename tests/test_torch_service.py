"""The slice as a whole: one open/push/enroll/poll schedule through the JAX
``StreamSessionService(fused=True, kernel_backend="ref")`` and the port's
service on the same params (carried by ``convert.params_from_jax``),
allclose at rtol=2e-4, atol=2e-5; then the port's own guarantees,
bit-exact: park/resume through explicit parks and LRU evictions, and
chunk-size invariance; parked blobs keep the reference's layout."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import build_bundle as j_build_bundle  # noqa: E402
from repro.models.tcn import tcn_empty_state as j_empty  # noqa: E402
from repro.sessions import StreamSessionService as JService  # noqa: E402
from repro.sessions import state as jstate  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import build_tcn_bundle  # noqa: E402
from repro_torch.sessions import AdmissionError, StreamSessionService  # noqa: E402
from repro_torch.sessions import state as tstate  # noqa: E402

RTOL, ATOL = 2e-4, 2e-5
SMALL = dict(tcn_channels=(8, 8), tcn_kernel=3, tcn_in_channels=2,
             embed_dim=12, n_classes=4)


@functools.lru_cache(maxsize=None)
def _setup(seed=0):
    jcfg = j_get_config("chameleon-tcn").replace(kernel_backend="ref", **SMALL)
    cfg = get_config("chameleon-tcn").replace(**SMALL)
    jbundle = j_build_bundle(jcfg)
    params = jbundle.init(jax.random.key(seed))
    rng = np.random.default_rng(seed + 3)
    bn = jax.tree.map(lambda a: a + jnp.asarray(
        0.05 * np.abs(rng.normal(size=a.shape)).astype(np.float32)),
        j_empty(jcfg))
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    bundle = build_tcn_bundle(cfg, "cpu")
    return (jbundle, params, bn, bundle, params_from_jax(np_tree(params), "cpu"),
            params_from_jax(np_tree(bn), "cpu"))


def _data(seed=1, n=3, T=40):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, T, 2)).astype(np.float32),
            rng.normal(size=(3, 2, 12, 2)).astype(np.float32))


def _schedule(svc, x, shots, *, park=False):
    """open (global head, dedicated tenant, shared tenant 0), ragged
    pushes, enroll 3 ways on the dedicated tenant, park, push, poll."""
    a = svc.open_session()
    b = svc.open_session(tenant=None)
    c = svc.open_session(tenant=0)
    out = [svc.push_audio({a: x[0, :9], b: x[1, :5], c: x[2, :13]})]
    for way in range(3):
        svc.enroll_shots(b, shots[way])
    if park:
        svc.park(a)
        svc.park(b)
        f = svc.open_session()  # takes a freed slot; b resumes elsewhere
        svc.push_audio({f: x[2, :3]})
    out.append(svc.push_audio({a: x[0, 9:30], b: x[1, 5:30], c: x[2, 13:17]}))
    out.append(svc.push_audio({b: x[1, 30:40], c: x[2, 17:40]}))
    return (a, b, c), out, [svc.poll(s) for s in (a, b, c)]


def _assert_same(out_a, out_b, ids_a, ids_b, *, exact):
    for ra, rb in zip(out_a, out_b):
        for sa, sb in zip(ids_a, ids_b):
            if sa not in ra:
                continue
            for key in ("emb", "logits", "tenant_logits"):
                va, vb = ra[sa][key], rb[sb][key]
                assert (va is None) == (vb is None), key
                if va is None:
                    continue
                if exact:
                    np.testing.assert_array_equal(va, vb)
                else:
                    live = np.isfinite(va)  # unlearned ways: bias -inf
                    np.testing.assert_array_equal(live, np.isfinite(vb))
                    np.testing.assert_allclose(va[live], vb[live],
                                               rtol=RTOL, atol=ATOL)
            assert ra[sa]["step"] == rb[sb]["step"]


@pytest.mark.parametrize("fused", [True, False])
def test_slice_matches_reference_service(fused):
    jbundle, params, bn, bundle, p, bnt = _setup()
    x, shots = _data()
    kw = dict(n_slots=3, max_tenants=2, max_ways=4, t_chunk=8, fused=fused)
    jsvc = JService(jbundle, params, bn, kernel_backend="ref", **kw)
    tsvc = StreamSessionService(bundle, p, bnt, **kw)
    ids_j, out_j, polls_j = _schedule(jsvc, x, shots)
    ids_t, out_t, polls_t = _schedule(tsvc, x, shots)
    _assert_same(out_j, out_t, ids_j, ids_t, exact=False)
    for pj, pt in zip(polls_j, polls_t):
        for key in ("state", "tenant", "n_ways", "steps"):
            assert pj[key] == pt[key], key
    assert tsvc.dispatches == jsvc.dispatches
    assert tsvc.stats()["slot_state_bytes"] == jsvc.stats()["slot_state_bytes"]


@pytest.mark.parametrize("quantize", [False, True])
def test_park_resume_bit_exact(quantize):
    *_, bundle, p, bnt = _setup()
    x, shots = _data(2)
    kw = dict(n_slots=3, max_tenants=2, max_ways=4, t_chunk=4,
              quantize=quantize, fused=True)
    ids_a, out_a, _ = _schedule(StreamSessionService(bundle, p, bnt, **kw), x, shots)
    svc = StreamSessionService(bundle, p, bnt, **kw)
    ids_b, out_b, polls = _schedule(svc, x, shots, park=True)
    assert svc.evictions >= 1  # a parked session came back through eviction
    assert svc.parked_blob_bytes > 0
    _assert_same(out_a, out_b, ids_a, ids_b, exact=True)


def test_chunk_size_invariance_bit_exact():
    *_, bundle, p, bnt = _setup()
    x, _ = _data(3, n=1, T=23)
    outs = []
    for t_chunk in (1, 4, 16):
        svc = StreamSessionService(bundle, p, bnt, n_slots=2, t_chunk=t_chunk,
                                   fused=True)
        sid = svc.open_session()
        r = svc.push_audio({sid: x[0]})[sid]
        outs.append((r["emb"], r["logits"]))
    for e, lg in outs[1:]:
        np.testing.assert_array_equal(outs[0][0], e)
        np.testing.assert_array_equal(outs[0][1], lg)


@pytest.mark.parametrize("quantize", [False, True])
def test_parked_blob_layout_matches_reference(quantize):
    """A slot packed by either package has the same keys, dtypes and
    shapes, decodes to the same values, and restores into the other."""
    jbundle, params, bn, bundle, p, bnt = _setup()
    cfg = bundle.cfg
    jcfg = jbundle.cfg
    g = tstate.grid_init(cfg, 2, "cpu")
    run = tstate.make_grid_fused(cfg, quantize=quantize, device="cpu")
    from repro_torch.models.tcn import bake_stream_params
    _, _, fp = bake_stream_params(p, bnt, cfg, quantize=quantize)
    x = torch.tensor(np.random.default_rng(4).normal(size=(2, 9, 2)).astype(np.float32))
    g, _, _ = run(fp, g, x, torch.tensor([9, 5], dtype=torch.int32))
    blob = tstate.pack_slot(g, 1, pack_u4=quantize)
    jg = jstate.grid_init(jcfg, 2)
    jg = jstate.unpack_slot(jg, 0, blob)  # the port's blob restores in JAX
    jblob = jstate.pack_slot(jg, 0, pack_u4=quantize)

    def walk(a, b):
        assert set(a) == set(b)
        for key in a:
            if isinstance(a[key], dict):
                walk(a[key], b[key])
            else:
                va, vb = np.asarray(a[key]), np.asarray(b[key])
                assert va.dtype == vb.dtype and va.shape == vb.shape, key
                np.testing.assert_array_equal(va, vb)

    walk(blob, jblob)
    assert tstate.parked_bytes(blob) == jstate.parked_bytes(jblob)
    g2 = tstate.unpack_slot(tstate.grid_init(cfg, 2, "cpu"), 1, jblob)
    for b in g["blocks"]:
        for r in ("ring1", "ring2"):
            assert torch.equal(g2["blocks"][b][r][1], g["blocks"][b][r][1])


def test_admission_tenants_and_errors():
    *_, bundle, p, bnt = _setup()
    svc = StreamSessionService(bundle, p, bnt, n_slots=2, max_tenants=2,
                               max_ways=1, t_chunk=4, max_sessions=2)
    a = svc.open_session(tenant=None)
    svc.open_session()
    with pytest.raises(AdmissionError):
        svc.open_session(tenant=None)
    assert svc._free_tenants == [1]  # the refused open returned its row
    with pytest.raises(ValueError):
        svc.open_session(tenant=5)
    with pytest.raises(ValueError):
        svc.push_audio({a: np.zeros((3, 5), np.float32)})
    shots = np.zeros((2, 6, 2), np.float32)
    assert svc.enroll_shots(a, shots, label="yes") == 0
    assert svc.enroll_shots(a, shots, label="yes") == 0  # refines way 0
    with pytest.raises(RuntimeError):
        svc.enroll_shots(a, shots)  # max_ways=1
    assert svc.poll(a)["n_ways"] == 1
    svc.close(a)
    assert sorted(svc._free_tenants) == [0, 1]  # dedicated row freed with it


@pytest.mark.parametrize("with_cost", [False, True])
def test_scheduler_decisions_match_reference(with_cost):
    """The same admit/bind/touch/park/release sequence gives the same
    placements and evictions in both schedulers (LRU and cost-aware)."""
    from repro.sessions.scheduler import SlotScheduler as JSched
    from repro_torch.sessions import SlotScheduler as TSched

    cost = (lambda sid: (sid * 7) % 5) if with_cost else None
    js, ts = (S(3, 6, cost_fn=cost, stale_window=2) for S in (JSched, TSched))
    rng = np.random.default_rng(9)
    live = []
    for step in range(60):
        op = int(rng.integers(4))
        if op == 0 and len(live) < 6:
            sid = step
            for s in (js, ts):
                s.admit(sid)
            live.append(sid)
        elif live:
            sid = live[int(rng.integers(len(live)))]
            if op == 1:
                pinned = set(live[:1])
                assert js.bind(sid, pinned) == ts.bind(sid, pinned)
            elif op == 2:
                js.touch(sid)
                ts.touch(sid)
                assert js.park(sid) == ts.park(sid)
            else:
                assert js.release(sid) == ts.release(sid)
                live.remove(sid)
        assert js.slot_of == ts.slot_of and js.parked == ts.parked


def test_fused_switch_and_backend():
    """The fused (kernel) executor is the default; ``fused=False`` selects
    the per-step one; a backend that does not match the device raises."""
    *_, bundle, p, bnt = _setup()
    assert StreamSessionService(bundle, p, bnt, n_slots=1).fused
    assert not StreamSessionService(bundle, p, bnt, n_slots=1, fused=False).fused
    svc = StreamSessionService(bundle, p, bnt, n_slots=1, kernel_backend="ref")
    assert svc.stats()["fused"]
    with pytest.raises(ValueError):
        StreamSessionService(bundle, p, bnt, n_slots=1, kernel_backend="cuda")
