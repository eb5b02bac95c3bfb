"""Spill/restore and session handoff in the port: dense and paged
parking lots through checkpoint/store and back into a fresh service, the
atomic refusals of tests/test_sessions.py and tests/test_cl_service.py,
export/detach/adopt of one session, all bit-exact; then files crossing
the packages both ways — a spill written by the JAX service restored by
the port and the reverse (same keys, dtypes and shapes; the continuation
allclose at rtol=2e-4, atol=2e-5), and tree checkpoints likewise."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_pair import same_result, svc  # noqa: E402
from repro.checkpoint import store as jstore  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.sessions import AdmissionError  # noqa: E402


def _data(seed=12):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(40, 2)).astype(np.float32),
            rng.normal(size=(2, 10, 2)).astype(np.float32))


def _flat_layout(path):
    with np.load(path) as z:
        return {k: (z[k].dtype, z[k].shape) for k in z.files
                if k != "__meta__"}


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("paged", [False, True])
def test_spill_restore_roundtrip(tmp_path, paged, quantize):
    """Sessions spilled to disk come back in a fresh service, parked, and
    continue bit for bit like a never-spilled control, tenant bank and
    nibble-packed rings included."""
    x, shots = _data()
    mk = lambda: svc(paged=paged, quantize=quantize, t_chunk=8)
    ctl, s = mk(), mk()
    c, a = ctl.open_session(tenant=None), s.open_session(tenant=None)
    g_c, g_a = ctl.open_session(), s.open_session()   # global head
    for v, sid, g in ((ctl, c, g_c), (s, a, g_a)):
        v.enroll_shots(sid, shots)
        v.push_audio({sid: x[:25], g: x[:13]})
    path = str(tmp_path / "sessions.npz")
    s.spill_parking(path, include_bound=True)
    assert s.poll(a)["state"] == "parked"
    fresh = mk()
    assert fresh.restore_parking(path) == [a, g_a]
    assert fresh.poll(a)["steps"] == 25 and fresh.poll(g_a)["steps"] == 13
    assert fresh.poll(a)["n_ways"] == 1
    assert fresh.stats()["parked_blob_bytes"] == s.stats()["parked_blob_bytes"]
    if paged:
        assert fresh.bankpool.pool.n_live == 0  # the tenant came back parked
    want = ctl.push_audio({c: x[25:], g_c: x[13:]})
    got = fresh.push_audio({a: x[25:], g_a: x[13:]})
    same_result(got[a], want[c], exact=True)
    same_result(got[g_a], want[g_c], exact=True)
    assert fresh.open_session() not in (a, g_a)  # sids stay unique


def test_restore_refuses_live_sid_collision(tmp_path):
    s = svc(paged=False, max_tenants=1)
    sid = s.open_session()
    s.push_audio({sid: np.zeros(2, np.float32)})
    path = str(tmp_path / "p.npz")
    s.spill_parking(path, include_bound=True)
    with pytest.raises(ValueError, match="already live"):
        s.restore_parking(path)


@pytest.mark.parametrize("paged", [False, True])
def test_restore_refuses_tenant_in_use_and_leaves_no_trace(tmp_path, paged):
    mk = lambda: svc(paged=paged, max_tenants=1, max_ways=2)
    src = mk()
    throwaway = src.open_session()      # sid 0: keep spilled sids != dst's
    a = src.open_session(tenant=None)   # sid 1 claims tenant 0
    src.enroll_shots(a, np.ones((1, 8, 2), np.float32))
    src.push_audio({a: np.zeros(2, np.float32)})
    src.close(throwaway)
    path = str(tmp_path / "p.npz")
    src.spill_parking(path, include_bound=True)
    dst = mk()
    d = dst.open_session(tenant=None)   # also claims tenant 0: collision
    dst.enroll_shots(d, np.full((1, 8, 2), 2.0, np.float32))
    before = dst.export_tenant(0)
    live_before = dst.sched.live_sessions
    with pytest.raises(ValueError, match="tenant 0 already in use"):
        dst.restore_parking(path)
    after = dst.export_tenant(0)
    for key in ("s_sums", "counts"):
        np.testing.assert_array_equal(after[key], before[key])
    assert dst.sched.live_sessions == live_before
    assert a not in dst.sessions


def test_restore_refuses_over_capacity_atomically(tmp_path):
    src = svc(paged=False, max_tenants=1)
    src.close(src.open_session())  # sid 0: keep spilled sids != dst's
    sids = [src.open_session() for _ in range(2)]
    src.push_audio({sid: np.zeros(2, np.float32) for sid in sids})
    path = str(tmp_path / "p.npz")
    src.spill_parking(path, include_bound=True)
    dst = svc(paged=False, max_tenants=1, max_sessions=2)
    keep = dst.open_session()
    with pytest.raises(AdmissionError):
        dst.restore_parking(path)  # 1 live + 2 restored > 2
    assert dst.sched.live_sessions == 1 and list(dst.sessions) == [keep]


@pytest.mark.parametrize("paged", [False, True])
def test_export_detach_adopt_session_bit_exact(paged):
    """export_session snapshots without ending the session; detach +
    adopt moves it (and, through export/adopt_tenant, its bank) to a peer
    that continues it bit for bit."""
    x, shots = _data(13)
    ctl = svc(paged=paged)
    c = ctl.open_session(tenant=1)
    ctl.enroll_shots(c, shots, label="cat")
    ctl.push_audio({c: x[:17]})
    want = ctl.push_audio({c: x[17:]})[c]

    src, dst = svc(paged=paged), svc(paged=paged)
    a = src.open_session(tenant=1)
    src.enroll_shots(a, shots, label="cat")
    src.push_audio({a: x[:17]})
    blob, meta = src.export_session(a)
    assert meta == {"tenant": 1, "dedicated": False, "steps": 17}
    assert src.poll(a)["state"] == "parked" and a in src.sessions
    assert src.stats()["parked_blob_bytes"] > 0
    blob2, meta2 = src.detach_session(a)
    assert blob2 is blob and meta2 == meta
    assert a not in src.sessions and src.stats()["live_sessions"] == 0
    assert src.stats()["parked_blob_bytes"] == 0
    with pytest.raises(ValueError, match="adopt_tenant first"):
        dst.adopt_session(blob, meta)
    tblob = src.export_tenant(1)
    src.close_tenant(1)
    assert dst.adopt_tenant(1, tblob) == 1
    b = dst.adopt_session(blob, meta)
    assert dst.poll(b)["state"] == "parked" and dst.poll(b)["steps"] == 17
    same_result(dst.push_audio({b: x[17:]})[b], want, exact=True)
    assert dst._tenant_labels[1] == {"cat": 0}
    with pytest.raises(KeyError):
        dst.export_session(999)
    full = svc(paged=paged, max_sessions=1)
    full.open_session()
    with pytest.raises(AdmissionError):
        full.adopt_session(blob, {"steps": 17})


# ---------------------------------------------------------------------------
# files across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_spill_crosses_packages(tmp_path, writer, paged, quantize):
    """A lot spilled by one package restores in the other: the same npz
    keys, dtypes and shapes, the same meta, and the restored sessions
    continue allclose to the writer's own continuation."""
    x, shots = _data(14)
    mk = lambda ref: svc(ref=ref, paged=paged, quantize=quantize, t_chunk=8)
    w_ref = writer == "jax"
    paths = {}
    conts = {}
    for ref in (w_ref, not w_ref):
        s = mk(ref)
        a = s.open_session(tenant=None)
        g = s.open_session()
        s.enroll_shots(a, shots)
        s.push_audio({a: x[:21], g: x[:9]})
        paths[ref] = str(tmp_path / f"{'jax' if ref else 'torch'}.npz")
        s.spill_parking(paths[ref], include_bound=True)
        conts[ref] = s.push_audio({a: x[21:], g: x[9:]})
    assert _flat_layout(paths[True]) == _flat_layout(paths[False])
    (pm_t, meta_t), (pm_j, meta_j) = (store.load_sessions(paths[False]),
                                      jstore.load_sessions(paths[True]))
    assert meta_t.keys() == meta_j.keys()
    assert meta_t["sessions"] == meta_j["sessions"]
    assert meta_t["next_sid"] == meta_j["next_sid"]
    reader = mk(not w_ref)
    restored = reader.restore_parking(paths[w_ref])
    assert restored == [0, 1]
    got = reader.push_audio({0: x[21:], 1: x[9:]})
    for sid in (0, 1):
        same_result(got[sid], conts[w_ref][sid], exact=False)
    assert reader.poll(0)["n_ways"] == 1


def test_tree_checkpoints_cross_packages(tmp_path):
    """save/restore_into of a nested tree of tensors: the reference's
    manifest keys, a reload into either package, and the newest valid
    step winning over a corrupt one."""
    from repro_torch.sessions.tenancy import TenantBank

    rng = np.random.default_rng(5)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    tree = {"params": {"w": f(3, 4), "b": f(4)}, "ring": [f(2, 3), f(5)],
            "bank": TenantBank(f(2, 3, 4), f(2, 3),
                               torch.tensor([1, 2], dtype=torch.int32)),
            "step": torch.tensor(7, dtype=torch.int32), "none": None}
    d_t, d_j = str(tmp_path / "t"), str(tmp_path / "j")
    store.save(d_t, 3, tree)
    jstore.save(d_j, 3, store._map_leaves(lambda _, v: v.numpy(), tree))
    (st, flat_t), (sj, flat_j) = (store.restore_flat(d_t),
                                  jstore.restore_flat(d_j))
    assert st == sj == 3 and flat_t.keys() == flat_j.keys()
    assert "['bank'].s_sums" in flat_t and "['ring'][1]" in flat_t
    for k in flat_t:
        np.testing.assert_array_equal(flat_t[k], flat_j[k])
        assert flat_t[k].dtype == flat_j[k].dtype
    zeros = {"params": {k: torch.zeros_like(v)
                        for k, v in tree["params"].items()},
             "ring": [torch.zeros_like(v) for v in tree["ring"]],
             "bank": TenantBank(*(torch.zeros_like(v) for v in tree["bank"])),
             "step": torch.zeros((), dtype=torch.int32), "none": None}
    step, back = store.restore_into(d_j, zeros)  # the reference's files
    assert step == 3 and isinstance(back["bank"], TenantBank)
    assert len(store._flatten_with_path(back)) == 8
    for (ka, va), (kb, vb) in zip(store._flatten_with_path(back),
                                  store._flatten_with_path(tree)):
        assert ka == kb and va.dtype == vb.dtype and torch.equal(va, vb)
    store.save(d_t, 4, tree)
    with open(store.list_checkpoints(d_t)[-1][1] + "/arr_00000.npy",
              "r+b") as fh:
        fh.seek(-4, 2)
        fh.write(b"\xff\xff\xff\xff")
    assert store.restore_flat(d_t)[0] == 3  # corrupt step 4 skipped
    ck = store.AsyncCheckpointer(d_t, keep=2)
    ck.save_async(5, tree)
    ck.wait()
    assert [s for s, _ in store.list_checkpoints(d_t)] == [4, 5]


def test_spill_refuses_a_blob_with_no_arrays(tmp_path):
    with pytest.raises(ValueError, match="no arrays"):
        store.save_sessions(str(tmp_path / "e.npz"), {3: {}})
    with pytest.raises(ValueError, match="no arrays"):
        jstore.save_sessions(str(tmp_path / "e.npz"), {3: {}})
