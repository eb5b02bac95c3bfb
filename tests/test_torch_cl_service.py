"""Continual learning in the port's session layer: paged tenant banks over
the block pool, the u4 rehearsal buffer and tenant handoff, against the
JAX package.

One test per behaviour of tests/test_cl_service.py, each run through the
port on the CPU and, where the reference has the surface, through the
reference on the same inputs.  Inside the port the checks are bit-exact
(paged == dense, park/unpark, residue, exhaustion, label-keyed refine, the
way cap, export/adopt); port against reference, fp32 values are allclose
at rtol=2e-4, atol=2e-5 with the same -inf pattern.  The rehearsal
buffer's integer artifacts (packed codes, scales, the reservoir's choices)
are compared byte for byte.  The plane's enroll verb, the paged spill, the
enroll metrics and the drain handoff are held twice: through the service
verbs they rest on (enroll-before-push order, stats, export/adopt) and
through the port's ServingPlane, spill_parking/restore_parking and
metrics().  The reference services run fused with the plain ("ref")
kernel backend."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import build_bundle as j_build_bundle  # noqa: E402
from repro.models.tcn import tcn_empty_state as j_empty  # noqa: E402
from repro.sessions import PagedBankPool as JPool  # noqa: E402
from repro.sessions import RehearsalBuffer as JBuffer  # noqa: E402
from repro.sessions import StreamSessionService as JService  # noqa: E402
from repro.sessions import paged_bank_fc as j_paged_bank_fc  # noqa: E402
from repro.sessions.scheduler import AdmissionError as JAdmissionError  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.protonet import pn_logits_banked  # noqa: E402
from repro_torch.models import build_tcn_bundle  # noqa: E402
from repro_torch.sessions import (  # noqa: E402
    NULL_BLOCK,
    AdmissionError,
    PagedBankPool,
    PoolExhausted,
    RehearsalBuffer,
    StreamSessionService,
    bank_add_class,
    bank_fc,
    bank_init,
    paged_bank_fc,
)

RTOL, ATOL = 2e-4, 2e-5
SMALL = dict(tcn_channels=(8, 8), tcn_kernel=3, tcn_in_channels=2,
             embed_dim=12, n_classes=4)


@functools.lru_cache(maxsize=None)
def _setup(seed=0):
    jcfg = j_get_config("chameleon-tcn").replace(kernel_backend="ref", **SMALL)
    cfg = get_config("chameleon-tcn").replace(**SMALL)
    jbundle = j_build_bundle(jcfg)
    params = jbundle.init(jax.random.key(seed))
    rng = np.random.default_rng(seed + 7)
    bn = jax.tree.map(lambda a: a + jnp.asarray(
        0.05 * np.abs(rng.normal(size=a.shape)).astype(np.float32)),
        j_empty(jcfg))
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    return (jbundle, params, bn, build_tcn_bundle(cfg, "cpu"),
            params_from_jax(np_tree(params), "cpu"),
            params_from_jax(np_tree(bn), "cpu"))


def _svc(paged, *, ref=False, **kw):
    """The reference test's service: 2 slots, 2 tenants, 5 ways, blocks of
    2 ways; the port's on the CPU, or the reference's (``ref``)."""
    jbundle, params, bn, bundle, p, bnt = _setup()
    kw = {"n_slots": 2, "max_tenants": 2, "max_ways": 5, "fused": True,
          "paged_bank": paged, "bank_block_ways": 2, **kw}
    if ref:
        return JService(jbundle, params, bn, kernel_backend="ref", **kw)
    return StreamSessionService(bundle, p, bnt, **kw)


def _fc_rows(pool, tenant):
    tables, ways = pool.slot_tables(np.array([tenant], np.int32))
    if isinstance(pool, JPool):
        w, b = j_paged_bank_fc(pool.s_sums, pool.counts, jnp.asarray(tables),
                               jnp.asarray(ways))
        return np.asarray(w[0]), np.asarray(b[0])
    w, b = paged_bank_fc(pool.s_sums, pool.counts, torch.from_numpy(tables),
                         torch.from_numpy(ways))
    return w[0].numpy(), b[0].numpy()


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    live = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), live)
    np.testing.assert_array_equal(got[~live], want[~live])  # same -inf
    np.testing.assert_allclose(got[live], want[live], rtol=RTOL, atol=ATOL)


def _same_results(a, b, *, exact):
    for key in ("emb", "logits", "tenant_logits"):
        if a[key] is None or b[key] is None:
            assert a[key] is None and b[key] is None, key
        elif exact:
            np.testing.assert_array_equal(a[key], b[key])
        else:
            _close(a[key], b[key])
    if exact:
        assert a["pred"] == b["pred"]


# ---------------------------------------------------------------------------
# paging.py: the block allocator under the paged banks
# ---------------------------------------------------------------------------

def test_block_pool_matches_reference():
    """The same random alloc/ref/free/writable sequence gives the same ids,
    refcounts, shared counts and exhaustion points in both packages."""
    from repro.sessions.paging import BlockPool as JBlockPool
    from repro_torch.sessions import BlockPool

    pools = (BlockPool(5), JBlockPool(5))
    rng = np.random.default_rng(14)
    held = []
    for _ in range(300):
        op = int(rng.integers(4))
        if op == 0 or not held:
            got = []
            for pool in pools:
                try:
                    got.append(pool.alloc())
                except (AdmissionError, JAdmissionError):
                    got.append("exhausted")
            assert got[0] == got[1]
            if got[0] != "exhausted":
                held.append(got[0])
        else:
            bid = held[int(rng.integers(len(held)))]
            if op == 1:
                assert pools[0].ref(bid) == pools[1].ref(bid)
                held.append(bid)
            elif op == 2:
                for pool in pools:
                    pool.free(bid)
                held.remove(bid)
            else:
                try:
                    w = [pool.writable(bid) for pool in pools]
                except (AdmissionError, JAdmissionError):
                    continue  # a shared block with no free block to copy to
                assert w[0] == w[1]
                held[held.index(bid)] = w[0][0]
        for pool in pools:
            pool.check()
        assert [pools[0].refcount(i) for i in range(6)] == \
            [pools[1].refcount(i) for i in range(6)]
        assert (pools[0].n_free, pools[0].n_shared) == \
            (pools[1].n_free, pools[1].n_shared)
    with pytest.raises(ValueError):
        pools[0].free(NULL_BLOCK)
    with pytest.raises(ValueError):
        BlockPool(0)


# ---------------------------------------------------------------------------
# bankpool.py: the paged tenant bank
# ---------------------------------------------------------------------------

def test_bankpool_grows_block_at_a_time_to_cap():
    pools = (PagedBankPool(8, block_ways=3, dim=4, max_tenant_blocks=2,
                           device="cpu"),
             JPool(8, block_ways=3, dim=4, max_tenant_blocks=2))
    rng = np.random.default_rng(0)
    shots = [rng.normal(size=(2, 4)) for _ in range(7)]
    for pool in pools:
        pool.create(0)
        assert pool.row_bytes(0) == 0
        for j in range(6):
            assert pool.add_class(0, shots[j]) == j
            assert len(pool.tables[0]) == j // 3 + 1
        assert pool.pool.n_live == 2
        assert pool.row_bytes(0) == 2 * 3 * 5 * 4  # blocks*BW*(V+1)*fp32
        with pytest.raises(RuntimeError, match="max_ways"):
            pool.add_class(0, shots[6])
    assert pools[0].tables == pools[1].tables
    assert pools[0].stats() == pools[1].stats()
    _close(pools[0].s_sums.numpy(), pools[1].s_sums)
    np.testing.assert_array_equal(pools[0].counts.numpy(),
                                  np.asarray(pools[1].counts))


def test_bankpool_park_unpark_bit_identical_and_zero_rows():
    pool = PagedBankPool(8, block_ways=2, dim=4, max_tenant_blocks=3,
                         device="cpu")
    pool.create(0)
    rng = np.random.default_rng(1)
    for _ in range(3):
        pool.add_class(0, rng.normal(size=(2, 4)))
    w0, b0 = _fc_rows(pool, 0)
    pool.park(0)
    assert pool.pool.n_live == 0 and pool.row_bytes(0) == 0
    assert not pool.is_resident(0)
    tables, ways = pool.slot_tables(np.array([0], np.int32))
    assert (tables == NULL_BLOCK).all() and ways[0] == 0  # parked = masked
    pool.park(0)  # idempotent
    pool.unpark(0)
    w1, b1 = _fc_rows(pool, 0)
    np.testing.assert_array_equal(w0, w1)
    np.testing.assert_array_equal(b0, b1)
    pool.pool.check()


def test_bankpool_exhaustion_and_failed_unpark_stays_parked():
    pool = PagedBankPool(1, block_ways=2, dim=4, max_tenant_blocks=2,
                         device="cpu")
    pool.create(0)
    pool.create(1)
    x = np.ones((1, 4), np.float32)
    pool.add_class(0, x)
    with pytest.raises(PoolExhausted) as exc:
        pool.add_class(1, x)  # the single block is taken
    assert isinstance(exc.value, AdmissionError)
    pool.park(0)
    pool.add_class(1, 2 * x)  # freed block recycled
    with pytest.raises(PoolExhausted):
        pool.unpark(0)
    assert not pool.is_resident(0)  # blob intact, still parked
    pool.drop(1)
    pool.unpark(0)
    w, _ = _fc_rows(pool, 0)
    np.testing.assert_array_equal(w[0], x[0])
    # a tenant of two blocks that finds one free block stays parked and
    # gives the block it took back
    big = PagedBankPool(2, block_ways=1, dim=4, max_tenant_blocks=2,
                        device="cpu")
    for t in (0, 1):
        big.create(t)
    big.add_class(0, x)
    big.add_class(0, x)
    big.park(0)
    big.add_class(1, x)
    with pytest.raises(PoolExhausted):
        big.unpark(0)
    assert not big.is_resident(0) and big.pool.n_live == 1
    big.pool.check()


def test_bankpool_recycled_block_carries_no_residue():
    pool = PagedBankPool(1, block_ways=2, dim=4, max_tenant_blocks=1,
                         device="cpu")
    pool.create(0)
    pool.add_class(0, np.full((2, 4), 3.0, np.float32))
    pool.add_class(0, np.full((1, 4), 5.0, np.float32))
    pool.drop(0)
    pool.create(1)
    pool.add_class(1, np.ones((1, 4), np.float32))
    bid = pool.tables[1][0]
    # way 1 of the recycled block must be zeroed, not tenant 0's old sums
    assert float(pool.counts[bid, 1]) == 0.0
    np.testing.assert_array_equal(pool.s_sums[bid, 1].numpy(),
                                  np.zeros(4, np.float32))


def test_bankpool_pack_adopt_roundtrip_parked():
    """pack -> adopt restores parked and bit-identical, within the port and
    across the packages in both directions (the blob is plain lists)."""
    rng = np.random.default_rng(2)
    shots = [rng.normal(size=(2, 4)).astype(np.float32) for _ in range(3)]
    mk = {"port": lambda: PagedBankPool(4, block_ways=2, dim=4,
                                        max_tenant_blocks=2, device="cpu"),
          "ref": lambda: JPool(4, block_ways=2, dim=4, max_tenant_blocks=2)}
    src = {}
    for name, make in mk.items():
        pool = make()
        pool.create(0)
        for s in shots:
            pool.add_class(0, s)
        src[name] = pool
    for a in mk:
        blob = src[a].pack(0)
        for b in mk:
            other = mk[b]()
            other.adopt(7, blob)
            assert not other.is_resident(7)  # adopted parked: zero rows
            assert other.pool.n_live == 0
            other.unpark(7)
            assert other.pack(7) == blob
            w0, b0 = _fc_rows(src[a], 0)
            w1, b1 = _fc_rows(other, 7)
            if a == b == "port":
                np.testing.assert_array_equal(w0, w1)
                np.testing.assert_array_equal(b0, b1)
            else:
                _close(w1, w0)
                _close(b1, b0)


# ---------------------------------------------------------------------------
# tenancy.py: bank_add_class overflow contract
# ---------------------------------------------------------------------------

def test_bank_add_class_overflow_masked_noop():
    bank = bank_init(2, 2, 4, "cpu")
    rng = np.random.default_rng(3)
    a, b = rng.normal(size=(2, 4)), rng.normal(size=(3, 4))
    bank = bank_add_class(bank, 0, torch.tensor(a, dtype=torch.float32))
    bank = bank_add_class(bank, 0, torch.tensor(b, dtype=torch.float32))
    before = [t.clone() for t in bank]
    bank = bank_add_class(bank, 0, torch.tensor(10 * a, dtype=torch.float32))
    assert int(bank.n_ways[0]) == 2  # did NOT clamp-overwrite way 1
    assert torch.equal(bank.s_sums, before[0])
    assert torch.equal(bank.counts, before[1])
    bank = bank_add_class(bank, 1, torch.tensor(b, dtype=torch.float32))
    assert int(bank.n_ways[1]) == 1


# ---------------------------------------------------------------------------
# rehearsal.py: bounded latent replay
# ---------------------------------------------------------------------------

def _same_buffers(tb: RehearsalBuffer, jb: JBuffer):
    """Byte for byte: the same keys, seen counters, packed codes and fp32
    scales in the same reservoir positions."""
    assert tb._mem.keys() == jb._mem.keys()
    assert tb._seen == jb._seen
    for key, mem in tb._mem.items():
        jmem = jb._mem[key]
        assert len(mem) == len(jmem)
        for (p, s), (jp_, js) in zip(mem, jmem):
            assert p.dtype == np.uint8 and p.shape == np.asarray(jp_).shape
            np.testing.assert_array_equal(p, np.asarray(jp_))
            assert np.float32(s).tobytes() == np.float32(js).tobytes()


def test_rehearsal_reservoir_bounded_bytes_and_rebuild():
    rng = np.random.default_rng(4)
    e1, e2 = rng.normal(size=(10, 6)), rng.normal(size=(2, 6))
    tb, jb = RehearsalBuffer(cap_per_class=4, seed=0), JBuffer(4, seed=0)
    for buf in (tb, jb):
        buf.add(0, 0, e1)
        assert buf.n_shots(0, 0) == 4
        assert buf.nbytes(0) == 4 * (3 + 4)  # 6 nibbles packed + fp32 scale
        assert buf.nbytes() == buf.nbytes(0)
        buf.add(1, 0, e2)
        assert buf.nbytes() > buf.nbytes(0)
    _same_buffers(tb, jb)
    s, k = tb.rebuild(0, 0, 6)
    js, jk = jb.rebuild(0, 0, 6)
    assert k == jk == 4 and s.shape == (6,) and s.dtype == np.float32
    np.testing.assert_array_equal(s, js)  # same bytes decode and sum alike
    tb.drop(0)
    with pytest.raises(KeyError):
        tb.rebuild(0, 0, 6)


def test_rehearsal_under_cap_keeps_every_shot():
    emb = np.random.default_rng(5).normal(size=(3, 5)).astype(np.float32)
    tb, jb = RehearsalBuffer(cap_per_class=8, seed=0), JBuffer(8, seed=0)
    tb.add(0, 2, emb)
    jb.add(0, 2, emb)
    _same_buffers(tb, jb)
    s, k = tb.rebuild(0, 2, 5)
    assert k == 3
    np.testing.assert_array_equal(s, jb.rebuild(0, 2, 5)[0])
    # u4 log2 codes keep sign and coarse magnitude: the rebuilt sum points
    # the same way as the exact sum
    exact = emb.sum(axis=0)
    cos = float(np.dot(s, exact) / (np.linalg.norm(s) * np.linalg.norm(exact)))
    assert cos > 0.8


@pytest.mark.parametrize("dim", [13, 64])
def test_rehearsal_bytes_and_choices_match_reference(dim):
    """Many offers past the cap on several (tenant, way) keys, interleaved:
    the same RNG draws keep the same shots, and every packed byte and scale
    equals the reference's (odd V exercises the pad nibble)."""
    rng = np.random.default_rng(dim)
    tb, jb = RehearsalBuffer(cap_per_class=3, seed=11), JBuffer(3, seed=11)
    for i in range(40):
        key = (i % 3, (i // 3) % 2)
        emb = (rng.normal(size=(1 + i % 4, dim))
               * np.exp(rng.normal(size=(1, dim)))).astype(np.float32)
        tb.add(*key, emb)
        jb.add(*key, emb)
    _same_buffers(tb, jb)
    assert tb.nbytes() == jb.nbytes()
    for key in tb._mem:
        np.testing.assert_array_equal(tb.rebuild(*key, dim)[0],
                                      jb.rebuild(*key, dim)[0])
    # a reservoir exported by either package is adopted by the other and
    # keeps sampling with the adopter's RNG
    for src, dst in ((tb, JBuffer(3, seed=1)), (jb, RehearsalBuffer(3, 1))):
        blob = src.export_tenant(1)
        dst.adopt_tenant(1, blob)
        assert dst.n_shots(1, 0) == src.n_shots(1, 0) == 3
        np.testing.assert_array_equal(dst.rebuild(1, 0, dim)[0],
                                      src.rebuild(1, 0, dim)[0])
        with pytest.raises(ValueError, match="refuse"):
            dst.adopt_tenant(1, blob)
        assert dst.nbytes() == src.nbytes(1)
    # the running byte total follows drops and adoptions
    for t in (2, 0):
        tb.drop(t)
        jb.drop(t)
        assert tb.nbytes() == jb.nbytes()
    assert tb.nbytes() == tb.nbytes(1) > 0
    tb.adopt_tenant(2, jb.export_tenant(1))
    assert tb.nbytes() == tb.nbytes(1) + tb.nbytes(2) == 2 * jb.nbytes()


# ---------------------------------------------------------------------------
# service: paged vs dense, growth, parking, label-keyed enrollment
# ---------------------------------------------------------------------------

def _grow_and_push(svc, shots, x):
    sid = svc.open_session(tenant=None)
    outs = []
    for s in shots:  # grows past the 2-way block boundary twice
        svc.enroll_shots(sid, s)
        outs.append(svc.push_audio({sid: x})[sid])
    return outs


def test_paged_service_bit_identical_to_dense():
    """Same enrolls, same pushes: paged tenant logits equal the dense ones
    bit for bit in the port, and match the reference's."""
    rng = np.random.default_rng(6)
    shots = [rng.normal(size=(2, 10, 2)).astype(np.float32)
             for _ in range(5)]
    x = rng.normal(size=(12, 2)).astype(np.float32)
    dense = _grow_and_push(_svc(False), shots, x)
    psvc = _svc(True)
    paged = _grow_and_push(psvc, shots, x)
    assert psvc.bankpool.pool.n_live == 3  # ceil(5 ways / 2 per block)
    for rd, rp in zip(dense, paged):
        assert rd["tenant_logits"].shape == rp["tenant_logits"].shape
        _same_results(rd, rp, exact=True)
    for rj, rp in zip(_grow_and_push(_svc(True, ref=True), shots, x), paged):
        _same_results(rp, rj, exact=False)


@pytest.mark.parametrize("max_ways", [8, 250, 256])
def test_paged_equals_dense_at_demo_widths(max_ways):
    """At the CL demo's widths (paged tables of 16-way blocks: 16, 256 and
    256 wide against dense 8, 250 and 256), with two tenants, a refine and
    a partly filled last block: tenant logits bit-identical."""
    rng = np.random.default_rng(max_ways)
    V = SMALL["embed_dim"]
    n = {0: max_ways, 1: max_ways // 3}
    emb = {t: rng.normal(size=(n[t], 3, V)).astype(np.float32) for t in n}
    x = rng.normal(size=(2, 20, 2)).astype(np.float32)
    outs = []
    for paged in (False, True):
        svc = _svc(paged, max_ways=max_ways, bank_block_ways=16)
        sids = [svc.open_session(tenant=t) for t in n]
        for t, sid in zip(n, sids):
            for j in range(n[t]):
                svc.enroll_shots(sid, emb[t][j], embedded=True)
        svc.enroll_shots(sids[0], emb[1][0], embedded=True, way=n[0] // 2)
        res = svc.push_audio({s: x[i] for i, s in enumerate(sids)})
        outs.append([res[s] for s in sids])
        assert all(r["tenant_logits"].shape == (20, max_ways)
                   for r in outs[-1])
    for rd, rp in zip(*outs):
        _same_results(rd, rp, exact=True)
    tl = outs[1][1]["tenant_logits"]  # tenant 1: -inf past its ways
    assert np.isfinite(tl[:, :n[1]]).all() and np.isneginf(tl[:, n[1]:]).all()


def test_paged_tenant_parks_on_park_and_push_restores_bit_identical():
    rng = np.random.default_rng(7)
    shots = rng.normal(size=(2, 10, 2)).astype(np.float32)
    x1 = rng.normal(size=(8, 2)).astype(np.float32)
    x2 = rng.normal(size=(8, 2)).astype(np.float32)

    def run(with_park, ref=False):
        svc = _svc(True, ref=ref)
        sid = svc.open_session(tenant=None)
        tenant = svc.sessions[sid].tenant
        svc.enroll_shots(sid, shots)
        svc.push_audio({sid: x1})
        if with_park:
            svc.park(sid)  # last bound session leaves -> bank parks
            assert svc.bankpool.stats()["blocks_live"] == 0
            assert not svc.bankpool.is_resident(tenant)
            assert svc.stats()["bank_pool_blocks_live"] == 0
        return svc.push_audio({sid: x2})[sid]  # lazy rebind + unpark

    plain, parked = run(False), run(True)
    _same_results(plain, parked, exact=True)
    _same_results(parked, run(True, ref=True), exact=False)


def test_paged_tenant_parks_on_eviction():
    """The eviction path bypasses _on_unbind; the _on_evict hook must still
    release the outgoing tenant's bank rows."""
    rng = np.random.default_rng(8)
    a = rng.normal(size=(2, 10, 2)).astype(np.float32)
    b = rng.normal(size=(1, 10, 2)).astype(np.float32)
    x = rng.normal(size=(4, 2)).astype(np.float32)
    out = []
    for ref in (False, True):
        svc = _svc(True, ref=ref, n_slots=1)
        s1 = svc.open_session(tenant=None)
        t1 = svc.sessions[s1].tenant
        svc.enroll_shots(s1, a)
        assert svc.bankpool.is_resident(t1)
        s2 = svc.open_session(tenant=None)  # binding evicts s1 from the grid
        assert not svc.bankpool.is_resident(t1)  # evicted tenant parked
        assert svc.evictions == 1
        svc.enroll_shots(s2, b)
        r = svc.push_audio({s1: x})
        assert svc.bankpool.is_resident(t1)  # pushing restored residency
        assert np.isfinite(r[s1]["tenant_logits"][-1][0])
        out.append(r[s1])
    _same_results(out[0], out[1], exact=False)


def test_enroll_label_keyed_streaming_append_then_refine():
    # integer-valued embeddings make the running-mean fold exact, so
    # label-refinement must EQUAL enrolling all shots at once
    a1 = np.array([[2., 0., 4.] + [0.] * 9], np.float32)
    a2 = np.array([[4., 2., 0.] + [0.] * 9], np.float32)
    b = np.array([[0., 8., 2.] + [0.] * 9], np.float32)
    rows = {}
    for paged in (False, True):
        for ref in (False, True):
            svc = _svc(paged, ref=ref)
            sid = svc.open_session(tenant=None)
            assert svc.enroll_shots(sid, a1, embedded=True, label="cat") == 0
            assert svc.enroll_shots(sid, b, embedded=True, label="dog") == 1
            assert svc.enroll_shots(sid, a2, embedded=True, label="cat") == 0
            assert svc.poll(sid)["n_ways"] == 2
            with pytest.raises(ValueError, match="not both"):
                svc.enroll_shots(sid, a1, embedded=True, label="cat", way=0)
            once = _svc(paged, ref=ref)
            oid = once.open_session(tenant=None)
            once.enroll_shots(oid, np.concatenate([a1, a2]), embedded=True)
            once.enroll_shots(oid, b, embedded=True)
            got = []
            for s, i in ((svc, sid), (once, oid)):
                t = s.sessions[i].tenant
                got.append(_fc_rows(s.bankpool, t) if paged else
                           (np.asarray(s.bank.s_sums[t]),
                            np.asarray(s.bank.counts[t])))
            for u, v in zip(*got):
                np.testing.assert_array_equal(u, v)
            rows[paged, ref] = got[0]
    for paged in (False, True):  # the exact integer sums agree across
        for u, v in zip(rows[paged, False], rows[paged, True]):
            np.testing.assert_array_equal(u, v)


def test_enroll_past_max_ways_raises_not_clamps():
    one = np.ones((1, 12), np.float32)
    for paged in (False, True):
        svc = _svc(paged, max_ways=2)
        sid = svc.open_session(tenant=None)
        svc.enroll_shots(sid, one, embedded=True)
        svc.enroll_shots(sid, 2 * one, embedded=True)
        with pytest.raises(RuntimeError, match="max_ways"):
            svc.enroll_shots(sid, 3 * one, embedded=True)
        assert svc.poll(sid)["n_ways"] == 2
        if paged:
            assert svc.bankpool.n_ways[svc.sessions[sid].tenant] == 2


def test_paged_enroll_pool_exhaustion_is_admission_error():
    # 1 shared block for 2 tenants: the second tenant's first enroll must
    # surface the paging back-pressure type, not corrupt the first
    one = np.ones((1, 12), np.float32)
    for ref in (False, True):
        svc = _svc(True, ref=ref, bank_blocks=1)
        s1 = svc.open_session(tenant=0)
        s2 = svc.open_session(tenant=1)
        svc.enroll_shots(s1, one, embedded=True)
        w_before = _fc_rows(svc.bankpool, 0)
        with pytest.raises(JAdmissionError if ref else PoolExhausted) as exc:
            svc.enroll_shots(s2, one, embedded=True)
        assert type(exc.value).__name__ == "PoolExhausted"
        assert ref or isinstance(exc.value, AdmissionError)
        assert svc.poll(s1)["n_ways"] == 1 and svc.poll(s2)["n_ways"] == 0
        for u, v in zip(w_before, _fc_rows(svc.bankpool, 0)):
            np.testing.assert_array_equal(u, v)
        # closing the first tenant frees its block for the second
        svc.close(s1)
        svc.close_tenant(0)
        assert svc.enroll_shots(s2, one, embedded=True) == 0


def test_rehearse_tenant_rebuilds_from_buffer():
    emb = np.zeros((3, 2, 12), np.float32)
    for c in range(3):  # well-separated axis-aligned prototypes
        emb[c, :, 4 * c] = (8.0, 4.0)
    sums = {}
    for paged in (True, False):
        for ref in (False, True):
            svc = _svc(paged, ref=ref, rehearsal_cap=8)
            sid = svc.open_session(tenant=None)
            tenant = svc.sessions[sid].tenant
            for c in range(3):
                svc.enroll_shots(sid, emb[c], embedded=True)
            if paged:
                w0, _ = _fc_rows(svc.bankpool, tenant)
            assert svc.rehearse_tenant(tenant) == 3
            if paged:
                w1, b1 = _fc_rows(svc.bankpool, tenant)
                for c in range(3):  # direction kept: each way still wins
                    logits = w0[c][None] @ w1.T + b1[None]
                    assert logits[0, :3].argmax() == c
                t = svc.bankpool.tables[tenant]
                sums[paged, ref] = np.asarray(svc.bankpool.s_sums)[t]
            else:
                sums[paged, ref] = np.asarray(svc.bank.s_sums)[tenant]
    # rebuilt rows come from identical bytes: equal across the packages
    for paged in (True, False):
        np.testing.assert_array_equal(sums[paged, False], sums[paged, True])
    svc2 = _svc(True)  # rehearsal disabled
    sid2 = svc2.open_session(tenant=None)
    with pytest.raises(RuntimeError, match="rehearsal"):
        svc2.rehearse_tenant(svc2.sessions[sid2].tenant)


def test_paged_export_adopt_roundtrip():
    """The port's counterpart of the reference's spill/restore round trip:
    a paged tenant's export is adopted PARKED by a fresh service and
    classifies identically there; the blob crosses the packages."""
    rng = np.random.default_rng(9)
    shots = rng.normal(size=(2, 10, 2)).astype(np.float32)
    x = rng.normal(size=(8, 2)).astype(np.float32)
    svc = _svc(True)
    sid = svc.open_session(tenant=None)
    tenant = svc.sessions[sid].tenant
    svc.enroll_shots(sid, shots, label="yes")
    blob = svc.export_tenant(tenant)
    assert set(blob) == {"s_sums", "counts", "n_ways", "labels"}
    assert blob["labels"] == {"yes": 0}
    want = svc.push_audio({svc.open_session(tenant=tenant): x})
    for peer in (_svc(True), _svc(False)):
        assert peer.adopt_tenant(None, blob) == 0
        if peer.paged_bank:
            assert peer.bankpool.pool.n_live == 0  # adopted parked
        got = peer.push_audio({peer.open_session(tenant=0): x})
        _same_results(next(iter(want.values())), next(iter(got.values())),
                      exact=True)
        assert peer.enroll_shots(peer.open_session(tenant=0), shots,
                                 label="yes") == 0  # the label came along
        with pytest.raises(ValueError, match="already in use"):
            peer.adopt_tenant(0, blob)
    jsvc = _svc(True, ref=True)
    jsvc.adopt_tenant(1, blob)
    jwant = jsvc.export_tenant(1)
    for key in ("s_sums", "counts"):
        np.testing.assert_array_equal(jwant[key], blob[key])
    back = _svc(True)
    back.adopt_tenant(1, jwant)
    for key in ("s_sums", "counts"):
        np.testing.assert_array_equal(back.export_tenant(1)[key], blob[key])


def test_enroll_before_push_updates_the_bank_the_push_reads():
    """The port's counterpart of the plane's FIFO enroll verb: an enroll
    made before a push is what that push classifies with."""
    rng = np.random.default_rng(10)
    shots1 = rng.normal(size=(2, 10, 2)).astype(np.float32)
    shots2 = rng.normal(size=(1, 10, 2)).astype(np.float32)
    x = rng.normal(size=(6, 2)).astype(np.float32)
    res = []
    for ref in (False, True):
        svc = _svc(True, ref=ref)
        sid = svc.open_session(tenant=1)
        assert svc.poll(sid)["tenant"] == 1
        assert svc.enroll_shots(sid, shots1) == 0
        assert svc.enroll_shots(sid, shots2) == 1
        r = svc.push_audio({sid: x})[sid]
        assert np.isfinite(r["tenant_logits"][-1][1])  # sees way 1
        assert r["pred"] == int(r["tenant_logits"][-1].argmax())
        if not ref:
            assert svc.stats()["enrolls"] == 2
        res.append(r)
    _same_results(res[0], res[1], exact=False)


def test_enroll_stats_surface():
    stats = []
    for ref in (False, True):
        svc = _svc(True, ref=ref, rehearsal_cap=2)
        sid = svc.open_session(tenant=None)
        svc.enroll_shots(sid, np.ones((3, 12), np.float32), embedded=True)
        st = svc.stats()
        assert st["paged_bank"] is True
        assert st["tenant_row_bytes"] == 2 * 13 * 4  # BW * (V+1) * fp32
        assert st["bank_pool_blocks_live"] == 1
        assert st["rehearsal_bytes"] == 2 * (6 + 4)  # 2 of 3 shots kept
        stats.append(st)
    assert stats[0]["enrolls"] == 1
    for key in stats[0]:
        if key.startswith(("bank_pool_", "rehearsal", "tenant_row")):
            assert stats[0][key] == stats[1][key], key


def test_tenant_handoff_carries_post_enroll_bank():
    """Counterpart of the plane's drain handoff: the tenant exported after
    its last enroll lands on a peer (port or reference) that classifies
    like a never-moved control, and keeps enrolling there."""
    rng = np.random.default_rng(12)
    shots1 = rng.normal(size=(2, 10, 2)).astype(np.float32)
    shots2 = rng.normal(size=(1, 10, 2)).astype(np.float32)
    x = rng.normal(size=(6, 2)).astype(np.float32)
    ctrl = _svc(True)
    csid = ctrl.open_session(tenant=0)
    ctrl.enroll_shots(csid, shots1)
    ctrl.enroll_shots(csid, shots2)
    want = ctrl.push_audio({csid: x})[csid]

    old = _svc(True)
    sid = old.open_session(tenant=0)
    old.enroll_shots(sid, shots1)
    old.enroll_shots(sid, shots2)
    blob = old.export_tenant(0)
    old.close(sid)
    old.close_tenant(0)
    for peer, exact in ((_svc(True), True), (_svc(False), True),
                        (_svc(True, ref=True), False)):
        peer.adopt_tenant(0, blob)
        psid = peer.open_session(tenant=0)
        assert peer.poll(psid)["n_ways"] == 2
        _same_results(peer.push_audio({psid: x})[psid], want, exact=exact)
        assert peer.enroll_shots(psid, shots2) == 2
    assert old.live_tenants() == [] and ctrl.live_tenants() == [0]


def test_chunk_size_invariance_and_gather_once_with_paged_bank():
    """Tenant logits do not depend on t_chunk (1 vs 4 vs 16) with a paged
    bank, and the service's tick (FC rows gathered once, every step in one
    contraction) equals the per-step form that gathered each step."""
    rng = np.random.default_rng(13)
    x = rng.normal(size=(23, 2)).astype(np.float32)
    emb = rng.normal(size=(5, 2, 12)).astype(np.float32)
    outs = []
    for t_chunk in (1, 4, 16):
        svc = _svc(True, t_chunk=t_chunk)
        sid = svc.open_session(tenant=None)
        for e in emb:
            svc.enroll_shots(sid, e, embedded=True)
        outs.append(svc.push_audio({sid: x})[sid])
    for r in outs[1:]:
        _same_results(outs[0], r, exact=True)
    for paged in (False, True):
        svc = _svc(paged)
        sid = svc.open_session(tenant=0)
        for e in emb:
            svc.enroll_shots(sid, e, embedded=True)
        e = torch.from_numpy(rng.normal(size=(2, 7, 12)).astype(np.float32))
        w, b = svc._slot_fc()
        if paged:
            tables, ways = svc.bankpool.slot_tables(svc.tenant_of_slot)
            src = paged_bank_fc(svc.bankpool.s_sums, svc.bankpool.counts,
                                torch.from_numpy(tables),
                                torch.from_numpy(ways))
            ids = torch.arange(2)
        else:
            src = bank_fc(svc.bank)
            ids = torch.from_numpy(svc.tenant_of_slot)
        old = torch.stack([pn_logits_banked(e[:, i].contiguous(), *src, ids)
                           for i in range(e.shape[1])], dim=1)
        assert torch.equal(svc._banked(e, w, b), old)


def test_long_chunk_wide_bank_contracts_in_bounded_groups(monkeypatch):
    """A 784-step chunk against a 250-way paged bank (a 256-wide table):
    the tenant logits come out in step groups whose product stays within
    ``ROWS_PRODUCT_ELEMS``, with the bits of 16-step ticks."""
    from repro_torch.core import protonet

    rng = np.random.default_rng(784)
    V = SMALL["embed_dim"]
    emb = rng.normal(size=(250, 3, V)).astype(np.float32)
    x = rng.normal(size=(2, 784, 2)).astype(np.float32)
    per_step = 2 * 256 * V
    monkeypatch.setattr(protonet, "ROWS_PRODUCT_ELEMS", 100 * per_step)
    seen = []
    real = protonet.sum_last
    monkeypatch.setattr(protonet, "sum_last",
                        lambda p: seen.append(p.numel()) or real(p))
    outs = []
    for t_chunk in (784, 16):
        svc = _svc(True, max_ways=250, bank_block_ways=16, t_chunk=t_chunk)
        sids = [svc.open_session(tenant=t) for t in (0, 1)]
        for j in range(250):
            svc.enroll_shots(sids[j % 2], emb[j], embedded=True)
        seen.clear()
        res = svc.push_audio({s: x[i] for i, s in enumerate(sids)})
        outs.append([res[s] for s in sids])
        assert max(seen) <= 100 * per_step
    assert len(seen) == 784 // 16  # the 16-step ticks: one group each
    for r784, r16 in zip(*outs):
        assert r784["tenant_logits"].shape == (784, 250)
        _same_results(r784, r16, exact=True)


# ---------------------------------------------------------------------------
# direct ports of the plane and spill behaviours of tests/test_cl_service.py
# ---------------------------------------------------------------------------

def test_plane_enroll_verb_routes_and_orders_fifo():
    import asyncio

    from repro_torch.serving import ServingPlane

    rng = np.random.default_rng(10)
    shots1 = rng.normal(size=(2, 10, 2)).astype(np.float32)
    shots2 = rng.normal(size=(1, 10, 2)).astype(np.float32)
    x = rng.normal(size=(6, 2)).astype(np.float32)
    svc = _svc(True)
    plane = ServingPlane(svc, metrics=svc.metrics_registry)

    async def main():
        async with plane:
            # the tenant is forwarded to the tenant-aware service, not just
            # used for routing
            psid = await plane.open_session(tenant=1)
            assert (await plane.poll(psid))["tenant"] == 1
            assert await plane.enroll(psid, shots1) == 0
            # an enroll queued before a push updates the bank the push reads
            fe = asyncio.ensure_future(plane.enroll(psid, shots2))
            fp = asyncio.ensure_future(plane.push(psid, x))
            way, res = await asyncio.gather(fe, fp)
            assert way == 1
            assert np.isfinite(res["tenant_logits"][-1][1])  # sees way 1
            return res

    res = asyncio.run(main())
    assert svc.metrics()["plane_enrolls_total"][0]["value"] == 2
    enrolls = [e["value"] for e in svc.metrics()["enrolls_total"]
               if e["labels"].get("service") == "tcn"]
    assert enrolls == [2]
    assert res["pred"] == int(res["tenant_logits"][-1].argmax())
    # the same ops on the reference's service give the same logits
    ref = _svc(True, ref=True)
    sid = ref.open_session(tenant=1)
    ref.enroll_shots(sid, shots1)
    ref.enroll_shots(sid, shots2)
    _same_results(res, ref.push_audio({sid: x})[sid], exact=False)


def test_paged_spill_restore_roundtrip(tmp_path):
    """A paged tenant's bank rides the spill as the reference's JSON meta,
    restores parked, and classifies identically."""
    rng = np.random.default_rng(9)
    shots = rng.normal(size=(2, 10, 2)).astype(np.float32)
    x1 = rng.normal(size=(8, 2)).astype(np.float32)
    x2 = rng.normal(size=(8, 2)).astype(np.float32)
    svc = _svc(True)
    sid = svc.open_session(tenant=None)
    svc.enroll_shots(sid, shots)
    svc.push_audio({sid: x1})
    svc.park(sid)
    path = tmp_path / "spill.json"
    svc.spill_parking(str(path))
    fresh = _svc(True)
    assert fresh.restore_parking(str(path)) == [sid]
    assert fresh.bankpool.pool.n_live == 0  # restored parked
    want = svc.push_audio({sid: x2})[sid]
    got = fresh.push_audio({sid: x2})[sid]
    np.testing.assert_array_equal(want["tenant_logits"], got["tenant_logits"])
    _same_results(got, want, exact=True)


def test_enroll_metrics_and_stats_surface():
    svc = _svc(True, rehearsal_cap=2)
    sid = svc.open_session(tenant=None)
    svc.enroll_shots(sid, np.ones((3, 12), np.float32), embedded=True)
    snaps = [svc.metrics()]
    ref = _svc(True, ref=True, rehearsal_cap=2)
    ref.enroll_shots(ref.open_session(tenant=None),
                     np.ones((3, 12), np.float32), embedded=True)
    snaps.append(ref.metrics())
    for snap in snaps:
        get = lambda name: [e for e in snap[name]
                            if e["labels"].get("service") == "tcn"][0]
        assert get("enrolls_total")["value"] == 1
        assert get("enroll_shots_total")["value"] == 3
        assert get("enroll_latency_us")["count"] == 1
        assert get("bank_pool_blocks_live")["value"] == 1
        assert get("rehearsal_bytes")["value"] == 2 * (6 + 4)
    for name in ("enrolls_total", "enroll_shots_total",
                 "bank_pool_blocks_live", "bank_pool_blocks_free",
                 "rehearsal_bytes", "dispatches_total", "evictions_total"):
        assert snaps[0][name] == snaps[1][name], name
    st = svc.stats()
    assert st["paged_bank"] is True and st["enrolls"] == 1
    assert st["tenant_row_bytes"] == 2 * 13 * 4  # block_ways * (V+1) * fp32
    assert st["bank_pool_blocks_live"] == 1
    assert st["rehearsal_bytes"] > 0


def test_tenant_bank_mutated_during_drain_lands_on_peer_post_enroll():
    """An enroll accepted just before drain() applies on the old worker
    (drain waits for the accepted queue), and the handoff carries the
    post-enroll bank: the peer classifies like a never-drained control."""
    import asyncio

    from repro_torch.obs import MetricsRegistry
    from repro_torch.serving import ServingPlane

    rng = np.random.default_rng(12)
    shots1 = rng.normal(size=(2, 10, 2)).astype(np.float32)
    shots2 = rng.normal(size=(1, 10, 2)).astype(np.float32)
    x = rng.normal(size=(6, 2)).astype(np.float32)
    ctrl = _svc(True)
    csid = ctrl.open_session(tenant=0)
    ctrl.enroll_shots(csid, shots1)
    ctrl.enroll_shots(csid, shots2)
    want = ctrl.push_audio({csid: x})[csid]

    async def main():
        plane = ServingPlane([_svc(True), _svc(True)],
                             metrics=MetricsRegistry())
        async with plane:
            psid = await plane.open_session(tenant=0)
            assert await plane.enroll(psid, shots1) == 0
            victim = plane._sessions[psid][0]
            fe = asyncio.ensure_future(plane.enroll(psid, shots2))
            await asyncio.sleep(0)  # the enroll op is now queued
            way, summary = await asyncio.gather(fe, plane.drain(victim.idx))
            assert way == 1
            assert summary["moved_sessions"] == 1
            assert summary["moved_tenants"] == 1
            assert plane._sessions[psid][0] is not victim
            assert (await plane.poll(psid))["n_ways"] == 2
            res = await plane.push(psid, x)
            # the bank keeps learning on the peer
            assert await plane.enroll(psid, shots2) == 2
            return res

    _same_results(asyncio.run(main()), want, exact=True)
