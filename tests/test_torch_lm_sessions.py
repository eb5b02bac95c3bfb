"""The port's LMSessionService on the CPU: the invariants of
tests/test_lm_sessions.py (its RWKV cases are in
tests/test_torch_recurrent_sessions.py) held bit for bit inside the port — chunked == per-token decode,
chunk boundaries, interleaving, evict/park/resume, parking through disk,
seq_cap retirement, int32 positions, restore refusals, oversized prompts,
back-pressure and oversubscription, paged == dense, O(1) paged admission,
the parked-bytes gauge, paged spill/restore, layout refusals, pool
exhaustion, prefix copy-on-write — with fixed seeds where the reference
draws from an unseeded ``@given``.

The chunk-schedule invariance is not bit-exact (a chunk's products round
at another M; the reference's own bit-exact assert of this fails on jax
0.9's CPU).  At this test's two narrow layers it holds in its strong
form: the same greedy tokens, every KV element within one bf16 ulp of
token-at-a-time prefill; chip_smoke.py holds the full-depth contract
(layer 0 within one ulp of its scale, the rest within 5e-2).

Against the reference: the greedy tokens of a JAX LMSessionService and the
port's on the same prompts at act_dtype float32 are equal up to the first
step where the reference's top-2 logit margin is below 1e-3; and LM spill
files (bf16 KV) written by either package restore in the other bit for
bit."""

import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import build_bundle as j_build_bundle  # noqa: E402
from repro.sessions import LMSessionService as JLMService  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import numpy_bits, params_from_jax  # noqa: E402
from repro_torch.models import build_bundle  # noqa: E402
from repro_torch.sessions import (  # noqa: E402
    AdmissionError,
    LMSessionService,
    PrefixCache,
    BlockPool,
    parked_bytes,
    pow2_chunks,
    prefix_keys,
)
from repro_torch.sessions.state import (  # noqa: E402
    PAGED_MARKER,
    copy_block,
    gather_column,
    leaf_axes,
    make_pools,
    pack_blocks,
    pack_column,
    paged_flags,
    split_blocks,
    unpack_blocks,
    unpack_column,
    zero_from_column,
)
from repro_torch.utils.trees import tree_leaves  # noqa: E402

TINY = dict(n_layers=2, d_model=32, d_ff=64, vocab_size=64, head_dim=16)


@functools.lru_cache(maxsize=None)
def _lm_setup(dtype: str = "bfloat16"):
    cfg = get_config("olmo-1b").smoke().replace(act_dtype=dtype, **TINY)
    bundle = build_bundle(cfg, "cpu")
    return cfg, bundle, bundle.init(torch.Generator().manual_seed(0))


def _svc(n_slots=2, seq_cap=48, t_chunk=8, **kw):
    _, bundle, params = _lm_setup()
    return LMSessionService(bundle, params, n_slots=n_slots, seq_cap=seq_cap,
                            t_chunk=t_chunk, **kw)


def _paged_svc(**kw):
    kw.setdefault("max_sessions", 8)
    return _svc(paged=True, **kw)


def _bits(blob):
    return [np.asarray(x) for x in tree_leaves(numpy_bits(blob))]


def _same_bits(a, b) -> bool:
    a, b = _bits(a), _bits(b)
    return len(a) == len(b) and all(np.array_equal(x, y)
                                    for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# column helpers
# ---------------------------------------------------------------------------

def test_leaf_axes_pow2_chunks_prefix_keys():
    _, bundle, _ = _lm_setup()
    bax = leaf_axes(lambda: bundle.cache_specs(2, 8),
                    lambda: bundle.cache_specs(3, 8))
    sax = leaf_axes(lambda: bundle.cache_specs(2, 8),
                    lambda: bundle.cache_specs(2, 9))
    assert bax == {"dense": {"k": 1, "v": 1}}
    assert sax == {"dense": {"k": 2, "v": 2}}
    assert pow2_chunks(255, 128) == [128, 64, 32, 16, 8, 4, 2, 1]
    assert pow2_chunks(10, 6) == [4, 4, 2]
    with pytest.raises(ValueError):
        pow2_chunks(3, 0)
    assert prefix_keys([1, 2, 3, 4, 5], 2) == [(1, 2), (1, 2, 3, 4)]


def test_pack_unpack_zero_from_column():
    """pack_column truncates to [0, pos) on the host (bf16 as bits),
    unpack_column zero-extends into any slot, zero_from_column scrubs
    rows >= start: the canonical column a park + resume rebuilds."""
    _, bundle, _ = _lm_setup()
    cache = bundle.empty_cache(2, 8)
    g = torch.Generator().manual_seed(1)
    for a in tree_leaves(cache):
        a.copy_(torch.randn(a.shape, generator=g).to(a.dtype))
    bax = {"dense": {"k": 1, "v": 1}}
    sax = {"dense": {"k": 2, "v": 2}}
    blob = pack_column(cache, bax, 0, trunc_axes=sax, trunc_len=5)
    assert blob["dense"]["k"].shape == (2, 5, 2, 16)
    assert blob["dense"]["k"].dtype == np.dtype("V2")
    other = bundle.empty_cache(2, 8)
    unpack_column(other, bax, 1, blob)
    zero_from_column(cache, bax, sax, 0, 5)
    for key in ("k", "v"):
        assert torch.equal(other["dense"][key][:, 1], cache["dense"][key][:, 0])
    assert not cache["dense"]["k"][:, 0, 5:].any()
    assert cache["dense"]["k"][:, 1, 5:].any()  # other slot untouched


def test_pool_helpers_rebuild_the_dense_column():
    """make_pools -> split_blocks/unpack_blocks -> gather_column gives the
    dense column back bit for bit; pack_blocks and copy_block move whole
    blocks."""
    _, bundle, _ = _lm_setup()
    specs = bundle.cache_specs(2, 8)
    bax = {"dense": {"k": 1, "v": 1}}
    sax = {"dense": {"k": 2, "v": 2}}
    assert paged_flags(bax, sax) == {"dense": {"k": True, "v": True}}
    pools = make_pools(specs, bax, sax, extent=5, block_len=4, device="cpu")
    pool = pools["dense"]["k"]
    assert tuple(pool.shape) == (2, 5, 4, 2, 16) and not pool.any()
    col = torch.randn(2, 8, 2, 16).to(torch.bfloat16)
    blocks = split_blocks(col, 1, 4)
    assert tuple(blocks.shape) == (2, 2, 4, 2, 16)
    unpack_blocks(pool, [3, 1], blocks.clone(), 1)
    row = torch.tensor([3, 1], dtype=torch.int32)
    assert torch.equal(gather_column(pool, row, 1), col)
    assert torch.equal(gather_column(pool, row[None], 1)[:, 0], col)
    host = pack_blocks(pool, [3, 1], 1)
    assert host.dtype == np.dtype("V2") and host.shape == (2, 2, 4, 2, 16)
    copy_block(pool, 3, 2, 1)
    assert torch.equal(pool[:, 2], pool[:, 3])


# ---------------------------------------------------------------------------
# chunked decode exactness
# ---------------------------------------------------------------------------

def test_chunked_decode_matches_per_token_decode():
    chunked, stepwise = _svc(t_chunk=16), _svc(t_chunk=1)
    prompt = np.array([3, 1, 4, 1, 5], np.int32)
    a, b = chunked.open_session(prompt), stepwise.open_session(prompt)
    d0c, d0s = chunked.dispatches, stepwise.dispatches
    out_c = chunked.decode({a: 20})[a]
    out_s = stepwise.decode({b: 20})[b]
    assert out_c == out_s and len(out_c) == 20
    # 4 prompt tokens prefill at open; the last + 20 generated = 20 steps
    assert chunked.dispatches - d0c == 2
    assert stepwise.dispatches - d0s == 20
    chunked.park(a)
    stepwise.park(b)
    assert _same_bits(chunked.parking[a], stepwise.parking[b])


def test_chunk_boundary_invariance():
    whole, split = _svc(t_chunk=8), _svc(t_chunk=8)
    prompt = np.array([7, 9], np.int32)
    a, b = whole.open_session(prompt), split.open_session(prompt)
    out_a = whole.decode({a: 18})[a]
    out_b = []
    for n in (1, 5, 2, 7, 3):
        out_b += split.decode({b: n})[b]
    assert out_a == out_b


def test_interleaved_sessions_do_not_perturb_each_other():
    ctl = _svc(n_slots=2)
    c = ctl.open_session(np.array([7, 9, 4], np.int32))
    want = ctl.decode({c: 11})[c]
    svc = _svc(n_slots=2)
    r = svc.open_session(np.array([7, 9, 4], np.int32))
    got = svc.decode({r: 3})[r]
    r2 = svc.open_session(np.array([1, 2], np.int32))
    got += svc.decode({r: 4, r2: 4})[r]
    got += svc.decode({r: 4})[r]
    assert got == want


# ---------------------------------------------------------------------------
# chunked prefill
# ---------------------------------------------------------------------------

def _ordered(u: np.ndarray) -> np.ndarray:
    s = u.astype(np.int32)
    return np.where(s >= 0x8000, 0x8000 - s, s)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_chunked_prefill_schedule_contract(seed):
    """Prefill chunk caps 0 (token at a time through the decode scan), 1,
    a power of two and 64: the same greedy stream, and the parked KV
    within one bf16 ulp of the cap-0 column."""
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, 64, size=int(rng.integers(2, 44))) \
        .astype(np.int32)
    streams, cols = [], []
    for cap in (0, 1, int(rng.choice([2, 4, 8, 16])), 64):
        svc = _svc(n_slots=2, seq_cap=64, t_chunk=8, prefill_chunk=cap)
        sid = svc.open_session(prompt)
        streams.append(svc.decode({sid: 6})[sid])
        svc.park(sid)
        cols.append(_bits(svc.parking[sid]))
    for s, col in zip(streams[1:], cols[1:]):
        assert s == streams[0]
        for x, y in zip(col, cols[0]):
            assert x.shape == y.shape
            assert int(np.abs(_ordered(x) - _ordered(y)).max()) <= 1


def test_chunked_prefill_dispatch_budget():
    svc = _svc(n_slots=2, seq_cap=320, t_chunk=16, prefill_chunk=128)
    prompt = np.random.default_rng(0).integers(0, 64, 256).astype(np.int32)
    d0 = svc.dispatches
    sid = svc.open_session(prompt)
    assert svc.dispatches - d0 == 8  # 128+64+32+16+8+4+2+1
    assert svc.sessions[sid].steps == 255
    assert svc.poll(sid)["prompt_left"] == 1
    d0 = svc.dispatches
    out = svc.decode({sid: 4})[sid]
    assert len(out) == 4 and svc.dispatches - d0 == 1


def test_chunked_prefill_park_before_first_decode():
    ctl = _svc(n_slots=2, prefill_chunk=16)
    c = ctl.open_session(np.arange(1, 12, dtype=np.int32))
    want = ctl.decode({c: 8})[c]
    svc = _svc(n_slots=2, prefill_chunk=16, max_sessions=8)
    a = svc.open_session(np.arange(1, 12, dtype=np.int32))
    b1 = svc.open_session(np.array([1], np.int32))
    b2 = svc.open_session(np.array([2], np.int32))  # evicts a, never decoded
    assert svc.poll(a)["state"] == "parked"
    svc.decode({b1: 1, b2: 1})
    assert svc.decode({a: 8})[a] == want


def test_chunked_prefill_prompt_ending_at_seq_cap_retires():
    svc = _svc(n_slots=2, seq_cap=24, t_chunk=8, prefill_chunk=8)
    prompt = np.random.default_rng(3).integers(0, 64, 23).astype(np.int32)
    ctl = _svc(n_slots=2, seq_cap=24, t_chunk=8, prefill_chunk=0)
    c = ctl.open_session(prompt)
    want = ctl.decode({c: 2})[c]
    a = svc.open_session(prompt)
    assert svc.sessions[a].steps == 22
    out = svc.decode({a: 50})[a]
    assert out == want and len(out) == 2  # 24 - 23 + 1
    assert svc.poll(a)["state"] == "done"
    assert not svc.sched.is_bound(a)
    b = svc.open_session(np.array([4], np.int32))
    assert len(svc.decode({b: 2})[b]) == 2


# ---------------------------------------------------------------------------
# KV park/resume, persistence, guards
# ---------------------------------------------------------------------------

def test_evict_park_resume_bit_identical():
    ctl = _svc(n_slots=2, max_sessions=8)
    c = ctl.open_session(np.array([5, 6], np.int32))
    want = ctl.decode({c: 16})[c]
    svc = _svc(n_slots=2, max_sessions=8)
    a = svc.open_session(np.array([5, 6], np.int32))
    got = svc.decode({a: 6})[a]
    b1 = svc.open_session(np.array([1], np.int32))
    b2 = svc.open_session(np.array([2], np.int32))
    assert svc.poll(a)["state"] == "parked"
    svc.decode({b1: 3, b2: 3})
    got += svc.decode({a: 10})[a]
    assert svc.stats()["evictions"] >= 2
    assert got == want


def test_explicit_park_blob_is_o_pos():
    svc = _svc(n_slots=2, max_sessions=4)
    a = svc.open_session(np.array([1, 2, 3], np.int32))
    b = svc.open_session(np.array([4], np.int32))
    svc.decode({a: 12, b: 2})
    svc.park(a)
    svc.park(b)
    ba, bb = parked_bytes(svc.parking[a]), parked_bytes(svc.parking[b])
    assert ba > bb > 0
    assert svc.kv_park_bytes(svc.sessions[a].steps) == ba
    svc2 = _svc(n_slots=2, max_sessions=4, stale_window=1 << 30)
    a2 = svc2.open_session(np.array([1, 2, 3], np.int32))
    b2 = svc2.open_session(np.array([4], np.int32))
    svc2.decode({a2: 12, b2: 2})
    svc2.sched.touch(b2)  # a2 is LRU but far more expensive to park
    svc2.open_session(np.array([9], np.int32))
    assert svc2.poll(b2)["state"] == "parked"
    assert svc2.poll(a2)["state"] == "active"


def test_park_resume_roundtrips_through_disk(tmp_path):
    """bf16 KV columns spill with the reference's dtype sidecar and resume
    bit for bit in a fresh service."""
    ctl = _svc(n_slots=2)
    c = ctl.open_session(np.array([8, 3], np.int32))
    want = ctl.decode({c: 14})[c]
    svc = _svc(n_slots=2)
    s = svc.open_session(np.array([8, 3], np.int32))
    first = svc.decode({s: 5})[s]
    path = str(tmp_path / "lm_sessions.npz")
    svc.spill_parking(path, include_bound=True)
    assert svc.poll(s)["state"] == "parked"
    fresh = _svc(n_slots=2)
    assert fresh.restore_parking(path) == [s]
    assert fresh.outputs[s] == first
    assert _same_bits(fresh.parking[s], svc.parking[s])
    assert first + fresh.decode({s: 9})[s] == want


def test_seq_cap_retires_instead_of_wrapping():
    svc = _svc(n_slots=2, seq_cap=12)
    a = svc.open_session(np.array([1, 2, 3], np.int32))
    out = svc.decode({a: 50})[a]
    assert len(out) == 10  # 12 - 3 + 1
    assert svc.poll(a)["state"] == "done"
    assert svc.sessions[a].steps == 12
    assert not svc.sched.is_bound(a)
    with pytest.raises(RuntimeError):
        svc.decode({a: 1})
    assert svc.outputs[a] == out
    b = svc.open_session(np.array([4], np.int32))
    assert len(svc.decode({b: 2})[b]) == 2


def test_positions_are_int32_end_to_end():
    svc = _svc(n_slots=2)
    a = svc.open_session(np.array([1, 2], np.int32))
    svc.decode({a: 3})
    assert svc.slot_pos.dtype == np.int32
    assert isinstance(svc.sessions[a].steps, int)
    from repro_torch.serving import LMServer, ServeConfig
    _, bundle, params = _lm_setup()
    srv = LMServer(bundle, params, ServeConfig(max_batch=2, seq_cap=16))
    with pytest.warns(DeprecationWarning):
        srv.add_request(np.array([1], np.int32))
    srv.step()
    assert srv.pos.dtype == np.int32


def test_restore_refuses_incompatible_seq_cap(tmp_path):
    src = _svc(n_slots=2, seq_cap=48)
    s = src.open_session(np.array([1, 2], np.int32))
    src.decode({s: 30})
    path = str(tmp_path / "lot.npz")
    src.spill_parking(path, include_bound=True)
    small = _svc(n_slots=2, seq_cap=24)
    with pytest.raises(ValueError, match="seq_cap|does not fit"):
        small.restore_parking(path)
    assert not small.sessions and small.sched.live_sessions == 0
    ok = small.open_session(np.array([3], np.int32))
    assert len(small.decode({ok: 2})[ok]) == 2


def test_oversized_prompt_refused():
    with pytest.raises(ValueError):
        _svc(n_slots=2, seq_cap=8).open_session(np.arange(8, dtype=np.int32))


def test_admission_backpressure_and_oversubscription():
    svc = _svc(n_slots=2, max_sessions=2)
    svc.open_session(np.array([1], np.int32))
    svc.open_session(np.array([2], np.int32))
    with pytest.raises(AdmissionError):
        svc.open_session(np.array([3], np.int32))
    over = _svc(n_slots=2, max_sessions=3)
    s1 = over.open_session(np.array([1], np.int32))
    over.decode({s1: 1})
    over.open_session(np.array([2], np.int32))
    s3 = over.open_session(np.array([3], np.int32))
    assert over.poll(s1)["state"] == "parked"
    assert over.sched.is_bound(s3)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("paged", [False, True])
def test_churn_bit_identical_to_never_evicted(seed, paged):
    """Any interleaving of open/push/park/evict/resume on 2 slots (dense
    or paged) gives the tokens of a never-evicted 4-slot dense run."""
    rng = np.random.default_rng(seed)
    _, bundle, params = _lm_setup()
    mk = lambda n, **kw: LMSessionService(bundle, params, n_slots=n,
                                          seq_cap=128, t_chunk=4,
                                          max_sessions=8, **kw)
    svc, ref = mk(2, paged=paged), mk(4)
    prompts = [rng.integers(0, 64, size=rng.integers(1, 5)).astype(np.int32)
               for _ in range(3)]
    sids = [svc.open_session(p) for p in prompts]
    rids = [ref.open_session(p) for p in prompts]
    for _ in range(6):
        picks = [i for i in range(3) if rng.random() < 0.6][:2]
        if rng.random() < 0.3 and picks:
            svc.park(sids[picks[0]])
        wants = {i: int(rng.integers(1, 5)) for i in picks}
        if wants:
            got = svc.decode({sids[i]: n for i, n in wants.items()})
            want = ref.decode({rids[i]: n for i, n in wants.items()})
            for i in picks:
                assert got[sids[i]] == want[rids[i]]
    for sid in sids:
        svc.close(sid)
    if paged:  # no block leaks past the registry's pins
        svc.pool.check()
        assert svc.pool.n_live == len(svc._prefix)


# ---------------------------------------------------------------------------
# paged slot memory
# ---------------------------------------------------------------------------

def test_paged_decode_bit_identical_to_dense():
    dense, paged = _svc(max_sessions=8), _paged_svc()
    assert paged.paged and not dense.paged
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 64, size=n).astype(np.int32)
               for n in (5, 11, 3)]
    outs = {}
    for svc in (dense, paged):
        sids = [svc.open_session(p) for p in prompts]
        got = {s: [] for s in sids}
        for _ in range(4):  # 3 sessions on 2 slots: every round churns
            for sid in sids:
                got[sid].extend(svc.decode({sid: 5})[sid])
        outs[svc] = [got[s] for s in sids]
        outs[svc, "kv"] = [svc.live_column(s) for s in sids
                           if svc.sched.is_bound(s)]
    assert outs[dense] == outs[paged]
    assert all(_same_bits(a, b) for a, b in zip(outs[dense, "kv"],
                                                 outs[paged, "kv"]))
    assert paged.stats()["evictions"] >= 1
    paged.pool.check()


def test_paged_admission_is_o1_and_parked_sessions_hold_no_blocks():
    svc = _paged_svc()
    a = svc.open_session(np.array([1, 2, 3], np.int32))
    svc.decode({a: 10})
    held = len(svc._blocks[a])
    assert held == -(-svc.sessions[a].steps // svc.block_len)
    live0 = svc.pool.n_live
    svc.park(a)
    assert svc._blocks.get(a, []) == []
    assert svc.pool.n_live == live0 - held
    assert PAGED_MARKER in svc.parking[a]
    assert (svc._table == 0).all(axis=1).any()
    svc.decode({a: 3})


def test_paged_parked_bytes_gauge_tracks_blob_sizes():
    svc = _paged_svc()
    g = svc.metrics_registry.gauge("parked_bytes", service="lm")
    assert g.value == 0
    a = svc.open_session(np.array([1, 2, 3], np.int32))
    svc.decode({a: 6})
    svc.park(a)
    want = parked_bytes(svc.parking[a])
    assert svc.parked_blob_bytes == want and g.value == want
    svc.decode({a: 1})
    assert svc.parked_blob_bytes == 0 and g.value == 0
    svc.park(a)
    svc.close(a)
    assert svc.parked_blob_bytes == 0 and g.value == 0


def test_paged_spill_restore_roundtrip(tmp_path):
    ctl = _svc(max_sessions=8)
    c = ctl.open_session(np.array([8, 3], np.int32))
    want = ctl.decode({c: 14})[c]
    svc = _paged_svc()
    s = svc.open_session(np.array([8, 3], np.int32))
    first = svc.decode({s: 5})[s]
    path = str(tmp_path / "paged.npz")
    svc.spill_parking(path, include_bound=True)
    fresh = _paged_svc()
    assert fresh.restore_parking(path) == [s]
    assert fresh.outputs[s] == first
    assert first + fresh.decode({s: 9})[s] == want


def test_paged_restore_refuses_layout_and_geometry_mismatch(tmp_path):
    paged = _paged_svc()
    s = paged.open_session(np.array([1, 2], np.int32))
    paged.decode({s: 8})
    ppath = str(tmp_path / "paged.npz")
    paged.spill_parking(ppath, include_bound=True)
    dense = _svc(max_sessions=8)
    d = dense.open_session(np.array([1, 2], np.int32))
    dense.decode({d: 8})
    dpath = str(tmp_path / "dense.npz")
    dense.spill_parking(dpath, include_bound=True)
    for svc, path in ((_svc(max_sessions=8), ppath),
                      (_paged_svc(), dpath),
                      (_paged_svc(block_len=8), ppath),
                      (_paged_svc(n_blocks=2), ppath)):
        with pytest.raises(ValueError, match="incompatible|does not fit"):
            svc.restore_parking(path)
        assert not svc.sessions and svc.sched.live_sessions == 0
        ok = svc.open_session(np.array([3], np.int32))
        assert len(svc.decode({ok: 2})[ok]) == 2


def test_paged_pool_exhaustion_is_admission_backpressure():
    svc = _paged_svc(n_blocks=3)
    long = np.arange(1, 21, dtype=np.int32)
    a = svc.open_session(long)
    svc.decode({a: 12})
    with pytest.raises(AdmissionError):
        svc.open_session(np.arange(40, 60, dtype=np.int32))
    assert len(svc.sessions) == 1 and svc.sched.live_sessions == 1
    svc.pool.check()
    assert svc.decode({a: 2})[a]
    svc.close(a)
    b = svc.open_session(long)
    assert len(svc.decode({b: 2})[b]) == 2


def test_paged_prefix_sharing_cow():
    svc = _paged_svc(seq_cap=96)
    prompt = np.arange(1, 40, dtype=np.int32)  # 2 full 16-blocks + tail
    a = svc.open_session(prompt)
    out_a = svc.decode({a: 6})[a]
    assert len(svc._prefix) == 2
    live0 = svc.pool.n_live
    b = svc.open_session(prompt)
    assert svc.sessions[b].steps >= 2 * svc.block_len
    assert svc.pool.n_shared >= 2
    assert svc.pool.n_live <= live0 + 2
    out_b = svc.decode({b: 6})[b]
    assert out_a == out_b
    hits = svc.metrics_registry.counter(
        "prefix_block_hits_total", service="lm").value
    assert hits >= 2
    svc.close(a)
    svc.close(b)
    svc.pool.check()


def test_prefix_cache_pins_and_releases():
    pool = BlockPool(4)
    cache = PrefixCache(pool, max_entries=2)
    b1, b2, b3 = pool.alloc(), pool.alloc(), pool.alloc()
    keys = prefix_keys(list(range(6)), 2)
    for key, bid in zip(keys, (b1, b2, b3)):
        cache.insert(key, bid)
    assert len(cache) == 2  # the LRU entry went
    assert cache.match(keys) == []  # its chain head is gone
    assert cache.misses == 1
    for bid in (b1, b2, b3):
        pool.free(bid)
    cache.clear()
    pool.check()
    assert pool.n_live == 0


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _pair(dtype: str):
    jcfg = j_get_config("olmo-1b").smoke().replace(act_dtype=dtype, **TINY)
    jb = j_build_bundle(jcfg)
    jp = jb.init(jax.random.key(3))
    b = build_bundle(get_config("olmo-1b").smoke().replace(
        act_dtype=dtype, **TINY), "cpu")
    return jb, jp, b, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _margins(jb, jp, prompt, tokens) -> list:
    """The reference's top-2 logit margin before each generated token,
    from its decode fed token by token (one compiled program)."""
    dec = jax.jit(jb.decode_fn)
    cache = jb.empty_cache(1, 64)
    seq = np.concatenate([prompt, tokens]).astype(np.int32)
    out = []
    for i in range(len(prompt) + len(tokens) - 1):
        lg, cache = dec(jp, cache, {"tokens": jnp.asarray(seq[None, i:i + 1]),
                                    "pos": jnp.int32(i)})
        if i >= len(prompt) - 1:
            top = np.sort(np.asarray(lg[0]))[-2:]
            out.append(float(top[1] - top[0]))
    return out


@pytest.mark.parametrize("paged", [False, True])
def test_greedy_tokens_match_the_reference(paged):
    jb, jp, b, p = _pair("float32")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 64, n).astype(np.int32) for n in (7, 20, 3)]
    jsvc = JLMService(jb, jp, n_slots=2, seq_cap=64, t_chunk=8,
                      max_sessions=8)
    svc = LMSessionService(b, p, n_slots=2, seq_cap=64, t_chunk=8,
                           max_sessions=8, paged=paged)
    for prompt in prompts:
        js, s = jsvc.open_session(prompt), svc.open_session(prompt)
        want = jsvc.decode({js: 12})[js]
        got = svc.decode({s: 12})[s]
        margins = _margins(jb, jp, prompt, want)
        n = next((j for j, m in enumerate(margins) if m < 1e-3),
                 len(want))
        assert got[:n] == want[:n], (n, margins)


@pytest.mark.parametrize("paged", [False, True])
def test_lm_spill_files_cross_the_packages(tmp_path, paged):
    """bf16 LM spills: the reference's file restores in the port with the
    same KV bits (and through a resume and a park again); the port's file
    restores in the reference with the same bits, as bfloat16."""
    jb, jp, b, p = _pair("bfloat16")
    kw = dict(n_slots=2, seq_cap=64, t_chunk=8, max_sessions=8, paged=paged)
    jsvc, svc = JLMService(jb, jp, **kw), LMSessionService(b, p, **kw)
    prompt = np.arange(3, 22, dtype=np.int32)
    js = jsvc.open_session(prompt)
    jsvc.decode({js: 5})
    jpath = str(tmp_path / "jax.npz")
    jsvc.spill_parking(jpath, include_bound=True)
    jbits = [np.asarray(x).view(np.uint16) if np.asarray(x).dtype.name ==
             "bfloat16" else np.asarray(x)
             for x in jax.tree.leaves(jsvc.parking[js])]
    assert any(np.asarray(x).dtype.name == "bfloat16"
               for x in jax.tree.leaves(jsvc.parking[js]))
    assert svc.restore_parking(jpath) == [js]
    got = _bits(svc.parking[js])
    assert all(np.array_equal(x, y) for x, y in zip(got, jbits))
    assert svc.outputs[js] == jsvc.outputs[js]
    svc.resume(js)   # into the port's cache ...
    svc.park(js)     # ... and back out: the same bits
    assert all(np.array_equal(x, y) for x, y in zip(_bits(svc.parking[js]),
                                                     jbits))
    assert len(svc.decode({js: 3})[js]) == 3
    ppath = str(tmp_path / "port.npz")
    svc.spill_parking(ppath, include_bound=True)
    fresh = JLMService(jb, jp, **kw)
    assert fresh.restore_parking(ppath) == [js]
    leaves = jax.tree.leaves(fresh.parking[js])
    assert any(np.asarray(x).dtype.name == "bfloat16" for x in leaves)
    back = [np.asarray(x).view(np.uint16) if np.asarray(x).dtype.name ==
            "bfloat16" else np.asarray(x) for x in leaves]
    assert all(np.array_equal(x, y)
               for x, y in zip(back, _bits(svc.parking[js])))
    assert len(fresh.decode({js: 2})[js]) == 2


def test_store_bf16_bits_and_refused_dtypes(tmp_path):
    """A bf16 leaf is written as the reference writes one (|V2 bytes and a
    "bfloat16" sidecar entry) and read back as the same bits by both
    packages; a sidecar naming a dtype numpy cannot name is refused with a
    TypeError."""
    import ml_dtypes

    from repro.checkpoint import store as jstore
    from repro_torch.checkpoint import store

    bits = np.arange(12, dtype=np.uint16).reshape(3, 4) * 977
    t = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    path = str(tmp_path / "p.npz")
    store.save_sessions(path, {3: {"kv": {"k": t}}}, {"next_sid": 4})
    jpark, jmeta = jstore.load_sessions(path)
    assert jpark[3]["kv"]["k"].dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(jpark[3]["kv"]["k"].view(np.uint16), bits)
    park, meta = store.load_sessions(path)
    assert meta == {"next_sid": 4}
    np.testing.assert_array_equal(numpy_bits(park)[3]["kv"]["k"], bits)
    # a sidecar entry numpy cannot resolve (without ml_dtypes, fp8 is one)
    odd = str(tmp_path / "odd.npz")
    meta = {"__dtypes__": {"0/x": "float6_unnamed"}}
    np.savez(odd, **{"0/x": np.zeros(4, np.uint8),
                     "__meta__": np.frombuffer(
                         json.dumps(meta).encode(), np.uint8)})
    with pytest.raises(TypeError, match="float6_unnamed"):
        store.load_sessions(odd)
