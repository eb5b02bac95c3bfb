"""Speculative decoding in the port (``repro_torch.sessions.spec``) on the
CPU: the GQA and MLA cases of tests/test_speculative.py and
tests/test_obs.py::test_speculative_device_acceptance_matches_host, held
inside the port, and the port against the JAX reference.

Inside the port, bit for bit: scan mode emits plain ``decode``'s stream
for every drafter of the zoo (oracle, always-wrong, truncated, random,
n-gram), dense and paged, through decode splits, park/evict churn and a
spill into a fresh service mid-draft; paged rollback returns the rejected
suffix's blocks to the pool; parallel mode is deterministic, invariant to
park/resume, exact in its emission counts, and paged == dense; both modes
retire at seq_cap like plain decode; the device acceptance count equals
the host's.

Against the reference (act_dtype float32, converted params):
``ngram_drafter``'s proposals are equal on random histories; the port's
speculative stream equals the reference ``SpeculativeDecoder``'s up to the
first step where the reference's top-2 logit margin is below 1e-3 (the
tokens' precedent of tests/test_torch_lm_sessions.py), and where the
whole stream agrees, the drafted and accepted counts are equal."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import build_bundle as j_build_bundle  # noqa: E402
from repro.sessions import LMSessionService as JLMService  # noqa: E402
from repro.sessions import SpeculativeDecoder as JSpec  # noqa: E402
from repro.sessions import ngram_drafter as j_ngram  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import numpy_bits, params_from_jax  # noqa: E402
from repro_torch.models import build_bundle  # noqa: E402
from repro_torch.obs import Tracer  # noqa: E402
from repro_torch.sessions import (  # noqa: E402
    LMSessionService,
    SpeculativeDecoder,
    ngram_drafter,
)
from repro_torch.sessions.state import (  # noqa: E402
    unpack_column,
    zero_from_column,
)
from repro_torch.utils.trees import tree_leaves  # noqa: E402

V = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module, restored after it: the tiny
    ops of these narrow models gain nothing from threads, and when test
    workers oversubscribe the cores, torch's threads wait on each other
    for every op (two orders of magnitude slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the reference suite's two pure-KV rows: GQA (olmo-1b) and MLA (deepseek)
ARCHS = {
    "gqa": ("olmo-1b", dict(n_layers=2, d_model=32, d_ff=64, vocab_size=V,
                            head_dim=16)),
    "mla": ("deepseek-v2-lite-16b", dict(n_layers=2, d_model=32, d_ff=64,
                                         vocab_size=V)),
}


@functools.lru_cache(maxsize=None)
def _setup(arch, dtype="bfloat16"):
    name, extra = ARCHS[arch]
    cfg = get_config(name).smoke().replace(act_dtype=dtype, **extra)
    bundle = build_bundle(cfg, "cpu")
    return bundle, bundle.init(torch.Generator().manual_seed(0))


def _svc(arch, **kw):
    bundle, params = _setup(arch)
    kw = {"n_slots": 2, "seq_cap": 96, "t_chunk": 8, "max_sessions": 8,
          **kw}
    return LMSessionService(bundle, params, **kw)


@functools.lru_cache(maxsize=None)
def _services(arch, paged=False):
    """(plain reference, speculative target) pair, reused across cases:
    sessions are opened and closed per case."""
    return _svc(arch), _svc(arch, paged=paged)


def _reference(arch, prompt, n):
    """The port's plain greedy stream: ground truth inside the port."""
    plain, _ = _services(arch)
    sid = plain.open_session(np.asarray(prompt, np.int32))
    try:
        return plain.decode({sid: n})[sid]
    finally:
        plain.close(sid)


def _drafters(prompt, ref):
    P = len(prompt)

    def right(hist, k):
        i = len(hist) - P
        return np.asarray(ref[i:i + k], np.int32)

    def wrong(hist, k):
        i = len(hist) - P
        return np.asarray([(t + 1) % V for t in ref[i:i + k]], np.int32)

    def truncated(hist, k):
        i = len(hist) - P
        return np.asarray(ref[i:i + k][:(k + 1) // 2], np.int32)

    def random(hist, k):
        return np.random.default_rng(len(hist)).integers(
            0, V, size=k).astype(np.int32)

    return {"always-right": right, "always-wrong": wrong,
            "truncated": truncated, "random": random,
            "self-draft": ngram_drafter()}


# ---------------------------------------------------------------------------
# the drafter against the reference's
# ---------------------------------------------------------------------------

def test_ngram_drafter_matches_the_reference():
    rng = np.random.default_rng(0)
    with pytest.raises(ValueError):
        ngram_drafter(1)
    for n in (2, 3, 4):
        for window in (8, 128):
            ours, ref = ngram_drafter(n, window), j_ngram(n, window)
            for _ in range(40):
                hist = rng.integers(0, int(rng.integers(2, 9)),
                                    size=int(rng.integers(0, 40)))
                k = int(rng.integers(0, 7))
                got, want = ours(hist, k), ref(hist, k)
                assert got.dtype == np.int32
                np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# scan mode: bit-identity to plain decode, inside the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_scan_bit_identical_for_every_drafter(arch, paged):
    prompt = np.array([3, 1, 4, 1, 5], np.int32)
    want = _reference(arch, prompt, 30)
    _, svc = _services(arch, paged)
    for name, dr in _drafters(prompt, want).items():
        sp = SpeculativeDecoder(svc, dr, k=4)
        sid = svc.open_session(prompt)
        try:
            got = sp.decode({sid: 12})[sid]
            if paged:  # rollback returned the rejected suffix's blocks
                steps = svc.sessions[sid].steps
                assert len(svc._blocks[sid]) == -(-steps // svc.block_len)
            got += sp.decode({sid: 18})[sid]  # split mid-stream
        finally:
            svc.close(sid)
        assert got == want, (arch, name)
    if paged:
        svc.pool.check()
        assert svc.pool.n_live == len(svc._prefix or ())


def test_acceptance_bookkeeping():
    """The oracle accepts everything in ceil(20 / (k+1)) verifies after
    the first-token dispatch; the adversary accepts nothing, one token a
    verify, and still emits the plain stream."""
    prompt = np.array([7, 9], np.int32)
    want = _reference("gqa", prompt, 24)
    _, svc = _services("gqa")
    drs = _drafters(prompt, want)

    sp = SpeculativeDecoder(svc, drs["always-right"], k=4)
    sid = svc.open_session(prompt)
    d0 = svc.dispatches
    sp.decode({sid: 21})
    n_right = svc.dispatches - d0
    svc.close(sid)
    assert sp.acceptance_rate == 1.0
    assert sp.accepts[sid] == sp.accepted > 0
    assert n_right == 1 + 4

    sp = SpeculativeDecoder(svc, drs["always-wrong"], k=4)
    sid = svc.open_session(prompt)
    d0 = svc.dispatches
    out = sp.decode({sid: 21})[sid]
    svc.close(sid)
    assert out == want[:21]
    assert sp.accepted == 0 and sp.drafted > 0
    assert svc.dispatches - d0 == 1 + 20
    assert sp.stats()["acceptance_rate"] == 0.0


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_scan_churn_bit_identical(arch, seed):
    """Random drafter mixes, K, decode splits and park/evict churn
    mid-stream never change the emitted stream (the reference draws these
    from an unseeded property; fixed seeds here)."""
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, V, size=int(rng.integers(1, 6))).astype(
        np.int32)
    total = int(rng.integers(8, 28))
    want = _reference(arch, prompt, total)
    _, svc = _services(arch)
    drs = list(_drafters(prompt, want).values())
    sp = SpeculativeDecoder(
        svc, lambda h, k: drs[int(rng.integers(len(drs)))](h, k),
        k=int(rng.integers(1, 6)))
    sid = svc.open_session(prompt)
    other = svc.open_session(np.array([1], np.int32))
    got = []
    try:
        left = total
        while left:
            n = int(min(rng.integers(1, 9), left))
            got += sp.decode({sid: n})[sid]
            left -= n
            if rng.random() < 0.4:
                svc.park(sid)
                svc.decode({other: 2})
    finally:
        svc.close(sid)
        svc.close(other)
    assert got == want


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_spill_restore_mid_draft(arch, paged, tmp_path):
    """A session spilled to disk mid-speculation resumes the exact plain
    stream in a fresh service (and another K): the drafter's input is the
    host-side history, which travels in the spill's meta."""
    prompt = np.array([5, 6], np.int32)
    want = _reference(arch, prompt, 24)
    svc = _svc(arch, paged=paged)
    sp = SpeculativeDecoder(svc, ngram_drafter(), k=3)
    sid = svc.open_session(prompt)
    got = sp.decode({sid: 9})[sid]
    path = str(tmp_path / "spec.npz")
    svc.spill_parking(path, include_bound=True)
    assert svc.poll(sid)["state"] == "parked"
    fresh = _svc(arch, paged=paged)
    assert fresh.restore_parking(path) == [sid]
    sp2 = SpeculativeDecoder(fresh, ngram_drafter(), k=5)
    got += sp2.decode({sid: 15})[sid]
    assert got == want
    if paged:
        fresh.close(sid)
        fresh.pool.check()


@pytest.mark.parametrize("verify", ["scan", "parallel"])
def test_retires_at_seq_cap(verify):
    """A draft that would run past seq_cap is cut; the session retires as
    plain decode's does (slot freed, outputs kept, a further decode
    raises)."""
    ctl = _svc("gqa", seq_cap=12, max_sessions=None)
    svc = _svc("gqa", seq_cap=12, max_sessions=None)
    prompt = np.array([1, 2, 3], np.int32)
    c = ctl.open_session(prompt)
    want = ctl.decode({c: 50})[c]
    sp = SpeculativeDecoder(svc, ngram_drafter(), k=4, verify=verify)
    sid = svc.open_session(prompt)
    out = sp.decode({sid: 50})[sid]
    assert len(out) == 10 and svc.poll(sid)["state"] == "done"
    if verify == "scan":
        assert out == want
    with pytest.raises(RuntimeError):
        sp.decode({sid: 1})


def test_validation():
    _, svc = _services("gqa")
    with pytest.raises(ValueError):
        SpeculativeDecoder(svc, k=0)
    with pytest.raises(ValueError):
        SpeculativeDecoder(svc, verify="teleport")

    class Recurrent:  # what a bundle with RWKV/Mamba leaves would be
        parallel_safe = False

    # the reference's refusal: a recurrent leaf rolls back by value, so
    # only the scan modes verify it (tests/test_torch_recurrent_sessions.py)
    with pytest.raises(ValueError, match="parallel verify"):
        SpeculativeDecoder(Recurrent(), verify="parallel")
    sp = SpeculativeDecoder(svc, k=2)
    with pytest.raises(KeyError):
        sp.decode({12345: 1})
    sid = svc.open_session(np.array([1], np.int32))
    try:
        with pytest.raises(ValueError):
            sp.decode({sid: -1})
        assert sp.decode({sid: 0}) == {sid: []}
    finally:
        svc.close(sid)


@pytest.mark.parametrize("verify", ["scan", "parallel"])
@pytest.mark.parametrize("paged", [False, True])
def test_device_acceptance_matches_host(paged, verify):
    """With device counters on, the per-lane acceptance computed on the
    device from the verify's outputs equals the host's rollback count,
    the stream is unchanged, and the registry's counters (labels of the
    reference) mirror the decoder's integers; each verify is one "verify"
    span."""
    prompts = [np.array([3, 1, 4, 1, 5, 1, 4, 1], np.int32),
               np.array([2, 7, 2, 7, 2], np.int32)]

    def run(dev):
        svc = _svc("gqa", paged=paged, device_counters=dev,
                   tracer=Tracer(enabled=True))
        sp = SpeculativeDecoder(svc, ngram_drafter(), k=3, verify=verify)
        sids = [svc.open_session(p) for p in prompts]
        out = sp.decode({sid: 24 for sid in sids})
        return svc, sp, [out[sid] for sid in sids]

    _, sp_plain, stream_plain = run(False)
    svc, sp, stream = run(True)
    assert stream == stream_plain
    assert sp_plain.last_device_accepts is None
    assert sp.last_device_accepts is not None
    assert sp.accepted == sp_plain.accepted > 0
    snap = svc.metrics()
    assert snap["spec_device_accepted_total"][0]["value"] == sp.accepted
    assert snap["spec_drafted_total"][0]["value"] == sp.drafted
    assert snap["spec_drafted_total"][0]["labels"] == {
        "service": "lm", "verify": verify}
    assert snap["spec_accepted_total"][0]["value"] == sp.accepted
    shapes = {h["labels"]["shape"] for h in snap["dispatch_latency_us"]}
    assert "V4" in shapes
    spans = [e for e in svc.tracer.events() if e.get("name") == "verify"]
    assert spans and all(e["args"]["mode"] == verify and e["cat"] == "spec"
                         for e in spans)


# ---------------------------------------------------------------------------
# parallel mode: self-consistency, paged == dense
# ---------------------------------------------------------------------------

def _parallel_churn(svc, prompt):
    sp = SpeculativeDecoder(svc, ngram_drafter(), k=4, verify="parallel")
    sid = svc.open_session(prompt)
    other = svc.open_session(np.array([9], np.int32))
    try:
        got = sp.decode({sid: 7})[sid]
        if svc.paged:  # the K+1 verified rows' blocks past it were freed
            steps = svc.sessions[sid].steps
            assert len(svc._blocks[sid]) == -(-steps // svc.block_len)
        svc.park(sid)              # mid-draft eviction
        svc.decode({other: 3})     # a neighbour writes the grid
        got += sp.decode({sid: 19})[sid]
    finally:
        svc.close(sid)
        svc.close(other)
    return got


@pytest.mark.parametrize("arch", list(ARCHS))
def test_parallel_self_consistent_and_paged_equals_dense(arch):
    """Parallel mode emits a deterministic stream of exactly the asked
    length; park/resume mid-draft and a neighbour's decode cannot change
    it (the same call budgets: a call cuts its last drafts to its budget,
    and parallel mode's stream depends on the drafts); the paged service
    (4-row blocks, so a verify's K+1 rows reach past the accepted
    position's block) emits the dense one's bits, holds only its
    position's blocks after a call and returns every block."""
    prompt = np.array([2, 7, 1], np.int32)
    dense, paged = _svc(arch), _svc(arch, paged=True, block_len=4)
    sp = SpeculativeDecoder(dense, ngram_drafter(), k=4, verify="parallel")
    sid = dense.open_session(prompt)
    want = sp.decode({sid: 7})[sid]  # the churn runs' call budgets
    want += sp.decode({sid: 19})[sid]
    dense.close(sid)
    assert len(want) == 26
    assert _parallel_churn(dense, prompt) == want
    assert _parallel_churn(paged, prompt) == want
    paged.pool.check()
    assert paged.pool.n_live == len(paged._prefix or ())


def test_parallel_inactive_lanes_keep_their_rows():
    """A bound lane not verified in a parallel dispatch may sit near the
    cap, where the clamped K+1-row block would overlap its live rows:
    they are restored, so its column is unchanged."""
    svc = _svc("gqa", seq_cap=32)
    busy = svc.open_session(np.arange(1, 27, dtype=np.int32))  # pos 25
    svc.decode({busy: 4})  # pos 29: the clamp (32 - 5) falls below it
    before = svc.live_column(busy)
    sp = SpeculativeDecoder(svc, lambda h, k: np.zeros(k, np.int32), k=4,
                            verify="parallel")
    sid = svc.open_session(np.array([4, 2], np.int32))
    sp.decode({sid: 10})
    after = svc.live_column(busy)
    assert all(np.array_equal(a, b) for a, b in zip(
        tree_leaves(numpy_bits(before)), tree_leaves(numpy_bits(after))))


def test_parallel_acceptance_and_cap():
    """Oracle drafts replaying parallel mode's own stream are fully
    accepted; lanes too close to seq_cap fall back to the plain scan and
    retire."""
    svc = _svc("gqa", seq_cap=24, max_sessions=None)
    sp = SpeculativeDecoder(svc, ngram_drafter(), k=4, verify="parallel")
    sid = svc.open_session(np.array([4, 2], np.int32))
    first = sp.decode({sid: 8})[sid]

    def oracle(hist, k):
        i = len(hist) - 2
        return np.asarray((first + [0] * k)[i:i + k], np.int32)

    sp2 = SpeculativeDecoder(svc, oracle, k=4, verify="parallel")
    sid2 = svc.open_session(np.array([4, 2], np.int32))
    assert sp2.decode({sid2: 8})[sid2] == first
    assert sp2.acceptance_rate == 1.0
    tail = sp.decode({sid: 50})[sid]
    assert len(first + tail) == 24 - 2 + 1
    assert svc.poll(sid)["state"] == "done"
    svc.close(sid2)


def test_zero_from_column_canonicalizes_rejected_rows():
    """zero_from_column scrubs a rejected verify tail to what a park
    (O(pos) truncation) and resume (zero extension) would rebuild."""
    svc = _svc("mla")
    sp = SpeculativeDecoder(svc, lambda h, k: np.full(k, (h[-1] + 1) % V,
                                                      np.int32),
                            k=4, verify="parallel")
    sid = svc.open_session(np.array([3, 3, 3], np.int32))
    sp.decode({sid: 6})
    assert sp.accepted < sp.drafted
    slot, steps = svc.sched.slot_of[sid], svc.sessions[sid].steps
    blob = svc._pack(slot, sid)
    scrubbed = [t.clone() for t in tree_leaves(zero_from_column(
        svc.cache, svc._batch_axes, svc._seq_axes, slot, steps))]
    rebuilt = tree_leaves(unpack_column(svc.cache, svc._batch_axes, slot,
                                        blob["kv"]))
    assert all(torch.equal(a, b) for a, b in zip(scrubbed, rebuilt))


def test_trim_blocks_returns_whole_blocks_past_the_position():
    svc = _svc("mla", paged=True, block_len=8)
    sid = svc.open_session(np.arange(1, 12, dtype=np.int32))  # pos 10
    svc._ensure_blocks(sid, 10, 40)  # a verify's rows, 5 blocks
    slot = svc.sched.slot_of[sid]
    assert len(svc._blocks[sid]) == 5 and svc._table[slot, 4] != 0
    live = svc.pool.n_live
    svc._trim_blocks(sid)  # back to ceil(10 / 8) = 2
    assert len(svc._blocks[sid]) == 2
    assert svc.pool.n_live == live - 3
    assert not svc._table[slot, 2:].any()
    svc._trim_blocks(sid)  # idempotent
    assert len(svc._blocks[sid]) == 2
    _svc("mla")._trim_blocks(0)  # dense: nothing to do
    svc.close(sid)
    svc.pool.check()


# ---------------------------------------------------------------------------
# against the reference's SpeculativeDecoder
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _pair(arch):
    name, extra = ARCHS[arch]
    jcfg = j_get_config(name).smoke().replace(act_dtype="float32", **extra)
    jb = j_build_bundle(jcfg)
    jp = jb.init(jax.random.key(3))
    b = build_bundle(get_config(name).smoke().replace(
        act_dtype="float32", **extra), "cpu")
    return jb, jp, b, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _margins(jb, jp, prompt, tokens) -> list:
    """The reference's top-2 logit margin before each generated token."""
    dec = jax.jit(jb.decode_fn)
    cache = jb.empty_cache(1, 96)
    seq = np.concatenate([prompt, tokens]).astype(np.int32)
    out = []
    for i in range(len(prompt) + len(tokens) - 1):
        lg, cache = dec(jp, cache, {"tokens": jnp.asarray(seq[None, i:i + 1]),
                                    "pos": jnp.int32(i)})
        if i >= len(prompt) - 1:
            top = np.sort(np.asarray(lg[0]))[-2:]
            out.append(float(top[1] - top[0]))
    return out


@pytest.mark.parametrize("verify", ["scan", "parallel"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_speculative_stream_matches_the_reference(arch, verify):
    """The same n-gram drafter over the same prompts, in either verify
    mode: the port's stream equals the reference's up to its first near
    tie, and where it agrees throughout, so do the drafted and accepted
    counts."""
    jb, jp, b, p = _pair(arch)
    kw = dict(n_slots=2, seq_cap=96, t_chunk=8, max_sessions=8)
    jsvc, svc = JLMService(jb, jp, **kw), LMSessionService(b, p, **kw)
    jsp = JSpec(jsvc, j_ngram(), k=4, verify=verify)
    sp = SpeculativeDecoder(svc, k=4, verify=verify)
    rng = np.random.default_rng(7)
    whole = 0
    for n in (5, 2, 11):
        prompt = rng.integers(0, V, n).astype(np.int32)
        js, s = jsvc.open_session(prompt), svc.open_session(prompt)
        d0, a0, jd0, ja0 = sp.drafted, sp.accepted, jsp.drafted, jsp.accepted
        want = jsp.decode({js: 20})[js]
        got = sp.decode({s: 20})[s]
        margins = _margins(jb, jp, prompt, want)
        cut = next((j for j, m in enumerate(margins) if m < 1e-3), len(want))
        assert got[:cut] == want[:cut], (cut, margins)
        if cut == len(want):
            whole += 1
            assert (sp.drafted - d0, sp.accepted - a0) == \
                (jsp.drafted - jd0, jsp.accepted - ja0)
        jsvc.close(js)
        svc.close(s)
    assert whole >= 1
