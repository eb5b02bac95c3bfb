"""The recurrent LM families in the port's session layer, on the CPU: the
RWKV and SSM (zamba hybrid) cases of tests/test_lm_sessions.py and
tests/test_speculative.py held bit for bit inside the port, and the port
against the JAX reference.

Inside the port, bit for bit: recurrent leaves are masked by value (chunk
invariance, a ragged dispatch leaving its masked lane's state and its
neighbours' bits alone, park/resume through eviction); a recurrent
service is not ``parallel_safe`` (no chunked prefill, no prefix sharing,
the prompt fed by the first decode); zamba's paged service (KV pools
beside dense Mamba leaves) equals its dense one, RWKV's ``paged=True``
stays dense; park/resume and spill/restore equal never-parked twins;
scan-mode speculation (the alive-masked verify scans) emits plain
decode's stream for every drafter of the zoo, dense and (zamba) paged,
through decode splits, park/evict churn (fixed seeds where the reference
draws from an unseeded ``@given``) and a spill mid-draft; rejected
suffix blocks go back to the pool; the device acceptance count equals
the host's; parallel verify is refused with ``ValueError``.

Against the reference: the parked-bytes coefficients are equal; greedy
tokens (act_dtype float32) and scan-mode speculative streams equal up to
the first step where the reference's top-2 logit margin is below 1e-3;
spill files (bf16 token-shift rows and conv rings, fp32 states, bf16 KV)
written by either package restore in the other bit for bit, dense and
paged."""

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
from repro_torch.sessions import (  # noqa: E402
    LMSessionService,
    SpeculativeDecoder,
    ngram_drafter,
)
from repro_torch.utils.trees import tree_leaves  # noqa: E402

V = 64
ARCHS = {
    "rwkv": ("rwkv6-1.6b", dict(n_layers=2, d_model=32, d_ff=64,
                                vocab_size=V, rwkv_head_dim=16)),
    "ssm": ("zamba2-1.2b", dict(n_layers=2, d_model=32, d_ff=64,
                                vocab_size=V)),
}
# (arch, paged): RWKV has nothing to page
LAYOUTS = [("rwkv", False), ("ssm", False), ("ssm", True)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module, restored after it (tiny ops
    gain nothing from threads when test workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    """(plain reference, target) pair, reused across cases: sessions are
    opened and closed per case."""
    return _svc(arch), _svc(arch, paged=paged)


def _reference(arch, prompt, n):
    """The port's plain greedy stream: ground truth inside the port."""
    plain, _ = _services(arch)
    sid = plain.open_session(np.asarray(prompt, np.int32))
    try:
        return plain.decode({sid: n})[sid]
    finally:
        plain.close(sid)


def _bits(tree) -> list:
    return tree_leaves(numpy_bits(tree))


def _same(a, b) -> bool:
    a, b = _bits(a), _bits(b)
    return len(a) == len(b) and all(np.array_equal(x, y)
                                    for x, y in zip(a, b))


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
# the session layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,paged", LAYOUTS)
def test_recurrent_cache_bundles_masked_by_value(arch, paged):
    """tests/test_lm_sessions.py:96: chunk invariance, no cross-lane
    perturbation (a ragged dispatch masks a's tail), park/resume."""
    mk = lambda n_slots, **kw: _svc(arch, n_slots=n_slots, seq_cap=64,
                                    paged=paged, **kw)
    ctl = mk(2, max_sessions=None)
    c = ctl.open_session(np.array([3, 1, 4], np.int32))
    want = ctl.decode({c: 12})[c]

    svc = mk(2)
    a = svc.open_session(np.array([3, 1, 4], np.int32))
    got = svc.decode({a: 3})[a]
    b = svc.open_session(np.array([9], np.int32))
    got += svc.decode({a: 2, b: 5})[a]  # ragged: b's lane masks a's tail
    b2 = svc.open_session(np.array([7], np.int32))  # evicts LRU: parks a
    assert svc.poll(a)["state"] == "parked"
    svc.decode({b: 1, b2: 1})
    got += svc.decode({a: 7})[a]  # resume in whichever slot frees up
    assert got == want
    assert svc.stats()["evictions"] >= 1


@pytest.mark.parametrize("arch,paged", LAYOUTS)
def test_masked_lane_state_is_frozen_by_value(arch, paged):
    """A bound lane left out of a dispatch keeps every cache leaf bit for
    bit (its recurrent state by value, its KV rows by position), and the
    lanes decoded beside it get the bits of a dispatch without it."""
    svc = _svc(arch, paged=paged)
    ctl = _svc(arch, paged=paged)
    p = [np.array([5, 6, 7], np.int32), np.array([1, 2], np.int32)]
    a, b = (svc.open_session(x) for x in p)
    ca, cb = (ctl.open_session(x) for x in p)
    svc.decode({a: 4, b: 4})
    ctl.decode({ca: 4, cb: 4})
    before = svc.live_column(a)
    got = svc.decode({b: 6})[b]
    want = ctl.decode({ca: 6, cb: 6})[cb]
    assert got == want
    assert _same(svc.live_column(a), before)
    assert _same(svc.live_column(b), ctl.live_column(cb))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_chunked_prefill_disabled_on_recurrent_bundles(arch):
    """tests/test_lm_sessions.py:220: no chunked prefill, no prefill
    dispatch at open, the prompt fed by the first decode; no prefix
    registry on a paged hybrid."""
    svc = _svc(arch, seq_cap=32, prefill_chunk=64)
    assert not svc.parallel_safe and svc.prefill_chunk == 0
    d0 = svc.dispatches
    sid = svc.open_session(np.array([3, 1, 4, 1], np.int32))
    assert svc.dispatches == d0  # no prefill dispatches at open
    assert svc.sessions[sid].steps == 0
    assert svc.poll(sid)["prompt_left"] == 4
    assert len(svc.decode({sid: 3})[sid]) == 3
    assert svc.sessions[sid].steps == 4 + 3 - 1
    paged = _svc(arch, seq_cap=32, paged=True)
    assert paged.paged == (arch == "ssm")
    if paged.paged:
        assert paged._prefix is None


@pytest.mark.parametrize("t_chunk", [1, 16])
@pytest.mark.parametrize("arch,paged", LAYOUTS)
def test_chunk_size_and_layout_invariance(arch, paged, t_chunk):
    """t_chunk 1 and 16 and the paged layout against the dense t_chunk=8
    service: tokens and every cache leaf bit for bit."""
    prompts = [np.arange(3, 14, dtype=np.int32), np.array([9, 2], np.int32)]
    ref, _ = _services(arch)
    svc = _svc(arch, t_chunk=t_chunk, paged=paged)
    r = [ref.open_session(p) for p in prompts]
    s = [svc.open_session(p) for p in prompts]
    try:
        want = ref.decode({x: 13 for x in r})
        got = svc.decode({x: 13 for x in s})
        assert [got[x] for x in s] == [want[x] for x in r]
        for x, y in zip(s, r):
            assert _same(svc.live_column(x), ref.live_column(y))
    finally:
        for x in r:
            ref.close(x)


@pytest.mark.parametrize("arch,paged", LAYOUTS)
def test_park_bytes_and_blob_layout(arch, paged):
    """A parked blob holds every recurrent leaf whole and the KV rows
    [0, pos) (whole blocks when paged); ``kv_park_bytes`` is the fixed
    part plus a part per position, the reference's coefficients."""
    name, extra = ARCHS[arch]
    jb = j_build_bundle(j_get_config(name).smoke().replace(**extra))
    jsvc = JLMService(jb, jb.init(jax.random.key(0)), n_slots=2, seq_cap=96,
                      t_chunk=8, paged=paged)
    svc = _svc(arch, paged=paged)
    assert (svc._park_fixed, svc._park_per_pos) == \
        (jsvc._park_fixed, jsvc._park_per_pos)
    assert svc._park_fixed > 0 and (svc._park_per_pos > 0) == (arch == "ssm")
    sid = svc.open_session(np.array([4, 5, 6], np.int32))
    svc.decode({sid: 18})
    steps = svc.sessions[sid].steps
    svc.park(sid)
    blob = svc.parking[sid]
    size = sum(a.nbytes for a in tree_leaves(blob["kv"]))
    rows = -(-steps // svc.block_len) * svc.block_len if svc.paged else steps
    assert size == svc.kv_park_bytes(rows)
    svc.close(sid)


# ---------------------------------------------------------------------------
# speculation: the alive-masked verify scans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,paged", LAYOUTS)
def test_speculative_bit_identical_for_every_drafter(arch, paged):
    """tests/test_speculative.py:114 (and :365 for the paged hybrid):
    every drafter's stream equals plain decode's, split mid-stream; paged
    rollback returns the rejected suffix's blocks to the pool."""
    prompt = np.array([3, 1, 4, 1, 5], np.int32)
    want = _reference(arch, prompt, 30)
    _, svc = _services(arch, paged)
    for name, dr in _drafters(prompt, want).items():
        sp = SpeculativeDecoder(svc, dr, k=4)
        sid = svc.open_session(prompt)
        try:
            got = sp.decode({sid: 12})[sid]
            if svc.paged:
                assert len(svc._blocks[sid]) == \
                    -(-svc.sessions[sid].steps // svc.block_len), name
            got += sp.decode({sid: 18})[sid]  # split mid-stream
        finally:
            svc.close(sid)
        assert got == want, (arch, name)
        if svc.paged:
            svc.pool.check()
    if svc.paged:
        assert svc.pool.n_live == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("arch,paged", LAYOUTS)
def test_speculative_churn(arch, paged, seed):
    """tests/test_speculative.py:161 from fixed seeds: random drafter
    mixes, K, decode splits and park/evict churn mid-stream never change
    the emitted stream."""
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, V, size=int(rng.integers(1, 6))).astype(
        np.int32)
    total = int(rng.integers(8, 28))
    want = _reference(arch, prompt, total)
    _, svc = _services(arch, paged)
    drs = list(_drafters(prompt, want).values())
    sp = SpeculativeDecoder(
        svc, lambda h, k: drs[int(rng.integers(len(drs)))](h, k),
        k=int(rng.integers(1, 6)))
    sid = svc.open_session(prompt)
    other = svc.open_session(np.array([1], np.int32))  # churn pressure
    got = []
    try:
        left = total
        while left:
            n = int(min(rng.integers(1, 9), left))
            got += sp.decode({sid: n})[sid]
            left -= n
            if rng.random() < 0.4:  # evict mid-draft sequence
                svc.park(sid)
                svc.decode({other: 2})
    finally:
        svc.close(sid)
        svc.close(other)
    assert got == want


@pytest.mark.parametrize("arch,paged", LAYOUTS)
def test_spec_park_resume_through_disk_mid_draft(arch, paged, tmp_path):
    """tests/test_speculative.py:197: a session spilled mid-speculation
    and restored into another service (another K) resumes the stream."""
    prompt = np.array([5, 6], np.int32)
    want = _reference(arch, prompt, 24)
    svc = _svc(arch, paged=paged)
    other = _svc(arch, paged=paged)
    sp = SpeculativeDecoder(svc, ngram_drafter(), k=3)
    sid = svc.open_session(prompt)
    got = sp.decode({sid: 9})[sid]
    path = str(tmp_path / f"spec_{arch}.npz")
    svc.spill_parking(path, include_bound=True)
    assert svc.poll(sid)["state"] == "parked"
    assert other.restore_parking(path) == [sid]
    sp2 = SpeculativeDecoder(other, ngram_drafter(), k=5)
    got += sp2.decode({sid: 15})[sid]
    assert got == want


@pytest.mark.parametrize("arch,paged", LAYOUTS)
def test_device_acceptance_matches_host(arch, paged):
    """With device counters on, the per-lane acceptance counted on the
    device from the verify scan's outputs equals the host's; the stream
    is unchanged."""
    prompts = [np.array([3, 1, 4, 1, 5, 1, 4, 1], np.int32),
               np.array([2, 7, 2, 7, 2], np.int32)]
    want = [_reference(arch, p, 20) for p in prompts]

    def oracle(hist, k):
        i = 0 if len(hist) >= 8 and hist[1] == 1 else 1
        j = len(hist) - len(prompts[i])
        ref = want[i][j:j + k]
        return np.asarray(ref if j % 3 else [(t + 1) % V for t in ref],
                          np.int32)

    svc = _svc(arch, paged=paged, device_counters=True)
    sp = SpeculativeDecoder(svc, oracle, k=3)
    sids = [svc.open_session(p) for p in prompts]
    out = sp.decode({s: 20 for s in sids})
    assert [out[s] for s in sids] == want
    assert sp.last_device_accepts is not None
    assert 0 < sp.accepted < sp.drafted
    snap = svc.metrics()
    assert snap["spec_device_accepted_total"][0]["value"] == sp.accepted


def test_speculative_validation():
    """tests/test_speculative.py:241 on the recurrent services: parallel
    verify raises the reference's ValueError; scan mode keeps the plain
    decoder's admission contract."""
    for arch, paged in LAYOUTS:
        _, svc = _services(arch, paged)
        with pytest.raises(ValueError, match="parallel verify"):
            SpeculativeDecoder(svc, verify="parallel")
    _, svc = _services("rwkv")
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


@pytest.mark.parametrize("arch", list(ARCHS))
def test_speculative_retires_at_seq_cap(arch):
    """A draft that would pass seq_cap is cut; the session retires as
    plain decode's does."""
    ctl = _svc(arch, seq_cap=12, max_sessions=None)
    svc = _svc(arch, seq_cap=12, max_sessions=None)
    prompt = np.array([1, 2, 3], np.int32)
    c = ctl.open_session(prompt)
    want = ctl.decode({c: 50})[c]
    sp = SpeculativeDecoder(svc, ngram_drafter(), k=4)
    sid = svc.open_session(prompt)
    out = sp.decode({sid: 50})[sid]
    assert out == want and len(out) == 10
    assert svc.poll(sid)["state"] == "done"
    with pytest.raises(RuntimeError):
        sp.decode({sid: 1})


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _pair(arch, dtype):
    name, extra = ARCHS[arch]
    jb = j_build_bundle(j_get_config(name).smoke().replace(act_dtype=dtype,
                                                           **extra))
    jp = jb.init(jax.random.key(3))
    b = build_bundle(get_config(name).smoke().replace(act_dtype=dtype,
                                                      **extra), "cpu")
    host = jax.tree.map(lambda a: np.array(a).view(np.uint16)
                        if np.asarray(a).dtype.name == "bfloat16"
                        else np.array(a), jp)
    return jb, jp, b, params_from_jax(host, "cpu")


def _margins(jb, jp, prompt, tokens) -> list:
    """The reference's top-2 logit margin before each generated token,
    from its decode fed token by token."""
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


@pytest.mark.parametrize("arch", list(ARCHS))
def test_greedy_and_speculative_streams_match_the_reference(arch):
    """act_dtype float32, converted params: the plain greedy stream of the
    port's service (dense, and paged for the hybrid) and its scan-mode
    speculative stream (n-gram drafter, K=4) equal the reference's up to
    its first near tie; where the whole stream agrees, the drafted and
    accepted counts are equal."""
    jb, jp, b, p = _pair(arch, "float32")
    kw = dict(n_slots=2, seq_cap=96, t_chunk=8, max_sessions=8)
    jsvc = JLMService(jb, jp, **kw)
    svcs = [LMSessionService(b, p, **kw)]
    if arch == "ssm":
        svcs.append(LMSessionService(b, p, paged=True, **kw))
    jsp = JSpec(jsvc, j_ngram(), k=4)
    sps = [SpeculativeDecoder(s, k=4) for s in svcs]
    rng = np.random.default_rng(11)
    whole = 0
    for n in (7, 3):
        prompt = rng.integers(0, V, n).astype(np.int32)
        js = jsvc.open_session(prompt)
        want = jsvc.decode({js: 12})[js]
        js2 = jsvc.open_session(prompt)
        d0, a0 = jsp.drafted, jsp.accepted
        jspec = jsp.decode({js2: 16})[js2]
        margins = _margins(jb, jp, prompt, jspec)
        cut = next((j for j, m in enumerate(margins) if m < 1e-3),
                   len(jspec))
        assert jspec[:12] == want  # the reference's own contract
        for svc, sp in zip(svcs, sps):
            s = svc.open_session(prompt)
            got = svc.decode({s: 12})[s]
            assert got[:min(cut, 12)] == want[:min(cut, 12)], (cut, margins)
            s2 = svc.open_session(prompt)
            sd0, sa0 = sp.drafted, sp.accepted
            gspec = sp.decode({s2: 16})[s2]
            assert gspec[:cut] == jspec[:cut], (cut, margins)
            if cut == len(jspec):
                whole += 1
                assert (sp.drafted - sd0, sp.accepted - sa0) == \
                    (jsp.drafted - d0, jsp.accepted - a0)
            svc.close(s)
            svc.close(s2)
        jsvc.close(js)
        jsvc.close(js2)
    assert whole >= 1


def _jbits(tree) -> list:
    return [np.asarray(x).view(np.uint16) if np.asarray(x).dtype.name ==
            "bfloat16" else np.asarray(x) for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("arch,paged", LAYOUTS)
def test_spill_files_cross_the_packages(arch, paged, tmp_path):
    """bf16 services: the reference's spill file restores in the port with
    the same bits (recurrent leaves whole, bf16 rows and rings, fp32
    states; through a resume and a park again), and the port's restores
    in the reference with the same bits."""
    jb, jp, b, p = _pair(arch, "bfloat16")
    kw = dict(n_slots=2, seq_cap=64, t_chunk=8, max_sessions=8, paged=paged)
    jsvc, svc = JLMService(jb, jp, **kw), LMSessionService(b, p, **kw)
    prompt = np.arange(3, 22, dtype=np.int32)
    js = jsvc.open_session(prompt)
    jsvc.decode({js: 5})
    jpath = str(tmp_path / "jax.npz")
    jsvc.spill_parking(jpath, include_bound=True)
    jbits = _jbits(jsvc.parking[js])
    assert svc.restore_parking(jpath) == [js]
    assert all(np.array_equal(x, y)
               for x, y in zip(_bits(svc.parking[js]), jbits))
    assert svc.outputs[js] == jsvc.outputs[js]
    svc.resume(js)   # into the port's cache ...
    svc.park(js)     # ... and back out: the same bits
    assert all(np.array_equal(x, y)
               for x, y in zip(_bits(svc.parking[js]), jbits))
    assert len(svc.decode({js: 3})[js]) == 3
    ppath = str(tmp_path / "port.npz")
    svc.spill_parking(ppath, include_bound=True)
    fresh = JLMService(jb, jp, **kw)
    assert fresh.restore_parking(ppath) == [js]
    assert all(np.array_equal(x, y)
               for x, y in zip(_jbits(fresh.parking[js]),
                               _bits(svc.parking[js])))
    assert len(fresh.decode({js: 2})[js]) == 2


@pytest.mark.parametrize("arch", list(ARCHS))
def test_lm_server_serves_and_speculates(arch):
    """LMServer over a recurrent bundle: ``step`` in waves past the batch
    (parking), speculating servers (scan verify, dense and paged) equal
    to the plain server's streams; ``spec_verify="parallel"`` raises the
    reference's ValueError."""
    from repro_torch.serving import LMServer, ServeConfig

    bundle, params = _setup(arch)
    prompts = [np.arange(1, 6, dtype=np.int32), np.array([9, 3], np.int32),
               np.array([4], np.int32)]

    def run(**kw):
        paged = kw.pop("paged", False)
        srv = LMServer(bundle, params, ServeConfig(
            max_batch=2, seq_cap=64, decode_chunk=8, max_sessions=4, **kw),
            paged=paged)
        sids = [srv.open_session(p) for p in prompts]
        srv.step(5)
        srv.step(6)
        return [srv.outputs[s] for s in sids], srv

    want, srv = run()
    assert all(len(o) == 11 for o in want)
    assert srv.stats()["evictions"] >= 2
    for paged in (False, True):
        got, spec = run(speculative=3, paged=paged)
        assert got == want
        assert spec.service.paged == (paged and arch == "ssm")
    with pytest.raises(ValueError, match="parallel verify"):
        run(speculative=3, spec_verify="parallel")
