"""The 16 kHz raw-audio preset (``chameleon-tcn-audio``) in the port, on the
CPU: the greedy cone evaluation and the Fig. 8(c) accounting against the
JAX ``core/streaming.py`` (integer accounting exactly, cone outputs at
rtol=2e-4, atol=2e-5, the repo's precedent), and a narrow audio-shaped
replica (5 blocks of 8 channels, k=7, d up to 16, Cin=1, V=64, 12 classes)
served by the port's ``StreamSessionService`` against the JAX service over
a stream that wraps every ring, then the port's own guarantees on it,
bit-exact: chunk-size invariance and park/resume.

The service comparison scales atol by the largest |value| of each compared
array (rtol=2e-4, atol=2e-5 * max(1, max|want|)): the seeded, untrained
replica's embeddings reach several hundred, and there the JAX package's
own fused and per-step executors already differ by ~3e-7 of that scale,
more than a fixed atol of 2e-5 allows near zero."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import streaming as js  # noqa: E402
from repro.models import build_bundle as j_build_bundle  # noqa: E402
from repro.models.tcn import tcn_empty_state as j_empty  # noqa: E402
from repro.sessions import StreamSessionService as JService  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import streaming as ts  # noqa: E402
from repro_torch.models import build_tcn_bundle  # noqa: E402
from repro_torch.models.tcn import tcn_forward  # noqa: E402
from repro_torch.sessions import StreamSessionService  # noqa: E402

RTOL, ATOL = 2e-4, 2e-5
REPLICA = dict(tcn_channels=(8,) * 5)  # d = 1..16, deepest ring 96 rows
CONE_SMALL = dict(tcn_channels=(8, 8, 8), tcn_kernel=3, embed_dim=12,
                  n_classes=4)
STREAM = 120  # > 96: every ring of the replica wraps


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


@functools.lru_cache(maxsize=None)
def _setup(preset="chameleon-tcn-audio", overrides=tuple(REPLICA.items()),
           seed=0):
    """JAX bundle, params and non-trivial BN state, and the port's copies
    (with a random FC head, which the init leaves at zero)."""
    ov = dict(overrides)
    jcfg = j_get_config(preset).replace(kernel_backend="ref", **ov)
    cfg = get_config(preset).replace(**ov)
    jbundle = j_build_bundle(jcfg)
    params = jbundle.init(jax.random.key(seed))
    rng = np.random.default_rng(seed + 11)
    params["fc"] = {
        "w": jnp.asarray(rng.normal(size=params["fc"]["w"].shape)
                         .astype(np.float32) * 0.2),
        "b": jnp.asarray(rng.normal(size=params["fc"]["b"].shape)
                         .astype(np.float32) * 0.1)}
    bn = jax.tree.map(lambda a: a + jnp.asarray(
        0.05 * np.abs(rng.normal(size=a.shape)).astype(np.float32)),
        j_empty(jcfg))
    return (jcfg, cfg, jbundle, params, bn, build_tcn_bundle(cfg, "cpu"),
            params_from_jax(_np_tree(params), "cpu"),
            params_from_jax(_np_tree(bn), "cpu"))


@pytest.mark.parametrize("preset", ["chameleon-tcn-audio", "chameleon-tcn",
                                    "chameleon-tcn-kws"])
def test_accounting_matches_reference(preset):
    jcfg, cfg = j_get_config(preset), get_config(preset)
    assert ts.stream_state_bytes(cfg) == js.stream_state_bytes(jcfg)
    assert ts.stream_state_bytes(cfg, 4) == js.stream_state_bytes(jcfg, 4)
    for T in (1, 1_000, 16_000, 1_000_000):
        for name in ("cone_stats", "ws_inference_stats",
                     "greedy_inference_stats"):
            assert getattr(ts, name)(cfg, T) == getattr(js, name)(jcfg, T)
    for T in (1, 50, 784, 16_000):
        got, want = ts._cone_positions(cfg, T), js._cone_positions(jcfg, T)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_audio_accounting_claims():
    """Fig. 8(c) at 16k steps: > 50x activation entries and > 5x MACs
    below the weight-stationary baseline, and < 2.5 kB of u4 FIFO state."""
    cfg = get_config("chameleon-tcn-audio")
    ws, g = ts.ws_inference_stats(cfg, 16_000), ts.cone_stats(cfg, 16_000)
    assert ws["act_entries"] / g["act_entries"] > 50
    assert ws["macs"] / g["macs"] > 5
    assert g["act_entries"] * 0.5 / 1024 < 2.5
    assert ts.cone_stats(cfg, 1_000)["act_entries"] == g["act_entries"]


@pytest.mark.parametrize("quantize", [False, True])
def test_cone_eval_matches_reference(quantize):
    """The JAX test's model (3 blocks of 8, k=3, Cin=1): the port's cone
    against the JAX cone, and against the port's dense forward."""
    jcfg, cfg, _, params, bn, _, p, bnt = _setup(
        "chameleon-tcn", tuple(CONE_SMALL.items()))
    x = np.random.default_rng(5).normal(size=(2, 50, 1)).astype(np.float32)
    if quantize:
        x = np.abs(x)
    je, jl, jn = js.cone_eval(params, bn, jcfg, jnp.asarray(x),
                              quantize=quantize)
    e, lg, n = ts.cone_eval(p, bnt, cfg, torch.from_numpy(x),
                            quantize=quantize)
    assert n == jn and n < 50 * 6
    np.testing.assert_allclose(e.numpy(), np.asarray(je), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), rtol=RTOL, atol=ATOL)
    de, dl, _ = tcn_forward(p, bnt, cfg, torch.from_numpy(x), quantize=quantize)
    np.testing.assert_allclose(e.numpy(), de.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(lg.numpy(), dl.numpy(), rtol=RTOL, atol=ATOL)


def test_cone_eval_audio_replica_matches_dense_forward():
    *_, p, bnt = _setup()
    cfg = _setup()[1]
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(2, 300, 1)).astype(np.float32))
    e, lg, n = ts.cone_eval(p, bnt, cfg, x)
    de, dl, _ = tcn_forward(p, bnt, cfg, x)
    np.testing.assert_allclose(e.numpy(), de.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(lg.numpy(), dl.numpy(), rtol=RTOL, atol=ATOL)
    assert n < 300 * 2 * len(cfg.tcn_channels)


def _data(seed, n=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, STREAM, 1)).astype(np.float32),
            rng.normal(size=(3, 2, 40, 1)).astype(np.float32))


def _ragged(svc, x, shots, cuts, *, park=False):
    """Open three sessions (global head, dedicated tenant, shared tenant 0),
    push each stream at its own ragged cut points, enroll 3 ways on the
    dedicated tenant after the first push, optionally park two sessions
    mid-stream (a filler takes a freed slot), poll."""
    sids = [svc.open_session(), svc.open_session(tenant=None),
            svc.open_session(tenant=0)]
    outs = []
    for r in range(len(cuts[0]) - 1):
        if r == 1:
            for way in range(3):
                svc.enroll_shots(sids[1], shots[way])
        if park and r == 2:
            svc.park(sids[0])
            svc.park(sids[1])
            f = svc.open_session()
            svc.push_audio({f: x[2, :3]})
        outs.append(svc.push_audio({
            sid: x[i, cuts[i][r]:cuts[i][r + 1]] for i, sid in enumerate(sids)
            if cuts[i][r + 1] > cuts[i][r]}))
    return sids, outs, [svc.poll(s) for s in sids]


CUTS = [[0, 9, 40, 77, 101, STREAM], [0, 5, 30, 31, 90, STREAM],
        [0, 13, 17, 60, 119, STREAM]]


def _same(outs_a, outs_b, ids_a, ids_b, *, exact):
    for ra, rb in zip(outs_a, outs_b):
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
                    scale = max(1.0, float(np.abs(vb[live]).max(initial=0)))
                    np.testing.assert_allclose(va[live], vb[live], rtol=RTOL,
                                               atol=ATOL * scale)
            assert ra[sa]["step"] == rb[sb]["step"]


def test_audio_replica_service_matches_reference():
    _, cfg, jbundle, params, bn, bundle, p, bnt = _setup()
    x, shots = _data(1)
    kw = dict(n_slots=4, max_tenants=2, max_ways=4, t_chunk=16, fused=True)
    ids_j, out_j, polls_j = _ragged(
        JService(jbundle, params, bn, kernel_backend="ref", **kw), x, shots,
        CUTS)
    tsvc = StreamSessionService(bundle, p, bnt, **kw)
    ids_t, out_t, polls_t = _ragged(tsvc, x, shots, CUTS)
    _same(out_j, out_t, ids_j, ids_t, exact=False)
    assert [q["steps"] for q in polls_t] == [STREAM] * 3
    assert [q["n_ways"] for q in polls_t] == [q["n_ways"] for q in polls_j]
    assert polls_t[1]["n_ways"] == 3
    last = out_t[-1][ids_t[1]]
    assert last["tenant_logits"].shape[1] == 4
    assert last["logits"].shape[1] == cfg.n_classes
    assert last["emb"].shape[1] == cfg.embed_dim


@pytest.mark.parametrize("quantize", [False, True])
def test_audio_replica_invariants_bit_exact(quantize):
    """t_chunk 16 against 128 and another push schedule; park/resume."""
    *_, bundle, p, bnt = _setup()
    x, shots = _data(2)
    kw = dict(n_slots=4, max_tenants=2, max_ways=4, quantize=quantize,
              fused=True)
    base = _ragged(StreamSessionService(bundle, p, bnt, t_chunk=16, **kw),
                   x, shots, CUTS)

    def per_sample(outs, sids):
        return {i: np.concatenate([o[s]["emb"] for o in outs if s in o])
                for i, s in enumerate(sids)}

    ref = per_sample(base[1], base[0])
    other = [[0, 1, 2, 50, 51, STREAM], [0, 40, 41, 42, 100, STREAM],
             [0, 70, 71, 72, 73, STREAM]]
    for t_chunk, cuts in ((128, CUTS), (16, other), (128, other)):
        sids, outs, _ = _ragged(
            StreamSessionService(bundle, p, bnt, t_chunk=t_chunk, **kw),
            x, shots, cuts)
        got = per_sample(outs, sids)
        for i in ref:
            np.testing.assert_array_equal(ref[i], got[i])
    kw["n_slots"] = 3  # the filler's slot is needed back: an eviction
    svc = StreamSessionService(bundle, p, bnt, t_chunk=16, **kw)
    sids, outs, _ = _ragged(svc, x, shots, CUTS, park=True)
    assert svc.evictions >= 1
    _same(base[1], outs, base[0], sids, exact=True)
