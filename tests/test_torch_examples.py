"""The three TCN example twins (examples/quickstart_torch.py,
serve_multitenant_torch.py, serve_stream_torch.py) and
``training.episodic.get_meta_trained_tcn`` against the reference on the
CPU, each started from the reference's params carried over with
``convert.params_from_jax``:

  * the meta-trained embedder, 3 episodes on both sides
    (``benchmarks/common.get_meta_trained_tcn``);
  * the quickstart's FSL episode and streamed query on the reference's
    trained tree;
  * serve_multitenant's steps through both packages' services
    (``fused=True`` on both sides), and alice's resume bit for bit against
    a port service that never evicted her;
  * serve_stream's end-of-clip logits and ticks, and its LMServer tokens.

AdamW and the gauge leaves.  A conv bias in front of a train-mode BN has
an exact gradient of zero (the BN subtracts the batch mean), and so has
``head_b`` wherever the head's ReLU passes (prototypical logits do not
change when every embedding moves by the same vector).  Both packages
compute rounding noise there, and Adam divides each gradient by its own
magnitude, so each package moves those leaves by up to ``lr`` a step in
a direction neither controls (0.0053 after 3 steps at lr 2e-3 here,
against 2.3e-6 for every other leaf).  Every other leaf, and the BN
running variances (which no bias reaches), are held at
tests/test_torch_training.py's ``TRAIN_RTOL, TRAIN_ATOL``; the gauge
leaves and the running means they feed, to Adam's bound on two such
walks, ``2 x episodes x lr``.  The later comparisons therefore carry the
reference's trained tree into the port rather than comparing two
trainings."""

import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import protonet as jpn  # noqa: E402
from repro.core.streaming import stream_init as j_stream_init  # noqa: E402
from repro.core.streaming import stream_step as j_stream_step  # noqa: E402
from repro.data import EpisodicSampler as JEpisodicSampler  # noqa: E402
from repro.data import KeywordAudio as JKeywordAudio  # noqa: E402
from repro.models import build_bundle as j_build_bundle  # noqa: E402
from repro.models.tcn import tcn_empty_state as j_empty  # noqa: E402
from repro.models.tcn import tcn_forward as j_forward  # noqa: E402
from repro.serving import LMServer as JLMServer  # noqa: E402
from repro.serving import ServeConfig as JServeConfig  # noqa: E402
from repro.sessions import StreamSessionService as JService  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.training.episodic import get_meta_trained_tcn  # noqa: E402
from repro_torch.utils.trees import flatten_dict  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
RTOL, ATOL = 2e-4, 2e-5              # x max(1, max|want|): the fp32 precedent
TRAIN_RTOL, TRAIN_ATOL = 1e-3, 1e-4  # tests/test_torch_training.py
EPISODES, LR = 3, 2e-3               # the reference's AdamW rate
GAUGE = ("conv1_b", "conv2_b", "head_b", "bn1_mean", "bn2_mean")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module, restored after it (parallel
    test workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


quickstart = _load(ROOT / "examples" / "quickstart_torch.py")
multitenant = _load(ROOT / "examples" / "serve_multitenant_torch.py")
serve_stream = _load(ROOT / "examples" / "serve_stream_torch.py")


def _port(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree), "cpu")


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(got, want):
    """The same -inf pattern (unlearned ways), the rest within RTOL and
    ATOL x max(1, max|want|)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    live = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), live)
    np.testing.assert_array_equal(got[~live], want[~live])
    scale = max(1.0, float(np.abs(want[live]).max()))
    np.testing.assert_allclose(got[live], want[live], rtol=RTOL,
                               atol=ATOL * scale)


def _same_argmax_but_ties(got, want):
    """Equal argmax wherever the reference's top-2 margin exceeds the
    comparison's tolerance."""
    got, want = _np(got), _np(want)
    top = np.sort(np.where(np.isfinite(want), want, -np.inf), -1)
    tie = top[..., -1] - top[..., -2] <= 2 * (
        ATOL * max(1.0, float(np.abs(want[np.isfinite(want)]).max()))
        + RTOL * np.abs(top[..., -1]))
    agree = got.argmax(-1) == want.argmax(-1)
    assert (agree | tie).all(), (got.argmax(-1), want.argmax(-1))


# ---------------------------------------------------------------------------
# the meta-trained embedder and the quickstart
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _reference_meta():
    """(reduced jcfg, the reference's initial tree, its get_meta_trained_tcn
    at EPISODES)."""
    common = _load(ROOT / "benchmarks" / "common.py")
    jcfg = j_get_config("chameleon-tcn").replace(
        tcn_channels=(16, 16, 16), tcn_kernel=5, embed_dim=32, n_classes=5)
    init = j_build_bundle(jcfg).init(jax.random.key(0))
    return jcfg, init, common.get_meta_trained_tcn(episodes=EPISODES)


def test_meta_trained_tcn_matches_reference():
    _, init, (_, _, jparams, jstate, jds, jtest) = _reference_meta()
    cfg, bundle, params, state, ds, test_cls = get_meta_trained_tcn(
        episodes=EPISODES, device="cpu", params=_port(init))
    assert cfg.tcn_channels == (16, 16, 16) and cfg.tcn_kernel == 5 \
        and cfg.embed_dim == 32 and bundle.device.type == "cpu"
    np.testing.assert_array_equal(test_cls, jtest)
    np.testing.assert_array_equal(ds.sample(int(test_cls[0]), 2, seed=3),
                                  jds.sample(int(jtest[0]), 2, seed=3))
    for got, want in ((params, jparams), (state, jstate)):
        got = flatten_dict(got)
        want = flatten_dict(jax.tree.map(np.asarray, want))
        assert got.keys() == want.keys()
        for k, w in want.items():
            g = got[k].numpy()
            if k.split("/")[-1] in GAUGE:
                np.testing.assert_allclose(g, w, rtol=0,
                                           atol=2 * EPISODES * LR, err_msg=k)
            else:
                np.testing.assert_allclose(g, w, rtol=TRAIN_RTOL,
                                           atol=TRAIN_ATOL, err_msg=k)


def test_meta_trained_tcn_is_kept_per_key():
    a = get_meta_trained_tcn(episodes=1, img=8, n_classes=10, device="cpu")
    assert get_meta_trained_tcn(episodes=1, img=8, n_classes=10,
                                device="cpu") is a
    b = get_meta_trained_tcn(episodes=1, img=8, n_classes=10, device="cpu",
                             params=a[2])
    assert b is not a and b[2] is not a[2]
    assert get_meta_trained_tcn(episodes=1, img=8, n_classes=10,
                                device="cpu") is a


def test_quickstart_fsl_and_stream_match_reference():
    jcfg, _, (_, _, jparams, jstate, ds, test_cls) = _reference_meta()
    cfg = get_config("chameleon-tcn").replace(
        tcn_channels=(16, 16, 16), tcn_kernel=5, embed_dim=32, n_classes=5)
    params, state = _port(jparams), _port(jstate)
    got = quickstart.few_shot(cfg, params, state, ds, test_cls, "cpu")

    # the reference's examples/quickstart.py, steps 2 and 3 (a script)
    sx, sy, qx, qy = JEpisodicSampler(ds, test_cls, seed=5).episode(
        0, n_ways=5, k_shots=3, n_query=4)
    emb_s, _, _ = j_forward(jparams, jstate, jcfg, jnp.asarray(sx))
    w, b = jpn.pn_fc_from_sums(jpn.support_sums(emb_s, jnp.asarray(sy), 5),
                               k=3)
    emb_q, _, _ = j_forward(jparams, jstate, jcfg, jnp.asarray(qx))
    want = jpn.pn_logits(emb_q, w, b)
    np.testing.assert_array_equal(got["qy"].numpy(), qy)
    _close(got["logits"], want)
    _same_argmax_but_ties(got["logits"], want)

    x = got["qx"][:1]
    emb, full = quickstart.stream_one(cfg, params, state, x)
    jx = jnp.asarray(qx[:1])
    sstate = j_stream_init(jcfg, 1)
    for t in range(jx.shape[1]):
        sstate, jemb, _ = j_stream_step(jparams, jstate, jcfg, sstate,
                                        jx[:, t])
    _close(emb, jemb)
    _close(full, j_forward(jparams, jstate, jcfg, jx)[0])
    _close(emb, full)


def test_quickstart_run_on_the_cpu():
    _, init, _ = _reference_meta()
    out = quickstart.run("cpu", episodes=2, params=_port(init))
    assert out["logits"].shape == (20, 5) and 0.0 <= out["acc"] <= 1.0
    assert out["stream_err"] == float((out["stream_emb"]
                                       - out["full_emb"]).abs().max())
    _close(out["stream_emb"], out["full_emb"])


# ---------------------------------------------------------------------------
# serve_multitenant
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _kws_reference():
    jcfg = j_get_config("chameleon-tcn-kws").replace(kernel_backend="ref")
    jb = j_build_bundle(jcfg)
    return jcfg, jb, jb.init(jax.random.key(0))


def _j_stream_clip(svc, sid, frames):
    res = svc.push({sid: frames})[sid]
    tl = res["tenant_logits"]
    return {"pred": res["pred"], "step": res["step"],
            "emb": res["emb"][-1], "logits": res["logits"][-1],
            "tenant_logits": None if tl is None else tl[-1]}


def _j_multitenant():
    """The reference's examples/serve_multitenant.py steps (a script) on
    the KWS preset at full width, fused=True on the plain backend."""
    jcfg, jb, jp = _kws_reference()
    svc = JService(jb, jp, j_empty(jcfg), n_slots=4, max_tenants=4,
                   max_ways=4, max_sessions=12, fused=True,
                   kernel_backend="ref")
    audio = JKeywordAudio(n_classes=6, seed=0)
    out = {"n_ways": {}, "state": {}}
    alice = svc.open_session(tenant=None)
    bob = svc.open_session(tenant=None)
    for cls in (0, 1):
        svc.enroll_shots(alice, audio.mfcc(audio.sample(cls, 3, seed=cls)))
    for cls in (2, 3):
        svc.enroll_shots(bob, audio.mfcc(audio.sample(cls, 3, seed=cls)))
    qa = audio.mfcc(audio.sample(0, 1, seed=50))[0]
    qb = audio.mfcc(audio.sample(3, 1, seed=51))[0]
    out["alice"] = _j_stream_clip(svc, alice, qa)
    out["bob"] = _j_stream_clip(svc, bob, qb)
    out["n_ways"]["alice"] = svc.poll(alice)["n_ways"]
    out["n_ways"]["bob"] = svc.poll(bob)["n_ways"]
    svc.enroll_shots(bob, audio.mfcc(audio.sample(4, 3, seed=4)))
    out["bob_new"] = _j_stream_clip(
        svc, bob, audio.mfcc(audio.sample(4, 1, seed=52))[0])
    out["n_ways"]["bob_new"] = svc.poll(bob)["n_ways"]
    burst = [svc.open_session() for _ in range(6)]
    svc.push({sid: qa[:10] for sid in burst[:4]})
    out["stats"] = svc.stats()
    out["state"]["burst"] = svc.poll(alice)["state"]
    out["alice_resumed"] = svc.push({alice: qa[0]})[alice]
    out["state"]["resumed"] = svc.poll(alice)["state"]
    return out


@functools.lru_cache(maxsize=None)
def _multitenant_pair():
    _, _, jp = _kws_reference()
    return multitenant.run("cpu", fused=True, params=_port(jp)), \
        _j_multitenant()


@pytest.mark.parametrize("step", ["alice", "bob", "bob_new",
                                  "alice_resumed"])
def test_serve_multitenant_matches_reference(step):
    got, want = _multitenant_pair()
    g, w = got[step], want[step]
    for key in ("emb", "logits", "tenant_logits"):
        _close(g[key], w[key])
    _same_argmax_but_ties(g["tenant_logits"], w["tenant_logits"])
    assert g["step"] == w["step"]


def test_serve_multitenant_polls_match_reference():
    got, want = _multitenant_pair()
    assert got["n_ways"] == want["n_ways"] == {"alice": 2, "bob": 2,
                                               "bob_new": 3}
    assert got["state"] == want["state"] == {"burst": "parked",
                                             "resumed": "active"}
    for key in ("bound", "parked", "live_sessions", "evictions",
                "dispatches"):
        assert got["stats"][key] == want["stats"][key], key


def test_serve_multitenant_resume_is_bit_exact():
    got, _ = _multitenant_pair()
    assert got["resume_exact"]
    ctl = got["control"]
    for key in ("emb", "logits", "tenant_logits"):
        np.testing.assert_array_equal(got["alice_resumed"][key], ctl[key])
    assert got["dispatches"] == {"service": got["stats"]["dispatches"] + 1,
                                 "control": 5}


# ---------------------------------------------------------------------------
# serve_stream
# ---------------------------------------------------------------------------

def test_serve_stream_kws_matches_reference():
    jcfg, jb, jp = _kws_reference()
    got = serve_stream.stream_kws("cpu", _port(jp))
    svc = JService(jb, jp, j_empty(jcfg), n_slots=2, max_tenants=1,
                   t_chunk=16, fused=True, kernel_backend="ref")
    audio = JKeywordAudio(n_classes=4, seed=0)
    frames = audio.mfcc(np.concatenate([audio.sample(0, 1, seed=1),
                                        audio.sample(2, 1, seed=2)]))
    sids = [svc.open_session() for _ in range(2)]
    res = svc.push_audio({sid: frames[i] for i, sid in enumerate(sids)})
    want = np.stack([res[sid]["logits"][-1] for sid in sids])
    assert got["frames"] == frames.shape == (2, 63, 28)
    _close(got["logits"], want)
    assert got["dispatches"] == svc.dispatches == 4


def test_serve_stream_lm_matches_reference():
    jcfg = j_get_config("olmo-1b").smoke().replace(
        n_layers=2, d_model=32, d_ff=64, vocab_size=64, head_dim=16)
    jb = j_build_bundle(jcfg)
    jp = jb.init(jax.random.key(1))
    lm = JLMServer(jb, jp, JServeConfig(max_batch=4, seq_cap=48))
    sid = {n: lm.open_session(np.array(serve_stream.LM_PROMPTS[n], np.int32))
           for n in ("r1", "r2")}
    for _ in range(serve_stream.LM_STEPS):
        lm.step()
    want = {n: list(lm.outputs[s]) for n, s in sid.items()}
    lm.close(sid["r1"])
    r3 = lm.open_session(np.array(serve_stream.LM_PROMPTS["r3"], np.int32))
    lm.step()
    want["r3"] = list(lm.outputs[r3])
    got = serve_stream.serve_lm(serve_stream.lm_server("cpu", _port(jp)))
    assert got == want
    assert [len(got[n]) for n in ("r1", "r2", "r3")] == [8, 8, 1]
