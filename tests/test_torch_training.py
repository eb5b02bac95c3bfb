"""The port's training path against the JAX package's, on the narrow TCN
of tests/_torch_pair.py (one input channel: 8x8 glyphs as 64-step
sequences), params carried over with ``convert.params_from_jax``:

  * the train-mode forward (emb, logits, new BN state) and the bundle's
    ``loss_fn`` gradients, fp32 and QAT, against ``jax.value_and_grad``;
  * one ``adamw``/``sgd`` update, ``warmup_cosine``, ``clip_by_global_norm``
    and the int8 error-feedback codes (equal) and residuals;
  * 5 ``Trainer`` steps (plain, ``grad_accum=2``, ``int8_ef``) and the
    meta-training episode step of ``examples/fsl_episodic.py`` against the
    reference's on the same batches;
  * on the port alone: bitwise kill-and-resume, grad-accumulation parity,
    straggler detection, schedule and clip, and compression tracking the
    uncompressed loss (the reference's tests/test_trainer.py on the TCN).

The multi-step comparisons run SGD with momentum.  A conv bias in front
of a train-mode BN has an exact gradient of zero, and both packages
compute rounding noise there (~1e-8); Adam divides each gradient by its
own magnitude, so that noise becomes steps of O(lr) whose sign neither
package controls.  AdamW is held to the reference one update at a time
on dense gradients (``test_optimizer_updates_match_reference``).
"""

import functools
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_pair import SMALL  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import protonet as jpn  # noqa: E402
from repro.data import EpisodicSampler, GlyphClasses  # noqa: E402
from repro.models import build_bundle as j_build_bundle  # noqa: E402
from repro.models import tcn as jt  # noqa: E402
from repro.quant import compress as jc  # noqa: E402
from repro.training import TrainConfig as JTrainConfig  # noqa: E402
from repro.training import Trainer as JTrainer  # noqa: E402
from repro.training import optim as jo  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import protonet as pn  # noqa: E402
from repro_torch.models import build_tcn_bundle  # noqa: E402
from repro_torch.models import tcn as tt  # noqa: E402
from repro_torch.quant import compress as tc  # noqa: E402
from repro_torch.training import (  # noqa: E402
    TrainConfig,
    Trainer,
    make_train_step,
    value_and_grad,
)
from repro_torch.training import optim as to  # noqa: E402
from repro_torch.training.episodic import make_episode_step  # noqa: E402
from repro_torch.utils.trees import tree_leaves  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module, restored after it: when test
    workers share the cores, torch's threads wait on each other for every
    op, and a step that takes ~20 ms alone then takes seconds, which hides
    test_straggler_detection's injected 1 s straggler under its EMA."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RTOL, ATOL = 2e-4, 2e-5          # forward (the repo's fp32 precedent)
TRAIN_RTOL, TRAIN_ATOL = 1e-3, 1e-4  # after several optimizer steps
GEOM = dict(SMALL, tcn_in_channels=1)
IMG = 8


@functools.lru_cache(maxsize=None)
def _setup(seed=0):
    jcfg = j_get_config("chameleon-tcn").replace(kernel_backend="ref", **GEOM)
    cfg = get_config("chameleon-tcn").replace(**GEOM)
    jb = j_build_bundle(jcfg)
    params = jb.init(jax.random.key(seed))
    rng = np.random.default_rng(seed + 50)
    # a non-zero FC head, so the logits and its gradients are exercised;
    # and a non-zero embedding bias: with head_b = 0 the quantized head's
    # pre-activations are sums of grid values (u4 activations x log2
    # weights) that cancel exactly, where ReLU's gradient jumps and each
    # package's rounding (+-1 ulp) picks its own side
    params["fc"]["w"] = jnp.asarray(
        rng.normal(size=params["fc"]["w"].shape).astype(np.float32))
    params["head_b"] = jnp.asarray(
        0.1 * rng.normal(size=params["head_b"].shape).astype(np.float32))
    bn = jax.tree.map(lambda a: a + jnp.asarray(
        0.1 * np.abs(rng.normal(size=a.shape)).astype(np.float32)),
        jt.tcn_empty_state(jcfg))
    return jcfg, cfg, jb, params, bn, build_tcn_bundle(cfg, "cpu")


def _port(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree), "cpu")


def _leaves_np(tree):
    """Leaves in sorted key order, as numpy: both packages' trees line up."""
    if isinstance(tree, dict) or hasattr(tree, "_fields"):
        return [np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)
                for x in tree_leaves(tree)]
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _close_trees(got, want, rtol, atol, scaled=False):
    a, b = _leaves_np(got), _leaves_np(want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        tol = atol * max(1.0, float(np.abs(y).max())) if scaled else atol
        np.testing.assert_allclose(x, y, rtol=rtol, atol=tol)


@functools.lru_cache(maxsize=None)
def _glyphs(seed, n=8):
    """(x (n, 64, 1), labels (n,)) of 8x8 glyphs of 4 classes."""
    ds = GlyphClasses(4, seed=seed, size=IMG)
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 4, n).astype(np.int32)
    x = np.concatenate([ds.sample(int(c), 1, seed=seed * 100 + i)
                        for i, c in enumerate(labels)]).astype(np.float32)
    return x, labels


def _batches(seed, accum=1):
    x, y = _glyphs(seed, 8 * accum)
    if accum > 1:
        x, y = x.reshape(accum, 8, *x.shape[1:]), y.reshape(accum, 8)
    return ({"x": jnp.asarray(x), "labels": jnp.asarray(y)},
            {"x": torch.from_numpy(x), "labels": torch.from_numpy(y)})


# ---------------------------------------------------------------------------
# forward and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quantize", [False, True])
def test_train_forward_matches_reference(quantize):
    jcfg, cfg, _, params, bn, _ = _setup()
    x, _ = _glyphs(1)
    ej, lj, sj = jt.tcn_forward(params, bn, jcfg, jnp.asarray(x), train=True,
                                quantize=quantize)
    et, lt, st = tt.tcn_forward(_port(params), _port(bn), cfg,
                                torch.from_numpy(x), train=True,
                                quantize=quantize)
    _close_trees([et, lt], [ej, lj], RTOL, ATOL)
    _close_trees(st, sj, RTOL, ATOL)
    # the running stats moved: momentum 0.9 towards the batch statistics
    assert not np.allclose(_leaves_np(st)[0], _leaves_np(bn)[0])


def test_eval_forward_returns_state_unchanged():
    _, cfg, _, params, bn, _ = _setup()
    x, _ = _glyphs(2)
    _, _, st = tt.tcn_forward(_port(params), _port(bn), cfg,
                              torch.from_numpy(x))
    _close_trees(st, bn, 0.0, 0.0)


@pytest.mark.parametrize("quantize", [False, True])
def test_loss_fn_grads_match_reference(quantize):
    jcfg, cfg, jb, params, bn, bundle = _setup()
    jbatch, tbatch = _batches(3)
    (lj, (mj, sj)), gj = jax.value_and_grad(
        lambda p: jb.loss_fn(p, jbatch, bn, quantize=quantize),
        has_aux=True)(params)
    lt, (mt, st), gt = value_and_grad(
        lambda p: bundle.loss_fn(p, tbatch, _port(bn), quantize=quantize),
        _port(params))
    np.testing.assert_allclose(float(lt), float(lj), rtol=RTOL, atol=ATOL)
    assert float(mt["acc"]) == float(mj["acc"])
    _close_trees(st, sj, RTOL, ATOL)
    _close_trees(gt, gj, RTOL, ATOL, scaled=True)
    assert any(np.abs(g).max() > 0 for g in _leaves_np(gt))


def test_ste_gradients_pass_through_the_fake_quant():
    """log2 weights: the gradient w.r.t. the raw weight is the gradient
    w.r.t. its quantized value (scale stop-gradient); u4 activations pass
    gradient 1 everywhere, the clipped region included."""
    from repro_torch.quant.log2 import fake_quant_act_u4, fake_quant_log2

    w = torch.tensor([0.3, -0.7, 0.01, 1.5], requires_grad=True)
    (fake_quant_log2(w) * torch.arange(1.0, 5.0)).sum().backward()
    np.testing.assert_array_equal(w.grad.numpy(), [1.0, 2.0, 3.0, 4.0])
    a = torch.tensor([-1.0, 0.1, 2.0, 9.0], requires_grad=True)
    fake_quant_act_u4(a, 0.25).sum().backward()
    np.testing.assert_array_equal(a.grad.numpy(), [1.0, 1.0, 1.0, 1.0])


# ---------------------------------------------------------------------------
# optimizers, schedule, clip, compression
# ---------------------------------------------------------------------------

def _tree(rng, scale=1.0):
    return {"a": (scale * rng.normal(size=(3, 4))).astype(np.float32),
            "b": {"d": (scale * rng.normal(size=(2, 2))).astype(np.float32),
                  "c": (scale * rng.normal(size=(5,))).astype(np.float32)}}


@pytest.mark.parametrize("name", ["adamw", "adamw_sched", "sgd", "sgd_clip"])
def test_optimizer_updates_match_reference(name):
    rng = np.random.default_rng(7)
    params, g1, g2 = _tree(rng), _tree(rng, 3.0), _tree(rng, 0.1)
    jopt, topt = {
        "adamw": (jo.adamw(1e-2), to.adamw(1e-2)),
        "adamw_sched": (jo.adamw(jo.warmup_cosine(0.1, 2, 10), grad_clip=None),
                        to.adamw(to.warmup_cosine(0.1, 2, 10), grad_clip=None)),
        "sgd": (jo.sgd(0.1), to.sgd(0.1)),
        "sgd_clip": (jo.sgd(0.1, grad_clip=0.5), to.sgd(0.1, grad_clip=0.5)),
    }[name]
    jp, tp = jax.tree.map(jnp.asarray, params), _port(params)
    js, ts = jopt[0](jp), topt[0](tp)
    for g in (g1, g2):
        ju, js, jm = jopt[1](jax.tree.map(jnp.asarray, g), js, jp)
        tu, ts, tm = topt[1](_port(g), ts, tp)
        _close_trees(tu, ju, 1e-5, 1e-9)
        _close_trees(ts, js, 1e-5, 1e-9)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
        jp, tp = jo.apply_updates(jp, ju), to.apply_updates(tp, tu)
        _close_trees(tp, jp, 1e-5, 1e-9)
    assert int(ts.step) == int(js.step) == 2


def test_warmup_cosine_and_clip_match_reference():
    js, ts = jo.warmup_cosine(0.3, 10, 100), to.warmup_cosine(0.3, 10, 100)
    steps = np.arange(0, 121)
    np.testing.assert_allclose(
        [float(ts(torch.tensor(s, dtype=torch.int32))) for s in steps],
        [float(js(jnp.asarray(s))) for s in steps], rtol=1e-5, atol=1e-9)
    tree = _tree(np.random.default_rng(3), 5.0)
    for max_norm in (0.5, 1e3):
        cj, nj = jo.clip_by_global_norm(jax.tree.map(jnp.asarray, tree),
                                        max_norm)
        ct, nt = to.clip_by_global_norm(_port(tree), max_norm)
        np.testing.assert_allclose(float(nt), float(nj), rtol=1e-5)
        _close_trees(ct, cj, 1e-5, 1e-9)


def test_int8_ef_codes_equal_reference():
    rng = np.random.default_rng(11)
    jerr = jc.init_error_state(jax.tree.map(jnp.asarray, _tree(rng)))
    terr = tc.init_error_state(_port(_tree(rng)))
    for step in range(4):
        g = _tree(rng, 10.0 ** (step - 2))
        jcodes, jscales, jerr = jc.compress_tree(
            jax.tree.map(jnp.asarray, g), jerr)
        tcodes, tscales, terr = tc.compress_tree(_port(g), terr)
        for a, b in zip(_leaves_np(tcodes), _leaves_np(jcodes)):
            assert a.dtype == b.dtype == np.int8
            np.testing.assert_array_equal(a, b)
        _close_trees(tscales, jscales, 1e-6, 0.0)
        _close_trees(terr, jerr, 1e-6, 1e-12)
        _close_trees(tc.decompress_tree(tcodes, tscales),
                     jc.decompress_tree(jcodes, jscales), 1e-6, 0.0)


# ---------------------------------------------------------------------------
# the Trainer and the meta-training step against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", [{}, {"grad_accum": 2},
                                     {"grad_compression": "int8_ef"}],
                         ids=["plain", "accum2", "int8_ef"])
def test_trainer_matches_reference(variant):
    jcfg, cfg, jb, params, bn, bundle = _setup()
    accum = variant.get("grad_accum", 1)
    jt_ = JTrainer(jb.loss_fn, params,
                   JTrainConfig(steps=5, log_every=1, **variant),
                   lambda s: _batches(10 + s, accum)[0],
                   optimizer=jo.sgd(0.05),
                   # a copy: the reference's jit step donates its state
                   model_state=jax.tree.map(jnp.array, bn))
    tt_ = Trainer(bundle.loss_fn, _port(params),
                  TrainConfig(steps=5, log_every=1, **variant),
                  lambda s: _batches(10 + s, accum)[1],
                  optimizer=to.sgd(0.05), model_state=_port(bn))
    jst, jh = jt_.run()
    tst, th = tt_.run()
    _close_trees(tst.params, jst.params, TRAIN_RTOL, TRAIN_ATOL)
    _close_trees(tst.model_state, jst.model_state, TRAIN_RTOL, TRAIN_ATOL)
    if "grad_compression" not in variant:
        _close_trees(tst.opt_state, jst.opt_state, TRAIN_RTOL, TRAIN_ATOL)
    else:
        # an int8 code may differ by one where x/scale sits within rounding
        # of a half (a tie): there the residuals are mirror images (+-s/2
        # for a code step s) and the momentum moves by s; error feedback
        # carries the difference into the next step, so the params stay
        # close.  At most 1% of a leaf's residuals may be such ties, and
        # the momentum is held to a few code steps (1/127 of its largest
        # value each)
        for x, y in zip(_leaves_np(tst.err_state), _leaves_np(jst.err_state)):
            off = ~np.isclose(x, y, rtol=TRAIN_RTOL, atol=TRAIN_ATOL)
            assert off.mean() <= 0.01, off.mean()
            np.testing.assert_allclose(x[off], -y[off], rtol=TRAIN_RTOL,
                                       atol=TRAIN_ATOL)
        for x, y in zip(_leaves_np(tst.opt_state), _leaves_np(jst.opt_state)):
            np.testing.assert_allclose(
                x, y, rtol=TRAIN_RTOL,
                atol=5 * float(np.abs(y).max()) / 127 + TRAIN_ATOL)
    assert int(tst.step) == int(jst.step) == 5
    np.testing.assert_allclose([h["loss"] for h in th],
                               [h["loss"] for h in jh],
                               rtol=TRAIN_RTOL, atol=TRAIN_ATOL)


def test_episode_step_matches_reference_example():
    """examples/fsl_episodic.py's episode_loss and step (copied here: the
    example is a script) against training/episodic.make_episode_step."""
    jcfg, cfg, _, params, bn, _ = _setup()
    opt_init, opt_update = jo.sgd(0.05)

    def j_episode_loss(params, state, sx, sy, qx, qy):
        emb_s, _, new_state = jt.tcn_forward(params, state, jcfg, sx,
                                             train=True)
        emb_q, _, _ = jt.tcn_forward(params, new_state, jcfg, qx, train=True)
        s = jpn.support_sums(emb_s, sy, 5)
        w, b = jpn.pn_fc_from_sums(s, sx.shape[0] // 5)
        logits = jpn.pn_logits(emb_q, w, b)
        lse = jax.nn.logsumexp(logits, axis=-1)
        gold = jnp.take_along_axis(logits, qy[:, None], 1)[:, 0]
        acc = jnp.mean((jnp.argmax(logits, -1) == qy).astype(jnp.float32))
        return jnp.mean(lse - gold), (new_state, acc)

    @jax.jit
    def j_step(params, state, opt_state, sx, sy, qx, qy):
        (loss, (new_state, acc)), grads = jax.value_and_grad(
            j_episode_loss, has_aux=True)(params, state, sx, sy, qx, qy)
        updates, opt_state, _ = opt_update(grads, opt_state, params)
        return jo.apply_updates(params, updates), new_state, opt_state, \
            loss, acc

    t_step = make_episode_step(cfg, to.sgd(0.05), n_ways=5)
    sampler = EpisodicSampler(GlyphClasses(12, seed=0, size=IMG),
                              np.arange(12), seed=1)
    jstate = (params, bn, opt_init(params))
    tstate = (_port(params), _port(bn), to.sgd(0.05)[0](_port(params)))
    for ep in range(3):
        ep_np = sampler.episode(ep, n_ways=5, k_shots=3, n_query=3)
        *jstate, jl, ja = j_step(*jstate, *map(jnp.asarray, ep_np))
        *tstate, tl, ta = t_step(*tstate, *map(torch.from_numpy, ep_np))
        np.testing.assert_allclose(float(tl), float(jl), rtol=TRAIN_RTOL,
                                   atol=TRAIN_ATOL)
        np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)
    for t_tree, j_tree in zip(tstate, jstate):
        _close_trees(t_tree, j_tree, TRAIN_RTOL, TRAIN_ATOL)


def test_support_sums_matches_reference():
    rng = np.random.default_rng(5)
    for n_ways, k in ((5, 3), (5, 6), (7, 1)):
        emb = rng.normal(size=(n_ways * k, 12)).astype(np.float32)
        labels = rng.permutation(np.repeat(np.arange(n_ways), k)).astype(
            np.int32)
        got = pn.support_sums(torch.from_numpy(emb), torch.from_numpy(labels),
                              n_ways)
        want = jpn.support_sums(jnp.asarray(emb), jnp.asarray(labels), n_ways)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# the port alone (tests/test_trainer.py and test_checkpoint.py on the TCN)
# ---------------------------------------------------------------------------

def _port_trainer(cfg_t, data=None, **kw):
    _, _, _, params, bn, bundle = _setup()
    return Trainer(bundle.loss_fn, _port(params), cfg_t,
                   data or (lambda s: _batches(20 + s)[1]),
                   model_state=_port(bn), **kw)


@pytest.mark.parametrize("compression", [None, "int8_ef"])
def test_bitwise_resume_after_kill(tmp_path, compression):
    cfg_t = lambda d: TrainConfig(steps=9, ckpt_dir=str(d), ckpt_every=4,
                                  log_every=100, grad_compression=compression)
    st, _ = _port_trainer(cfg_t(tmp_path / "a")).run()
    tr1 = _port_trainer(cfg_t(tmp_path / "b"))
    tr1.run(steps=6)     # killed after step 6: the newest checkpoint is 4
    tr2 = _port_trainer(cfg_t(tmp_path / "b"))
    assert tr2.maybe_resume() == 6
    st2, _ = tr2.run()
    for a, b in zip(_leaves_np(st), _leaves_np(st2)):
        np.testing.assert_array_equal(a, b)


def test_trainer_leaves_the_callers_params_alone():
    _, _, _, params, bn, bundle = _setup()
    p, s = _port(params), _port(bn)
    before = [x.clone() for x in tree_leaves(p) + tree_leaves(s)]
    Trainer(bundle.loss_fn, p, TrainConfig(steps=2, log_every=100),
            lambda i: _batches(i)[1], model_state=s).run()
    for x, y in zip(tree_leaves(p) + tree_leaves(s), before):
        assert torch.equal(x, y)


def test_grad_accum_equivalence_without_batch_stats():
    """With a loss whose samples are independent (the eval-mode forward),
    accum=4 over quarters == accum=1 over the whole batch."""
    _, cfg, _, params, bn, bundle = _setup()
    bnt = _port(bn)

    def loss_fn(p, batch):
        _, logits, _ = tt.tcn_forward(p, bnt, cfg, batch["x"])
        from repro_torch.models.build import cross_entropy
        loss, acc = cross_entropy(logits, batch["labels"])
        return loss, {"acc": acc}

    opt = to.sgd(0.1, momentum=0.0)
    p = _port(params)
    _, batch = _batches(4)
    st = lambda: (p, opt[0](p), {}, {}, torch.zeros((), dtype=torch.int32))
    from repro_torch.training import TrainState
    a, _ = make_train_step(loss_fn, opt)(TrainState(*st()), batch)
    mb = {k: v.reshape(4, 2, *v.shape[1:]) for k, v in batch.items()}
    b, _ = make_train_step(loss_fn, opt, grad_accum=4)(TrainState(*st()), mb)
    for x, y in zip(_leaves_np(a.params), _leaves_np(b.params)):
        np.testing.assert_allclose(x, y, atol=2e-6)


def test_straggler_detection():
    tr = _port_trainer(TrainConfig(steps=12, log_every=100,
                                   straggler_factor=8.0))
    orig = tr.train_step

    def sometimes_slow(state, batch):
        step_now = int(state.step)
        out = orig(state, batch)
        if step_now == 9:
            time.sleep(1.0)
        return out

    tr.train_step = sometimes_slow
    tr.run()
    assert 9 in [e[0] for e in tr.straggler_events]


def test_schedule_and_clip():
    sched = to.warmup_cosine(1.0, 10, 100)
    assert float(sched(0)) < 0.2
    assert abs(float(sched(torch.tensor(10))) - 1.0) < 0.05
    assert float(sched(100)) < 0.2
    clipped, norm = to.clip_by_global_norm({"a": torch.full((10,), 10.0)},
                                           1.0)
    assert abs(float(torch.linalg.norm(clipped["a"])) - 1.0) < 1e-5
    assert abs(float(norm) - 10.0 * 10 ** 0.5) < 1e-4


def test_compression_tracks_uncompressed_loss():
    h = []
    for comp in (None, "int8_ef"):
        tr = _port_trainer(TrainConfig(steps=20, log_every=19,
                                       grad_compression=comp),
                           optimizer=to.adamw(3e-3))
        h.append(tr.run()[1])
    assert h[0][0]["loss"] == h[1][0]["loss"]
    assert abs(h[0][-1]["loss"] - h[1][-1]["loss"]) < 0.35, (h[0][-1], h[1][-1])
    assert h[0][-1]["loss"] < h[0][0]["loss"]
