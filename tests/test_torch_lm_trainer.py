"""The LM-bundle tests of ``tests/test_trainer.py`` on the port, each
against the reference's numbers on the same params and batches, and a
bit-for-bit kill-and-resume of an LM ``Trainer``.

The tiny config is the reference test's (olmo-1b ``smoke()`` cut to 2
layers of d 32, vocab 128, bf16 activations).  The reference's params
are converted to the port; its bf16 activations round elsewhere than the
port's, so trajectories are compared at the LM bf16 tolerance of
``test_torch_lm_train.py`` (5e-2 of the scale), not bit for bit.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.data import lm_batch as j_lm_batch  # noqa: E402
from repro.models import build_bundle as j_build_bundle  # noqa: E402
from repro.training import TrainConfig as JTrainConfig  # noqa: E402
from repro.training import Trainer as JTrainer  # noqa: E402
from repro.training import TrainState as JTrainState  # noqa: E402
from repro.training import make_train_step as j_make_train_step  # noqa: E402
from repro.training import optim as jo  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.data import lm_batch  # noqa: E402
from repro_torch.models import build_bundle  # noqa: E402
from repro_torch.training import (  # noqa: E402
    TrainConfig,
    Trainer,
    TrainState,
    make_train_step,
)
from repro_torch.training import optim as to  # noqa: E402
from repro_torch.utils.trees import tree_leaves  # noqa: E402

TINY = dict(n_layers=2, d_model=32, d_ff=64, vocab_size=128, head_dim=16)
BF16_REL = 5e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _tiny():
    """(reference bundle, reference params, port bundle): the reference's
    ``tests/test_trainer.py::_tiny``."""
    jb = j_build_bundle(j_get_config("olmo-1b").smoke().replace(**TINY))
    params = jb.init(jax.random.key(0))
    return jb, params, build_bundle(get_config("olmo-1b").smoke().replace(
        **TINY), "cpu")


def _port_params():
    return params_from_jax(jax.tree.map(np.asarray, _tiny()[1]), "cpu")


def _jdata(batch, seq):
    return lambda s: {k: jnp.asarray(v) for k, v in
                      j_lm_batch(s, batch, seq, TINY["vocab_size"]).items()}


def _tdata(batch, seq):
    return lambda s: {k: torch.from_numpy(v) for k, v in
                      lm_batch(s, batch, seq, TINY["vocab_size"]).items()}


def test_grad_accum_equivalence():
    """accum=4 over quarters == accum=1 over the full batch (same tokens),
    at the reference test's atol; the one-step update against the
    reference's."""
    jb, jparams, bundle = _tiny()
    opt = to.sgd(0.1, momentum=0.0)
    batch = _tdata(4, 32)(0)
    p = _port_params()
    st = lambda: TrainState(p, opt[0](p), {}, {},  # noqa: E731
                            torch.zeros((), dtype=torch.int32))
    a, _ = make_train_step(bundle.loss_fn, opt)(st(), batch)
    mb = {k: v.reshape(4, 1, *v.shape[1:]) for k, v in batch.items()}
    b, _ = make_train_step(bundle.loss_fn, opt, grad_accum=4)(st(), mb)
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=2e-4)

    jopt = jo.sgd(0.1, momentum=0.0)
    ja, _ = jax.jit(j_make_train_step(jb.loss_fn, jopt))(
        JTrainState(jparams, jopt[0](jparams), {}, {},
                    jnp.zeros((), jnp.int32)), _jdata(4, 32)(0))
    for x, y, p0 in zip(tree_leaves(a.params), jax.tree.leaves(ja.params),
                        jax.tree.leaves(jparams)):
        step = np.asarray(y) - np.asarray(p0)
        got = x.numpy() - np.asarray(p0)
        assert np.abs(got - step).max() <= BF16_REL * max(
            1e-6, float(np.abs(step).max()))


def test_compression_converges_like_uncompressed():
    """int8-EF training tracks the uncompressed loss trajectory (the
    reference test's 0.35), and each final loss is the reference's."""
    jb, jparams, bundle = _tiny()
    finals = {}
    for comp in (None, "int8_ef"):
        _, th = Trainer(bundle.loss_fn, _port_params(),
                        TrainConfig(steps=30, log_every=29,
                                    grad_compression=comp),
                        _tdata(8, 32)).run()
        _, jh = JTrainer(jb.loss_fn, jax.tree.map(jnp.array, jparams),
                         JTrainConfig(steps=30, log_every=29,
                                      grad_compression=comp),
                         _jdata(8, 32)).run()
        finals[comp] = th[-1]["loss"]
        assert [h["step"] for h in th] == [h["step"] for h in jh]
        for got, want in zip(th, jh):
            assert abs(got["loss"] - want["loss"]) <= BF16_REL * max(
                1.0, abs(want["loss"]))
    assert abs(finals[None] - finals["int8_ef"]) < 0.35, finals


def test_loss_decreases_on_copy_task():
    """60 AdamW 3e-3 steps on lm_batch(step, 8, 64): the mean loss of the
    last 5 at least 0.2 below the first 5's, and both means the
    reference's."""
    jb, jparams, bundle = _tiny()
    _, hist = Trainer(bundle.loss_fn, _port_params(),
                      TrainConfig(steps=60, log_every=1), _tdata(8, 64),
                      optimizer=to.adamw(3e-3)).run()
    _, jhist = JTrainer(jb.loss_fn, jax.tree.map(jnp.array, jparams),
                        JTrainConfig(steps=60, log_every=1), _jdata(8, 64),
                        optimizer=jo.adamw(3e-3)).run()
    first = np.mean([h["loss"] for h in hist[:5]])
    last = np.mean([h["loss"] for h in hist[-5:]])
    assert last < first - 0.2, (first, last)
    for got, want in ((first, np.mean([h["loss"] for h in jhist[:5]])),
                      (last, np.mean([h["loss"] for h in jhist[-5:]]))):
        assert abs(got - want) <= BF16_REL * max(1.0, abs(want)), (got, want)


def test_lm_bitwise_resume_after_kill(tmp_path):
    """olmo-1b ``smoke()`` with grad_accum=2 and int8_ef: a run killed
    after 3 of 6 steps and resumed from its checkpoint equals the
    uninterrupted run bit for bit (params, optimizer and error state,
    the logged metrics)."""
    cfg = get_config("olmo-1b").smoke()
    bundle = build_bundle(cfg, "cpu")
    params = bundle.init(torch.Generator().manual_seed(0))

    def data(s):
        b = lm_batch(s, 4, 32, cfg.vocab_size)
        return {k: torch.from_numpy(v.reshape(2, 2, -1)) for k, v in b.items()}

    def trainer(d):
        return Trainer(bundle.loss_fn, params,
                       TrainConfig(steps=6, grad_accum=2, log_every=1,
                                   ckpt_dir=str(d), ckpt_every=2,
                                   grad_compression="int8_ef"),
                       data, optimizer=to.adamw(3e-3))

    whole, wh = trainer(tmp_path / "a").run()
    trainer(tmp_path / "b").run(steps=3)
    tr = trainer(tmp_path / "b")
    assert tr.maybe_resume() == 3
    resumed, rh = tr.run()
    for a, b in zip(tree_leaves(whole), tree_leaves(resumed)):
        assert torch.equal(a, b)
    assert rh == wh[3:]
    assert all(np.isfinite(h["loss"]) for h in wh)
