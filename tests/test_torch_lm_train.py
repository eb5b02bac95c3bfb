"""LM training in the port against the JAX reference, on the CPU: the
norms' hand-written backward, ``chunked_cross_entropy``, remat, and every
``smoke()`` bundle's ``loss_fn`` with its gradients against
``jax.value_and_grad`` of the reference's (the archs of
``tests/test_archs_smoke.py::test_train_step_finite``: here the dense,
vlm and audio families; the MoE family is in
``test_torch_lm_train_moe.py`` and the recurrent families in
``test_torch_lm_train_recurrent.py``, which import the helpers below).

The same seeded numpy inputs and the reference's params (converted) go
through both packages.  Tolerances:

  * fp32 (``act_dtype="float32"``): loss, ``acc`` and every gradient leaf
    at rtol 1e-4, atol 1e-5 x max(1, max|want|); ``tokens`` equal;
  * bf16 (the configs' activation dtype): the loss within 5e-2 x max(1,
    |want|); each gradient leaf within 5e-2 relative L2 of the
    reference's bf16 gradient, or else no farther from the reference's
    fp32 gradient than the reference's own bf16 gradient is, plus 5e-2.
    bf16 keeps 8 mantissa bits and the packages round their chains in
    different places; in RWKV6 and the MoE router the reference's own
    bf16 gradients sit 0.15-0.58 (relative L2) from its fp32 ones, so no
    port can be held to 5e-2 of them there, only to the fp32 truth.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import build_bundle as j_build_bundle  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.data import arch_batch  # noqa: E402
from repro_torch.models import build_bundle  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.models.build import _lm_inputs  # noqa: E402
from repro_torch.training import value_and_grad  # noqa: E402
from repro_torch.utils.trees import tree_leaves  # noqa: E402

BF16_REL = 5e-2
ARCHS = ["olmo-1b", "stablelm-1.6b", "command-r-35b", "qwen2.5-32b",
         "internvl2-76b", "seamless-m4t-large-v2"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module, restored after it: tiny models
    under several test workers run far slower with torch's thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def close32(got, want, what=""):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * scale,
                               err_msg=what)


def close16(got, want, what=""):
    got, want = _f32(got), _f32(want)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    assert float(np.abs(got - want).max(initial=0.0)) <= BF16_REL * scale, \
        what


def rel_l2(a, b) -> float:
    a, b = _f32(a), _f32(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ---------------------------------------------------------------------------
# the bundles: seeded batches, reference and port value-and-grad
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def reference(name: str, dtype: str):
    """(params as numpy, batch, loss, metrics, {path: grad}) of the
    reference's jitted value_and_grad at ``smoke()`` in ``dtype``, on
    ``data.arch_batch`` (B=2, S=32, seed 0)."""
    cfg = j_get_config(name).smoke().replace(act_dtype=dtype)
    bundle = j_build_bundle(cfg)
    params = bundle.init(jax.random.key(0))
    batch = arch_batch(cfg)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        bundle.loss_fn, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    return (jax.tree.map(np.asarray, params), batch, float(loss),
            {k: float(v) for k, v in metrics.items()},
            {jax.tree_util.keystr(k): np.asarray(v, np.float32)
             for k, v in flat})


def port(name: str, dtype: str):
    """(loss, metrics, grad leaves in the reference's flat order) of the
    port's ``loss_fn`` on the reference's params and batch."""
    params, batch, *_ = reference(name, dtype)
    cfg = get_config(name).smoke().replace(act_dtype=dtype)
    bundle = build_bundle(cfg, "cpu")
    loss, metrics, grads = value_and_grad(
        bundle.loss_fn, params_from_jax(params, "cpu"),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    return loss, metrics, tree_leaves(grads)


def check_fp32(name):
    _, _, loss, metrics, grads = reference(name, "float32")
    got_loss, got_m, got_g = port(name, "float32")
    close32(got_loss, loss, "loss")
    assert set(got_m) == set(metrics), (sorted(got_m), sorted(metrics))
    assert float(got_m["tokens"]) == metrics["tokens"]
    for k in metrics:
        close32(got_m[k], metrics[k], k)
    assert len(got_g) == len(grads)
    for g, (path, want) in zip(got_g, grads.items()):
        assert g.dtype == torch.float32, path
        close32(g, want, path)


def check_bf16(name):
    _, _, loss, metrics, grads = reference(name, "bfloat16")
    grads32 = reference(name, "float32")[4]
    got_loss, got_m, got_g = port(name, "bfloat16")
    assert abs(float(got_loss) - loss) <= BF16_REL * max(1.0, abs(loss))
    assert set(got_m) == set(metrics)
    assert float(got_m["tokens"]) == metrics["tokens"]
    assert 0.0 <= float(got_m["acc"]) <= 1.0
    assert np.isfinite(float(got_loss))
    for g, (path, want) in zip(got_g, grads.items()):
        r = rel_l2(g, want)
        if r <= BF16_REL:
            continue
        truth = grads32[path]
        assert rel_l2(g, truth) <= rel_l2(want, truth) + BF16_REL, \
            (path, r, rel_l2(g, truth), rel_l2(want, truth))


@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_grads_match_reference_fp32(name):
    check_fp32(name)


@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_grads_match_reference_bf16(name):
    check_bf16(name)


# ---------------------------------------------------------------------------
# the norms' backward
# ---------------------------------------------------------------------------

def _norm_case(kind, x, w, b):
    if kind == "rmsnorm":
        return (lambda x, w, b: jl.rmsnorm(x, w),
                lambda x, w, b: tl.rmsnorm(x, w), (x, w, None))
    if kind == "layernorm":
        return jl.layernorm, tl.layernorm, (x, w, b)
    return (lambda x, w, b: jl.layernorm_np(x),
            lambda x, w, b: tl.layernorm_np(x), (x, None, None))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm", "layernorm_np"])
def test_norm_backward_matches_reference_vjp(kind, dtype):
    """dx, dw, db against ``jax.vjp`` of the reference's custom VJP; dx in
    the activation dtype, dw and db fp32; the non-parametric form gets
    no parameter gradient."""
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(2, 5, 48)) * 3 + 1).astype(np.float32)
    w = rng.normal(size=48).astype(np.float32)
    b = rng.normal(size=48).astype(np.float32)
    dy = rng.normal(size=x.shape).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jfn, tfn, (_, w_, b_) = _norm_case(kind, x, w, b)

    jargs = [jnp.asarray(x, jdt), None if w_ is None else jnp.asarray(w),
             None if b_ is None else jnp.asarray(b)]
    live = [i for i, a in enumerate(jargs) if a is not None]

    def jf(*a):
        full = list(jargs)
        for i, v in zip(live, a):
            full[i] = v
        return jfn(*full)

    y, vjp = jax.vjp(jf, *[jargs[i] for i in live])
    want = vjp(jnp.asarray(dy, jdt))

    targs = [torch.from_numpy(x).to(tdt).requires_grad_(True),
             None if w_ is None else torch.from_numpy(w).requires_grad_(True),
             None if b_ is None else torch.from_numpy(b).requires_grad_(True)]
    out = tfn(*targs)
    got = torch.autograd.grad(out, [targs[i] for i in live],
                              torch.from_numpy(dy).to(tdt))
    check = close32 if dtype == "float32" else close16
    check(out, y, "y")
    assert got[0].dtype == tdt
    for g, wv, i in zip(got, want, live):
        check(g, wv, f"arg {i}")
        if i:
            assert g.dtype == torch.float32


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_norm_forward_is_the_no_grad_forward_bit_for_bit(dtype):
    """Under autograd the norms run through their ``Function``, whose
    forward is the same helper as the no-grad path's: equal bits (LM
    serving's bit-exact invariants ride on this forward)."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(3, 7, 64)).astype(np.float32) * 2
                         ).to(dtype)
    w = torch.from_numpy(rng.normal(size=64).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=64).astype(np.float32))
    for fn, args in ((tl.rmsnorm, (w,)), (tl.layernorm, (w, b)),
                     (tl.layernorm_np, ())):
        with torch.no_grad():
            plain = fn(x, *args)
        xr = x.clone().requires_grad_(True)
        tracked = fn(xr, *[a.clone().requires_grad_(True) for a in args])
        assert tracked.grad_fn is not None
        assert torch.equal(tracked.detach(), plain)
        assert fn(x, *args).grad_fn is None  # nothing requires grad


# ---------------------------------------------------------------------------
# chunked_cross_entropy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_cross_entropy_matches_reference(dtype):
    """S = 37 over chunks of 8 (padded with label -1), labels at -1 in
    places and one row all masked: loss, acc, tokens and the gradients of
    the hidden states and the head."""
    rng = np.random.default_rng(5)
    B, S, D, V, chunk = 3, 37, 16, 50, 8
    h = rng.normal(size=(B, S, D)).astype(np.float32)
    w = (rng.normal(size=(D, V)) / 4).astype(np.float32)
    y = rng.integers(0, V, (B, S)).astype(np.int32)
    y[0, ::3] = -1
    y[2] = -1
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32

    (jloss, jm), (jdh, jdw) = jax.value_and_grad(
        lambda hh, ww: jtr.chunked_cross_entropy(hh, ww, jnp.asarray(y),
                                                 chunk),
        argnums=(0, 1), has_aux=True)(jnp.asarray(h, jdt), jnp.asarray(w))
    th = torch.from_numpy(h).to(tdt).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    loss, m = tt.chunked_cross_entropy(th, tw, torch.from_numpy(y), chunk)
    dh, dw = torch.autograd.grad(loss, [th, tw])
    check = close32 if dtype == "float32" else close16
    close32(loss, jloss, "loss") if dtype == "float32" \
        else check(loss, jloss, "loss")
    assert float(m["tokens"]) == float(jm["tokens"]) == (y >= 0).sum()
    close32(m["acc"], jm["acc"], "acc")
    check(dh, jdh, "dh")
    check(dw, jdw, "dw")
    assert dh.dtype == tdt and dw.dtype == torch.float32


def test_chunked_cross_entropy_all_masked_counts_one():
    """No label >= 0: loss 0 over a count clamped to 1, as the
    reference's."""
    h = torch.randn(2, 5, 8, generator=torch.Generator().manual_seed(0))
    w = torch.randn(8, 11, generator=torch.Generator().manual_seed(1))
    loss, m = tt.chunked_cross_entropy(h, w, torch.full((2, 5), -1), 4)
    want, jm = jtr.chunked_cross_entropy(jnp.asarray(h.numpy()),
                                         jnp.asarray(w.numpy()),
                                         jnp.full((2, 5), -1), 4)
    assert float(loss) == float(want) == 0.0
    assert float(m["tokens"]) == float(jm["tokens"]) == 1.0
    assert float(m["acc"]) == 0.0


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

def _remat_batch(cfg, seed=6):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (2, 40)),
           "labels": rng.integers(-1, cfg.vocab_size, (2, 40))}
    if cfg.family == "audio":
        out["frames"] = rng.normal(size=(2, 24, cfg.d_model)).astype(
            np.float32)
    return {k: torch.from_numpy(v) for k, v in out.items()}


def _loss_without_remat(cfg):
    """The bundle's loss with the layers run plainly (no checkpoint)."""
    def loss_fn(params, batch):
        x, labels, enc_h = _lm_inputs(params, cfg, batch)
        h, metrics = tt.backbone(params, cfg, x, 0, None, enc_h)
        loss, lm_m = tt.chunked_cross_entropy(h, params["lm_head"], labels,
                                              cfg.logit_chunk)
        if "moe_aux" in metrics:
            loss = loss + cfg.router_aux_coef * metrics["moe_aux"]
        return loss, {**metrics, **lm_m}

    return loss_fn


@pytest.mark.parametrize("name", ["olmo-1b", "deepseek-v2-lite-16b",
                                  "seamless-m4t-large-v2"])
def test_remat_gives_the_same_loss_and_gradients(name):
    """4 layers (grouped by 4 with ``scan_layers``, one by one without),
    policies "nothing" and "dots": the loss and every gradient
    ``torch.equal`` to the plain run's."""
    base = get_config(name).smoke().replace(n_layers=4)
    params = build_bundle(base, "cpu").init(torch.Generator().manual_seed(0))
    batch = _remat_batch(base)
    want = value_and_grad(_loss_without_remat(base), params, batch)
    for scan in (True, False):
        for policy in ("nothing", "dots"):
            cfg = base.replace(scan_layers=scan, remat_policy=policy)
            got = value_and_grad(build_bundle(cfg, "cpu").loss_fn, params,
                                 batch)
            assert torch.equal(got[0], want[0]), (scan, policy)
            assert all(torch.equal(a, b) for a, b in zip(
                tree_leaves(got[2]), tree_leaves(want[2]))), (scan, policy)


def test_pick_group_matches_reference():
    for L in range(1, 41):
        assert tt._pick_group(L) == jtr._pick_group(L)


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


def test_remat_dots_keeps_the_weight_products():
    """"dots" saves the products without a batch axis, so the backward
    recomputes fewer of them than "nothing" does; without remat none is
    recomputed."""
    counts = {}
    for policy in ("nothing", "dots"):
        cfg = get_config("olmo-1b").smoke().replace(n_layers=4,
                                                    remat_policy=policy)
        b = build_bundle(cfg, "cpu")
        p = b.init(torch.Generator().manual_seed(0))
        leaves = [x.requires_grad_(True) for x in tree_leaves(p)]
        loss, _ = b.loss_fn(p, _remat_batch(cfg))
        with _CountMM() as mode:
            torch.autograd.grad(loss, leaves)
        counts[policy] = mode.n
    assert counts["dots"] < counts["nothing"], counts


def test_serving_calls_take_no_checkpoint():
    """A cached call refuses remat; the bundle's serving functions run
    without it (``scan_layers``' default)."""
    cfg = get_config("olmo-1b").smoke()
    b = build_bundle(cfg, "cpu")
    p = b.init(torch.Generator().manual_seed(0))
    x = torch.zeros(1, 2, cfg.d_model)
    rope = tt._rope(cfg, torch.arange(2), cfg.dh)
    with pytest.raises(ValueError, match="remat"):
        tt.scan_layers(p["layers"], cfg, x, rope, b.empty_cache(1, 4)["dense"],
                       0, remat=True)
    with pytest.raises(ValueError, match="remat policy"):
        tt.checkpointed(lambda v: v, "everything")


def test_embedding_backward_repeats_bit_for_bit_on_threads():
    """``embed_tokens``' backward sums a row's repeats in a fixed order:
    with several intra-op threads (an index's backward accumulates with
    atomics on them) the gradient repeats bit for bit over calls, and it
    is the library's own embedding gradient."""
    cfg = get_config("olmo-1b").smoke()
    g = torch.Generator().manual_seed(8)
    w = torch.randn(64, 256, generator=g)
    tokens = torch.randint(0, 64, (8, 512), generator=g)
    dy = torch.randn(8, 512, 256, generator=g).to(torch.bfloat16)
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        got = []
        for _ in range(6):
            leaf = w.clone().requires_grad_(True)
            out = tt.embed_tokens({"embed": leaf}, cfg, tokens)
            got.append(torch.autograd.grad(out, leaf, dy)[0])
    finally:
        torch.set_num_threads(n)
    assert all(torch.equal(got[0], x) for x in got[1:])
    leaf = w.clone().requires_grad_(True)
    want = torch.autograd.grad(torch.nn.functional.embedding(tokens, leaf)
                               .to(torch.bfloat16), leaf, dy)[0]
    assert torch.equal(got[0], want)
    with torch.no_grad():
        assert torch.equal(tt.embed_tokens({"embed": w}, cfg, tokens),
                           w[tokens].to(torch.bfloat16))
