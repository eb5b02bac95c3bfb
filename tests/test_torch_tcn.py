"""repro_torch.models.tcn against the JAX reference on the same params
(carried by ``convert.params_from_jax``): the eval-mode forward with and
without QAT fake-quant, BN folding, the session-open bake (packed codes
byte-equal) and the fused batch forward through the ``tcn_block`` plain
version.  fp32 tolerance rtol=2e-4, atol=2e-5 (the repo's precedent for
BN-folded against raw)."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import build_bundle as j_build_bundle  # noqa: E402
from repro.models import tcn as jt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import build_tcn_bundle  # noqa: E402
from repro_torch.models import tcn as tt  # noqa: E402

RTOL, ATOL = 2e-4, 2e-5
SMALL = dict(tcn_channels=(8, 8, 8), tcn_kernel=3, tcn_in_channels=1,
             embed_dim=12, n_classes=4)


@functools.lru_cache(maxsize=None)
def _setup(seed=0):
    jcfg = j_get_config("chameleon-tcn").replace(kernel_backend="ref", **SMALL)
    cfg = get_config("chameleon-tcn").replace(**SMALL)
    params = j_build_bundle(jcfg).init(jax.random.key(seed))
    rng = np.random.default_rng(seed + 100)
    # non-trivial head and BN state, so folding and the FC are exercised
    params["fc"]["w"] = jnp.asarray(rng.normal(size=(12, 4)).astype(np.float32))
    bn = jax.tree.map(lambda a: a + jnp.asarray(
        0.1 * np.abs(rng.normal(size=a.shape)).astype(np.float32)),
        jt.tcn_empty_state(jcfg))
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    return jcfg, cfg, params, bn, np_tree(params), np_tree(bn)


def _x(seed, B=3, T=30):
    return np.random.default_rng(seed).normal(size=(B, T, 1)).astype(np.float32)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL, atol=ATOL)


def test_param_defs_match_reference_shapes():
    jcfg, cfg, *_ = _setup()
    jdefs = jt.tcn_param_defs(jcfg)
    tdefs = tt.tcn_param_defs(cfg)
    jshapes = jax.tree.map(lambda d: tuple(d.shape), jdefs,
                           is_leaf=lambda d: hasattr(d, "axes"))

    def walk(j, t):
        assert set(j) == set(t)
        for key in j:
            if isinstance(j[key], dict):
                walk(j[key], t[key])
            else:
                assert j[key] == tuple(t[key].shape), key

    walk(jshapes, tdefs)
    assert tt.receptive_field(cfg) == jt.receptive_field(jcfg)


def test_init_is_seeded_and_shaped():
    _, cfg, *_ = _setup()
    b = build_tcn_bundle(cfg, "cpu")
    p1 = b.init(torch.Generator().manual_seed(3))
    p2 = b.init(torch.Generator().manual_seed(3))
    assert torch.equal(p1["blocks"]["b1"]["conv2_w"], p2["blocks"]["b1"]["conv2_w"])
    assert tuple(p1["blocks"]["b0"]["down_w"].shape) == (1, 1, 8)
    assert float(p1["fc"]["w"].abs().sum()) == 0.0


@pytest.mark.parametrize("quantize", [False, True])
def test_eval_forward_matches_reference(quantize):
    jcfg, cfg, params, bn, p_np, bn_np = _setup()
    x = _x(1)
    ej, lj, _ = jt.tcn_forward(params, bn, jcfg, jnp.asarray(x), train=False,
                               quantize=quantize)
    et, lt = tt.tcn_forward(params_from_jax(p_np, "cpu"),
                            params_from_jax(bn_np, "cpu"), cfg,
                            torch.tensor(x), quantize=quantize)
    _close(et.numpy(), ej)
    _close(lt.numpy(), lj)


def test_fold_bn_matches_reference():
    jcfg, cfg, params, bn, p_np, bn_np = _setup()
    fj, fbj = jt.fold_bn(params, bn, jcfg)
    ft, fbt = tt.fold_bn(params_from_jax(p_np, "cpu"),
                         params_from_jax(bn_np, "cpu"), cfg)
    for name in fj["blocks"]:
        for key in ("conv1_w", "conv1_b", "conv2_w", "conv2_b"):
            _close(ft["blocks"][name][key].numpy(), fj["blocks"][name][key])
        np.testing.assert_array_equal(fbt[name]["bn1_var"].numpy(),
                                      np.asarray(fbj[name]["bn1_var"]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bake_weight_codes_byte_equal(seed):
    """On the same fp32 weight, the packed codes, scale and scan value of
    the bake are identical in both packages."""
    w = (np.random.default_rng(seed).normal(size=(3, 8, 8)) * 0.4).astype(np.float32)
    sj, fj = jt._bake_weight(jnp.asarray(w), True)
    st, ft = tt._bake_weight(torch.tensor(w), True)
    np.testing.assert_array_equal(ft["codes"].numpy(), np.asarray(fj["codes"]))
    assert ft["scale"].item() == float(fj["scale"])
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("quantize", [False, True])
def test_fused_forward_matches_reference(quantize):
    jcfg, cfg, params, bn, p_np, bn_np = _setup()
    _, _, fused_j = jt.bake_stream_params(params, bn, jcfg, quantize=quantize)
    fused_t = params_from_jax(jax.tree.map(np.asarray, fused_j), "cpu")
    x = _x(2)
    ej, lj = jt.make_fused_forward(jcfg, quantize=quantize)(fused_j, jnp.asarray(x))
    fwd = tt.make_fused_forward(cfg, quantize=quantize, device="cpu")
    et, lt = fwd(fused_t, torch.tensor(x))
    _close(et.numpy(), ej)
    _close(lt.numpy(), lj)
    # the port's own bake gives the same fused tree layout and result
    _, _, own = tt.bake_stream_params(params_from_jax(p_np, "cpu"),
                                      params_from_jax(bn_np, "cpu"), cfg,
                                      quantize=quantize)
    e2, _ = fwd(own, torch.tensor(x))
    _close(e2.numpy(), et.numpy())


def test_fused_forward_close_to_raw_forward():
    """BN folding reassociates, so the fused forward is allclose (not
    bit-equal) to the eval forward on the raw params, as in the reference."""
    _, cfg, _, _, p_np, bn_np = _setup()
    p, bn = params_from_jax(p_np, "cpu"), params_from_jax(bn_np, "cpu")
    _, _, fused = tt.bake_stream_params(p, bn, cfg)
    x = torch.tensor(_x(3))
    ef, lf = tt.make_fused_forward(cfg, device="cpu")(fused, x)
    er, lr = tt.tcn_forward(p, bn, cfg, x)
    _close(ef.numpy(), er.numpy())
    _close(lf.numpy(), lr.numpy())
