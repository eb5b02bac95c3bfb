"""Parity of repro_torch.quant.log2 with the JAX reference: log2 codes,
packed bytes and decoded values match exactly (apart from a documented
``round(-log2 a)`` tie, where the two ``log2`` may differ by an ulp), u4
activation fake-quant matches bit for bit, and the STE passes gradients."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.quant import log2 as jq  # noqa: E402
from repro_torch.quant import log2 as tq  # noqa: E402

SEEDS = [0, 1, 2, 3]


def _weights(seed, shape=(7, 5, 32)):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=shape) * 0.3).astype(np.float32)
    w.flat[::17] = 0.0  # exact zeros take code 0
    return w


def _tie_mask(w, scale):
    """Elements whose -log2(|w|/scale) sits within 1e-5 of a half-integer."""
    a = np.abs(w.astype(np.float64)) / float(scale)
    e = -np.log2(np.maximum(a, 2.0 ** -12))
    return np.abs(e - np.floor(e) - 0.5) < 1e-5


@pytest.mark.parametrize("seed", SEEDS)
def test_codes_scale_and_values_match(seed):
    w = _weights(seed)
    sj = jq.compute_scale(jnp.asarray(w))
    st = tq.compute_scale(torch.from_numpy(w))
    assert np.float32(sj) == st.item()
    qj = np.asarray(jq.quantize_log2(jnp.asarray(w), sj))
    qt = tq.quantize_log2(torch.from_numpy(w), st).numpy()
    assert qt.dtype == np.int8
    differ = qj != qt
    assert not (differ & ~_tie_mask(w, st.item())).any()
    same = ~differ
    dj = np.asarray(jq.dequantize_log2(jnp.asarray(qj), sj))
    dt = tq.dequantize_log2(torch.tensor(qj), st).numpy()
    np.testing.assert_array_equal(dj, dt)
    fj = np.asarray(jq.fake_quant_log2(jnp.asarray(w)))
    ft = tq.fake_quant_log2(torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(fj[same], ft[same])


@pytest.mark.parametrize("seed", SEEDS)
def test_pack_unpack_bytes_match(seed):
    rng = np.random.default_rng(seed)
    q = rng.integers(-8, 8, size=(3, 4, 2 * (seed + 1))).astype(np.int8)
    pj = np.asarray(jq.pack_nibbles(jnp.asarray(q)))
    pt = tq.pack_nibbles(torch.from_numpy(q)).numpy()
    assert pt.dtype == np.uint8 and pt.shape[-1] == q.shape[-1] // 2
    np.testing.assert_array_equal(pj, pt)
    np.testing.assert_array_equal(tq.unpack_nibbles(torch.from_numpy(pt)).numpy(), q)
    np.testing.assert_array_equal(
        np.asarray(jq.unpack_nibbles(jnp.asarray(pt))),
        tq.unpack_nibbles(torch.from_numpy(pt)).numpy())


def test_pack_rejects_odd_axis():
    with pytest.raises(ValueError):
        tq.pack_nibbles(torch.zeros((2, 3), dtype=torch.int8))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("fixed_scale", [True, False])
def test_act_u4_matches(seed, fixed_scale):
    x = (np.random.default_rng(seed).normal(size=(64, 8)) * 2.0).astype(np.float32)
    if fixed_scale:
        fj = jq.fake_quant_act_u4(jnp.asarray(x), jnp.float32(0.25))
        ft = tq.fake_quant_act_u4(torch.from_numpy(x), 0.25)
        qj = jq.quantize_act_u4(jnp.asarray(x), jnp.float32(0.25))
        qt = tq.quantize_act_u4(torch.from_numpy(x), 0.25)
        np.testing.assert_array_equal(np.asarray(qj), qt.numpy())
    else:
        fj = jq.fake_quant_act_u4(jnp.asarray(x))
        ft = tq.fake_quant_act_u4(torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(fj), ft.numpy())


def test_ste_gradient_passthrough():
    w = torch.from_numpy(_weights(5, (8, 8))).requires_grad_(True)
    (tq.fake_quant_log2(w) * 2.0).sum().backward()
    np.testing.assert_array_equal(w.grad.numpy(), np.full((8, 8), 2.0, np.float32))
    x = torch.linspace(-1.0, 5.0, 32).requires_grad_(True)
    tq.fake_quant_act_u4(x, 0.25).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.ones(32, np.float32))


def test_codebook_range():
    """The 128:1 dynamic range of the nibble codebook, as in the reference."""
    mags = tq.dequantize_log2(torch.arange(-8, 8, dtype=torch.int8),
                              torch.tensor(1.0))
    nz = mags[mags != 0].abs()
    assert (nz.max() / nz.min()).item() == 128.0
