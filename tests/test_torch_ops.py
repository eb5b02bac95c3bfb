"""The port's kernel-op entry point (``repro_torch.kernels.ops``) on the CPU:
the plain versions that the ``log2_matmul`` and ``dilated_conv`` wrappers
run for CPU tensors, held against the JAX Pallas kernels in interpret mode
at the JAX tests' shapes and tolerances (log2_matmul: fp32 rtol=1e-4,
atol=1e-3, bf16 rtol=2e-2, atol=0.2; dilated_conv: rtol=atol=1e-4), the
conv's causality bit for bit, and the backend resolution of ``make_*_op``.
The kernels themselves are held against these plain versions on a card by
tests/test_torch_cuda.py and chip_smoke.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.dilated_conv import dilated_causal_conv  # noqa: E402
from repro.kernels.log2_matmul import log2_matmul as j_log2_matmul  # noqa: E402
from repro.quant.log2 import pack_nibbles as j_pack  # noqa: E402
from repro.quant.log2 import quantize_log2 as j_quant  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.dilated_conv import dilated_conv  # noqa: E402
from repro_torch.kernels.log2_matmul import log2_matmul  # noqa: E402

CONV_TOL = 1e-4


def _packed(rng, K, N):
    """Nibble-packed log2 codes of a random (K, N) weight, and its scale,
    as numpy (the reference's quantizer, so both sides get the same bytes)."""
    w = rng.normal(size=(K, N)).astype(np.float32) * 0.05
    s = np.float32(np.abs(w).max())
    packed = np.array(j_pack(j_quant(jnp.asarray(w), jnp.float32(s))))
    return packed, s


@pytest.mark.parametrize("M,K,N", [(8, 32, 16), (100, 64, 130),
                                   (256, 128, 512), (1, 256, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_log2_matmul_matches_reference(M, K, N, dtype):
    rng = np.random.default_rng(M + N)
    packed, s = _packed(rng, K, N)
    x = rng.normal(size=(M, K)).astype(np.float32)
    want = j_log2_matmul(jnp.asarray(x, getattr(jnp, dtype)),
                         jnp.asarray(packed), jnp.float32(s), bm=64, bn=64,
                         interpret=True)
    op = ops.make_log2_matmul_op(device="cpu")
    got = op(torch.from_numpy(x).to(getattr(torch, dtype)),
             torch.from_numpy(packed), torch.tensor(s))
    assert got.dtype == torch.float32 and tuple(got.shape) == (M, N)
    tol = 1e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol * 10)


def test_log2_matmul_identity_decodes_exactly():
    """x = I_K gives the decoded weights themselves, bit for bit."""
    rng = np.random.default_rng(3)
    packed, s = _packed(rng, 64, 48)
    from repro_torch.quant.log2 import dequantize_log2, unpack_nibbles

    w = dequantize_log2(unpack_nibbles(torch.from_numpy(packed)),
                        torch.tensor(s))
    got = log2_matmul(torch.eye(64), torch.from_numpy(packed), torch.tensor(s))
    assert torch.equal(got, w)


@pytest.mark.parametrize("B,T,Cin,Cout,K,d", [
    (2, 37, 4, 8, 3, 1), (3, 128, 16, 32, 7, 4), (1, 200, 8, 100, 2, 16),
    (2, 64, 28, 24, 3, 2), (2, 20, 4, 100, 7, 8), (1, 50, 1, 24, 1, 1)])
def test_dilated_conv_matches_reference(B, T, Cin, Cout, K, d):
    rng = np.random.default_rng(T + Cout)
    x = rng.normal(size=(B, T, Cin)).astype(np.float32)
    w = (rng.normal(size=(K, Cin, Cout)) * 0.2).astype(np.float32)
    b = (rng.normal(size=(Cout,)) * 0.1).astype(np.float32)
    want = dilated_causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                               d, bco=32, interpret=True)
    op = ops.make_dilated_conv_op(device="cpu")
    got = op(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), d)
    assert tuple(got.shape) == (B, T, Cout)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=CONV_TOL,
                               atol=CONV_TOL)


def test_dilated_conv_is_causal():
    """Changing x[:, t0:] leaves out[:, :t0] bit-identical."""
    rng = np.random.default_rng(0)
    B, T, C, K, d, t0 = 1, 32, 4, 3, 2, 20
    x = torch.from_numpy(rng.normal(size=(B, T, C)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(K, C, C)) * 0.3).astype(np.float32))
    b = torch.zeros(C)
    y1 = dilated_conv(x, w, b, d)
    x2 = x.clone()
    x2[:, t0:] = 123.0
    y2 = dilated_conv(x2, w, b, d)
    assert torch.equal(y1[:, :t0], y2[:, :t0])
    assert not torch.equal(y1[:, t0:], y2[:, t0:])
    jy = dilated_causal_conv(jnp.asarray(x2.numpy()), jnp.asarray(w.numpy()),
                             jnp.asarray(b.numpy()), d, interpret=True)
    np.testing.assert_allclose(y2.numpy(), np.asarray(jy), rtol=CONV_TOL,
                               atol=CONV_TOL)


@pytest.mark.parametrize("make", ["make_log2_matmul_op", "make_dilated_conv_op",
                                  "make_proto_extract_op"])
def test_make_op_resolves_backend_once(make):
    """The op is the wrapper itself, also as exported from the package; a
    CUDA backend on a CPU device and an unknown name raise."""
    fn = getattr(ops, make)
    op = fn(device="cpu")
    assert op is fn("ref", "cpu") and op is fn("auto", torch.device("cpu"))
    with pytest.raises(ValueError, match="does not run on device"):
        fn("cuda", device="cpu")
    with pytest.raises(ValueError, match="unknown kernel backend"):
        fn("mosaic", device="cpu")
    import repro_torch.kernels as kernels

    assert getattr(kernels, make) is fn


def test_cpu_calls_launch_no_kernel():
    before = (log2_matmul.launches, dilated_conv.launches)
    rng = np.random.default_rng(1)
    packed, s = _packed(rng, 16, 8)
    log2_matmul(torch.ones(2, 16), torch.from_numpy(packed), torch.tensor(s))
    dilated_conv(torch.ones(1, 5, 2), torch.ones(3, 2, 4), torch.zeros(4), 2)
    assert (log2_matmul.launches, dilated_conv.launches) == before
