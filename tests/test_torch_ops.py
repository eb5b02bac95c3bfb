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


def _split3(x: torch.Tensor):
    """The kernel's exact split of fp32 x into three bf16 parts: hi keeps
    the top 16 bits of x, mid the top 16 of x - hi, lo what is left."""
    top = lambda v: (v.view(torch.int32) & -65536).view(torch.float32)
    hi = top(x)
    r = x - hi
    mid = top(r)
    return hi, mid, r - mid


def _code_bf16(c: int) -> int:
    """bf16 bits of P for a 4-bit code, as the kernels build them from the
    nibble: sign << 15 | (128 - |q|) << 7, 0 for code 0."""
    neg = c >> 3
    a = 16 - c if neg else c
    return (neg << 15) | ((128 - a) << 7) if c else 0


def _decoded_p(packed: np.ndarray) -> torch.Tensor:
    """P (K, N) fp32 from nibble-packed codes through the bf16 bit rule."""
    lo, hi = packed & 0xF, packed >> 4
    codes = np.stack([lo, hi], axis=-1).reshape(packed.shape[0], -1)
    bits = np.array([_code_bf16(c) for c in range(16)], np.uint16)[codes]
    return torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16).float()


def _contract(x: torch.Tensor, packed: np.ndarray, scale) -> torch.Tensor:
    """The kernels' arithmetic in plain tensors: scale * sum over the bf16
    parts of x (three for fp32 x, one for bf16) of part @ P in fp32."""
    p = _decoded_p(packed)
    parts = _split3(x) if x.dtype == torch.float32 else (x.float(),)
    acc = None
    for part in parts:
        assert torch.equal(part.to(torch.bfloat16).float(), part)
        acc = part @ p if acc is None else acc + part @ p
    return acc * torch.tensor(scale)


def test_bf16_split_reproduces_fp32_exactly():
    """hi + mid + lo == x bit for bit, each part exact in bf16, over values
    with random 24-bit significands and exponents spanning 2^-100..2^100,
    both signs, zero and powers of two."""
    rng = np.random.default_rng(16)
    sig = (rng.integers(2 ** 23, 2 ** 24, size=20000) / 2.0 ** 23)
    x = rng.choice([-1.0, 1.0], size=20000) * np.ldexp(
        sig, rng.integers(-100, 101, size=20000))
    x = np.concatenate([x, [0.0, 1.0, -2.0 ** -90, 2.0 ** 100,
                            1 + 2.0 ** -23, -(2 - 2.0 ** -22)]])
    xt = torch.from_numpy(x.astype(np.float32))
    assert torch.equal(xt.double(), torch.from_numpy(x))  # exact in fp32
    hi, mid, lo = _split3(xt)
    for part in (hi, mid, lo):
        assert torch.equal(part.to(torch.bfloat16).float(), part)
    assert torch.equal((hi + (mid + lo)).view(torch.int32),
                       xt.view(torch.int32))
    assert (lo != 0).any() and (mid != 0).any()


@pytest.mark.parametrize("scale", [0.37, 3.0e-3])
def test_nibble_bf16_bits_equal_dequantized_codes(scale):
    """The direct nibble -> bf16 bit rule equals dequantize_log2(code) /
    scale, in both packages, for all 16 codes."""
    from repro.quant.log2 import dequantize_log2 as j_dequant
    from repro_torch.quant.log2 import dequantize_log2, unpack_nibbles

    packed = np.array([[lo | hi << 4 for lo in range(16) for hi in (lo, 15 - lo)]],
                      dtype=np.uint8)
    got = _decoded_p(packed)
    s = torch.tensor(np.float32(scale))
    codes = unpack_nibbles(torch.from_numpy(packed))
    assert sorted(set(codes.flatten().tolist())) == list(range(-8, 8))
    assert torch.equal(got, dequantize_log2(codes, s) / s)
    jw = np.array(j_dequant(jnp.asarray(codes.numpy()), jnp.float32(scale)))
    assert torch.equal(got, torch.from_numpy(jw) / s)


@pytest.mark.parametrize("M,K,N", [(8, 32, 16), (100, 64, 130),
                                   (256, 128, 512), (1, 256, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_log2_matmul_contract_matches_reference(M, K, N, dtype):
    """scale * sum_parts (x_part @ P), the kernels' bit contract, against
    the Pallas kernel in interpret mode at test_log2_matmul_matches_
    reference's shapes and tolerance; rows of the identity give the
    decoded weights bit for bit."""
    rng = np.random.default_rng(M + N + 1)
    packed, s = _packed(rng, K, N)
    x = rng.normal(size=(M, K)).astype(np.float32)
    want = j_log2_matmul(jnp.asarray(x, getattr(jnp, dtype)),
                         jnp.asarray(packed), jnp.float32(s), bm=64, bn=64,
                         interpret=True)
    got = _contract(torch.from_numpy(x).to(getattr(torch, dtype)), packed, s)
    tol = 1e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol * 10)
    from repro_torch.quant.log2 import dequantize_log2, unpack_nibbles

    rows = rng.choice(K, size=min(M, K), replace=False)
    eye = torch.eye(K)[torch.from_numpy(rows)].to(getattr(torch, dtype))
    w = dequantize_log2(unpack_nibbles(torch.from_numpy(packed)),
                        torch.tensor(s))
    assert torch.equal(_contract(eye, packed, s), w[torch.from_numpy(rows)])


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
