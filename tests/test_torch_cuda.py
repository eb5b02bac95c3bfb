"""The port's CUDA kernels against their plain PyTorch versions on an
NVIDIA GPU (TF32 plays no part: neither side calls a library product).
Marked ``cuda``; every test skips when no card is present.  This file
imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.proto_extract import proto_extract  # noqa: E402
from repro_torch.kernels.ref import proto_extract_ref, tcn_block_fused  # noqa: E402
from repro_torch.kernels.tcn_block import tcn_block  # noqa: E402
from repro_torch.models.tcn import _bake_weight  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _block(seed, S, T, Cin, C, k, d, *, packed, with_down, dev):
    rng = np.random.default_rng(seed)
    n = (k - 1) * d
    f = lambda *s: torch.tensor(rng.normal(size=s).astype(np.float32)).to(dev)
    p = {"conv1_w": f(k, Cin, C) * 0.3, "conv1_b": f(C) * 0.1,
         "conv2_w": f(k, C, C) * 0.2, "conv2_b": f(C) * 0.1}
    if with_down:
        p["down_w"], p["down_b"] = f(1, Cin, C) * 0.5, f(C) * 0.1
    if packed:
        for key in ("conv1_w", "conv2_w", "down_w"):
            if key in p:
                p[key] = _bake_weight(p[key], True)[1]
    return f(S, n + T, Cin), f(S, n, C), p


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("Cin,with_down,d", [(1, True, 1), (32, False, 8),
                                              (32, False, 64)])
def test_tcn_block_kernel_matches_plain(dev, quantize, Cin, with_down, d):
    strip1, hist2, p = _block(d, 4, 16, Cin, 32, 7, d, packed=quantize,
                              with_down=with_down, dev=dev)
    before = tcn_block.launches
    h, mid = tcn_block(strip1, hist2, p, dilation=d, k=7, quantize=quantize)
    hr, mr = tcn_block_fused(strip1, hist2, p, dilation=d, k=7,
                             quantize=quantize)
    torch.cuda.synchronize()
    assert tcn_block.launches == before + 1
    # same summation order, no FMA contraction: equal bits
    assert torch.equal(h, hr) and torch.equal(mid, mr)


def test_tcn_block_rejects_bad_operands(dev):
    strip1, hist2, p = _block(0, 2, 4, 32, 32, 7, 1, packed=False,
                              with_down=False, dev=dev)
    with pytest.raises(ValueError):
        tcn_block(strip1.double(), hist2, p, dilation=1, k=7)
    with pytest.raises(ValueError):
        tcn_block(strip1, hist2.cpu(), p, dilation=1, k=7)
    with pytest.raises(ValueError):
        tcn_block(strip1.transpose(1, 2).contiguous().transpose(1, 2), hist2,
                  p, dilation=1, k=7)


@pytest.mark.parametrize("n_ways,k", [(5, 1), (5, 5), (37, 3)])
def test_proto_extract_kernel_matches_plain(dev, n_ways, k):
    labels = np.repeat(np.arange(n_ways), k)
    emb = torch.tensor(np.random.default_rng(k).normal(
        size=(len(labels), 64)).astype(np.float32)).to(dev)
    onehot = torch.tensor((labels[None] == np.arange(n_ways)[:, None]).astype(
        np.float32)).to(dev)
    before = proto_extract.launches
    w, b = proto_extract(emb, onehot, k)
    wr, br = proto_extract_ref(emb, onehot, k)
    torch.cuda.synchronize()
    assert proto_extract.launches == before + 1
    assert torch.equal(w, wr)
    torch.testing.assert_close(b, br, rtol=1e-5, atol=1e-6)
