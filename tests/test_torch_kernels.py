"""The port's kernel modules on the CPU: the plain versions that the
``tcn_block`` and ``proto_extract`` wrappers run for CPU tensors, held
against the JAX Pallas kernels in interpret mode (fp32 tolerance
rtol=2e-4, atol=2e-5, the repo's precedent), against the port's own
per-position oracle (bit-exact), and the backend resolution and build
layer that keep a CUDA tensor on the kernel.  The kernels themselves are
held against these plain versions on a card by tests/test_torch_cuda.py
and chip_smoke.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.proto_extract import proto_extract as j_proto_extract  # noqa: E402
from repro.kernels.tcn_block import tcn_block_pallas  # noqa: E402
from repro.quant.log2 import pack_nibbles as j_pack  # noqa: E402
from repro.quant.log2 import quantize_log2 as j_quant  # noqa: E402
from repro_torch.kernels import _build, dispatch  # noqa: E402
from repro_torch.kernels.proto_extract import (  # noqa: E402
    proto_extract,
    proto_extract_labels,
)
from repro_torch.kernels.ref import (  # noqa: E402
    expand_weight,
    proto_extract_ref,
    tcn_block_fused,
    tcn_block_ref,
)
from repro_torch.kernels.tcn_block import tcn_block  # noqa: E402

RTOL, ATOL = 2e-4, 2e-5


def _block_np(seed, S, T, Cin, C, k, d, *, packed, with_down):
    """Random strips and a baked-layout block dict, as numpy (the same
    inputs go to both packages)."""
    rng = np.random.default_rng(seed)
    n = (k - 1) * d
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    strip1, hist2 = f(S, n + T, Cin), f(S, n, C)

    def w(*shape):
        a = f(*shape) * 0.3
        if not packed:
            return a
        s = np.float32(np.abs(a).max())
        q = j_quant(jnp.asarray(a), jnp.float32(s))
        return {"codes": np.asarray(j_pack(q)), "scale": np.asarray(s)}

    p = {"conv1_w": w(k, Cin, C), "conv1_b": f(C) * 0.1,
         "conv2_w": w(k, C, C), "conv2_b": f(C) * 0.1}
    if with_down:
        p["down_w"] = w(1, Cin, C)
        p["down_b"] = f(C) * 0.1
    return strip1, hist2, p


def _to_torch(tree, device="cpu"):
    if isinstance(tree, dict):
        return {k: _to_torch(v, device) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree)).to(device)


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree)


@pytest.mark.parametrize("d,quantize,with_down", [
    (1, False, True), (1, True, True), (2, False, False), (4, True, False)])
def test_tcn_block_matches_pallas_interpret(d, quantize, with_down):
    k, S, T, C = 3, 2, 6, 8
    Cin = 3 if with_down else C
    strip1, hist2, p = _block_np(d + 10 * quantize, S, T, Cin, C, k, d,
                                 packed=quantize, with_down=with_down)
    hj, mj = tcn_block_pallas(jnp.asarray(strip1), jnp.asarray(hist2),
                              _to_jax(p), dilation=d, k=k, quantize=quantize,
                              interpret=True)
    ht, mt = tcn_block(torch.tensor(strip1), torch.tensor(hist2),
                       _to_torch(p), dilation=d, k=k, quantize=quantize)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("d", [1, 2, 8])
@pytest.mark.parametrize("T", [1, 7, 20])
@pytest.mark.parametrize("quantize", [False, True])
def test_fused_equals_per_position_oracle(d, T, quantize):
    """Inside the port the batched plain version and the per-position
    oracle sum in the same order: bit-exact."""
    k, C = 3, 8
    strip1, hist2, p = _block_np(100 + d + T, 2, T, 1, C, k, d,
                                 packed=quantize, with_down=True)
    pt = _to_torch(p)
    h, mid = tcn_block_fused(torch.tensor(strip1), torch.tensor(hist2), pt,
                             dilation=d, k=k, quantize=quantize)
    hr, mr = tcn_block_ref(torch.tensor(strip1), torch.tensor(hist2),
                           expand_weight(pt["conv1_w"]), pt["conv1_b"],
                           expand_weight(pt["conv2_w"]), pt["conv2_b"],
                           expand_weight(pt["down_w"]), pt["down_b"],
                           dilation=d, k=k, quantize=quantize)
    assert torch.equal(h, hr) and torch.equal(mid, mr)


@pytest.mark.parametrize("d", [1, 4])
def test_block_output_independent_of_chunk_length(d):
    """A position's output does not depend on how many positions follow
    it in the chunk — what makes chunk-size invariance exact."""
    k, C, T = 3, 8, 12
    strip1, hist2, p = _block_np(7 + d, 3, T, C, C, k, d, packed=False,
                                 with_down=False)
    s1, h2, pt = torch.tensor(strip1), torch.tensor(hist2), _to_torch(p)
    h, mid = tcn_block(s1, h2, pt, dilation=d, k=k)
    n = (k - 1) * d
    for t_short in (1, 5):
        hs, ms = tcn_block(s1[:, :n + t_short].contiguous(), h2, pt,
                           dilation=d, k=k)
        assert torch.equal(hs, h[:, :t_short])
        assert torch.equal(ms, mid[:, :t_short])


@pytest.mark.parametrize("shots", [[1] * 5, [5] * 5, [1, 3, 2, 4, 1, 2, 3]])
def test_proto_extract_matches_pallas_interpret(shots):
    N, V = len(shots), 16
    rng = np.random.default_rng(sum(shots))
    labels = np.repeat(np.arange(N), shots)
    emb = rng.normal(size=(len(labels), V)).astype(np.float32)
    onehot = (labels[None, :] == np.arange(N)[:, None]).astype(np.float32)
    k = max(shots)
    wj, bj = j_proto_extract(jnp.asarray(emb), jnp.asarray(onehot), k,
                             bn=8, interpret=True)
    wt, bt = proto_extract(torch.tensor(emb), torch.tensor(onehot), k)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=RTOL, atol=ATOL)
    wr, br = jref.proto_extract_ref(jnp.asarray(emb), jnp.asarray(onehot), k)
    np.testing.assert_allclose(bt.numpy(), np.asarray(br), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("labels", [[0, 1, 2, 1, 0, 2, 2],
                                    [2, -1, 0, 3, 1, 1, 7, 0]])
def test_proto_extract_labels_matches_pallas_interpret(labels):
    """The label entry against the Pallas kernel on jax.nn.one_hot of the
    labels (a label outside [0, N) a zero column); on the CPU it equals the
    one-hot entry on the comparison one-hot bit for bit."""
    N, V, k = 3, 16, 3
    labels = np.asarray(labels, np.int32)
    emb = np.random.default_rng(len(labels)).normal(
        size=(len(labels), V)).astype(np.float32)
    onehot = jax.nn.one_hot(jnp.asarray(labels), N, dtype=jnp.float32).T
    wj, bj = j_proto_extract(jnp.asarray(emb), onehot, k, bn=8,
                             interpret=True)
    for ldtype in (torch.int32, torch.int64):
        wt, bt = proto_extract_labels(torch.tensor(emb),
                                      torch.tensor(labels).to(ldtype), N, k)
        np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=RTOL,
                                   atol=ATOL)
        wr, br = proto_extract(torch.tensor(emb),
                               torch.tensor(np.asarray(onehot)), k)
        assert torch.equal(wt, wr) and torch.equal(bt, br)


def test_cpu_wrappers_count_no_launch():
    """On CPU tensors the wrappers run the plain versions and launch
    nothing, so the launch counters stay put."""
    before = (tcn_block.launches, proto_extract.launches)
    strip1, hist2, p = _block_np(3, 1, 4, 8, 8, 3, 1, packed=False,
                                 with_down=False)
    tcn_block(torch.tensor(strip1), torch.tensor(hist2), _to_torch(p),
              dilation=1, k=3)
    proto_extract(torch.ones(2, 4), torch.eye(2), 1)
    assert (tcn_block.launches, proto_extract.launches) == before
    w, b = proto_extract(torch.ones(2, 4), torch.eye(2), 1)
    wr, br = proto_extract_ref(torch.ones(2, 4), torch.eye(2), 1)
    assert torch.equal(w, wr) and torch.equal(b, br)


def test_dispatch_resolves_from_the_device(monkeypatch):
    monkeypatch.delenv(dispatch.ENV_VAR, raising=False)
    assert dispatch.resolve("auto", "cpu") == "ref"
    assert dispatch.resolve(None, "cuda") == "cuda"
    assert dispatch.resolve("ref", "cpu") == "ref"
    with pytest.raises(ValueError):
        dispatch.resolve("cuda", "cpu")
    with pytest.raises(ValueError):
        dispatch.resolve("ref", "cuda")
    with pytest.raises(ValueError):
        dispatch.resolve("mosaic", "cpu")
    monkeypatch.setenv(dispatch.ENV_VAR, "cuda")
    assert dispatch.ENV_VAR == "REPRO_TORCH_KERNEL_BACKEND"
    with pytest.raises(ValueError):
        dispatch.resolve("auto", "cpu")
    assert dispatch.resolve("ref", "cpu") == "ref"  # explicit beats env


def test_build_layer_raises_without_nvcc(monkeypatch, tmp_path):
    """No compiler means an error, never a silent fallback; the build
    directory follows its environment variable."""
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "kb"))
    assert _build.build_dir() == tmp_path / "kb"
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build_all()
    assert set(_build.SOURCES) == {"tcn_block", "proto_extract", "log2_matmul",
                                   "dilated_conv"}
    for src in _build.SOURCES.values():
        assert (_build.CSRC / src).exists()
