"""The port's CUDA kernels against their plain PyTorch versions on an
NVIDIA GPU.  ``tcn_block`` (strip and chunk entries) and
``proto_extract`` share their plain versions' summation order and are
compared bit for bit; ``log2_matmul``
and ``dilated_conv`` are compared at the JAX tests' tolerances with the
plain products in full fp32 (TF32 switched off around them).
Marked ``cuda``; every test skips when no card is present.  This file
imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.dilated_conv import dilated_conv  # noqa: E402
from repro_torch.kernels.log2_matmul import (  # noqa: E402
    DECODE_MAX_M,
    log2_matmul,
)
from repro_torch.kernels.proto_extract import proto_extract  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    dilated_conv_ref,
    log2_matmul_ref,
    proto_extract_ref,
    tcn_block_fused,
    tcn_chunk_plain,
)
from repro_torch.kernels.tcn_block import tcn_block, tcn_chunk  # noqa: E402
from repro_torch.models.tcn import _bake_weight  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.fixture
def no_tf32(dev):
    """Full-fp32 library products for the plain versions, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield dev
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = old


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


# tcn_chunk at the CPU tests' sizes: 4 blocks of C=8, k=7, d = 1..8
# (rings of 6..48 rows), Cin=2 into block 0
CHUNK_WIDTHS, CHUNK_K = ((2, 8), (8, 8), (8, 8), (8, 8)), 7


def _chunk_case(seed, S, T, *, packed, dev):
    """Block params, a grid whose step counters sit just before, at and
    after every ring's wrap, a chunk and ragged lengths (0 and T among
    them)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.tensor(rng.normal(size=s).astype(np.float32)).to(dev)
    k = CHUNK_K
    blocks, rings, times = {}, {}, [0]
    for i, (cin, C) in enumerate(CHUNK_WIDTHS):
        n = (k - 1) * 2 ** i
        blocks[f"b{i}"] = _block(seed + i, 1, 1, cin, C, k, 2 ** i,
                                 packed=packed, with_down=cin != C, dev=dev)[2]
        rings[f"b{i}"] = {"ring1": f(S, n, cin), "ring2": f(S, n, C)}
        times += [n - 1, n, n + 1]
    t = torch.tensor([times[i % len(times)] for i in range(S)],
                     dtype=torch.int32, device=dev)
    lengths = torch.tensor(rng.integers(0, T + 1, size=S), dtype=torch.int32,
                           device=dev)
    lengths[0], lengths[1] = 0, T
    return blocks, {"t": t, "blocks": rings}, f(S, T, CHUNK_WIDTHS[0][0]), lengths


def _grid_equal(a, b) -> bool:
    return torch.equal(a["t"], b["t"]) and all(
        torch.equal(a["blocks"][n][r], b["blocks"][n][r])
        for n in a["blocks"] for r in ("ring1", "ring2"))


def _grid_clone(g):
    return {"t": g["t"].clone(), "blocks": {
        n: {r: v.clone() for r, v in d.items()} for n, d in g["blocks"].items()}}


@pytest.mark.parametrize("packed,quantize", [(False, False), (False, True),
                                             (True, False), (True, True)])
@pytest.mark.parametrize("T", [1, 2, 7, 16, 40])
def test_tcn_chunk_kernel_matches_plain(dev, T, packed, quantize):
    blocks, grid, x, lengths = _chunk_case(T, 13, T, packed=packed, dev=dev)
    kw = dict(k=CHUNK_K, quantize=quantize)
    want, hr = tcn_chunk_plain(blocks, grid, x, lengths, **kw)
    before = _grid_clone(grid)
    launches = tcn_chunk.launches
    got, h = tcn_chunk(blocks, grid, x, lengths, **kw)
    torch.cuda.synchronize()
    assert tcn_chunk.launches == launches + 1
    assert _grid_equal(grid, before)  # the functional call leaves it alone
    # same summation order, no FMA contraction: equal bits
    assert torch.equal(h, hr) and _grid_equal(got, want)
    out, h2 = tcn_chunk(blocks, grid, x, lengths, inplace=True, **kw)
    torch.cuda.synchronize()
    assert tcn_chunk.launches == launches + 2
    assert out is grid and torch.equal(h2, hr) and _grid_equal(grid, want)


def test_tcn_chunk_rejects_a_chunk_too_long(dev):
    from repro_torch.kernels.tcn_block import max_chunk_len

    widths = [((CHUNK_K - 1) * 2 ** i, cin, C, cin != C)
              for i, (cin, C) in enumerate(CHUNK_WIDTHS)]
    T = max_chunk_len(widths, CHUNK_K) + 1
    blocks, grid, x, lengths = _chunk_case(0, 2, T, packed=False, dev=dev)
    launches = tcn_chunk.launches
    with pytest.raises(ValueError, match="shared memory"):
        tcn_chunk(blocks, grid, x, lengths, k=CHUNK_K)
    assert tcn_chunk.launches == launches


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


def _packed(rng, K, N, dev):
    from repro_torch.models.tcn import _bake_weight

    w = torch.tensor((rng.normal(size=(K, N)) * 0.05).astype(np.float32))
    p = _bake_weight(w, True)[1]
    return p["codes"].to(dev), p["scale"].to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", [(8, 32, 16), (100, 64, 130), (1, 256, 64),
                                   (16, 2048, 8192), (70, 300, 258)])
def test_log2_matmul_kernel_matches_plain(no_tf32, M, K, N, dtype):
    dev = no_tf32
    rng = np.random.default_rng(M + K + N)
    codes, scale = _packed(rng, K, N, dev)
    x = torch.tensor(rng.normal(size=(M, K)).astype(np.float32)).to(dev, dtype)
    before = log2_matmul.launches
    got = log2_matmul(x, codes, scale)
    want = log2_matmul_ref(x, codes, scale)
    torch.cuda.synchronize()
    assert log2_matmul.launches == before + 1
    # bf16 x is upcast exactly on both sides: one fp32 tolerance (JAX test's)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", [1, 4, 16, 64, 100, 256])
@pytest.mark.parametrize("K,N", [(2048, 2048), (520, 130), (96, 258)])
def test_log2_matmul_both_paths_match_plain(no_tf32, M, K, N, dtype):
    """The decode path (M <= DECODE_MAX_M) and the tile path, ragged N
    (130, 258: not a multiple of a tile or a 16-byte load) included."""
    dev = no_tf32
    rng = np.random.default_rng(7 * M + K + N)
    codes, scale = _packed(rng, K, N, dev)
    x = torch.tensor(rng.normal(size=(M, K)).astype(np.float32)).to(dev, dtype)
    got = log2_matmul(x, codes, scale)
    want = log2_matmul_ref(x, codes, scale)
    torch.cuda.synchronize()
    assert (M <= DECODE_MAX_M) == (M in (1, 4))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("M,K,N", [(1, 2048, 2048), (4, 2048, 2048),
                                   (2, 8192, 8192), (3, 300, 130)])
def test_log2_matmul_decode_path_repeats_and_decodes_exactly(dev, M, K, N):
    """The decode path gives the same bits on every run (its lanes' and
    warps' sums are added in a fixed order, no atomics), and rows of the
    identity give the decoded W bit for bit."""
    from repro_torch.quant.log2 import dequantize_log2, unpack_nibbles

    rng = np.random.default_rng(M + N)
    codes, scale = _packed(rng, K, N, dev)
    x = torch.tensor(rng.normal(size=(M, K)).astype(np.float32)).to(dev)
    first = log2_matmul(x, codes, scale)
    for _ in range(3):
        assert torch.equal(log2_matmul(x, codes, scale), first)
    rows = torch.from_numpy(rng.choice(K, size=M, replace=False)).to(dev)
    eye = torch.eye(K, device=dev)[rows]
    w = dequantize_log2(unpack_nibbles(codes), scale)
    assert torch.equal(log2_matmul(eye, codes, scale), w[rows])
    assert torch.equal(log2_matmul(eye.to(torch.bfloat16), codes, scale),
                       w[rows])


def test_log2_matmul_identity_decodes_bit_exact(dev):
    from repro_torch.quant.log2 import dequantize_log2, unpack_nibbles

    codes, scale = _packed(np.random.default_rng(0), 256, 256, dev)
    got = log2_matmul(torch.eye(256, device=dev), codes, scale)
    assert torch.equal(got, dequantize_log2(unpack_nibbles(codes), scale))


@pytest.mark.parametrize("d", [1, 64, 2048])
@pytest.mark.parametrize("Cin", [1, 24])
def test_dilated_conv_audio_shapes_match_plain(no_tf32, Cin, d):
    """The audio preset's 24-channel convs (K=7, Cout=24) over 1 s clips,
    held to the plain version and causal bit for bit."""
    dev = no_tf32
    B, T, K = 2, 16_000, 7
    rng = np.random.default_rng(d + Cin)
    f = lambda *s: torch.tensor(rng.normal(size=s).astype(np.float32)).to(dev)
    x, w, b = f(B, T, Cin), f(K, Cin, 24) * (K * Cin) ** -0.5, f(24) * 0.1
    got = dilated_conv(x, w, b, d)
    torch.testing.assert_close(got, dilated_conv_ref(x, w, b, d), rtol=1e-4,
                               atol=1e-4)
    t0 = T - 3 * d // 2 - 5
    x2 = x.clone()
    x2[:, t0:] = -7.0
    y2 = dilated_conv(x2, w, b, d)
    assert torch.equal(y2[:, :t0], got[:, :t0])
    assert not torch.equal(y2[:, t0:], got[:, t0:])
    assert torch.equal(dilated_conv(x, w, b, d), got)


@pytest.mark.parametrize("B,T,Cin,Cout,K,d", [
    (2, 37, 4, 8, 3, 1), (1, 200, 8, 100, 2, 16), (2, 20, 4, 100, 7, 8),
    (2, 3000, 24, 24, 7, 256), (3, 500, 1, 24, 1, 1), (2, 64, 40, 33, 3, 2)])
def test_dilated_conv_kernel_matches_plain(no_tf32, B, T, Cin, Cout, K, d):
    dev = no_tf32
    rng = np.random.default_rng(T + Cout)
    f = lambda *s: torch.tensor(rng.normal(size=s).astype(np.float32)).to(dev)
    x, w, b = f(B, T, Cin), f(K, Cin, Cout) * (K * Cin) ** -0.5, f(Cout) * 0.1
    before = dilated_conv.launches
    got = dilated_conv(x, w, b, d)
    want = dilated_conv_ref(x, w, b, d)
    torch.cuda.synchronize()
    assert dilated_conv.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    x2 = x.clone()
    x2[:, T // 2:] = 123.0
    assert torch.equal(dilated_conv(x2, w, b, d)[:, :T // 2], got[:, :T // 2])


def test_new_kernels_reject_bad_operands(dev):
    codes, scale = _packed(np.random.default_rng(1), 32, 16, dev)
    x = torch.ones(4, 32, device=dev)
    with pytest.raises(ValueError):
        log2_matmul(x.double(), codes, scale)
    with pytest.raises(ValueError):
        log2_matmul(x, codes.cpu(), scale)
    with pytest.raises(ValueError):
        log2_matmul(torch.ones(4, 31, device=dev), codes, scale)
    w = torch.ones(3, 2, 4, device=dev)
    with pytest.raises(ValueError):
        dilated_conv(torch.ones(1, 5, 3, device=dev), w, torch.zeros(4, device=dev), 1)
    with pytest.raises(ValueError):
        dilated_conv(torch.ones(1, 5, 2, device=dev), w, torch.zeros(4), 1)


@pytest.mark.parametrize("name,limit", [("chameleon-tcn", 313),
                                        ("chameleon-tcn-audio", 222)])
def test_service_long_tick_equals_short_ticks(dev, name, limit):
    """StreamSessionService(t_chunk=784) on the card: one whole 784-sample
    push per session is one tick of ⌈784/limit⌉ tcn_chunk launches, bit
    for bit equal to t_chunk=16 (embeddings, logits, slot grid)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_tcn_bundle
    from repro_torch.sessions import StreamSessionService

    cfg = get_config(name)
    bundle = build_tcn_bundle(cfg, dev)
    params = bundle.init(torch.Generator().manual_seed(5))
    params["fc"]["w"] = torch.randn(
        params["fc"]["w"].shape, generator=torch.Generator().manual_seed(6)
    ).to(dev)
    from repro_torch.models.tcn import tcn_empty_state

    bn = tcn_empty_state(cfg, dev)
    L = 784
    x = np.random.default_rng(8).normal(
        size=(3, L, cfg.tcn_in_channels)).astype(np.float32)
    runs = []
    for t_chunk in (L, 16):
        svc = StreamSessionService(bundle, params, bn, n_slots=3,
                                   t_chunk=t_chunk)
        sids = [svc.open_session() for _ in range(3)]
        before = tcn_chunk.launches
        res = svc.push_audio({sid: x[i] for i, sid in enumerate(sids)})
        torch.cuda.synchronize()
        ticks = 1 if t_chunk == L else L // 16
        per_tick = -(-L // limit) if t_chunk == L else 1
        assert svc.dispatches == ticks
        assert tcn_chunk.launches - before == ticks * per_tick
        runs.append(([res[s] for s in sids], svc.states))
    (long, lg), (short, sg) = runs
    for a, b in zip(long, short):
        assert np.isfinite(a["emb"]).all()
        for key in ("emb", "logits"):
            assert np.array_equal(a[key], b[key])
    assert _grid_equal(lg, sg)
