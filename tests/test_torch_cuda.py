"""The port's CUDA kernels against their plain PyTorch versions on an
NVIDIA GPU.  ``tcn_block`` (strip and chunk entries, at the CPU tests'
widths and at ``chameleon-tcn-kws``'s) and ``proto_extract`` share their
plain versions' summation order and are compared bit for bit;
``log2_matmul`` and ``dilated_conv`` are compared at the JAX tests'
tolerances with the plain products in full fp32 (TF32 switched off around
them).  The continual-learning service (paged and dense tenant banks,
park/unpark, rehearsal) is held bit for bit between its two bank layouts
at the CL demo's widths, and the serving layer at chameleon-tcn's width:
the ServingPlane through a crash and a drain, spill/restore, and
TCNStreamServer, each bit for bit against a synchronous control.  The
dense LM family (olmo-1b and qwen2.5-32b cut narrow): t_chunk 16 == 1,
paged == dense, park/resume and spill/restore bit for bit, the chunk
schedule at its contract, and the baked bf16 tree equal to the per-use
cast; the same invariants for the MoE family (deepseek-v2-lite-16b with
MLA, moonshot-v1-16b-a3b, cut narrow), the MoE FFN on the card against
itself on the CPU (routing, top-k tie order and drop mask exact), and
speculative decoding (scan mode equal to plain decode, parallel mode
paged == dense); the recurrent families (rwkv6-1.6b and zamba2-1.2b cut
narrow): the same invariants, a masked lane's cache frozen by value, the
baked tree, and the alive-masked verify scans equal to plain decode; the
vlm and encoder-decoder families (internvl2-76b and seamless-m4t-large-v2
cut narrow): prefill, decode and embed on the card against the CPU (the
chunked non-causal encoder too), the service invariants, the cross
leaves' pass-through equal to ``lane_select`` bit for bit, and
``proto_extract`` at their embedding widths (V = 1024, 8192).
``proto_extract``'s one-hot and label entries are held against the plain
version at every shape its clusters, slab chunks, column tiles and
unaligned copies take, labels outside [0, N) included; b repeats bit for
bit at V = 8192; and ``adapt`` runs one device op, the kernel.
Marked ``cuda``; every test skips when no card is present.  This file
imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.data import arch_batch  # noqa: E402
from repro_torch.kernels.dilated_conv import dilated_conv  # noqa: E402
from repro_torch.kernels.log2_matmul import (  # noqa: E402
    DECODE_MAX_M,
    log2_matmul,
)
from repro_torch.kernels.proto_extract import (  # noqa: E402
    proto_extract,
    proto_extract_labels,
)
from repro_torch.kernels.ref import (  # noqa: E402
    dilated_conv_ref,
    log2_matmul_ref,
    proto_extract_ref,
    tcn_block_fused,
    tcn_chunk_plain,
)
from repro_torch.kernels.tcn_block import tcn_block, tcn_chunk  # noqa: E402
from repro_torch.models.tcn import _bake_weight  # noqa: E402
from repro_torch.sessions import StreamSessionService  # noqa: E402

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
@pytest.mark.parametrize("Cin,C,k,with_down,d", [
    (1, 32, 7, True, 1), (32, 32, 7, False, 8), (32, 32, 7, False, 64),
    (28, 24, 3, True, 1), (24, 24, 3, False, 8)])  # chameleon-tcn, -kws
def test_tcn_block_kernel_matches_plain(dev, quantize, Cin, C, k, with_down,
                                        d):
    strip1, hist2, p = _block(d, 4, 16, Cin, C, k, d, packed=quantize,
                              with_down=with_down, dev=dev)
    before = tcn_block.launches
    h, mid = tcn_block(strip1, hist2, p, dilation=d, k=k, quantize=quantize)
    hr, mr = tcn_block_fused(strip1, hist2, p, dilation=d, k=k,
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
# (rings of 6..48 rows), Cin=2 into block 0; and at chameleon-tcn-kws's:
# 4 blocks of 24 channels, k=3, Cin=28 (rings of 2..16 rows)
CHUNK_WIDTHS, CHUNK_K = ((2, 8), (8, 8), (8, 8), (8, 8)), 7
KWS_WIDTHS, KWS_K = ((28, 24), (24, 24), (24, 24), (24, 24)), 3


def _chunk_case(seed, S, T, *, packed, dev, widths=CHUNK_WIDTHS, k=CHUNK_K):
    """Block params, a grid whose step counters sit just before, at and
    after every ring's wrap, a chunk and ragged lengths (0 and T among
    them)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.tensor(rng.normal(size=s).astype(np.float32)).to(dev)
    blocks, rings, times = {}, {}, [0]
    for i, (cin, C) in enumerate(widths):
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
    return blocks, {"t": t, "blocks": rings}, f(S, T, widths[0][0]), lengths


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
@pytest.mark.parametrize("widths,k", [(CHUNK_WIDTHS, CHUNK_K),
                                      (KWS_WIDTHS, KWS_K)], ids=["small", "kws"])
def test_tcn_chunk_kernel_matches_plain(dev, widths, k, T, packed, quantize):
    blocks, grid, x, lengths = _chunk_case(T, 13, T, packed=packed, dev=dev,
                                           widths=widths, k=k)
    kw = dict(k=k, quantize=quantize)
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


def _proto_case(seed, shots, V, dev, outliers=False, offset=0):
    """Embeddings and labels for ``shots[j]`` shots of way j, shuffled;
    with ``outliers``, two more shots labelled -1 and N (no way's).
    ``offset`` floats in front of emb's storage (offset 1: not 16-byte
    aligned, the kernel's 4-byte copies)."""
    rng = np.random.default_rng(seed)
    N = len(shots)
    labels = np.repeat(np.arange(N), shots)
    if outliers:
        labels = np.concatenate([labels, [-1, N]])
    labels = labels[rng.permutation(len(labels))]
    flat = torch.tensor(rng.normal(size=offset + len(labels) * V).astype(
        np.float32)).to(dev)
    emb = flat[offset:].view(len(labels), V)
    onehot = torch.tensor((labels[None] == np.arange(N)[:, None]).astype(
        np.float32)).to(dev)
    return emb, torch.tensor(labels).to(dev), onehot


def _check_proto_entries(emb, labels, onehot, k):
    """Both entries against the plain version: W bit for bit, b at rtol
    1e-5, atol 1e-6; labels as int32 and as int64; one launch each."""
    N = onehot.shape[0]
    wr, br = proto_extract_ref(emb, onehot, k)
    calls = [("onehot", lambda: proto_extract(emb, onehot, k))] + [
        (f"labels {dt}", lambda dt=dt: proto_extract_labels(
            emb, labels.to(dt), N, k)) for dt in (torch.int32, torch.int64)]
    for entry, call in calls:
        before = (proto_extract.launches, proto_extract_labels.launches)
        w, b = call()
        torch.cuda.synchronize()
        assert proto_extract.launches == before[0] + 1, entry
        assert proto_extract_labels.launches == before[1] + (
            entry != "onehot"), entry
        assert torch.equal(w, wr), entry
        torch.testing.assert_close(b, br, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n_ways,k", [(5, 1), (5, 5), (37, 3)])
@pytest.mark.parametrize("outliers", [False, True])
def test_proto_extract_kernel_matches_plain(dev, n_ways, k, outliers):
    """Both entries at V = 64: 5-way 1- and 5-shot (Nk = 5, 25) and 37
    ways of 3 shots, with and without labels outside [0, N)."""
    emb, labels, onehot = _proto_case(k, [k] * n_ways, 64, dev, outliers)
    _check_proto_entries(emb, labels, onehot, k)


@pytest.mark.parametrize("shots,V,offset", [
    ([1 + (j % 4) for j in range(37)], 64, 0),  # 1-4 shots a way
    ([1], 37, 0),                               # unaligned V, Nk = 1
    ([2, 1, 3], 37, 0),
    ([5] * 5, 64, 1),                           # emb not 16-byte aligned
    ([5] * 5, 1024, 0), ([10] * 5, 1024, 0),   # 3 and 5 slab chunks
    ([2, 1, 2], 20004, 0), ([2, 1, 2], 20001, 0),  # several tiles a CTA
])
@pytest.mark.parametrize("outliers", [False, True])
def test_proto_extract_ragged_shapes_match_plain(dev, shots, V, offset,
                                                 outliers):
    emb, labels, onehot = _proto_case(V + len(shots), shots, V, dev,
                                      outliers, offset)
    _check_proto_entries(emb, labels, onehot, max(shots))


def test_proto_extract_rejects_what_it_does_not_take(dev):
    emb = torch.zeros(4, 8, device=dev)
    bad = [lambda: proto_extract(emb, torch.zeros(2, 3, device=dev), 1),
           lambda: proto_extract(emb.T, torch.zeros(2, 8, device=dev), 1),
           lambda: proto_extract_labels(emb, torch.zeros(4, device=dev), 2, 1),
           lambda: proto_extract_labels(emb, torch.zeros(
               5, dtype=torch.int32, device=dev), 2, 1),
           lambda: proto_extract_labels(emb, torch.zeros(
               4, dtype=torch.int32), 2, 1),
           lambda: proto_extract_labels(emb, torch.zeros(
               4, dtype=torch.int32, device=dev), 0, 1)]
    before = proto_extract.launches
    for call in bad:
        with pytest.raises(ValueError):
            call()
    assert proto_extract.launches == before


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


# ---------------------------------------------------------------------------
# continual learning: paged == dense tenant banks on the card
# ---------------------------------------------------------------------------

def _cl_services(dev, max_ways):
    """A paged (16-way blocks) and a dense chameleon-tcn service with the
    same random weights, 8 sessions over 4 tenants."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_tcn_bundle

    cfg = get_config("chameleon-tcn")
    bundle = build_tcn_bundle(cfg, dev)
    params = bundle.init(torch.Generator().manual_seed(3))
    return [StreamSessionService(bundle, params, n_slots=8, max_tenants=4,
                                 max_ways=max_ways, paged_bank=paged,
                                 bank_block_ways=16, rehearsal_cap=4)
            for paged in (True, False)]


def _cl_tick(svcs, sids, x):
    outs = [svc.push_audio({sid: x[i] for i, sid in enumerate(s)})
            for svc, s in zip(svcs, sids)]
    torch.cuda.synchronize()
    for sp, sd in zip(*sids):
        for key in ("emb", "logits", "tenant_logits"):
            a, b = outs[0][sp][key], outs[1][sd][key]
            assert (a is None) == (b is None), key
            if a is not None:
                assert np.array_equal(a, b), key
    return outs


@pytest.mark.parametrize("max_ways", [8, 250, 256])
def test_paged_bank_equals_dense_on_card(dev, max_ways):
    """Tenant logits of the paged bank (tables 16, 256 and 256 wide) equal
    the dense bank's (8, 250 and 256 wide) bit for bit; parking a tenant's
    sessions takes its blocks out of the pool and resuming them continues
    bit-identically; a rehearsal rebuild on the card keeps the equality."""
    rng = np.random.default_rng(max_ways)
    svcs = _cl_services(dev, max_ways)
    sids = [[svc.open_session(tenant=i % 4) for i in range(8)] for svc in svcs]
    n = [max_ways, max_ways // 2, 3, 0]
    for t in range(4):
        for j in range(n[t]):
            e = rng.normal(size=(3, 64)).astype(np.float32)
            for svc, s in zip(svcs, sids):
                assert svc.enroll_shots(s[t], e, embedded=True) == j
    e = rng.normal(size=(2, 64)).astype(np.float32)
    for svc, s in zip(svcs, sids):
        svc.enroll_shots(s[0], e, embedded=True, way=max_ways - 1)
    x = lambda: rng.normal(size=(8, 16, 1)).astype(np.float32)
    out = _cl_tick(svcs, sids, x())
    tl = out[0][sids[0][1]]["tenant_logits"]
    assert tl.shape == (16, max_ways) and np.isfinite(tl[:, :n[1]]).all()
    assert np.isneginf(tl[:, n[1]:]).all()
    paged = svcs[0]
    live = paged.bankpool.pool.n_live
    for i in (1, 5):  # every session of tenant 1
        paged.park(sids[0][i])
    assert not paged.bankpool.is_resident(1)
    assert paged.bankpool.pool.n_live == live - -(-n[1] // 16)
    _cl_tick(svcs, sids, x())
    assert paged.bankpool.is_resident(1)
    for svc in svcs:
        assert svc.rehearse_tenant(0) == max_ways
    _cl_tick(svcs, sids, x())
    blobs = [svc.export_tenant(0) for svc in svcs]
    for key in ("s_sums", "counts"):
        assert np.array_equal(blobs[0][key], blobs[1][key])


# ---------------------------------------------------------------------------
# serving on the card: the plane, spill/restore, TCNStreamServer
# ---------------------------------------------------------------------------

def _serving(dev, seed=11):
    """chameleon-tcn at full width with random weights (FC too), and a
    factory of paged services of one geometry."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_tcn_bundle

    cfg = get_config("chameleon-tcn")
    bundle = build_tcn_bundle(cfg, dev)
    g = torch.Generator().manual_seed(seed)
    params = bundle.init(g)
    params["fc"]["w"] = torch.randn(params["fc"]["w"].shape,
                                    generator=g).to(dev) * 0.2

    def mk(**kw):
        return StreamSessionService(
            bundle, params, n_slots=8, max_tenants=8, max_ways=16,
            paged_bank=True, bank_block_ways=8, rehearsal_cap=4,
            max_sessions=32, **kw)

    return cfg, bundle, params, mk


def _chunks(rng, n_rounds):
    return [rng.normal(size=(int(rng.integers(1, 40)), 1)).astype(np.float32)
            for _ in range(n_rounds)]


def _same(a, b):
    for key in ("emb", "logits", "tenant_logits"):
        assert (a[key] is None) == (b[key] is None), key
        if a[key] is not None:
            assert np.array_equal(a[key], b[key]), key
    assert a["pred"] == b["pred"]


def test_plane_crash_and_drain_bit_identical_on_card(dev):
    """16 sessions (two tenants with two raw-shot ways each, the rest
    tenantless) over two workers, worker 0 crashing once; a drain of
    worker 1 between the two halves.  No session is lost and every result
    equals a synchronous control on one service of the same geometry."""
    import asyncio

    from repro_torch.obs import MetricsRegistry
    from repro_torch.serving import (FaultInjector, FaultPlan, Rejected,
                                     ServingPlane)

    _, _, _, mk = _serving(dev)
    rng = np.random.default_rng(0)
    N, R = 16, 6
    tenant = {i: (4 if i % 4 == 0 else 1 if i % 4 == 1 else None)
              for i in range(N)}  # tenants 4 and 1 hash to workers 0 and 1
    shots = {t: rng.normal(size=(2, 3, 64, 1)).astype(np.float32)
             for t in (4, 1)}
    data = {i: _chunks(rng, R) for i in range(N)}

    async def persist(op):
        for attempt in range(500):
            try:
                return await op()
            except Rejected as e:
                assert e.retryable
                await asyncio.sleep(0.001)
        raise AssertionError("retry budget spent")

    async def main():
        inj = FaultInjector(mk(), FaultPlan.parse("crash@9"), factory=mk)
        plane = ServingPlane([inj, mk()], metrics=MetricsRegistry(),
                             checkpoint_every=1)
        async with plane:
            psids = {}
            for i in range(N):
                kw = {} if tenant[i] is None else {"tenant": tenant[i]}
                psids[i] = await persist(lambda kw=kw: plane.open_session(**kw))
            for t in (4, 1):
                first = next(i for i in range(N) if tenant[i] == t)
                for s in shots[t]:
                    await persist(lambda s=s: plane.enroll(psids[first], s))
            outs = {i: [] for i in range(N)}

            async def client(i, rounds):
                for r in rounds:
                    outs[i].append(await persist(
                        lambda r=r: plane.push(psids[i], data[i][r])))

            await asyncio.gather(*(client(i, range(R // 2)) for i in range(N)))
            summary = await plane.drain(1)
            plane.undrain(1)
            await asyncio.gather(*(client(i, range(R // 2, R))
                                   for i in range(N)))
            return outs, plane.stats(), plane.metrics(), inj, summary

    outs, stats, m, inj, summary = asyncio.run(main())
    assert stats["lost_sessions"] == 0 and inj.crashes == 1
    assert m["plane_crashes_total"][0]["value"] == 1
    assert m["plane_recoveries_total"][0]["value"] == 1
    assert summary["moved_sessions"] > 0
    ctl = mk()
    sids = {i: ctl.open_session(**({} if tenant[i] is None
                                   else {"tenant": tenant[i]}))
            for i in range(N)}
    for t in (4, 1):
        first = next(i for i in range(N) if tenant[i] == t)
        for s in shots[t]:
            ctl.enroll_shots(sids[first], s)
    for i in range(N):
        for r in range(R):
            _same(outs[i][r], ctl.push({sids[i]: data[i][r]})[sids[i]])
    # a rebuilt worker bakes the same parameters as the first one
    fresh = mk()
    for a, b in zip(_leaves(inj.service._fused_params),
                    _leaves(fresh._fused_params)):
        assert torch.equal(a, b)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def test_spill_restore_bit_identical_on_card(dev, tmp_path):
    _, _, _, mk = _serving(dev)
    rng = np.random.default_rng(1)
    shots = rng.normal(size=(3, 64, 1)).astype(np.float32)
    x1 = rng.normal(size=(4, 50, 1)).astype(np.float32)
    x2 = rng.normal(size=(4, 64, 1)).astype(np.float32)
    runs = []
    for svc in (mk(), mk()):
        sids = [svc.open_session(tenant=i % 2) for i in range(4)]
        svc.enroll_shots(sids[0], shots)
        svc.push({s: x1[i] for i, s in enumerate(sids)})
        runs.append((svc, sids))
    (ctl, csids), (src, ssids) = runs
    path = str(tmp_path / "spill.npz")
    src.spill_parking(path, include_bound=True)
    fresh = mk()
    assert fresh.restore_parking(path) == ssids
    assert fresh.bankpool.pool.n_live == 0
    want = ctl.push({s: x2[i] for i, s in enumerate(csids)})
    got = fresh.push({s: x2[i] for i, s in enumerate(ssids)})
    torch.cuda.synchronize()
    for c, s in zip(csids, ssids):
        _same(got[s], want[c])


def test_tcn_stream_server_equals_bare_service_on_card(dev):
    import warnings

    from repro_torch.configs import get_config
    from repro_torch.models import build_tcn_bundle
    from repro_torch.serving import TCNStreamServer

    cfg = get_config("chameleon-tcn-kws")
    bundle = build_tcn_bundle(cfg, dev)
    params = bundle.init(torch.Generator().manual_seed(4))
    x = np.random.default_rng(2).normal(
        size=(8, 126, cfg.tcn_in_channels)).astype(np.float32)
    srv = TCNStreamServer(bundle, params, None, n_streams=8)
    shim = TCNStreamServer(bundle, params, None, n_streams=8)
    bare = StreamSessionService(bundle, params, n_slots=8, max_tenants=1,
                                max_ways=1)
    bsids = [bare.open_session() for _ in range(8)]
    for a in range(0, 126, 63):
        got = srv.push({s: x[i, a:a + 63] for i, s in enumerate(srv.sids)})
        want = bare.push({s: x[i, a:a + 63] for i, s in enumerate(bsids)})
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            embs, logits = shim.push_chunk(x[:, a:a + 63])
        for i, (s, b) in enumerate(zip(srv.sids, bsids)):
            _same(got[s], want[b])
            assert np.array_equal(embs[i], got[s]["emb"])
            assert np.array_equal(logits[i], got[s]["logits"])


# ---------------------------------------------------------------------------
# training on the card: determinism, resume, the trained embedder's kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows", [15, 25, 30])
def test_support_sums_repeats_bit_for_bit(dev, rows):
    """support_sums at the train phase's shapes (5 ways, V=64): the same
    inputs give the same bits every call."""
    from repro_torch.core.protonet import support_sums

    g = torch.Generator().manual_seed(rows)
    emb = (torch.randn(rows, 64, generator=g) * 10).to(dev)
    labels = torch.randperm(rows, generator=g).remainder(5).to(dev)
    first = support_sums(emb, labels, 5)
    for _ in range(200):
        assert torch.equal(support_sums(emb, labels, 5), first)


def _trained(dev, episodes=12, qat=4, seed=0):
    """chameleon-tcn meta-trained for a few 5-way 3-shot episodes of 28x28
    glyphs, then QAT: (cfg, bundle, ds, test classes, fp32 (params,
    state), QAT (params, state), one episode's tensors)."""
    from repro_torch.configs import get_config
    from repro_torch.data import EpisodicSampler, GlyphClasses, split_classes
    from repro_torch.models import build_tcn_bundle
    from repro_torch.models.tcn import tcn_empty_state
    from repro_torch.training.episodic import make_episode_step
    from repro_torch.training.optim import adamw

    cfg = get_config("chameleon-tcn")
    bundle = build_tcn_bundle(cfg, dev)
    params = bundle.init(torch.Generator().manual_seed(seed))
    state = tcn_empty_state(cfg, dev)
    ds = GlyphClasses(30, seed=seed)
    train_cls, test_cls = split_classes(30, 0.7, seed=seed)
    sampler = EpisodicSampler(ds, train_cls, seed=seed + 1)
    opt = adamw(2e-3)
    opt_state = opt[0](params)
    out = []
    for quantize, eps in ((False, range(episodes)),
                          (True, range(episodes, episodes + qat))):
        step = make_episode_step(cfg, opt, quantize=quantize)
        for ep in eps:
            batch = [torch.from_numpy(a).to(dev)
                     for a in sampler.episode(ep, 5, 3, 3)]
            params, state, opt_state, _, _ = step(params, state, opt_state,
                                                  *batch)
        out.append((params, state))
    return (cfg, bundle, ds, test_cls, *out, batch)


def test_train_step_repeats_bit_for_bit(dev):
    from repro_torch.training.episodic import make_episode_step
    from repro_torch.training.optim import adamw
    from repro_torch.utils.trees import tree_leaves

    cfg, _, _, _, (p, st), _, batch = _trained(dev, episodes=2, qat=0)
    opt = adamw(2e-3)
    for quantize in (False, True):
        step = make_episode_step(cfg, opt, quantize=quantize)
        a = step(p, st, opt[0](p), *batch)
        b = step(p, st, opt[0](p), *batch)
        assert all(torch.equal(x, y) for x, y in
                   zip(tree_leaves(list(a)), tree_leaves(list(b))))


def test_trainer_resume_is_bit_exact_on_card(dev, tmp_path):
    from repro_torch.configs import get_config
    from repro_torch.data import GlyphClasses
    from repro_torch.models import build_tcn_bundle
    from repro_torch.models.tcn import tcn_empty_state
    from repro_torch.training import TrainConfig, Trainer
    from repro_torch.utils.trees import tree_leaves

    cfg = get_config("chameleon-tcn")
    bundle = build_tcn_bundle(cfg, dev)
    params = bundle.init(torch.Generator().manual_seed(1))
    ds = GlyphClasses(5, seed=1)

    def data(i):
        x = np.concatenate([ds.sample(c, 4, seed=i) for c in range(5)])
        y = np.repeat(np.arange(5), 4).astype(np.int32)
        return {"x": torch.from_numpy(x.reshape(2, 10, 784, 1)).to(dev),
                "labels": torch.from_numpy(y.reshape(2, 10)).to(dev)}

    def trainer(d):
        return Trainer(bundle.loss_fn, params, TrainConfig(
            steps=5, grad_accum=2, grad_compression="int8_ef",
            ckpt_dir=str(d), ckpt_every=2, log_every=100), data,
            model_state=tcn_empty_state(cfg, dev))

    whole, _ = trainer(tmp_path / "a").run()
    trainer(tmp_path / "b").run(steps=3)
    resumed = trainer(tmp_path / "b")
    assert resumed.maybe_resume() == 3
    again, _ = resumed.run()
    assert all(torch.equal(x, y) for x, y in
               zip(tree_leaves(whole), tree_leaves(again)))


def _plain_fused_embed(cfg, fused, x, quantize):
    """make_fused_forward's embedding through tcn_block_fused (the strip
    entry's plain version) on the card."""
    from repro_torch.kernels.ref import expand_weight
    from repro_torch.quant.log2 import fake_quant_act_u4

    k, h = cfg.tcn_kernel, x
    for i, c in enumerate(cfg.tcn_channels):
        n = (k - 1) * 2 ** i
        h, _ = tcn_block_fused(
            torch.nn.functional.pad(h, (0, 0, n, 0)).contiguous(),
            h.new_zeros((x.shape[0], n, c)), fused["blocks"][f"b{i}"],
            dilation=2 ** i, k=k, act_scale=cfg.act_scale, quantize=quantize)
    emb = torch.relu(h[:, -1, :] @ expand_weight(fused["head_w"])
                     + fused["head_b"])
    return fake_quant_act_u4(emb, cfg.act_scale) if quantize else emb


def test_trained_fused_forward_and_adapt_match_plain(no_tf32):
    from repro_torch.core.protonet import (
        adapt,
        pn_fc_from_sums,
        support_sums,
    )
    from repro_torch.models.tcn import bake_stream_params, make_fused_forward

    dev = no_tf32
    cfg, _, _, _, fp32, qat, batch = _trained(dev)
    sx, sy = batch[0], batch[1]
    for quantize, (p, st) in ((False, fp32), (True, qat)):
        _, _, fused = bake_stream_params(p, st, cfg, quantize=quantize)
        emb = make_fused_forward(cfg, quantize=quantize, device=dev)(
            fused, sx)[0]
        assert torch.equal(emb, _plain_fused_embed(cfg, fused, sx, quantize))
    before = proto_extract.launches
    w, b = adapt(lambda _, x: x, None, emb, sy, 5, 3)
    assert proto_extract.launches == before + 1
    ws, bs = pn_fc_from_sums(support_sums(emb, sy, 5), 3)
    torch.testing.assert_close(w, ws, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(b, bs, rtol=1e-5, atol=1e-6)


def test_served_trained_stream_equals_full_forward(dev):
    from repro_torch.models.tcn import bake_stream_params, make_fused_forward

    cfg, bundle, ds, test_cls, _, (p, st), _ = _trained(dev)
    x = np.concatenate([ds.sample(int(c), 1, seed=3) for c in test_cls[:4]])
    svc = StreamSessionService(bundle, p, st, n_slots=4, max_tenants=1,
                               max_ways=5, t_chunk=16, quantize=True,
                               fused=True)
    sids = [svc.open_session() for _ in range(4)]
    for a in range(0, 784, 48):
        res = svc.push_audio({sid: x[i, a:a + 48] for i, sid in
                              enumerate(sids)})
    last = torch.from_numpy(np.stack([res[sid]["emb"][-1] for sid in sids]))
    _, _, fused = bake_stream_params(p, st, cfg, quantize=True)
    full = make_fused_forward(cfg, quantize=True, device=dev)(
        fused, torch.from_numpy(x).to(dev))[0]
    assert torch.equal(last, full.cpu())


# ---------------------------------------------------------------------------
# the dense LM family on the card
# ---------------------------------------------------------------------------

def _lm(dev, name="olmo-1b", **over):
    from repro_torch.configs import get_config
    from repro_torch.models import build_bundle

    cfg = get_config(name).smoke().replace(
        n_layers=2, d_model=256, d_ff=512, vocab_size=512, n_heads=4,
        n_kv_heads=1 if name == "qwen2.5-32b" else 4, head_dim=64, **over)
    bundle = build_bundle(cfg, dev)
    return bundle, bundle.init(torch.Generator(device=dev).manual_seed(0))


def _lm_svc(bundle, params, **kw):
    from repro_torch.sessions import LMSessionService

    return LMSessionService(bundle, params, **{
        "n_slots": 4, "seq_cap": 128, "t_chunk": 16, "max_sessions": 16,
        **kw})


def _lm_prompts(n=4, vocab=512, seed=1):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, 32)
    return [np.concatenate([shared, rng.integers(0, vocab, 5 + 7 * i)])
            .astype(np.int32) if i < 2 else
            rng.integers(0, vocab, 9 + 13 * i).astype(np.int32)
            for i in range(n)]


def _live_bits(svc, sids):
    from repro_torch.convert import numpy_bits
    from repro_torch.utils.trees import tree_leaves

    return [x for s in sids for x in tree_leaves(numpy_bits(
        svc.live_column(s)))]


@pytest.mark.parametrize("name", ["olmo-1b", "qwen2.5-32b",
                                  "deepseek-v2-lite-16b",
                                  "moonshot-v1-16b-a3b"])
def test_lm_invariants_bit_exact_on_card(dev, name):
    """t_chunk 16 == 1, paged == dense (prefix blocks shared copy-on-write)
    and park/resume through evictions, tokens and KV rows bit for bit."""
    bundle, params = _lm(dev, name)
    prompts = _lm_prompts()
    runs = {}
    for key, kw in (("dense", {}), ("t1", {"t_chunk": 1}),
                    ("paged", {"paged": True})):
        svc = _lm_svc(bundle, params, **kw)
        sids = [svc.open_session(p) for p in prompts]
        out = svc.decode({s: 24 for s in sids})
        runs[key] = ([out[s] for s in sids], _live_bits(svc, sids), svc)
    assert runs["paged"][2].pool.n_shared >= 2
    for key in ("t1", "paged"):
        assert runs[key][0] == runs["dense"][0], key
        assert all(np.array_equal(a, b) for a, b in
                   zip(runs[key][1], runs["dense"][1])), key
    # 8 sessions on 4 slots, decoded in two waves of 12: every session
    # parks and resumes; its tokens equal the never-parked run's
    for paged in (False, True):
        svc = _lm_svc(bundle, params, paged=paged, max_sessions=8)
        sids = [svc.open_session(p) for p in prompts + prompts]
        got = {s: [] for s in sids}
        for _ in range(2):
            for wave in (sids[:4], sids[4:]):
                for s, t in svc.decode({s: 12 for s in wave}).items():
                    got[s] += t
        assert svc.stats()["evictions"] >= 8
        assert [got[s] for s in sids] == runs["dense"][0] * 2


def test_lm_baked_tree_equals_per_use_cast_on_card(dev):
    from repro_torch.models.transformer import bake_lm_params

    bundle, params = _lm(dev, "qwen2.5-32b")
    baked = bake_lm_params(params, bundle.cfg)
    for i in range(bundle.cfg.n_layers):
        for key, w in params["layers"]["mlp"].items():
            assert torch.equal(baked["layers"][i]["mlp"][key],
                               w[i].to(torch.bfloat16))
    tok = torch.arange(4, dtype=torch.int32, device=dev)[:, None]
    pos = torch.tensor([0, 3, 5, 9], dtype=torch.int32, device=dev)
    with torch.no_grad():
        a, ca = bundle.decode_fn(params, bundle.empty_cache(4, 16),
                                 {"tokens": tok, "pos": pos})
        b, cb = bundle.decode_fn(baked, bundle.empty_cache(4, 16),
                                 {"tokens": tok, "pos": pos})
    assert torch.equal(a, b)
    assert torch.equal(ca["dense"]["k"], cb["dense"]["k"])
    assert bool(torch.isfinite(a).all())


def test_lm_spill_restore_and_chunk_schedule_on_card(dev, tmp_path):
    """A spilled session resumes in a fresh service bit for bit; 64-token
    prefill chunks against token-at-a-time prefill give the same greedy
    tokens and KV within one bf16 ulp."""
    bundle, params = _lm(dev)
    prompts = _lm_prompts()
    ctl = _lm_svc(bundle, params)
    c = [ctl.open_session(p) for p in prompts]
    want = ctl.decode({s: 20 for s in c})
    svc = _lm_svc(bundle, params)
    s = [svc.open_session(p) for p in prompts]
    first = svc.decode({x: 8 for x in s})
    path = str(tmp_path / "lm.npz")
    svc.spill_parking(path, include_bound=True)
    fresh = _lm_svc(bundle, params)
    assert fresh.restore_parking(path) == s
    rest = fresh.decode({x: 12 for x in s})
    assert [first[x] + rest[x] for x in s] == [want[x] for x in c]
    scan = _lm_svc(bundle, params, prefill_chunk=0)
    z = [scan.open_session(p) for p in prompts]
    got = scan.decode({x: 20 for x in z})
    assert [got[x] for x in z] == [want[x] for x in c]

    def ordered(u):
        v = u.astype(np.int32)
        return np.where(v >= 0x8000, 0x8000 - v, v)

    for a, b in zip(_live_bits(scan, z), _live_bits(ctl, c)):
        assert int(np.abs(ordered(a) - ordered(b)).max()) <= 1


# ---------------------------------------------------------------------------
# the MoE FFN and speculative decoding on the card
# ---------------------------------------------------------------------------

def _moe(cap):
    from repro_torch.models.config import ArchConfig
    from repro_torch.models.moe import moe_param_defs
    from repro_torch.models.params import init_params

    cfg = ArchConfig(n_experts=16, moe_topk=4, d_model=128, d_ff_expert=64,
                     n_shared_experts=2, capacity_factor=cap)
    p = init_params(moe_param_defs(cfg), torch.Generator().manual_seed(0),
                    "cpu")
    p["router"] = p["router"] / 0.006 * 128 ** -0.5  # away from near-ties
    return cfg, p


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cap", [0.5, 64.0])
def test_moe_ffn_card_matches_cpu(no_tf32, dtype, cap):
    """moe_ffn on the card against itself on the CPU: the same top-k
    experts and drop mask, y within the parity tests' tolerances."""
    from repro_torch.models.moe import expert_capacity, moe_ffn, \
        positions_in_expert, route

    dev = no_tf32
    cfg, p = _moe(cap)
    x = torch.randn((8, 64, 128), generator=torch.Generator().manual_seed(1)
                    ).to(dtype)
    pd = {k: (v.to(dev) if not isinstance(v, dict) else
              {kk: vv.to(dev) for kk, vv in v.items()}) for k, v in p.items()}
    y, m = moe_ffn(p, cfg, x)
    yd, md = moe_ffn(pd, cfg, x.to(dev))
    _, _, e = route(p, cfg, x)
    _, _, ed = route(pd, cfg, x.to(dev))
    assert torch.equal(e, ed.cpu())
    C = expert_capacity(64, cfg)
    keep = positions_in_expert(e.reshape(8, -1), 16) < C
    keep_d = positions_in_expert(ed.reshape(8, -1), 16) < C
    assert torch.equal(keep, keep_d.cpu())
    assert float(m["moe_dropped"]) == float(md["moe_dropped"])
    assert (float(m["moe_dropped"]) > 0) == (cap == 0.5)
    scale = max(1.0, float(y.float().abs().max()))
    err = float((yd.cpu().float() - y.float()).abs().max())
    assert err <= (1e-4 if dtype == torch.float32 else 5e-2) * scale


def test_moe_topk_tie_order_on_card(dev):
    """Ties go to the lower expert index on the card (a stable descending
    sort), and the stable argsort of the flattened expert ids places each
    pair as on the CPU."""
    from repro_torch.models.moe import positions_in_expert

    pr = torch.tensor([[0.1, 0.3, 0.3, 0.0, 0.3, 0.3]] * 64)
    _, idx = torch.sort(pr.to(dev), dim=-1, descending=True, stable=True)
    assert (idx[:, :4].cpu() == torch.tensor([1, 2, 4, 5])).all()
    flat = torch.randint(0, 6, (8, 4096), generator=torch.Generator()
                         .manual_seed(2))
    assert torch.equal(positions_in_expert(flat.to(dev), 6).cpu(),
                       positions_in_expert(flat, 6))


@pytest.mark.parametrize("name", ["olmo-1b", "deepseek-v2-lite-16b"])
def test_speculative_on_card(dev, name):
    """Scan-mode speculation emits plain decode's tokens bit for bit for
    the n-gram and a random drafter, dense and paged; parallel mode's
    paged stream equals its dense one."""
    from repro_torch.sessions import SpeculativeDecoder, ngram_drafter

    bundle, params = _lm(dev, name)
    prompts = _lm_prompts()
    plain = _lm_svc(bundle, params)
    sids = [plain.open_session(p) for p in prompts]
    out = plain.decode({s: 24 for s in sids})
    want = [out[s] for s in sids]

    def rand(hist, k):
        return np.random.default_rng(len(hist)).integers(
            0, 512, size=k).astype(np.int32)

    for paged in (False, True):
        for dr in (ngram_drafter(), rand):
            svc = _lm_svc(bundle, params, paged=paged)
            sp = SpeculativeDecoder(svc, dr, k=4)
            s = [svc.open_session(p) for p in prompts]
            got = sp.decode({x: 10 for x in s})
            rest = sp.decode({x: 14 for x in s})
            assert [got[x] + rest[x] for x in s] == want, (paged, dr)
    par = []
    for paged in (False, True):
        svc = _lm_svc(bundle, params, paged=paged)
        sp = SpeculativeDecoder(svc, ngram_drafter(), k=4, verify="parallel")
        s = [svc.open_session(p) for p in prompts]
        got = sp.decode({x: 24 for x in s})
        par.append([got[x] for x in s])
        assert all(len(g) == 24 for g in par[-1])
    assert par[0] == par[1]


# ---------------------------------------------------------------------------
# the recurrent families (RWKV, the zamba hybrid) on the card
# ---------------------------------------------------------------------------

def _rec(dev, name):
    from repro_torch.configs import get_config
    from repro_torch.models import build_bundle

    over = dict(n_layers=3, d_model=256, d_ff=512, vocab_size=512)
    if name == "rwkv6-1.6b":
        over.update(rwkv_head_dim=64)
    else:
        over.update(n_heads=4, n_kv_heads=4, head_dim=64, ssm_state=32,
                    ssm_head_dim=64, attn_every=2)
    cfg = get_config(name).replace(**over)
    bundle = build_bundle(cfg, dev)
    return bundle, bundle.init(torch.Generator(device=dev).manual_seed(0))


@pytest.mark.parametrize("name", ["rwkv6-1.6b", "zamba2-1.2b"])
def test_recurrent_invariants_bit_exact_on_card(dev, name):
    """Token-by-token prefill; t_chunk 16 == 1, paged == dense (zamba;
    RWKV stays dense) and park/resume through evictions, tokens and every
    cache leaf bit for bit; a ragged dispatch leaves the masked lane's
    cache as it was."""
    bundle, params = _rec(dev, name)
    prompts = _lm_prompts()
    runs = {}
    for key, kw in (("dense", {}), ("t1", {"t_chunk": 1}),
                    ("paged", {"paged": True})):
        svc = _lm_svc(bundle, params, **kw)
        assert not svc.parallel_safe and svc.prefill_chunk == 0
        assert svc.paged == (key == "paged" and name == "zamba2-1.2b")
        sids = [svc.open_session(p) for p in prompts]
        out = svc.decode({s: 20 for s in sids})
        runs[key] = ([out[s] for s in sids], _live_bits(svc, sids), svc)
    for key in ("t1", "paged"):
        assert runs[key][0] == runs["dense"][0], key
        assert all(np.array_equal(a, b) for a, b in
                   zip(runs[key][1], runs["dense"][1])), key
    svc = runs["t1"][2]
    sids = sorted(svc.sessions)
    before = _live_bits(svc, sids[:1])
    svc.decode({s: 4 for s in sids[1:]})
    assert all(np.array_equal(a, b)
               for a, b in zip(_live_bits(svc, sids[:1]), before))
    for paged in (False, True):
        svc = _lm_svc(bundle, params, paged=paged, max_sessions=8)
        sids = [svc.open_session(p) for p in prompts + prompts]
        got = {s: [] for s in sids}
        for _ in range(2):
            for wave in (sids[:4], sids[4:]):
                for s, t in svc.decode({s: 10 for s in wave}).items():
                    got[s] += t
        assert svc.stats()["evictions"] >= 8
        assert [got[s] for s in sids] == runs["dense"][0] * 2


@pytest.mark.parametrize("name", ["rwkv6-1.6b", "zamba2-1.2b"])
def test_recurrent_spill_and_baked_tree_on_card(dev, name, tmp_path):
    """A spilled session resumes in a fresh service bit for bit, and the
    baked bf16 tree (fp32-cast leaves kept fp32) decodes as the fp32 tree
    with its per-use casts."""
    from repro_torch.models.transformer import bake_lm_params
    from repro_torch.utils.trees import tree_leaves

    bundle, params = _rec(dev, name)
    prompts = _lm_prompts()
    ctl = _lm_svc(bundle, params)
    c = [ctl.open_session(p) for p in prompts]
    want = ctl.decode({s: 16 for s in c})
    svc = _lm_svc(bundle, params)
    s = [svc.open_session(p) for p in prompts]
    first = svc.decode({x: 6 for x in s})
    path = str(tmp_path / "rec.npz")
    svc.spill_parking(path, include_bound=True)
    fresh = _lm_svc(bundle, params)
    assert fresh.restore_parking(path) == s
    rest = fresh.decode({x: 10 for x in s})
    assert [first[x] + rest[x] for x in s] == [want[x] for x in c]
    baked = bake_lm_params(params, bundle.cfg)
    tok = torch.arange(4, dtype=torch.int32, device=dev)[:, None]
    pos = torch.tensor([0, 3, 5, 9], dtype=torch.int32, device=dev)
    with torch.no_grad():
        a, ca = bundle.decode_fn(params, bundle.empty_cache(4, 16),
                                 {"tokens": tok, "pos": pos})
        b, cb = bundle.decode_fn(baked, bundle.empty_cache(4, 16),
                                 {"tokens": tok, "pos": pos})
    assert torch.equal(a, b) and bool(torch.isfinite(a).all())
    assert all(torch.equal(x, y)
               for x, y in zip(tree_leaves(ca), tree_leaves(cb)))


@pytest.mark.parametrize("name", ["rwkv6-1.6b", "zamba2-1.2b"])
def test_recurrent_speculative_on_card(dev, name):
    """Scan-mode speculation (the alive-masked verify scan) emits plain
    decode's tokens bit for bit for the n-gram and a random drafter,
    dense and (zamba) paged, with the device acceptance count equal to
    the host's; parallel verify is refused."""
    from repro_torch.sessions import SpeculativeDecoder, ngram_drafter

    bundle, params = _rec(dev, name)
    prompts = _lm_prompts()
    plain = _lm_svc(bundle, params)
    sids = [plain.open_session(p) for p in prompts]
    out = plain.decode({s: 20 for s in sids})
    want = [out[s] for s in sids]

    def rand(hist, k):
        return np.random.default_rng(len(hist)).integers(
            0, 512, size=k).astype(np.int32)

    for paged in (False, True):
        for dr in (ngram_drafter(), rand):
            svc = _lm_svc(bundle, params, paged=paged, device_counters=True)
            sp = SpeculativeDecoder(svc, dr, k=4)
            s = [svc.open_session(p) for p in prompts]
            got = sp.decode({x: 8 for x in s})
            svc.park(s[0])
            rest = sp.decode({x: 12 for x in s})
            assert [got[x] + rest[x] for x in s] == want, (paged, dr)
            acc = svc.metrics()["spec_device_accepted_total"][0]["value"]
            assert acc == sp.accepted
    with pytest.raises(ValueError, match="parallel verify"):
        SpeculativeDecoder(plain, verify="parallel")


# ---------------------------------------------------------------------------
# the vlm and encoder-decoder families on the card
# ---------------------------------------------------------------------------

def _encdec(dev, name, **over):
    from repro_torch.configs import get_config
    from repro_torch.models import build_bundle

    over = dict(n_layers=2, d_model=256, d_ff=512, vocab_size=512,
                n_heads=4, n_kv_heads=2 if name == "internvl2-76b" else 4,
                head_dim=64, **over)
    cfg = get_config(name).smoke().replace(**over)
    bundle = build_bundle(cfg, dev)
    return bundle, bundle.init(torch.Generator(device=dev).manual_seed(0))


def _front(cfg, B, dev, seed=2, n_frames=40):
    g = torch.Generator().manual_seed(seed)
    if cfg.family == "vlm":
        x = torch.randn((B, cfg.n_patches, cfg.d_model), generator=g)
        return {"patches": (x * 0.5).to(torch.bfloat16).to(dev)}
    x = torch.randn((B, n_frames, cfg.d_model), generator=g)
    return {"frames": (x * 0.5).to(torch.bfloat16).to(dev)}


def _close_bf16(got, want):
    scale = max(1.0, float(want.float().abs().max()))
    assert float((got.float().cpu() - want.float().cpu()).abs().max()) \
        <= 5e-2 * scale


@pytest.mark.parametrize("threshold", [4096, 16])
@pytest.mark.parametrize("name", ["internvl2-76b", "seamless-m4t-large-v2"])
def test_encdec_bundles_card_match_cpu(no_tf32, name, threshold):
    """prefill (the front end and 12 tokens), a decode step after it and
    embed on the card against the same bundle on the CPU, bf16; at
    threshold 16 the encoder and the cross prefill take the chunked
    non-causal path."""
    from repro_torch.models import build_bundle
    from repro_torch.utils.trees import tree_leaves, tree_map

    dev = no_tf32
    bundle, params = _encdec(dev, name, attn_chunk_threshold=threshold)
    cpu = build_bundle(bundle.cfg, "cpu")
    p_cpu = tree_map(lambda t: t.cpu(), params)
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, 512, (2, 12)).astype(np.int32))
    batch = {"tokens": toks.to(dev), **_front(bundle.cfg, 2, dev)}
    batch_cpu = {k: v.cpu() for k, v in batch.items()}
    with torch.no_grad():
        lg, cache = bundle.prefill_fn(params, batch)
        lg_c, cache_c = cpu.prefill_fn(p_cpu, batch_cpu)
        _close_bf16(lg, lg_c)
        for a, b in zip(tree_leaves(cache), tree_leaves(cache_c)):
            _close_bf16(a, b)
        pos = 12 + (bundle.cfg.n_patches if name == "internvl2-76b" else 0)
        grow = lambda a: torch.nn.functional.pad(a, (0, 0, 0, 0, 0, 1)) \
            if a.shape[2] == pos else a
        nxt = toks[:, :1]
        d, _ = bundle.decode_fn(params, tree_map(grow, cache), {
            "tokens": nxt.to(dev), "pos": pos})
        d_c, _ = cpu.decode_fn(p_cpu, tree_map(grow, cache_c), {
            "tokens": nxt, "pos": pos})
        _close_bf16(d, d_c)
        _close_bf16(bundle.embed_fn(params, batch),
                    cpu.embed_fn(p_cpu, batch_cpu))
    assert bool(torch.isfinite(lg).all() & torch.isfinite(d).all())


@pytest.mark.parametrize("name", ["internvl2-76b", "seamless-m4t-large-v2"])
def test_encdec_invariants_bit_exact_on_card(dev, name):
    """Token prompts (seamless: token by token, the cross leaves zero and
    dense per slot): t_chunk 16 == 1, paged == dense and park/resume
    through evictions, tokens and every cache leaf bit for bit."""
    bundle, params = _encdec(dev, name)
    prompts = _lm_prompts()
    runs = {}
    for key, kw in (("dense", {}), ("t1", {"t_chunk": 1}),
                    ("paged", {"paged": True})):
        svc = _lm_svc(bundle, params, **kw)
        assert svc.parallel_safe == (name == "internvl2-76b")
        sids = [svc.open_session(p) for p in prompts]
        out = svc.decode({s: 16 for s in sids})
        runs[key] = ([out[s] for s in sids], _live_bits(svc, sids))
    for key in ("t1", "paged"):
        assert runs[key][0] == runs["dense"][0], key
        assert all(np.array_equal(a, b) for a, b in
                   zip(runs[key][1], runs["dense"][1])), key
    svc = _lm_svc(bundle, params, max_sessions=8)
    sids = [svc.open_session(p) for p in prompts + prompts]
    got = {s: [] for s in sids}
    for wave in (sids[:4], sids[4:], sids[:4], sids[4:]):
        for s, t in svc.decode({s: 8 for s in wave}).items():
            got[s] += t
    assert svc.stats()["evictions"] >= 8
    assert [got[s] for s in sids] == runs["dense"][0] * 2


@pytest.mark.parametrize("paged", [False, True])
def test_cross_pass_through_equals_lane_select_on_card(dev, paged,
                                                       monkeypatch):
    """A seamless step returns the cross leaves untouched and the scan
    passes them through the value mask unread; a scan that
    ``lane_select``s them gives the same tokens and cache bits, through a
    ragged dispatch."""
    from repro_torch.sessions import lm as lm_mod

    bundle, params = _encdec(dev, "seamless-m4t-large-v2")
    prompts = _lm_prompts()

    def run():
        svc = _lm_svc(bundle, params, paged=paged)
        cross = svc.cache["self"]["cross"]["k"]
        sids = [svc.open_session(p) for p in prompts]
        out = svc.decode({sids[0]: 6, sids[2]: 3})
        for s, t in svc.decode({s: 8 for s in sids}).items():
            out[s] = out.get(s, []) + t
        return svc, sids, out, cross

    svc, sids, out, cross = run()
    assert svc.cache["self"]["cross"]["k"] is cross
    orig = lm_mod.lane_select
    monkeypatch.setattr(lm_mod, "mask_recurrent", lambda v, n, o, b, r:
                        lm_mod.map_tree(lambda x, y, bax, rec:
                                        orig(v, x, y, bax) if rec else x,
                                        n, o, b, r))
    svc2, sids2, out2, cross2 = run()
    assert svc2.cache["self"]["cross"]["k"] is not cross2
    assert [out2[s] for s in sids2] == [out[s] for s in sids]
    assert all(np.array_equal(a, b) for a, b in
               zip(_live_bits(svc2, sids2), _live_bits(svc, sids)))


@pytest.mark.parametrize("V", [1024, 8192])
@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("outliers", [False, True])
def test_proto_extract_wide_embeddings_match_plain(dev, V, k, outliers):
    """proto_extract at the seamless (V = 1024, one CTA a way) and internvl
    (V = 8192, a cluster of 8 CTAs a way) embedding widths, 5 ways, both
    entries: W bit for bit, b at rtol 1e-5, atol 1e-6."""
    emb, labels, onehot = _proto_case(V + k, [k] * 5, V, dev, outliers)
    _check_proto_entries(emb, labels, onehot, k)


def test_proto_extract_bias_repeats_bit_for_bit(dev):
    """At V = 8192 (the cluster path) b's fixed-order reduction gives the
    same bits in 50 calls of each entry, and W the same values."""
    emb, labels, onehot = _proto_case(3, [5] * 5, 8192, dev, True)
    for call in (lambda: proto_extract(emb, onehot, 5),
                 lambda: proto_extract_labels(emb, labels, 5, 5)):
        w0, b0 = call()
        for _ in range(49):
            w, b = call()
            assert torch.equal(b.view(torch.int32), b0.view(torch.int32))
            assert torch.equal(w, w0)


def test_adapt_is_one_kernel_after_the_embedder(dev):
    """``adapt`` on the card: with an identity embed_fn the profiler sees
    exactly one device op, the proto_extract kernel (the label entry): no
    one-hot, cast or copy kernel, for int32 and int64 labels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.protonet import adapt

    emb, labels, _ = _proto_case(5, [5] * 5, 64, dev)
    for lab in (labels, labels.to(torch.int32)):
        adapt(lambda _, x: x, None, emb, lab, 5, 5)
        torch.cuda.synchronize()
        before = proto_extract_labels.launches
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                adapt(lambda _, x: x, None, emb, lab, 5, 5)
            torch.cuda.synchronize()
            time.sleep(0.05)  # lets the profiler collect the device records
        on_dev = [(e.key, e.count) for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        assert len(on_dev) == 1 and on_dev[0][1] == 5, on_dev
        assert "proto_extract" in on_dev[0][0], on_dev
        assert proto_extract_labels.launches == before + 5


# ---------------------------------------------------------------------------
# LM training: every family's loss and gradients on the card against the
# CPU, a step twice, kill and resume, the launcher
# ---------------------------------------------------------------------------

LM_TRAIN_REPEAT = ["olmo-1b", "deepseek-v2-lite-16b", "rwkv6-1.6b",
                   "zamba2-1.2b", "seamless-m4t-large-v2"]


def _on(tree, device):
    if isinstance(tree, dict):
        return {k: _on(v, device) for k, v in tree.items()}
    return (torch.from_numpy(tree) if isinstance(tree, np.ndarray)
            else tree).to(device)


def _lm_close(got, want, what):
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    scale = max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5 * scale,
                               msg=lambda m: f"{what}: {m}")


@pytest.mark.parametrize("name", ["rwkv6-1.6b", "deepseek-v2-lite-16b",
                                  "moonshot-v1-16b-a3b", "olmo-1b",
                                  "stablelm-1.6b", "command-r-35b",
                                  "qwen2.5-32b", "zamba2-1.2b",
                                  "internvl2-76b", "seamless-m4t-large-v2"])
def test_lm_loss_and_grads_card_match_cpu(no_tf32, name):
    """fp32 at ``smoke()``: loss, metrics and every gradient leaf of
    ``loss_fn`` on the card against the same call on the CPU, at the LM
    fp32 tolerance (rtol 1e-4, atol 1e-5 x max(1, max|want|))."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_bundle
    from repro_torch.training import value_and_grad
    from repro_torch.utils.trees import tree_leaves

    cfg = get_config(name).smoke().replace(act_dtype="float32")
    cpu = build_bundle(cfg, "cpu")
    params = cpu.init(torch.Generator().manual_seed(0))
    batch = arch_batch(cfg)
    want = value_and_grad(cpu.loss_fn, params, _on(batch, "cpu"))
    got = value_and_grad(build_bundle(cfg, no_tf32).loss_fn,
                         _on(params, no_tf32), _on(batch, no_tf32))
    _lm_close(got[0], want[0], "loss")
    assert set(got[1]) == set(want[1])
    for k in want[1]:
        _lm_close(got[1][k], want[1][k], k)
    for i, (g, w) in enumerate(zip(tree_leaves(got[2]),
                                   tree_leaves(want[2]))):
        assert g.device.type == "cuda"
        _lm_close(g, w, f"grad leaf {i}")


@pytest.mark.parametrize("name", LM_TRAIN_REPEAT)
def test_lm_train_step_repeats_bit_for_bit(dev, name):
    """The same state and batch give the same params, optimizer state,
    loss and metrics, bit for bit (bf16 activations, the configs')."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_bundle
    from repro_torch.training import TrainState, make_train_step
    from repro_torch.training.optim import adamw
    from repro_torch.utils.trees import tree_leaves

    cfg = get_config(name).smoke()
    b = build_bundle(cfg, dev)
    params = b.init(torch.Generator(device=dev).manual_seed(0))
    opt = adamw(1e-3)
    step = make_train_step(b.loss_fn, opt)
    state = TrainState(params, opt[0](params), {}, {},
                       torch.zeros((), dtype=torch.int32, device=dev))
    batch = _on(arch_batch(cfg, B=4, S=64, seed=1), dev)
    one, two = step(state, batch), step(state, batch)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(one),
                                                 tree_leaves(two)))


def test_lm_trainer_resume_is_bit_exact_on_card(dev, tmp_path):
    """olmo-1b ``smoke()``, grad_accum=2 and int8_ef, killed after 3 of 6
    steps and resumed: the uninterrupted run's state bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.data import lm_batch
    from repro_torch.models import build_bundle
    from repro_torch.training import TrainConfig, Trainer
    from repro_torch.training.optim import adamw
    from repro_torch.utils.trees import tree_leaves

    cfg = get_config("olmo-1b").smoke()
    b = build_bundle(cfg, dev)
    params = b.init(torch.Generator(device=dev).manual_seed(0))

    def data(s):
        return {k: torch.from_numpy(v.reshape(2, 4, -1)).to(dev) for k, v in
                lm_batch(s, 8, 64, cfg.vocab_size).items()}

    def trainer(d):
        return Trainer(b.loss_fn, params, TrainConfig(
            steps=6, grad_accum=2, grad_compression="int8_ef",
            ckpt_dir=str(d), ckpt_every=2, log_every=1), data,
            optimizer=adamw(3e-3))

    whole, hist = trainer(tmp_path / "a").run()
    trainer(tmp_path / "b").run(steps=3)
    tr = trainer(tmp_path / "b")
    assert tr.maybe_resume() == 3
    again, rest = tr.run()
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(whole),
                                                 tree_leaves(again)))
    assert rest == hist[3:]
    assert all(np.isfinite(h["loss"]) for h in hist)


def test_lm_backward_index_ops_repeat_on_card(dev):
    """The backward of the LM path's index ops, at shapes with many
    repeated indices, repeats bit for bit: the embedding gather
    (``embed_tokens``: an accumulating index put on the card, where
    ``F.embedding``'s own backward gave other bits from call to call),
    the loss's gold-logit gather, the MoE FFN's dispatch and combine
    (capacity dropping pairs) and the KV head repeat."""
    from repro_torch.configs import get_config
    from repro_torch.models.moe import moe_ffn, moe_param_defs
    from repro_torch.models.params import init_params
    from repro_torch.models.transformer import (
        chunked_cross_entropy,
        embed_tokens,
        repeat_heads,
    )

    g = torch.Generator(device=dev).manual_seed(5)
    emb = torch.randn(64, 256, device=dev, generator=g)  # 64 rows of 4,096
    tokens = torch.randint(0, 64, (8, 512), device=dev, generator=g)
    h = torch.randn(8, 512, 256, device=dev, generator=g,
                    dtype=torch.bfloat16)
    w_head = torch.randn(256, 64, device=dev, generator=g) / 16
    kv = torch.randn(4, 128, 2, 64, device=dev, generator=g)
    cfg = get_config("deepseek-v2-lite-16b").smoke().replace(
        capacity_factor=0.5, n_experts=8, moe_topk=4)
    mp = init_params(moe_param_defs(cfg), g, dev)
    x = torch.randn(4, 256, cfg.d_model, device=dev, generator=g)

    def grads():
        leaves = [t.detach().requires_grad_(True) for t in
                  (emb, h, w_head, kv, x, mp["router"], mp["wg"])]
        e, hh, wh, k, xx, router, wg = leaves
        loss, _ = chunked_cross_entropy(
            hh + embed_tokens({"embed": e}, cfg, tokens), wh, tokens, 128)
        y, aux = moe_ffn({**mp, "router": router, "wg": wg}, cfg, xx)
        total = loss + (repeat_heads(k, 8) ** 2).sum() + (y ** 2).sum() \
            + aux["moe_aux"]
        assert float(aux["moe_dropped"]) > 0
        return torch.autograd.grad(total, leaves)

    first = grads()
    for _ in range(3):
        assert all(torch.equal(a, b) for a, b in zip(first, grads()))


def test_launch_train_on_card(dev, capsys):
    """``python -m repro_torch.launch.train --arch olmo-1b --smoke
    --steps 3`` on its default device: the state lives on the card."""
    from repro_torch.launch import train as launch_train
    from repro_torch.utils.trees import tree_leaves

    state, hist = launch_train.main(["--arch", "olmo-1b", "--smoke",
                                     "--steps", "3"])
    assert "params on cuda" in capsys.readouterr().out
    assert all(t.device.type == "cuda" for t in tree_leaves(state))
    assert int(state.step) == 3
    assert all(np.isfinite(h["loss"]) for h in hist)
