#!/usr/bin/env python3
"""Build the PyTorch/CUDA port's kernels and drive its main path on one
NVIDIA GPU, checking every result.

    python3 chip_smoke.py

Phases, each raising on failure (nothing is caught; any failure exits
non-zero):

  kernels  each kernel against its plain PyTorch version on the card at
           every main-path shape (TF32 off): tcn_block's strip entry per
           block, and its chunk entry (tcn_chunk, every block in one
           launch) over a 64-slot grid whose step counters sit just before,
           at and after every ring's wrap, ragged lengths from 0 to T,
           functional and in place, bit for bit (h, rings, t); and
           proto_extract's one-hot and label entries (labels outside
           [0, N) too), W bit for bit;
  timings  device, wrapper, plain and library ms at the main-path shapes;
           proto_extract's two entries at N=5, Nk=25 beside the launch
           floor, their bound and (floor + bound) / ms, and the device ops
           adapt runs after the embedder (one, the kernel: checked);
  serve    StreamSessionService(fused=True) at the full chameleon-tcn width:
           64 sessions, 8 tenants, ragged 784-sample streams, 5-way 5-shot
           enrollment, poll (one tcn_chunk launch per tick and no plain ring
           bookkeeping, counted); then chunk-size invariance (t_chunk 16 vs
           1) and park/resume, bit-exact, for fp32 and quantized services;
           then one 784-sample tick (t_chunk=784, split into
           ceil(784/max_chunk_len) tcn_chunk launches) bit for bit equal to
           t_chunk=16;
  mesh     the services over a device mesh (launch/mesh.make_mesh, DTensor
           leaves), one NCCL rank per card this process sees (a world of
           one on one card): tcn_chunk at each rank's shape (64 / world
           slots) bit for bit against its plain version; the serve drive
           through StreamSessionService(mesh=) with the 64 slots over
           "data", counted (one tcn_chunk launch per tick on every rank),
           every rank's outputs the same and, on rank 0's card, bit for bit
           equal to the unsharded service, to t_chunk 1, to park/resume
           (resumes on other ranks counted) and, with more than one rank,
           to the bank over "model"; olmo-1b at full width (2 of 16
           layers) through LMSessionService(mesh=), 8 lanes, 32 greedy
           tokens bit for bit equal to the unsharded service, the cache
           still sharded, paged=True refused, and scan-mode speculation
           (K=4, n-gram) over that mesh service, 16 tokens a session bit
           for bit equal to the unsharded decoder's; the 64 x 16 tick
           through the mesh beside the bare service's; then olmo-1b at
           full width and depth with its params and AdamW state placed by
           param_pspecs / train_state_pspecs and the batch by
           batch_pspecs: 3 steps under shard_ctx (step ms p50, one step's
           collectives by type, one step profiled: device busy against
           wall, beside the unsharded step's) against the unsharded
           trainer's 3 steps (loss and every param);
           launch.train.main(--mesh 1x1, 3 steps,
           8 x 512) against the same call without --mesh (losses and
           params); decode_fn with placed params and a placed cache, 16
           greedy steps at 8 lanes, tokens and cache against the
           replicated twin (every check bit for bit on a world of one).
           Prints ``mesh_ranks``;
  fsl      5-way 1-shot and 5-shot episodes through protonet.adapt;
  train    meta-trains chameleon-tcn at full width on 28x28 glyphs (784-step
           sequences): 150 prototypical episodes (cut from 300: no
           accuracy gates this phase; 5-way 3-shot 3-query, AdamW 2e-3,
           the train-mode forward through autograd), the mean loss of the
           last 50 below the first 50's, then 40 QAT episodes;
           one step twice on the same inputs bit for bit, its time,
           launches and idle share; the Trainer (grad_accum=2, int8_ef)
           killed and resumed from its checkpoint, bit for bit equal to the
           whole run; then the Table I protocol on unseen classes (5-way 1-
           and 5-shot, fp32 and log2) through bake_stream_params +
           make_fused_forward (strip entry) and protonet.adapt
           (proto_extract), each episode held against the plain eval
           forward, support_sums + pn_fc_from_sums and the plain path's
           argmax (disagreements only at near ties), accuracies reported;
           and the trained log2 embedder served to 64 glyph streams:
           chunk-size invariance, park/resume, and every stream's last step
           against the full-sequence fused forward;
  cl       the paper's continual-learning demo on two chameleon-tcn services
           (paged and dense tenant banks, rehearsal on): tenant A learns 250
           ways x 10 shots of 784-sample clips one way at a time (every 10th
           way refined through label=), with a 64-session tick over 4
           tenants after every 25 ways, paged == dense bit for bit at every
           check and argmax agreement with l2_classify; then tenant B parked
           and resumed, a tenant growing past the 48-block pool
           (PoolExhausted, an AdmissionError), rehearse_tenant, and an
           export/adopt round trip between the layouts, each followed by a
           bit-exact tick; enrollment latency, the 250-way tick beside an
           8-way one (profiled), and the 250-way tick beside the same tick
           with each slot's FC rows gathered again every step;
  plane    the fault-tolerant ServingPlane over two paged CL services
           (cl_curve's served configuration, 64 slots, 128 sessions each)
           at the full chameleon-tcn width: 6 tenants enroll 5 ways x 5 raw
           784-sample shots, then 192 concurrent clients stream 784 samples
           each in ragged chunks, retrying Rejected through RetryPolicy,
           while worker 0 crashes, flakes and storms (FaultInjector), the
           spill journal snapshots every op, worker 1 drains and returns
           and work stealing moves idle tenant groups: no session lost, at
           least one crash and one recovery, a rebuilt worker's baked
           params equal and the dead service's tensors released, and every
           session bit for bit equal to a synchronous control on one
           service of the same geometry; op latency, MTTR, batch lanes,
           journal cost per epoch, and the 64 x 16 tick through the plane
           beside the bare service's;
  spill    worker 0's sessions after the plane drive: spill_parking (with
           the bound ones) into build/, restore_parking on a fresh service,
           64 more samples to every restored session, bit for bit equal to
           the control; the file's bytes and the spill and restore seconds;
  kws      chameleon-tcn-kws (4 blocks of 24, k=3, 28 MFCC channels): the
           kernels phase at its shapes, then the serve phase's checks (no
           784-sample tick: 63-frame windows) and its tick; then
           TCNStreamServer, 64 streams x 252 frames in 63-frame pushes, bit
           for bit equal to the bare service and to its push_chunk shim;
  examples the three example twins as a user runs them (each main() on
           the card, its printout on earlier lines): quickstart_torch
           (get_meta_trained_tcn at 80 episodes, 5-way 3-shot FSL on
           unseen classes above chance, one streamed query against the
           full forward, rtol 2e-4, atol 2e-5 x max(1, max|full|)),
           serve_multitenant_torch (chameleon-tcn-kws at full width, 4
           slots, 4 tenants, 12 sessions: its predictions equal to the
           unfused executor's, alice's resumed result bit for bit equal to
           a never-evicted service, one tcn_chunk launch per tick) and
           serve_stream_torch (4 ticks of 2 KWS streams, one tcn_chunk
           launch each; LMServer's tokens equal to each request alone on a
           fresh server);
  ops      log2_matmul (both paths: tensor-core tiles, and the decode path
           for M <= 4) and dilated_conv (repro_torch.kernels.ops) against
           their plain versions at every listed shape (TF32 off), the
           identity decode and the conv's causality bit for bit, their
           times beside torch.matmul / F.conv1d, then the ops entry point
           driven as a user calls it (kernel_bench's matmul workloads and a
           decode-shaped one, the chameleon-tcn-audio forward with every
           conv through the op);
  audio    chameleon-tcn-audio (12 blocks, d up to 2048): tcn_block at its
           serve and enrollment shapes, 64 sessions streaming 1 s clips
           16 samples per tick (every ring wraps) with 5-way 5-shot
           enrollment, chunk-size invariance (t_chunk 16 vs 160 over
           another ragged schedule) and park/resume bit-exact for fp32 and
           quantized services, a 5-shot episode through protonet.adapt,
           cone_eval against the dense forward, the Fig. 8(c) accounting,
           the push tick's latency and profile, and one 784-sample tick
           (ceil(784/max_chunk_len) launches) equal to t_chunk=16;
  lm       the dense LM family through LMServer on seeded random weights
           drawn on the card and baked to bf16 once (the baked tree's
           decode equal to the fp32 tree's per-use cast): olmo-1b at full
           width and depth, dense and paged (block_len 16) servers side by
           side (ServeConfig(max_batch=8, seq_cap=1024, decode_chunk=16,
           prefill_chunk=64)), 8 requests of 37-300 tokens (four sharing a
           128-token prefix, adopted copy-on-write by the paged service),
           64 greedy tokens each: paged == dense and t_chunk 16 == 1 bit
           for bit (tokens and KV rows), token-at-a-time prefill against
           64-token chunks (layer 0's K/V within one bf16 ulp of its
           scale, every layer's K/V and the next-step logits within 5e-2
           of their scale; the greedy streams' agreement reported), a
           second wave of 16 sessions over the 8 slots (every session
           parks and resumes; dense and paged) bit-equal to never-parked
           controls, two sessions spilled through checkpoint/store and
           restored, bit-equal to never-spilled twins, every logit finite;
           prefill tokens/s, decode ms per token, launches and idle share
           of a decode step (profiled), KV bytes per token, pool blocks
           and the bytes bound of a decode step; then qwen2.5-32b at full
           width with its depth cut to 2 of 64 layers (GQA 40/8 with
           attn_kv_repeat, qkv bias, rmsnorm), 16 tokens, no second wave.
           The LM path reaches none of the four kernels (asserted).
  moe      the lm phase's drive and checks on the MoE family:
           deepseek-v2-lite-16b at full width (MLA r 512 / dn 128 / dr 64 /
           dv 128, 64 routed experts top-6 + 2 shared, vocab 102,400) with
           its depth cut to 4 of 27 layers (1 dense + 3 MoE), then
           moonshot-v1-16b-a3b at full width (GQA 16/16 x 128, vocab
           163,840) cut to 2 of 48 layers, 16 tokens, no second wave.  The
           baked tree keeps the router fp32; the chunk-schedule contract
           holds on layer 0 (dense) only, the MoE layers reported (a
           64-token chunk's expert capacity drops tokens); MLA's absorbed
           decode within 0.06 of the baseline's logits at the reference
           test's configuration, and at full width argmax-equal but at
           near ties, its gap reported; the drop share of
           64-token prefill chunks, the latent cache bytes a token and the
           bytes bound of a decode step over the experts its router picked;
  spec     speculative decoding through LMServer(speculative=4) on olmo-1b
           at full width and depth, then on the cut deepseek: scan mode bit
           for bit equal to plain decode for the oracle, always-wrong,
           random and n-gram drafters, dense and paged (the rejected
           suffix's blocks back in the pool after every call), through
           parking every session mid-draft and a spill/restore into a
           fresh server; parallel mode's exact counts, paged == dense and
           park/resume invariance; the device acceptance count equal to
           the host's; tokens/s and acceptance for plain decode and both
           modes.  No port kernel launched (asserted).
  recurrent  the recurrent families through LMServer on seeded random
           weights baked to bf16 (the leaves the reference casts to fp32
           at use kept fp32; the baked decode equal to the fp32 tree's):
           rwkv6-1.6b (24 layers, d 2048, d_ff 7168, 32 wkv heads x 64,
           vocab 65,536), then zamba2-1.2b (38 Mamba2 layers, d_inner
           4096, 64 heads x 64, state 64, conv 4; the shared attention
           block every 6 layers, 32 heads x 64; d_ff 8192; vocab 32,000),
           both at full width and depth, seq_cap 256: 8 requests of 16-48
           tokens fed token by token (no chunked prefill), 32 greedy
           tokens each; t_chunk 16 == 1 bit for bit (tokens, every cache
           leaf), a ragged dispatch (one lane masked) bit-equal for the
           other lanes with the masked lane's cache frozen, a second wave
           of 16 sessions over the 8 slots against never-parked controls,
           two sessions spilled and restored against their continuations,
           zamba paged (block_len 16) == dense and its paged wave, RWKV's
           paged=True server dense; scan-mode speculation (K=4), lanes
           drafting with the oracle, always-wrong, random and n-gram
           drafters, every session parked mid-draft, equal to plain decode
           with the device acceptance count equal to the host's, dense and
           (zamba) paged; parallel verify refused (ValueError).  Reported:
           step_fn's chunked form against token-by-token steps, ms per
           token at T=1 and in T=16 dispatches, launches and idle share
           of a step, prefill tokens/s, park bytes (fixed and a token) and
           the bytes bound of a step (weights + recurrent state read and
           written + KV rows).  No port kernel launched (asserted).
  encdec   seamless-m4t-large-v2 at full width and depth (24 encoder and 24
           decoder layers, d 1024, 16 heads x 64, ReLU MLP 8192, vocab
           256,206) on seeded random weights baked to bf16: the bundle's
           prefill_fn over 8 x 4,096 seeded frames and prompts of 16-48
           tokens, the reference's cache contract (prefill(tokens[:S])
           against prefill(tokens[:S-1]) + one decode_fn step, rtol/atol
           3e-2), 32 greedy decode_fn steps against the cross cache;
           LMServer(max_batch=8, seq_cap=256) over token prompts fed token
           by token (the cross K/V zero and dense per slot, passed through
           the value mask unread): t_chunk 16 == 1, paged == dense, a
           ragged dispatch, a second wave of 16 sessions over 8 slots
           (park/resume) and two sessions spilled and restored, all bit for
           bit, scan speculation (K=4, the drafter zoo) equal to plain
           decode, parallel verify refused; a 5-way 1-shot adapt over
           embed_fn (frames and 16 tokens a shot: proto_extract at V=1024)
           against the plain version.  Reported: the encoder's ms, prefill
           positions/s, ms a decode step, launches and idle share, the
           bytes bound of a step (decoder weights + head + cross K/V + live
           rows), park bytes, proto_extract's times beside the launch
           floor and the library call;
  vlm      internvl2-76b at full width (d 8192, GQA 64/8 with
           attn_kv_repeat, SwiGLU 28,672, vocab 128,256) with its depth cut
           to 4 of 80 layers: the encdec phase's drive with 1,024 seeded
           patches in front of the text (decode positions count them),
           chunked prefill at open in the server, no speculation; adapt at
           V=8192;
  lm_train LM training (``phase_lm_train``): every family of the zoo at
           smoke(), loss_fn's loss, metrics and gradients in fp32 on the
           card against the CPU (rtol 1e-4, atol 1e-5 x scale, TF32 off)
           and three Trainer steps with a finite loss; one step twice bit
           for bit (olmo-1b, deepseek-v2-lite-16b, rwkv6-1.6b,
           zamba2-1.2b, seamless-m4t-large-v2); olmo-1b's Trainer
           (grad_accum=2, int8_ef) killed after 3 of 6 steps and resumed
           bit for bit; the copy task (60 AdamW steps, the loss down by
           0.2); then olmo-1b at full width and depth (1.28 B params,
           remat on, AdamW) on lm_batch(step, 8, 512): step ms p50 of 10,
           tokens/s, MFU and the hardware-FLOP share (launch/analytic's
           counts over the bf16 peak of core/costmodel), launches and
           idle share, peak memory, a finite loss at every step.  No port
           kernel launched (asserted).

    python3 chip_smoke.py --compare-with DIR

also builds the log2_matmul.cu, dilated_conv.cu and proto_extract.cu of
another tree's csrc/ directory DIR (e.g. a parent commit unpacked with git
archive) and times those kernels beside this tree's at every op shape
(proto_extract at its three main-path shapes), in the same process on the
same card.

Launch counters are zeroed just before each main-path drive and read just
after.  Each phase prints its wall seconds.  Timings are medians of
CUDA-event timed, warmed runs; a kernel's ``ms`` and its library call's
``library_ms`` are device time per call, from 20 calls captured in a
CUDA graph and replayed (no host work between the kernels), while
``wrapper_ms`` and ``plain_ms`` time one Python call each.  A push
tick's breakdown comes from torch.profiler.  An empty kernel's device
time per launch, timed as ``ms`` is, is the launch floor every kernel
time sits on.  The second-to-last line is
the kernels JSON, the last the device JSON.  Exits with code 2 and prints
no result when no CUDA device is present.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# published peaks of one H100 SXM (NVIDIA data sheet, in
# repro_torch/core/costmodel.py): fp32 outside the tensor cores, bf16 on
# the tensor cores (dense), and HBM3 bandwidth
from repro_torch.core.costmodel import (  # noqa: E402
    H100_HBM_BW as PEAK_BYTES,
    H100_PEAK_FLOPS_BF16 as PEAK_BF16_TC_FLOPS,
    H100_PEAK_FLOPS_FP32 as PEAK_FP32_FLOPS,
)
PEAK_NAMES = {PEAK_FP32_FLOPS: "fp32 CUDA cores 67 TFLOP/s",
              PEAK_BF16_TC_FLOPS: "bf16 tensor cores 989 TFLOP/s"}

RTOL, ATOL = 1e-5, 1e-6
QUANT_STEP = 0.25  # one u4 step at the fixed activation scale
N_SLOTS, T_CHUNK, N_TENANTS, STREAM_LEN = 64, 16, 8, 784
# chunk lengths the service gives tcn_chunk: t_chunk 16 or 160 and the
# power-of-two buckets of ragged remainders
CHUNK_TS = (1, 2, 4, 8, 16, 160)
N_WAYS, K_SHOTS = 5, 5


def log(*a) -> None:
    print(*a, flush=True)


def bound(nbytes: float, flops: float,
          peak: float = PEAK_FP32_FLOPS) -> tuple[float, str]:
    """Least time (ms) for the work, and what bounds it: the bytes at the
    HBM rate or the operations at ``peak`` (the units that run them)."""
    tb, tf = nbytes / PEAK_BYTES * 1e3, flops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_ms(fn, dev, n: int = 20, warmup: int = 3) -> float:
    """Median wall time of ``fn`` in ms: CUDA events on the card."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        if dev.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_ms(fn, dev, n: int = 20, reps: int = 5) -> float:
    """Device time (ms) per call of ``fn``, which launches kernels and does
    no host sync: ``n`` calls captured in one CUDA graph, the graph replayed
    between CUDA events (no host work between its kernels), the median of
    ``reps`` replays over ``n``."""
    import torch

    if dev.type != "cuda":
        return float("nan")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    del graph
    return statistics.median(times)


# ---------------------------------------------------------------------------
# shapes and inputs
# ---------------------------------------------------------------------------

def block_shapes(cfg):
    """(block, dilation, Cin, C, has_down) along the main path."""
    out, c_in = [], cfg.tcn_in_channels
    for i, c in enumerate(cfg.tcn_channels):
        out.append((i, 2 ** i, c_in, c, c_in != c))
        c_in = c
    return out


def block_inputs(g, S, T, d, Cin, C, k, has_down, packed, dev):
    """Random strips and one block's weights (fp32 or packed log2), drawn on
    the device from the torch.Generator ``g``."""
    import torch
    from repro_torch.models.tcn import _bake_weight

    n = (k - 1) * d
    t = lambda *shape: torch.randn(shape, generator=g, device=dev)
    strip1 = t(S, n + T, Cin)
    hist2 = t(S, n, C)
    p = {"conv1_w": t(k, Cin, C) * (Cin * k) ** -0.5,
         "conv1_b": t(C) * 0.1,
         "conv2_w": t(k, C, C) * (C * k) ** -0.5,
         "conv2_b": t(C) * 0.1}
    if has_down:
        p["down_w"] = t(1, Cin, C) * Cin ** -0.5
        p["down_b"] = t(C) * 0.1
    if packed:
        for w in ("conv1_w", "conv2_w", "down_w"):
            if w in p:
                p[w] = _bake_weight(p[w], True)[1]
    return strip1, hist2, p


def block_work(S, T, d, Cin, C, k, has_down, packed):
    """(bytes, flops) one block call must move and do."""
    n = (k - 1) * d
    wbytes = 0.5 if packed else 4.0
    w_elems = k * Cin * C + k * C * C + (Cin * C if has_down else 0)
    nbytes = (S * (n + T) * Cin + S * n * C + 2 * S * T * C) * 4 \
        + w_elems * wbytes + (3 if has_down else 2) * C * 4
    flops = S * T * (2 * k * Cin * C + 2 * k * C * C
                     + (2 * Cin * C if has_down else 0))
    return nbytes, flops


def chunk_inputs(g, cfg, S, T, packed, dev, full=False):
    """A slot grid at ``cfg``'s widths with random rings, step counters just
    before, at and after every ring's wrap (and 0), one chunk, ragged
    lengths in [0, T] with 0 and T among them (all T when ``full``), and
    random block weights (fp32 or packed log2)."""
    import torch

    k = cfg.tcn_kernel
    blocks, rings, times = {}, {}, [0]
    for (i, d, Cin, C, has_down) in block_shapes(cfg):
        n = (k - 1) * d
        blocks[f"b{i}"] = block_inputs(g, 1, 1, d, Cin, C, k, has_down,
                                       packed, dev)[2]
        rings[f"b{i}"] = {
            "ring1": torch.randn((S, n, Cin), generator=g, device=dev),
            "ring2": torch.randn((S, n, C), generator=g, device=dev)}
        times += [n - 1, n, n + 1]
    t = torch.tensor([times[i % len(times)] for i in range(S)],
                     dtype=torch.int32, device=dev)
    if full:
        lengths = torch.full((S,), T, dtype=torch.int32, device=dev)
    else:
        lengths = torch.randint(0, T + 1, (S,), generator=g, device=dev,
                                dtype=torch.int32)
        lengths[0], lengths[1] = 0, T
    x = torch.randn((S, T, cfg.tcn_in_channels), generator=g, device=dev)
    return blocks, {"t": t, "blocks": rings}, x, lengths


def chunk_work(cfg, S, T, packed):
    """(bytes, flops) one in-place tcn_chunk call must move and do: the
    weights, x in and h out, t and the lengths, and per conv of every slot
    the (k-1)*min(d, T) history rows its taps read and the min(T, n) ring
    rows it writes."""
    k = cfg.tcn_kernel
    wbytes = 0.5 if packed else 4.0
    nbytes = S * T * (cfg.tcn_in_channels + cfg.tcn_channels[-1]) * 4 \
        + 3 * S * 4
    flops = 0
    for (_, d, Cin, C, has_down) in block_shapes(cfg):
        n = (k - 1) * d
        w_elems = k * Cin * C + k * C * C + (Cin * C if has_down else 0)
        nbytes += w_elems * wbytes + (3 if has_down else 2) * C * 4
        nbytes += S * ((k - 1) * min(d, T) + min(T, n)) * (Cin + C) * 4
        flops += S * T * (2 * k * Cin * C + 2 * k * C * C
                          + (2 * Cin * C if has_down else 0))
    return nbytes, flops


def same_grid(a, b) -> bool:
    import torch

    return torch.equal(a["t"], b["t"]) and all(
        torch.equal(a["blocks"][n][r], b["blocks"][n][r])
        for n in a["blocks"] for r in ("ring1", "ring2"))


def clone_grid(g):
    return {"t": g["t"].clone(), "blocks": {
        n: {r: v.clone() for r, v in d.items()} for n, d in g["blocks"].items()}}


def tree_equal(a, b) -> bool:
    """Two trees of tensors (dicts, NamedTuples, lists) equal leaf by
    leaf, bit for bit."""
    import torch
    from repro_torch.utils.trees import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


class counting:
    """Within the block, count calls of the named functions of ``module``
    (looked up through the module, as their callers do)."""

    def __init__(self, module, names):
        self.module, self.names = module, names
        self.calls = dict.fromkeys(names, 0)

    def __enter__(self):
        self.saved = {n: getattr(self.module, n) for n in self.names}
        for n, fn in self.saved.items():
            def wrapped(*a, _n=n, _fn=fn, **kw):
                self.calls[_n] += 1
                return _fn(*a, **kw)
            setattr(self.module, n, wrapped)
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.module, n, fn)


def allclose(name, got, want, rtol, atol) -> float:
    """Raise unless |got-want| <= atol + rtol*|want| everywhere; returns
    the max abs error."""
    import torch

    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    err = (got.float() - want.float()).abs()
    if not (err <= atol + rtol * want.abs()).all():
        raise AssertionError(f"{name}: max abs err {err.max().item():.3g}")
    return err.max().item()


def compare(name, got, want, quantized: bool) -> float:
    """Raise unless ``got`` matches ``want``; returns the max abs error.
    fp32: |got-want| <= ATOL + RTOL*|want|.  Quantized: >= 99.9% of the
    elements bit-equal and the rest within one u4 step."""
    import torch

    if not quantized:
        return allclose(name, got, want, RTOL, ATOL)
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    err = (got - want).abs()
    eq = (got == want).float().mean().item()
    if eq < 0.999 or err.max().item() > QUANT_STEP * (1 + 1e-6):
        raise AssertionError(f"{name}: {eq:.5f} bit-equal, max err "
                             f"{err.max().item():.3g}")
    return err.max().item()


# ---------------------------------------------------------------------------
# phase: kernels
# ---------------------------------------------------------------------------

def phase_kernels(cfg, dev, seed: int = 0, embed_t: int = STREAM_LEN,
                  ts=(1, 2, 4, 8, T_CHUNK, STREAM_LEN),
                  embed_s=(K_SHOTS, N_WAYS * K_SHOTS)):
    """Every shape the main path gives a kernel: serve ticks of T_CHUNK and
    the power-of-two buckets of ragged remainders (S=64), and the embeds
    of ``embed_t``-long clips at each batch in ``embed_s``: one way's shots
    (S=5, and S=10 in the cl phase) and a 5-shot episode (S=25)."""
    import numpy as np
    import torch
    from repro_torch.kernels.proto_extract import (
        proto_extract,
        proto_extract_labels,
    )
    from repro_torch.kernels.ref import proto_extract_ref, tcn_block_fused
    from repro_torch.kernels.tcn_block import tcn_block

    rng = np.random.default_rng(seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    k, errs = cfg.tcn_kernel, {"tcn_block": 0.0, "proto_extract": 0.0}
    n_cases = 0
    for (i, d, Cin, C, has_down) in block_shapes(cfg):
        for (S, T) in [(s, t) for t in ts for s in (
                embed_s if t == embed_t else (N_SLOTS,))]:
            for packed in (False, True):
                for quantize in (False, True):
                    strip1, hist2, p = block_inputs(
                        g, S, T, d, Cin, C, k, has_down, packed, dev)
                    h, mid = tcn_block(strip1, hist2, p, dilation=d, k=k,
                                       act_scale=cfg.act_scale,
                                       quantize=quantize)
                    hr, mr = tcn_block_fused(strip1, hist2, p, dilation=d,
                                             k=k, act_scale=cfg.act_scale,
                                             quantize=quantize)
                    sync(dev)
                    tag = (f"tcn_block b{i} d={d} S={S} T={T} packed={packed}"
                           f" quantize={quantize}")
                    errs["tcn_block"] = max(
                        errs["tcn_block"],
                        compare(tag + " h", h, hr, quantize),
                        compare(tag + " mid", mid, mr, quantize))
                    n_cases += 1
    from repro_torch.kernels.ref import tcn_chunk_plain
    from repro_torch.kernels.tcn_block import tcn_chunk

    for T in CHUNK_TS:
        for packed in (False, True):
            for quantize in (False, True):
                blocks, grid, x, lengths = chunk_inputs(g, cfg, N_SLOTS, T,
                                                        packed, dev)
                kw = dict(k=k, act_scale=cfg.act_scale, quantize=quantize)
                want, hr = tcn_chunk_plain(blocks, grid, x, lengths, **kw)
                before = clone_grid(grid)
                got, h = tcn_chunk(blocks, grid, x, lengths, **kw)
                sync(dev)
                tag = (f"tcn_chunk S={N_SLOTS} T={T} packed={packed} "
                       f"quantize={quantize}")
                if not same_grid(grid, before):
                    raise AssertionError(f"{tag}: the functional call changed "
                                         "its input grid")
                if not (torch.equal(h, hr) and same_grid(got, want)):
                    raise AssertionError(f"{tag}: differs from the plain "
                                         "version")
                out, h2 = tcn_chunk(blocks, grid, x, lengths, inplace=True,
                                    **kw)
                sync(dev)
                if not (out is grid and torch.equal(h2, hr)
                        and same_grid(grid, want)):
                    raise AssertionError(f"{tag} in place: differs from the "
                                         "plain version")
                n_cases += 2
    V = cfg.embed_dim
    for (N, shots, outliers) in (
            (N_WAYS, [1] * N_WAYS, ()), (N_WAYS, [K_SHOTS] * N_WAYS, ()),
            (N_WAYS, [K_SHOTS] * N_WAYS, (-1, N_WAYS)),
            (37, [1 + (j % 4) for j in range(37)], ())):
        labels = np.concatenate([np.repeat(np.arange(N), shots), outliers])
        emb, lab, onehot = proto_inputs(rng, labels, N, V, dev)
        kk = max(shots)
        wr, br = proto_extract_ref(emb, onehot, kk)
        for entry, (w, b) in (
                ("onehot", proto_extract(emb, onehot, kk)),
                ("labels", proto_extract_labels(emb, lab, N, kk))):
            sync(dev)
            tag = f"proto_extract {entry} N={N} Nk={len(labels)}"
            if not torch.equal(w, wr):
                raise AssertionError(f"{tag}: W differs from the plain "
                                     "version")
            errs["proto_extract"] = max(errs["proto_extract"],
                                        compare(tag + " b", b, br, False))
            n_cases += 1
    log(f"kernels {cfg.name}: {n_cases} cases agree with the plain versions "
        f"(tcn_chunk bit for bit at T in {CHUNK_TS}, functional and in place;"
        f" proto_extract's W bit for bit, both entries, labels outside [0, N)"
        f" counting for no way);"
        f" max abs err tcn_block={errs['tcn_block']:.3g} "
        f"proto_extract={errs['proto_extract']:.3g}")
    return errs


def phase_timings(cfg, dev, floors: dict, smi: str, seed: int = 1,
                  embed_t: int = STREAM_LEN):
    """Per-shape kernel / plain / library times at the main-path shapes:
    the serve tick (S=64, T=16) through tcn_chunk (in place, as the service
    calls it, and functional), the strip entry per block at the serve
    tick's and a 5-shot episode's embed shapes (S=25, T=``embed_t``), and
    proto_extract's two entries at a 5-way 5-shot episode's (``
    time_proto_extract``).  The tcn_block JSON entry gets the chunk's
    numbers: the serve path's launch."""
    import numpy as np
    import torch
    from repro_torch.kernels.ref import tcn_block_fused
    from repro_torch.kernels.tcn_block import tcn_block

    rng = np.random.default_rng(seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    k = cfg.tcn_kernel
    tick = {"ms": 0.0, "wrapper_ms": 0.0, "plain_ms": 0.0, "bytes": 0.0,
            "flops": 0.0}
    for (i, d, Cin, C, has_down) in block_shapes(cfg):
        for (S, T) in ((N_SLOTS, T_CHUNK), (N_WAYS * K_SHOTS, embed_t)):
            strip1, hist2, p = block_inputs(g, S, T, d, Cin, C, k,
                                            has_down, False, dev)
            call = lambda: tcn_block(strip1, hist2, p, dilation=d, k=k)
            wrapper = time_ms(call, dev)
            ms = device_ms(call, dev)
            plain = time_ms(lambda: tcn_block_fused(
                strip1, hist2, p, dilation=d, k=k), dev)
            nb, fl = block_work(S, T, d, Cin, C, k, has_down, False)
            bms, by = bound(nb, fl)
            log(f"timing tcn_block {cfg.name} b{i} d={d} Cin={Cin} S={S} "
                f"T={T} fp32: "
                f"ms={ms:.4f} wrapper_ms={wrapper:.4f} "
                f"plain_ms={plain:.4f} bound_ms={bms:.6f} "
                f"bound_by={by} library_ms=null")
            if T == T_CHUNK:
                tick["ms"] += ms
                tick["wrapper_ms"] += wrapper
                tick["plain_ms"] += plain
                tick["bytes"] += nb
                tick["flops"] += fl
    tb_bound, tb_by = bound(tick["bytes"], tick["flops"])
    log(f"timing tcn_block {cfg.name} serve tick through the strip entry "
        f"({len(cfg.tcn_channels)} blocks, S={N_SLOTS}, T={T_CHUNK}): "
        f"ms={tick['ms']:.4f} wrapper_ms={tick['wrapper_ms']:.4f} "
        f"plain_ms={tick['plain_ms']:.4f} bound_ms={tb_bound:.6f} "
        f"bound_by={tb_by}")
    from repro_torch.kernels.ref import tcn_chunk_plain
    from repro_torch.kernels.tcn_block import tcn_chunk

    blocks, grid, x, lengths = chunk_inputs(g, cfg, N_SLOTS, T_CHUNK, False,
                                            dev, full=True)
    call = lambda: tcn_chunk(blocks, grid, x, lengths, k=k, inplace=True)
    functional = lambda: tcn_chunk(blocks, grid, x, lengths, k=k)
    ch = {"ms": device_ms(call, dev), "wrapper_ms": time_ms(call, dev),
          "plain_ms": time_ms(lambda: tcn_chunk_plain(blocks, grid, x,
                                                      lengths, k=k), dev),
          "library_ms": None}
    functional_ms = device_ms(functional, dev)
    nb, fl = chunk_work(cfg, N_SLOTS, T_CHUNK, False)
    ch["bound_ms"], ch["bound_by"] = bound(nb, fl)
    per_t = []
    for T in CHUNK_TS:
        b_, g_, x_, l_ = chunk_inputs(g, cfg, N_SLOTS, T, False, dev, full=True)
        ms_t = device_ms(lambda: tcn_chunk(b_, g_, x_, l_, k=k, inplace=True),
                         dev)
        per_t.append(f"T={T}:{ms_t:.4f}/{bound(*chunk_work(cfg, N_SLOTS, T, False))[0]:.6f}")
    log(f"timing tcn_chunk {cfg.name} S={N_SLOTS} in place, device ms/bound "
        f"ms per chunk length: {' '.join(per_t)}")
    log(f"timing tcn_chunk {cfg.name} serve tick ({len(cfg.tcn_channels)} "
        f"blocks in one launch, S={N_SLOTS}, T={T_CHUNK}, in place): "
        f"ms={ch['ms']:.4f} wrapper_ms={ch['wrapper_ms']:.4f} "
        f"plain_ms={ch['plain_ms']:.4f} bound_ms={ch['bound_ms']:.6f} "
        f"bound_by={ch['bound_by']} (bytes={nb:.0f} flops={fl:.0f}; "
        f"fixed-order fp32 ceiling {fl / (PEAK_FP32_FLOPS / 2) * 1e3:.6f} "
        f"ms); functional call ms={functional_ms:.4f}")
    labels = rng.permutation(np.repeat(np.arange(N_WAYS), K_SHOTS))
    emb, lab, onehot = proto_inputs(rng, labels, N_WAYS, cfg.embed_dim, dev)
    pe = time_proto_extract(emb, lab, onehot, K_SHOTS, dev, floors, smi,
                            cfg.name)
    return ch, pe


def proto_inputs(rng, labels, N, V, dev):
    """Seeded (Nk, V) embeddings for ``labels``, the labels on the card
    (int64) and the (N, Nk) one-hot built by comparison (a label outside
    [0, N) a zero column, as jax.nn.one_hot gives it)."""
    import numpy as np
    import torch

    labels = np.asarray(labels, np.int64)
    emb = torch.from_numpy(
        rng.normal(size=(len(labels), V)).astype("float32")).to(dev)
    onehot = torch.from_numpy(
        (labels[None, :] == np.arange(N)[:, None]).astype("float32")).to(dev)
    return emb, torch.from_numpy(labels).to(dev), onehot


# the driver's CUgraphNodeType values a captured adapt may hold
GRAPH_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host",
                    10: "alloc", 11: "free"}


def adapt_device_ops(emb, labels, N, k) -> dict:
    """The device work ``protonet.adapt`` puts on its stream after the
    embedder: an identity embed_fn over ``emb``, one warm call, then one
    call captured in a CUDA graph, whose nodes are counted by type through
    the driver (cuGraphGetNodes, cuGraphNodeGetType), with the number of
    proto_extract launches the capture made.  A capture records every
    kernel, copy and fill the call enqueues.  (torch.profiler, which the
    card test uses, returned no device op at all in this script's audio
    timings phase, after the serve and kws phases' profiles.)"""
    import ctypes

    import torch
    from repro_torch.core.protonet import adapt
    from repro_torch.kernels.proto_extract import proto_extract

    adapt(lambda _, x: x, None, emb, labels, N, k)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    before = proto_extract.launches
    with torch.cuda.graph(graph):
        adapt(lambda _, x: x, None, emb, labels, N, k)
    launches = proto_extract.launches - before
    cu = ctypes.CDLL("libcuda.so.1")
    handle, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(handle, None, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if n.value and cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    ops = {"proto_extract launches": launches}
    for node in nodes:
        t = ctypes.c_int(-1)
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t)):
            raise RuntimeError("cuGraphNodeGetType failed")
        name = GRAPH_NODE_TYPES.get(t.value, f"type {t.value}")
        ops[name] = ops.get(name, 0) + 1
    del graph
    return ops


def time_proto_extract(emb, labels, onehot, k, dev, floors, smi, tag):
    """Both proto_extract entries at one shape: device ms (CUDA-graph
    replay), the wrapper's and the plain version's ms, the library call
    (``torch.matmul`` + a bias reduction: never used by the port), the
    bound of this call's bytes and operations, the launch floor, and the
    share (floor + bound) / device ms.  Checks that ``adapt`` runs one
    device op after the embedder, the kernel.  Returns the label entry's
    numbers (the one ``adapt`` launches) with the one-hot entry's under
    "onehot"."""
    import torch
    from repro_torch.kernels.proto_extract import (
        proto_extract,
        proto_extract_labels,
    )
    from repro_torch.kernels.ref import (
        proto_extract_labels_ref,
        proto_extract_ref,
    )

    N, (Nk, V) = onehot.shape[0], emb.shape

    def library():  # one PyTorch call per output; never used by the port
        w = torch.matmul(onehot, emb)
        return w, -(w * w).sum(-1) * (1.0 / (2.0 * k))

    library_ms = device_ms(library, dev)
    # operations: the one-hot entry multiplies and adds every shot into
    # every way, the label entry adds each in-range shot once; then 2 a
    # column for the squares
    counted = int(((labels >= 0) & (labels < N)).sum())
    out = {}
    for entry, call, plain, sel_bytes, ops in (
            ("onehot", lambda: proto_extract(emb, onehot, k),
             lambda: proto_extract_ref(emb, onehot, k), onehot.numel() * 4,
             2 * N * Nk * V),
            ("labels", lambda: proto_extract_labels(emb, labels, N, k),
             lambda: proto_extract_labels_ref(emb, labels, N, k),
             labels.numel() * labels.element_size(), counted * V)):
        nb = emb.numel() * 4 + sel_bytes + N * (V + 1) * 4
        bms, by = bound(nb, ops + 2 * N * V)
        ms = device_ms(call, dev)
        out[entry] = {"ms": ms, "wrapper_ms": time_ms(call, dev),
                      "plain_ms": time_ms(plain, dev),
                      "library_ms": library_ms, "bound_ms": bms,
                      "bound_by": by, "launch_floor_ms": floors["empty"],
                      "store_floor_ms": floors["store"],
                      "floor_bound_share": (floors["empty"] + bms) / ms}
    for entry, t in out.items():
        log(f"timing proto_extract {entry} entry {tag} N={N} Nk={Nk} V={V}:"
            f" ms={t['ms']:.5f} wrapper_ms={t['wrapper_ms']:.4f} plain_ms="
            f"{t['plain_ms']:.4f} library_ms={t['library_ms']:.5f} "
            f"bound_ms={t['bound_ms']:.7f} bound_by={t['bound_by']} launch "
            f"floor {floors['empty']:.5f} ms (a store {floors['store']:.5f}),"
            f" (floor + bound) / ms = "
            f"{t['floor_bound_share']:.3f} [{smi}]")
    ops = adapt_device_ops(emb, labels, N, k)
    n_ops = sum(ops.values()) - ops["proto_extract launches"]
    log(f"adapt {tag} N={N} Nk={Nk} V={V}: {n_ops} device op(s) after the "
        f"embedder (a captured call's graph nodes): {ops}")
    if ops != {"proto_extract launches": 1, "kernel": 1}:
        raise RuntimeError(f"{tag}: adapt should run one proto_extract "
                           "kernel after the embedder and nothing else")
    return {"V": V, **out["labels"], "adapt_device_ops": n_ops,
            "onehot": out["onehot"]}


# ---------------------------------------------------------------------------
# phase: serve
# ---------------------------------------------------------------------------

def make_model(cfg, dev, seed: int = 0):
    """Bundle, random params (the FC head too, which the model's init
    zeroes) and a non-trivial BN state, from a seed."""
    import torch
    from repro_torch.models import build_tcn_bundle
    from repro_torch.models.tcn import tcn_empty_state

    bundle = build_tcn_bundle(cfg, dev)
    g = torch.Generator().manual_seed(seed)
    params = bundle.init(g)
    fc = params["fc"]
    fc["w"] = (torch.randn(fc["w"].shape, generator=g)
               * cfg.embed_dim ** -0.5).to(dev)
    fc["b"] = (0.1 * torch.randn(fc["b"].shape, generator=g)).to(dev)
    bn = tcn_empty_state(cfg, dev)
    for st in bn.values():
        for key, v in st.items():
            noise = torch.rand(v.shape, generator=g).to(dev)
            st[key] = v + 0.1 * noise if key.endswith("var") else 0.1 * noise
    return bundle, params, bn


def make_schedule(rng, n_sessions: int, length: int, max_chunk: int = 48,
                  min_chunk: int = 1):
    """Ragged push rounds: per round, each unfinished session gets a chunk
    of min_chunk..max_chunk samples, until every stream has ``length``."""
    pos = [0] * n_sessions
    rounds = []
    while min(pos) < length:
        r = {}
        for s in range(n_sessions):
            if pos[s] < length:
                n = int(min(rng.integers(min_chunk, max_chunk + 1),
                             length - pos[s]))
                r[s] = (pos[s], pos[s] + n)
                pos[s] += n
        rounds.append(r)
    return rounds


def drive(svc, audio, schedule, shots, *, park_every: int = 0,
          enroll_round: int = 1):
    """open 64 sessions over 8 tenants, stream the schedule, enroll 5-way
    5-shot on tenant 0 before round ``enroll_round``, poll; returns every
    session's outputs.
    ``park_every`` > 0 parks a rotating fifth of the sessions every that
    many rounds and fills the freed slots with short-lived sessions, so
    parked sessions resume through evictions, in other slots."""
    import numpy as np

    sids = [svc.open_session(tenant=s % N_TENANTS)
            for s in range(audio.shape[0])]
    outs = {s: [] for s in range(audio.shape[0])}
    fillers = []
    for r, rnd in enumerate(schedule):
        if r == enroll_round:
            for way in range(N_WAYS):
                svc.enroll_shots(sids[0], shots[way])
        if park_every and r % park_every == park_every - 1:
            parked = [s for s in range(len(sids)) if s % 5 == r % 5]
            for s in parked:
                svc.park(sids[s])
            for _ in parked:
                f = svc.open_session()
                svc.push_audio({f: audio[0, :3]})
                fillers.append(f)
        res = svc.push_audio({sids[s]: audio[s, a:b]
                              for s, (a, b) in rnd.items()})
        for s in rnd:
            o = res[sids[s]]
            outs[s].append((o["emb"], o["logits"], o["tenant_logits"]))
    polls = [svc.poll(sid) for sid in sids]
    for f in fillers:
        svc.close(f)
    cat = {}
    for s, seq in outs.items():
        tl = [x[2] for x in seq if x[2] is not None]
        cat[s] = (np.concatenate([x[0] for x in seq]),
                  np.concatenate([x[1] for x in seq]),
                  np.concatenate(tl) if tl else None)
    return cat, polls


def same_outputs(a: dict, b: dict) -> bool:
    import numpy as np

    for s in a:
        for x, y in zip(a[s], b[s]):
            if (x is None) != (y is None):
                return False
            if x is not None and not np.array_equal(x, y):
                return False
    return True


# the plain ring bookkeeping and block of the chunk's plain version: a CUDA
# grid must never reach them
PLAIN_CHUNK = ("ordered_history", "ring_advance", "tcn_block_fused")


def check_drive_launches(name, svc, cfg, plain_calls) -> tuple[int, int]:
    """After a drive: one tcn_chunk launch per tick, the strip entry only
    for the N_WAYS enrollment embeds (one call per block each), and no
    call of the plain chunk path.  Returns (chunk, strip) launches."""
    from repro_torch.kernels.tcn_block import tcn_block, tcn_chunk

    chunk, strip = tcn_chunk.launches, tcn_block.launches
    if chunk != svc.dispatches:
        raise AssertionError(f"{name}: {chunk} tcn_chunk launches in "
                             f"{svc.dispatches} ticks")
    if strip != N_WAYS * len(cfg.tcn_channels):
        raise AssertionError(f"{name}: {strip} strip launches, expected "
                             f"{N_WAYS} enrollment embeds")
    if any(plain_calls.values()):
        raise AssertionError(f"{name}: the plain chunk path ran {plain_calls}")
    return chunk, strip


def time_tick(name, svc, x, dev, top: int = 10) -> float:
    """One push_audio tick: exactly one tcn_chunk launch and no strip
    launch; then its end-to-end latency and, on the card, its profile."""
    from repro_torch.kernels.tcn_block import tcn_block, tcn_chunk

    tcn_block.launches = tcn_chunk.launches = 0
    svc.push_audio(x)
    if (tcn_chunk.launches, tcn_block.launches) != (1, 0):
        raise AssertionError(f"{name}: a tick launched tcn_chunk "
                             f"{tcn_chunk.launches} and the strip entry "
                             f"{tcn_block.launches} times")
    ms = time_ms(lambda: svc.push_audio(x), dev)
    log(f"timing {name} tick ({len(x)}x{T_CHUNK} samples, end to end, one "
        f"tcn_chunk launch): ms={ms:.4f}")
    if dev.type == "cuda":
        profile_tick(lambda: svc.push_audio(x), top=top, name=name)
    return ms


def check_long_tick(name, service, audio, cfg) -> int:
    """One push of STREAM_LEN samples to every session of a
    t_chunk=STREAM_LEN service: one tick, split by the fused chunk into
    ceil(STREAM_LEN / max_chunk_len) tcn_chunk launches, counted, and bit
    for bit equal (outputs and slot grid) to the same push through a
    t_chunk=T_CHUNK service.  Returns the long tick's launches."""
    import numpy as np
    from repro_torch.core.streaming import ring_sizes
    from repro_torch.kernels.tcn_block import max_chunk_len, tcn_block, tcn_chunk

    limit = max_chunk_len([(rs["ring1"][0], rs["ring1"][1], rs["ring2"][1],
                            rs["ring1"][1] != rs["ring2"][1])
                           for rs in ring_sizes(cfg).values()], cfg.tcn_kernel)
    runs = []
    for t_chunk in (STREAM_LEN, T_CHUNK):
        svc = service(False, t_chunk)
        sids = [svc.open_session() for _ in range(audio.shape[0])]
        x = {sid: audio[i, :STREAM_LEN] for i, sid in enumerate(sids)}
        tcn_block.launches = tcn_chunk.launches = 0
        res = svc.push_audio(x)
        runs.append(([res[sid] for sid in sids], svc.states, svc.dispatches,
                     tcn_chunk.launches, tcn_block.launches))
    (long, lgrid, lticks, llaunch, lstrip), (short, sgrid, sticks, slaunch, _) \
        = runs
    want = -(-STREAM_LEN // limit)
    if (lticks, llaunch, lstrip) != (1, want, 0):
        raise AssertionError(f"{name} t_chunk={STREAM_LEN}: {lticks} ticks, "
                             f"{llaunch} tcn_chunk and {lstrip} strip "
                             f"launches, expected 1 tick of {want}")
    for a, b in zip(long, short):
        if not all(np.array_equal(a[k], b[k]) for k in ("emb", "logits")):
            raise AssertionError(f"{name}: t_chunk {STREAM_LEN} and {T_CHUNK}"
                                 " differ")
    if not same_grid(lgrid, sgrid):
        raise AssertionError(f"{name}: t_chunk {STREAM_LEN} and {T_CHUNK} "
                             "leave different slot grids")
    log(f"{name} t_chunk={STREAM_LEN}: {audio.shape[0]} sessions x "
        f"{STREAM_LEN} samples in one tick of {llaunch} tcn_chunk launches "
        f"(max_chunk_len {limit}; launches per tick {llaunch}), bit for bit "
        f"equal to t_chunk={T_CHUNK} ({slaunch} launches in {sticks} ticks)")
    return llaunch


def phase_serve(cfg, dev, seed: int = 0, stream_len: int = STREAM_LEN,
                n_sessions: int = N_SLOTS, shot_len: int | None = None,
                long_tick: bool = True):
    """``n_sessions`` ragged streams of ``stream_len`` samples with 5-way
    5-shot enrollment of ``shot_len``-sample clips; invariance and
    park/resume; the tick; and, with ``long_tick``, one STREAM_LEN tick."""
    import numpy as np
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.proto_extract import proto_extract
    from repro_torch.kernels.tcn_block import tcn_block, tcn_chunk
    from repro_torch.models.tcn import bake_stream_params, make_fused_forward
    from repro_torch.sessions import StreamSessionService

    rng = np.random.default_rng(seed)
    bundle, params, bn = make_model(cfg, dev, seed)
    audio = rng.normal(size=(n_sessions, stream_len, cfg.tcn_in_channels)
                       ).astype(np.float32)
    shots = rng.normal(size=(N_WAYS, K_SHOTS, shot_len or stream_len,
                             cfg.tcn_in_channels)).astype(np.float32)
    schedule = make_schedule(rng, n_sessions, stream_len)

    def service(quantize, t_chunk):
        return StreamSessionService(
            bundle, params, bn, n_slots=n_sessions, max_tenants=N_TENANTS,
            max_ways=8, t_chunk=t_chunk, quantize=quantize, fused=True)

    result = {}
    for quantize in (False, True):
        svc = service(quantize, T_CHUNK)
        tcn_block.launches = tcn_chunk.launches = proto_extract.launches = 0
        with counting(ref, PLAIN_CHUNK) as plain:
            main, polls = drive(svc, audio, schedule, shots)
        chunk, strip = check_drive_launches(f"serve {cfg.name} quantize={quantize}", svc,
                                            cfg, plain.calls)
        if not quantize:
            result["launches"] = chunk + strip
        for s, (e, lg, tl) in main.items():
            if e.shape != (stream_len, cfg.embed_dim) or \
                    lg.shape != (stream_len, cfg.n_classes):
                raise AssertionError(f"serve: session {s} shapes {e.shape}, "
                                     f"{lg.shape}")
            # unlearned ways carry bias -inf by design: check learned ones
            for a in (e, lg) + ((tl[:, :N_WAYS],) if tl is not None else ()):
                if not np.isfinite(a).all():
                    raise AssertionError(f"serve: session {s} non-finite")
        if not any(np.abs(lg).max() > 0 for _, lg, _ in main.values()):
            raise AssertionError("serve: all logits are zero")
        if polls[0]["n_ways"] != N_WAYS or main[0][2] is None:
            raise AssertionError("serve: enrollment did not reach tenant 0")
        if any(p["steps"] != stream_len for p in polls):
            raise AssertionError("serve: a session lost steps")
        log(f"serve {cfg.name} quantize={quantize}: {n_sessions} sessions x {stream_len}"
            f" samples in {len(schedule)} ragged rounds, {svc.dispatches} "
            f"ticks, tcn_chunk launches={chunk} (one a tick), strip "
            f"launches={strip} (enrollment), plain chunk calls 0, enrolled "
            f"{polls[0]['n_ways']} ways; outputs finite")
        one, _ = drive(service(quantize, 1), audio, schedule, shots)
        if not same_outputs(main, one):
            raise AssertionError(f"serve {cfg.name} quantize={quantize}: t_chunk "
                                 f"{T_CHUNK} and 1 differ")
        parked_svc = service(quantize, T_CHUNK)
        parked, _ = drive(parked_svc, audio, schedule, shots, park_every=4)
        if not same_outputs(main, parked):
            raise AssertionError(f"serve {cfg.name} quantize={quantize}: park/resume "
                                 "changed the outputs")
        log(f"serve {cfg.name} quantize={quantize}: chunk-size invariance (t_chunk "
            f"{T_CHUNK} vs 1) and park/resume ({parked_svc.evictions} "
            "evictions) bit-exact")
        if not quantize:
            sids = [svc.open_session() for _ in range(n_sessions)]
            x = {sid: audio[i, :T_CHUNK] for i, sid in enumerate(sids)}
            result["tick_ms"] = time_tick(f"{cfg.name} push_audio", svc, x,
                                          dev)
    if long_tick:
        result["launches"] += check_long_tick("serve", service, audio, cfg)
    # small-input reference: the fused forward on the card against the
    # plain versions on the CPU
    _, _, fp = bake_stream_params(params, bn, cfg)
    x = shots[0, :2]
    fwd_dev = make_fused_forward(cfg, device=dev)
    fwd_cpu = make_fused_forward(cfg, device="cpu")
    fp_cpu = _to(fp, "cpu")
    e_dev, _ = fwd_dev(fp, torch.from_numpy(x).to(dev))
    e_cpu, _ = fwd_cpu(fp_cpu, torch.from_numpy(x))
    err = compare("serve: fused forward card vs CPU", e_dev.cpu(), e_cpu,
                  False)
    log("serve: fused forward on the card agrees with the CPU plain "
        f"versions (max abs err {err:.3g}, values up to "
        f"{e_cpu.abs().max().item():.3g})")
    return result


def profile_tick(fn, ticks: int = 10, top: int = 10,
                 name: str = "push_audio") -> dict:
    """Where a tick's time goes: torch.profiler over ``ticks`` calls,
    device busy time per tick against the profiled wall time, and the ops
    that take the most device time.  Returns the tick's numbers."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / ticks
    events = prof.key_averages()
    # device-side events only (kernels, copies): the CPU ops that launched
    # them report the same device time again
    on_dev = [e for e in events if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in on_dev) / 1e3 / ticks
    launches = sum(e.count for e in events
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                "cudaLaunchKernelExC")) / ticks
    log(f"profile {name} tick: wall_ms={wall:.4f} (profiled) "
        f"device_busy_ms={busy:.4f} device_idle_share="
        f"{1 - busy / wall:.4f} kernel_launches_per_tick={launches:.1f}")
    for e in sorted(on_dev, key=lambda e: e.self_device_time_total,
                    reverse=True)[:top]:
        log(f"  profile device op {e.key[:70]!r}: device_ms_per_tick="
            f"{e.self_device_time_total / 1e3 / ticks:.4f} calls_per_tick="
            f"{e.count / ticks:.1f}")
    return {"wall_ms": wall, "busy_ms": busy, "launches": launches}


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


# ---------------------------------------------------------------------------
# phase: fsl
# ---------------------------------------------------------------------------

def phase_fsl(cfg, dev, seed: int = 2, stream_len: int = STREAM_LEN):
    import numpy as np
    import torch
    from repro_torch.core.protonet import adapt, pn_fc_from_sums, support_sums
    from repro_torch.kernels.proto_extract import proto_extract
    from repro_torch.kernels.tcn_block import tcn_block
    from repro_torch.models.tcn import bake_stream_params, make_fused_forward

    rng = np.random.default_rng(seed)
    bundle, params, bn = make_model(cfg, dev, seed)
    _, _, fp = bake_stream_params(params, bn, cfg)
    fwd = make_fused_forward(cfg, device=dev)
    embed_fn = lambda p, x: fwd(p, x)[0]
    counts = {}
    for k in (1, K_SHOTS):
        support = torch.from_numpy(rng.normal(
            size=(N_WAYS * k, stream_len, cfg.tcn_in_channels)
        ).astype(np.float32)).to(dev)
        labels = torch.arange(N_WAYS, device=dev).repeat_interleave(k)
        tcn_block.launches = proto_extract.launches = 0
        w, b = adapt(embed_fn, fp, support, labels, N_WAYS, k)
        sync(dev)
        counts[k] = (proto_extract.launches, tcn_block.launches)
        if 0 in counts[k]:
            raise AssertionError("fsl: a kernel was not launched "
                                 f"(proto_extract, tcn_block) = {counts[k]}")
        ws, bs = pn_fc_from_sums(support_sums(embed_fn(fp, support), labels,
                                              N_WAYS), k)
        err = max(compare(f"fsl {k}-shot W", w, ws, False),
                  compare(f"fsl {k}-shot b", b, bs, False))
        log(f"fsl 5-way {k}-shot: W {tuple(w.shape)} b {tuple(b.shape)} "
            f"match support_sums+pn_fc_from_sums (max abs err {err:.3g}, "
            f"|b| up to {bs.abs().max().item():.3g}); "
            f"proto_extract launches={counts[k][0]} tcn_block "
            f"launches={counts[k][1]}")
    return counts


# ---------------------------------------------------------------------------
# phase: cl (the paper's continual-learning demo on paged and dense banks)
# ---------------------------------------------------------------------------

# benchmarks/cl_curve.py's served configuration: 250 ways learned one at a
# time with 10 shots each, 16-way bank blocks, 8 rehearsal shots a class;
# a 48-block pool (3 x 16 blocks) shared by 4 tenants
CL_WAYS, CL_SHOTS, CL_BLOCK_WAYS, CL_BLOCKS, CL_CAP = 250, 10, 16, 48, 8
CL_TENANTS, CL_CHECK_EVERY, CL_REFINE_EVERY = 4, 25, 10
# embedded ways of tenants B (16 blocks) and C (8 blocks)
CL_B_WAYS, CL_C_WAYS = 250, 128
KWS_WINDOW = 63  # chameleon-tcn-kws's MFCC frames per window (§IV-C)


def cl_service(bundle, params, bn, paged, max_ways, block_ways, blocks):
    """A CL service over the serve phase's grid (``blocks=None``: the
    service's default pool, max_tenants x ceil(max_ways / block_ways))."""
    from repro_torch.sessions import StreamSessionService

    return StreamSessionService(
        bundle, params, bn, n_slots=N_SLOTS, max_tenants=N_TENANTS,
        max_ways=max_ways, t_chunk=T_CHUNK, fused=True, paged_bank=paged,
        bank_block_ways=block_ways, bank_blocks=blocks, rehearsal_cap=CL_CAP)


def percentile_ms(seconds, q) -> float:
    import numpy as np

    return float(np.percentile(np.asarray(seconds) * 1e3, q))


def phase_cl(cfg, dev, seed: int = 8, ways: int = CL_WAYS,
             clip_len: int = STREAM_LEN):
    """Two services driven with the same calls, one with paged banks and
    one with dense banks; every tick's outputs equal bit for bit.  Returns
    the drive's tcn_block launches (both entries, both services)."""
    import numpy as np
    import torch
    from repro_torch.core.protonet import l2_classify, pn_logits_banked
    from repro_torch.kernels import ref
    from repro_torch.kernels.tcn_block import tcn_block, tcn_chunk
    from repro_torch.sessions import AdmissionError, PoolExhausted

    rng = np.random.default_rng(seed)
    bundle, params, bn = make_model(cfg, dev, seed)
    V, c_in = cfg.embed_dim, cfg.tcn_in_channels
    A, B, C, D = range(CL_TENANTS)
    svcs = {name: cl_service(bundle, params, bn, name == "paged", ways,
                             CL_BLOCK_WAYS, CL_BLOCKS)
            for name in ("paged", "dense")}
    paged = svcs["paged"]
    sids = {name: {} for name in svcs}  # session index -> sid
    tenant_of = {}
    ways_of = dict.fromkeys(range(CL_TENANTS), 0)
    lat = {name: [] for name in svcs}
    ticked = []  # the tags of the ticks run

    def open_(i, tenant):
        for name, svc in svcs.items():
            sids[name][i] = svc.open_session(tenant=tenant)
        tenant_of[i] = tenant

    def close_tenant(tenant):
        for i in [i for i, t in tenant_of.items() if t == tenant]:
            for name, svc in svcs.items():
                svc.close(sids[name].pop(i))
            del tenant_of[i]
        for svc in svcs.values():
            svc.close_tenant(tenant)
        ways_of[tenant] = 0

    def enroll(tenant, shots, *, timed=False, **kw):
        got = set()
        for name, svc in svcs.items():
            sync(dev)
            t0 = time.perf_counter()
            got.add(svc.enroll_shots(sids[name][tenant], shots, **kw))
            sync(dev)
            if timed:
                lat[name].append(time.perf_counter() - t0)
        if len(got) != 1:
            raise AssertionError(f"cl: the services enrolled ways {got}")
        way = got.pop()
        ways_of[tenant] = max(ways_of[tenant], way + 1)
        return way

    def embedded(n):
        return rng.normal(size=(n, CL_SHOTS, V)).astype(np.float32)

    def tick(tag):
        ticked.append(tag)
        idx = sorted(tenant_of)
        x = rng.normal(size=(len(idx), T_CHUNK, c_in)).astype(np.float32)
        outs = {}
        for name, svc in svcs.items():
            res = svc.push_audio({sids[name][i]: x[j]
                                  for j, i in enumerate(idx)})
            outs[name] = {i: res[sids[name][i]] for i in idx}
        for i in idx:
            p, d = outs["paged"][i], outs["dense"][i]
            for key in ("emb", "logits", "tenant_logits"):
                if (p[key] is None) != (d[key] is None) or (
                        p[key] is not None and not np.array_equal(p[key],
                                                                  d[key])):
                    raise AssertionError(f"cl {tag}: session {i} {key}: "
                                         "paged and dense differ")
            n, tl = ways_of[tenant_of[i]], p["tenant_logits"]
            if not np.isfinite(p["emb"]).all() or (n and (
                    tl.shape != (T_CHUNK, ways)
                    or not np.isfinite(tl[:, :n]).all()
                    or not np.isneginf(tl[:, n:]).all())):
                raise AssertionError(f"cl {tag}: session {i} (tenant "
                                     f"{tenant_of[i]}, {n} ways) not finite "
                                     "on its ways and -inf past them")
        return outs

    def agreement(outs) -> tuple[int, int]:
        """Tenant A's tenant-logit argmax against l2_classify over A's
        prototypes s/k on the same embeddings; a disagreement must be a
        near tie (squared distances equal to 1e-4 of their scale)."""
        blob = paged.export_tenant(A)
        protos = torch.from_numpy(blob["s_sums"] / blob["counts"][:, None])
        mine = [i for i in sorted(outs["paged"]) if tenant_of[i] == A]
        emb = np.concatenate([outs["paged"][i]["emb"] for i in mine])
        pred = np.concatenate([outs["paged"][i]["tenant_logits"]
                               for i in mine]).argmax(-1)
        cls, d2 = l2_classify(torch.from_numpy(emb).to(dev), protos.to(dev))
        cls, d2 = cls.cpu().numpy(), d2.cpu().numpy()
        scale = (emb ** 2).sum(-1) + (protos.numpy() ** 2).sum(-1).max()
        for r in np.nonzero(pred != cls)[0]:
            if abs(d2[r, pred[r]] - d2[r, cls[r]]) > 1e-4 * scale[r]:
                raise AssertionError(f"cl: step {r} classified {pred[r]}, "
                                     f"l2_classify {cls[r]}, not a near tie")
        return int((pred == cls).sum()), len(pred)

    for s in range(N_SLOTS):
        open_(s, s % CL_TENANTS)
    start = {name: svc.dispatches for name, svc in svcs.items()}
    tcn_block.launches = tcn_chunk.launches = 0
    t_drive = time.perf_counter()
    with counting(ref, PLAIN_CHUNK) as plain:
        for n_ways, tenant in ((CL_B_WAYS, B), (CL_C_WAYS, C)):
            for e in embedded(n_ways):
                enroll(tenant, e, embedded=True)
        checks = []
        for j in range(ways):  # the demo: one way at a time, raw clips
            clips = rng.normal(size=(CL_SHOTS, clip_len, c_in)
                               ).astype(np.float32)
            if enroll(A, clips, label=j, timed=True) != j:
                raise AssertionError(f"cl: way {j} enrolled elsewhere")
            if j % CL_REFINE_EVERY == CL_REFINE_EVERY - 1:
                more = rng.normal(size=clips.shape).astype(np.float32)
                if enroll(A, more, label=j, timed=True) != j:
                    raise AssertionError(f"cl: the refine of way {j} moved")
            if (j + 1) % CL_CHECK_EVERY == 0:
                checks.append(agreement(tick(f"{j + 1} ways")))
        bp = paged.bankpool
        live, packed_b = bp.pool.n_live, bp.pack(B)
        for i in [i for i, t in tenant_of.items() if t == B]:
            paged.park(sids["paged"][i])
        b_blocks = -(-CL_B_WAYS // CL_BLOCK_WAYS)
        if bp.is_resident(B) or live - bp.pool.n_live != b_blocks:
            raise AssertionError(f"cl: parking B freed {live - bp.pool.n_live}"
                                 f" blocks, expected {b_blocks}")
        parked_live = bp.pool.n_live
        tick("B resumed")  # the dense service never parked: the control
        if not bp.is_resident(B) or bp.pack(B) != packed_b:
            raise AssertionError("cl: B's rows changed through park/resume")
        n_d = bp.pool.n_free * CL_BLOCK_WAYS
        for e in embedded(n_d):
            enroll(D, e, embedded=True)
        extra = embedded(1)[0]
        try:
            paged.enroll_shots(sids["paged"][D], extra, embedded=True)
        except PoolExhausted as e:
            exhausted = e
        else:
            raise AssertionError(f"cl: way {n_d + 1} of D fit a full pool")
        if not isinstance(exhausted, AdmissionError) or \
                bp.n_ways[D] != n_d or bp.pool.n_free != 0:
            raise AssertionError("cl: exhaustion is not back-pressure")
        close_tenant(C)
        enroll(D, extra, embedded=True)  # C's blocks came back to the pool
        tick("C closed, D past the full pool")
        for svc in svcs.values():
            if svc.rehearse_tenant(A) != ways:
                raise AssertionError("cl: rehearse_tenant rebuilt too few")
        tick("A rehearsed")
        close_tenant(D)
        blobs = {name: svc.export_tenant(A) for name, svc in svcs.items()}
        same_blob(blobs["paged"], blobs["dense"], "cl export of A")
        svcs["dense"].adopt_tenant(C, blobs["paged"])
        paged.adopt_tenant(C, blobs["dense"])
        if bp.is_resident(C):
            raise AssertionError("cl: the paged bank adopted C resident")
        for s in range(C, N_SLOTS, CL_TENANTS):
            open_(s, C)
        ways_of[C] = ways
        tick("A adopted as C across the layouts")
        for name, svc in svcs.items():
            same_blob(svc.export_tenant(C), blobs["paged"],
                      f"cl {name} re-export of the adopted tenant")
    drive_s = time.perf_counter() - t_drive
    ticks = sum(svc.dispatches - start[name] for name, svc in svcs.items())
    chunk, strip = tcn_chunk.launches, tcn_block.launches
    raw = 2 * (ways + ways // CL_REFINE_EVERY)
    if chunk != ticks or strip != raw * len(cfg.tcn_channels) or \
            any(plain.calls.values()):
        raise AssertionError(f"cl: {chunk} tcn_chunk launches in {ticks} "
                             f"ticks, {strip} strip launches for {raw} raw "
                             f"enrolls, plain chunk calls {plain.calls}")
    agree, total = sum(c[0] for c in checks), sum(c[1] for c in checks)
    st = paged.stats()
    log(f"cl {cfg.name}: tenant A learned {ways} ways x {CL_SHOTS} shots of "
        f"{clip_len}-sample clips one way at a time ({ways // CL_REFINE_EVERY}"
        f" refined through label=) on a paged (bank_block_ways="
        f"{CL_BLOCK_WAYS}, bank_blocks={CL_BLOCKS}) and a dense service; "
        f"{len(ticked)} ticks of up to {N_SLOTS}x{T_CHUNK} samples over "
        f"{CL_TENANTS} tenants, paged == dense bit for bit at every check; "
        f"argmax agrees with l2_classify on {agree} of {total} steps (the "
        f"rest near ties); B parked ({parked_live} blocks live, {b_blocks} "
        "out) and resumed bit-exact; D's way past the full pool raised "
        f"PoolExhausted ({type(exhausted).__mro__[1].__name__}), and fit "
        "after close_tenant; rehearse_tenant and export/adopt between the "
        f"layouts bit-exact; {drive_s:.1f} s; tcn_chunk launches={chunk} "
        f"(one a tick), strip launches={strip} ({raw} raw enrolls), plain "
        "chunk calls 0")
    for name in svcs:
        log(f"timing cl {name} enroll_shots ({len(lat[name])} raw enrolls of "
            f"{CL_SHOTS}x{clip_len} samples, host clock to "
            f"torch.cuda.synchronize): p50_ms={percentile_ms(lat[name], 50):.4f}"
            f" p99_ms={percentile_ms(lat[name], 99):.4f}")
    log(f"cl pool: {', '.join(f'{k}={v}' for k, v in st.items() if k.startswith('bank_pool_'))}"
        f", tenant_row_bytes={st['tenant_row_bytes']} (one block); rehearsal "
        f"bytes paged={st['rehearsal_bytes']} dense="
        f"{svcs['dense'].stats()['rehearsal_bytes']} (tenant A "
        f"{paged.rehearsal.nbytes(A)})")
    # the ticks, 64 sessions x 16 samples each: 250 ways (also with the FC
    # rows gathered again every step, in the fixed-order contraction and
    # in torch.einsum, for comparison) beside 8 ways
    for s in range(D, N_SLOTS, CL_TENANTS):
        open_(s, A)
    x = rng.normal(size=(N_SLOTS, T_CHUNK, c_in)).astype(np.float32)
    pushes = {name: {sids[name][i]: x[i] for i in range(N_SLOTS)}
              for name in svcs}
    result = {"launches": chunk + strip}
    for name, svc in svcs.items():
        result[f"{name}_tick_ms"] = time_tick(f"cl {name} {ways}-way", svc,
                                              pushes[name], dev, top=5)
    e = torch.randn((N_SLOTS, T_CHUNK, V), device=dev)
    w, b = paged._slot_fc()
    ids = torch.arange(N_SLOTS, device=dev)

    def per_step_regather(emb, w, b):
        return torch.stack([pn_logits_banked(emb[:, i].contiguous(), w, b, ids)
                            for i in range(emb.shape[1])], dim=1)

    if not torch.equal(paged._banked(e, w, b), per_step_regather(e, w, b)):
        raise AssertionError("cl: the gathered-once tick differs from the "
                             "per-step regather")
    def per_step_einsum(emb, w, b):
        # the tick before the fixed-order contraction: each step indexed
        # the rows again and contracted them with torch.einsum (timed
        # only: its bits depend on N)
        return torch.stack([torch.einsum("sv,snv->sn", emb[:, i], w[ids])
                            + b[ids] for i in range(emb.shape[1])], dim=1)

    if dev.type == "cuda":
        push = lambda: paged.push_audio(pushes["paged"])
        forms = {"gathered once": None, "per-step regather": per_step_regather,
                 "per-step einsum": per_step_einsum}
        for form in list(forms) + list(forms)[::-1]:
            if forms[form] is not None:
                paged._banked = forms[form]
            profile_tick(push, top=3, name=f"cl paged {ways}-way, tenant FC "
                         f"{form}")
            paged.__dict__.pop("_banked", None)
    small = {name: cl_service(bundle, params, bn, name == "paged", 8, 8, None)
             for name in svcs}
    for name, svc in small.items():
        ssids = [svc.open_session(tenant=s % CL_TENANTS)
                 for s in range(N_SLOTS)]
        erng = np.random.default_rng(seed + 1)
        for t in range(CL_TENANTS):
            for _ in range(8):
                svc.enroll_shots(ssids[t], erng.normal(size=(CL_SHOTS, V)),
                                 embedded=True)
        result[f"{name}_tick8_ms"] = time_tick(
            f"cl {name} 8-way", svc, {sid: x[i] for i, sid in enumerate(ssids)},
            dev, top=5)
    return result


def same_blob(a: dict, b: dict, tag: str) -> None:
    """Two export_tenant blobs hold the same sums, counts, labels and
    rehearsal bytes."""
    import numpy as np

    if a["n_ways"] != b["n_ways"] or a["labels"] != b["labels"] or not all(
            np.array_equal(a[k], b[k]) for k in ("s_sums", "counts")):
        raise AssertionError(f"{tag}: the tenant's rows differ")
    ra, rb = a.get("rehearsal", {}), b.get("rehearsal", {})
    if ra.keys() != rb.keys() or any(
            ra[w]["seen"] != rb[w]["seen"] or len(ra[w]["shots"]) != len(
                rb[w]["shots"]) or any(
                not np.array_equal(p, q) or s != t
                for (p, s), (q, t) in zip(ra[w]["shots"], rb[w]["shots"]))
            for w in ra):
        raise AssertionError(f"{tag}: the rehearsal reservoirs differ")


# ---------------------------------------------------------------------------
# phases: plane, spill, kws server (the serving layer)
# ---------------------------------------------------------------------------

# the plane phase: benchmarks/cl_curve.py's served configuration on both
# workers, at the serve phase's grid, 192 sessions over 6 tenants; at most
# PLANE_LIVE sessions are open at a time (each worker admits 128), the
# last PLANE_KEEP stay open for the spill phase
PLANE_SESSIONS, PLANE_TENANTS, PLANE_LIVE, PLANE_KEEP = 192, 6, 128, 64
PLANE_MAX_SESSIONS, PLANE_STEAL = 128, 16
# worker 0's verb clock runs its tenants' first opens and 15 enrolls, then
# the clients' opens (the storm), then mostly pushes (one verb a batch,
# the flakes) and closes; a crash lands in each of the two stretches
PLANE_FAULTS = "crash@40,storm@60x40,flake@120x30,crash@200"
PLANE_DRAIN_AFTER = 48   # closed sessions before worker 1 drains
SPILL_EXTRA = 64         # samples pushed to every restored session


def plane_service(bundle, params, bn, **kw):
    from repro_torch.sessions import StreamSessionService

    return StreamSessionService(
        bundle, params, bn, n_slots=N_SLOTS, max_tenants=N_TENANTS,
        max_ways=CL_WAYS, t_chunk=T_CHUNK, fused=True, paged_bank=True,
        bank_block_ways=CL_BLOCK_WAYS, bank_blocks=CL_BLOCKS,
        rehearsal_cap=CL_CAP, max_sessions=PLANE_MAX_SESSIONS, **kw)


def host_bytes(obj) -> int:
    """Bytes of the numpy arrays in a nested blob (a journal entry)."""
    import numpy as np

    if isinstance(obj, dict):
        return sum(host_bytes(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(host_bytes(v) for v in obj)
    return obj.nbytes if isinstance(obj, np.ndarray) else 0


def plane_tenants() -> list:
    """PLANE_TENANTS tenant ids, half hashing to each of two workers (the
    plane routes a tenant to crc32(str(tenant)) % workers)."""
    import zlib

    by = {0: [], 1: []}
    for t in range(N_TENANTS):
        by[zlib.crc32(str(t).encode()) % 2].append(t)
    half = PLANE_TENANTS // 2
    if min(len(by[0]), len(by[1])) < half:
        raise AssertionError(f"tenant ids split {by}, need {half} a side")
    return sorted(by[0][:half] + by[1][:half])


def concat_results(results: list) -> tuple:
    import numpy as np

    tl = [r["tenant_logits"] for r in results]
    if any(t is None for t in tl):
        if not all(t is None for t in tl):
            raise AssertionError("tenant logits appeared mid-stream")
        tl = None
    else:
        tl = np.concatenate(tl)
    return (np.concatenate([r["emb"] for r in results]),
            np.concatenate([r["logits"] for r in results]), tl,
            [r["pred"] for r in results])


def same_stream(a: tuple, b: tuple) -> bool:
    import numpy as np

    return all((x is None and y is None) or (
        x is not None and y is not None and np.array_equal(x, y))
        for x, y in zip(a[:3], b[:3])) and a[3] == b[3]


def plane_tick(bundle, params, bn, audio) -> dict:
    """The 64 x T_CHUNK tick through a one-worker plane (64 concurrent
    clients, one batch, one tick; with and without the spill journal)
    beside the same tick on the bare service, in turns, host clock around
    calls that return host arrays."""
    import asyncio

    import numpy as np
    from repro_torch.obs import MetricsRegistry
    from repro_torch.serving import ServingPlane

    x = audio[:, :T_CHUNK]
    bare = plane_service(bundle, params, bn)
    sids = [bare.open_session() for _ in range(N_SLOTS)]
    work = {sid: x[i] for i, sid in enumerate(sids)}

    async def through(every):
        plane = ServingPlane(plane_service(bundle, params, bn),
                             metrics=MetricsRegistry(),
                             checkpoint_every=every)
        async with plane:
            ps = [await plane.open_session() for _ in range(N_SLOTS)]

            async def tick():
                await asyncio.gather(*(plane.push(p, x[i])
                                       for i, p in enumerate(ps)))

            for _ in range(3):
                await tick()
            ms = []
            for _ in range(20):
                t0 = time.perf_counter()
                await tick()
                ms.append((time.perf_counter() - t0) * 1e3)
            lanes = plane.metrics()["plane_batch_lanes"][0]
            if lanes["max"] != N_SLOTS:
                raise AssertionError(f"plane tick: batches of {lanes['max']}"
                                     f" lanes, expected {N_SLOTS}")
            return float(np.median(ms))

    def bare_ms():
        for _ in range(3):
            bare.push(work)
        ms = []
        for _ in range(20):
            t0 = time.perf_counter()
            bare.push(work)
            ms.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ms))

    out = {}
    for name in ("bare", "plane", "plane_journal", "plane", "bare"):
        if name == "bare":
            ms = bare_ms()
        else:
            ms = asyncio.run(through(1 if name == "plane_journal" else 0))
        out.setdefault(name, []).append(ms)
    log(f"plane tick ({N_SLOTS}x{T_CHUNK} samples, end to end, median of 20,"
        f" turns bare/plane/plane+journal/plane/bare): bare_ms="
        f"{out['bare']} plane_ms={out['plane']} "
        f"plane_journal_ms={out['plane_journal']}")
    return {k: float(np.median(v)) for k, v in out.items()}


def phase_plane(cfg, dev, seed: int = 11, stream_len: int = STREAM_LEN,
                shot_len: int = STREAM_LEN):
    """The fault-tolerant ServingPlane over two paged CL services at full
    width: tenants enroll N_WAYS x K_SHOTS raw clips, then PLANE_SESSIONS
    concurrent clients stream ragged chunks through crash, flake, storm,
    a drain of worker 1 and work stealing, retrying Rejected through
    RetryPolicy; every session's outputs equal a synchronous control's bit
    for bit.  Returns the launches and what the spill phase needs."""
    import asyncio
    import gc
    import weakref

    import numpy as np
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.tcn_block import tcn_block, tcn_chunk
    from repro_torch.obs import MetricsRegistry, latency_summary
    from repro_torch.serving import (FaultInjector, FaultPlan, Rejected,
                                     RetryPolicy, ServingPlane)
    from repro_torch.sessions.state import parked_bytes

    rng = np.random.default_rng(seed)
    bundle, params, bn = make_model(cfg, dev, seed)
    c_in = cfg.tcn_in_channels
    tenants = plane_tenants()
    tenant_of = [tenants[i % len(tenants)] for i in range(PLANE_SESSIONS)]
    audio = rng.normal(size=(PLANE_SESSIONS, stream_len + SPILL_EXTRA, c_in)
                       ).astype(np.float32)
    shots = {t: rng.normal(size=(N_WAYS, K_SHOTS, shot_len, c_in)
                           ).astype(np.float32) for t in tenants}
    schedule = make_schedule(rng, PLANE_SESSIONS, stream_len)
    chunks = {i: [rnd[i] for rnd in schedule if i in rnd]
              for i in range(PLANE_SESSIONS)}
    built = []  # every service the workers ran, to check the dead are freed

    def factory():
        svc = plane_service(bundle, params, bn)
        built.append(weakref.ref(svc))
        return svc

    inj = FaultInjector(factory(), FaultPlan.parse(PLANE_FAULTS),
                        factory=factory)
    reg = MetricsRegistry()
    plane = ServingPlane([inj, factory()], metrics=reg, checkpoint_every=1,
                         steal_threshold=PLANE_STEAL)
    journal = {"s": 0.0, "bytes": 0, "epochs": 0}
    flush = plane._flush_journal

    def timed_flush(w):
        dirty, tids = set(w.dirty), set(w.dirty_tenants)
        t0 = time.perf_counter()
        flush(w)
        journal["s"] += time.perf_counter() - t0
        journal["epochs"] += 1
        journal["bytes"] += sum(parked_bytes(plane._journal[p]["blob"])
                                for p in dirty if p in plane._journal)
        journal["bytes"] += sum(host_bytes(plane._tenant_journal[k])
                                for k in plane._tenant_journal
                                if k[0] == w.idx and k[1] in tids)

    plane._flush_journal = timed_flush
    latencies, outs = [], {i: [] for i in range(PLANE_SESSIONS)}
    psids, done = {}, {"closed": 0}
    drain_after = min(PLANE_DRAIN_AFTER, PLANE_SESSIONS - PLANE_KEEP)

    async def call(op, attempt_seed):
        policy = RetryPolicy(seed=attempt_seed)
        t0 = time.perf_counter()
        for attempt in range(10_000):
            try:
                res = await op()
                latencies.append(time.perf_counter() - t0)
                return res
            except Rejected as e:
                if not e.retryable:
                    raise
                await policy.sleep(attempt, e.retry_after)
        raise AssertionError("an op ran out of retries")

    async def main():
        drained = asyncio.Event()
        live = asyncio.Semaphore(PLANE_LIVE)
        first = {t: tenant_of.index(t) for t in tenants}
        async with plane:
            # each tenant's first session enrolls its ways before any push
            for t in tenants:
                await live.acquire()
                i = first[t]
                psids[i] = await call(lambda: plane.open_session(tenant=t), i)
            for t in tenants:
                for way in range(N_WAYS):
                    if await call(lambda: plane.enroll(
                            psids[first[t]], shots[t][way]), t) != way:
                        raise AssertionError("plane: enrollment order")

            async def client(i):
                if i not in psids:
                    await live.acquire()
                    psids[i] = await call(
                        lambda: plane.open_session(tenant=tenant_of[i]), i)
                for a, b in chunks[i]:
                    outs[i].append(await call(
                        lambda: plane.push(psids[i], audio[i, a:b]), i))
                if i < PLANE_SESSIONS - PLANE_KEEP:
                    await call(lambda: plane.close(psids[i]), i)
                    done["closed"] += 1
                    if done["closed"] == drain_after:
                        drained.set()
                    live.release()

            async def drainer():
                await drained.wait()
                while True:  # a crashed peer cannot take the handoff yet
                    try:
                        s = await plane.drain(1)
                        break
                    except RuntimeError:
                        await asyncio.sleep(0.005)
                plane.undrain(1)
                return s

            results = await asyncio.gather(
                drainer(), *(client(i) for i in range(PLANE_SESSIONS)))
            return results[0]

    tcn_block.launches = tcn_chunk.launches = 0
    t0 = time.perf_counter()
    with counting(ref, PLAIN_CHUNK) as plain:
        summary = asyncio.run(main())
    wall = time.perf_counter() - t0
    chunk, strip = tcn_chunk.launches, tcn_block.launches
    st, m = plane.stats(), plane.metrics()
    counter = lambda name: sum(e["value"] for e in m.get(name, []))
    fired = [k for _, k in inj.faults]
    if st["lost_sessions"] != 0:
        raise AssertionError(f"plane: {st['lost_sessions']} sessions lost")
    if counter("plane_crashes_total") < 1 or \
            counter("plane_recoveries_total") < 1:
        raise AssertionError(f"plane: faults fired {fired}, but crashes "
                             f"{counter('plane_crashes_total')} recoveries "
                             f"{counter('plane_recoveries_total')}")
    if summary["moved_sessions"] < 1:
        raise AssertionError(f"plane: the drain moved nothing {summary}")
    if strip != len(tenants) * N_WAYS * len(cfg.tcn_channels):
        raise AssertionError(f"plane: {strip} strip launches for "
                             f"{len(tenants) * N_WAYS} enrollments")
    if chunk < 1 or any(plain.calls.values()):
        raise AssertionError(f"plane: {chunk} tcn_chunk launches, plain "
                             f"chunk calls {plain.calls}")
    gc.collect()
    dead = [r for r in built if r() is not None and r() is not inj.service
            and r() is not plane.workers[1].service]
    if dead:
        raise AssertionError(f"plane: {len(dead)} crashed services still "
                             "hold their tensors")
    # the synchronous control: one service of the same geometry replays
    # each session's ops in its own order, in waves of N_SLOTS sessions
    ctl = plane_service(bundle, params, bn)
    csid = {}
    for t in tenants:
        i = tenant_of.index(t)
        csid[i] = ctl.open_session(tenant=t)
        for way in range(N_WAYS):
            ctl.enroll_shots(csid[i], shots[t][way])
    for w0 in range(0, PLANE_SESSIONS, N_SLOTS):
        wave = range(w0, min(w0 + N_SLOTS, PLANE_SESSIONS))
        for i in wave:
            if i not in csid:
                csid[i] = ctl.open_session(tenant=tenant_of[i])
        want = {i: [] for i in wave}
        for r in range(max(len(chunks[i]) for i in wave)):
            batch = {csid[i]: audio[i, slice(*chunks[i][r])]
                     for i in wave if r < len(chunks[i])}
            res = ctl.push_audio(batch)
            for i in wave:
                if r < len(chunks[i]):
                    want[i].append(res[csid[i]])
        for i in wave:
            if not same_stream(concat_results(outs[i]),
                               concat_results(want[i])):
                raise AssertionError(f"plane: session {i} (tenant "
                                     f"{tenant_of[i]}) differs from the "
                                     "synchronous control")
            if i < PLANE_SESSIONS - PLANE_KEEP:
                ctl.close(csid[i])
    if not tree_equal(inj.service._fused_params, ctl._fused_params):
        raise AssertionError("plane: a rebuilt worker baked other params")
    ops = len(latencies)
    lat = np.asarray(latencies) * 1e3
    mttr = latency_summary(m.get("plane_mttr_us", []))
    lanes = m["plane_batch_lanes"][0]
    rejected = {e["labels"]["reason"]: e["value"]
                for e in m["plane_rejected_total"] if e["value"]}
    evictions = sum(w.service.evictions for w in plane.workers)
    log(f"plane {cfg.name}: {PLANE_SESSIONS} sessions over tenants "
        f"{tenants} ({N_WAYS} ways x {K_SHOTS} raw {shot_len}-sample shots "
        f"each), 2 workers x {N_SLOTS} slots, {ops} ops completed in "
        f"{wall:.2f} s ({inj.ops} verbs on worker 0); op latency "
        f"p50_ms={np.percentile(lat, 50):.4f} "
        f"p99_ms={np.percentile(lat, 99):.4f}; faults fired "
        f"{ {k: fired.count(k) for k in sorted(set(fired))} }, crashes "
        f"{counter('plane_crashes_total')} recoveries "
        f"{counter('plane_recoveries_total')} lost 0; mttr p50_us="
        f"{mttr['p50_us']:.1f} p99_us={mttr['p99_us']:.1f}; batches "
        f"{counter('plane_batches_total')} mean_lanes="
        f"{lanes['sum'] / lanes['count']:.2f}; handoffs "
        f"{counter('plane_handoffs_total')} (drain {summary}), steals "
        f"{counter('plane_steals_total')}, evictions {evictions}; rejected "
        f"{rejected}")
    log(f"plane journal: {journal['epochs']} epochs, "
        f"s_per_epoch={journal['s'] / journal['epochs']:.6f} "
        f"bytes_per_epoch={journal['bytes'] / journal['epochs']:.0f} "
        f"(total {journal['s']:.2f} s, {journal['bytes']} bytes)")
    log(f"plane launches: tcn_chunk={chunk} strip={strip} (the enrollments),"
        " plain chunk calls 0; every one of the "
        f"{PLANE_SESSIONS} sessions bit-identical to the synchronous control")
    tick = plane_tick(bundle, params, bn, audio)
    keep = {i: csid[i] for i in range(PLANE_SESSIONS - PLANE_KEEP,
                                      PLANE_SESSIONS)}
    return {"launches": chunk + strip, "tick": tick, "worker0": inj.service,
            "psid_of": dict(plane.workers[0].psid_of),
            "session_of": {p: i for i, p in psids.items()},
            "control": ctl, "control_sids": keep, "audio": audio,
            "stream_len": stream_len, "make": lambda: plane_service(
                bundle, params, bn)}


def phase_spill(plane: dict):
    """Worker 0's sessions after the plane drive: spill_parking with
    include_bound into build/, restore_parking on a fresh service, and
    SPILL_EXTRA more samples to every restored session, bit for bit equal
    to the control continuing without a spill."""
    import numpy as np

    src = plane["worker0"]
    path = ROOT / "build" / "plane_spill.npz"
    t0 = time.perf_counter()
    src.spill_parking(str(path), include_bound=True)
    spill_s = time.perf_counter() - t0
    fresh = plane["make"]()
    t0 = time.perf_counter()
    restored = fresh.restore_parking(str(path))
    restore_s = time.perf_counter() - t0
    if not restored:
        raise AssertionError("spill: worker 0 held no session to spill")
    n = plane["stream_len"]
    audio, ctl = plane["audio"], plane["control"]
    index = {sid: plane["session_of"][plane["psid_of"][sid]]
             for sid in restored}
    for a in range(0, len(restored), N_SLOTS):
        group = restored[a:a + N_SLOTS]
        got = fresh.push_audio({sid: audio[index[sid], n:]
                                for sid in group})
        want = ctl.push_audio({plane["control_sids"][index[sid]]:
                               audio[index[sid], n:] for sid in group})
        for sid in group:
            if not same_stream(concat_results([got[sid]]), concat_results(
                    [want[plane["control_sids"][index[sid]]]])):
                raise AssertionError(f"spill: restored session {sid} "
                                     "differs from the control")
    log(f"spill: {len(restored)} sessions of worker 0 (tenants "
        f"{sorted({fresh.sessions[s].tenant for s in restored})}) spilled to"
        f" {path.name}: bytes={path.stat().st_size} spill_s={spill_s:.4f} "
        f"restore_s={restore_s:.4f}; {SPILL_EXTRA} more samples each, bit "
        f"for bit equal to the control")
    return {"bytes": path.stat().st_size, "spill_s": spill_s,
            "restore_s": restore_s, "sessions": len(restored)}


def phase_kws_server(cfg, dev, seed: int = 12, n_streams: int = N_SLOTS,
                     windows: int = 4):
    """TCNStreamServer on chameleon-tcn-kws: n_streams streams of
    windows x KWS_WINDOW frames in KWS_WINDOW-frame pushes, bit for bit
    equal to the bare service and to the push_chunk shim."""
    import warnings

    import numpy as np
    from repro_torch.kernels.tcn_block import tcn_block, tcn_chunk
    from repro_torch.serving import TCNStreamServer
    from repro_torch.sessions import StreamSessionService

    rng = np.random.default_rng(seed)
    bundle, params, bn = make_model(cfg, dev, seed)
    x = rng.normal(size=(n_streams, windows * KWS_WINDOW,
                         cfg.tcn_in_channels)).astype(np.float32)
    srv = TCNStreamServer(bundle, params, bn, n_streams=n_streams)
    tcn_block.launches = tcn_chunk.launches = 0
    got = []
    for a in range(0, x.shape[1], KWS_WINDOW):
        res = srv.push({sid: x[i, a:a + KWS_WINDOW]
                        for i, sid in enumerate(srv.sids)})
        got.append([res[sid] for sid in srv.sids])
    chunk, strip = tcn_chunk.launches, tcn_block.launches
    if chunk != srv.stats()["dispatches"] or strip:
        raise AssertionError(f"kws server: {chunk} tcn_chunk and {strip} "
                             f"strip launches in {srv.stats()['dispatches']}"
                             " ticks")
    bare = StreamSessionService(bundle, params, bn, n_slots=n_streams,
                                max_tenants=1, max_ways=1)
    bsids = [bare.open_session() for _ in range(n_streams)]
    shim = TCNStreamServer(bundle, params, bn, n_streams=n_streams)
    for w, a in enumerate(range(0, x.shape[1], KWS_WINDOW)):
        want = bare.push({s: x[i, a:a + KWS_WINDOW]
                          for i, s in enumerate(bsids)})
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            embs, logits = shim.push_chunk(x[:, a:a + KWS_WINDOW])
        for i, s in enumerate(bsids):
            g = got[w][i]
            if not same_stream(concat_results([g]),
                               concat_results([want[s]])):
                raise AssertionError(f"kws server: stream {i} differs from "
                                     "the bare service")
            if not (np.array_equal(embs[i], g["emb"])
                    and np.array_equal(logits[i], g["logits"])):
                raise AssertionError(f"kws server: stream {i} differs from "
                                     "the push_chunk shim")
            if not np.isfinite(g["emb"]).all():
                raise AssertionError("kws server: non-finite embedding")
    log(f"kws server {cfg.name}: {n_streams} streams x {x.shape[1]} frames "
        f"in {KWS_WINDOW}-frame pushes, {chunk} ticks (one tcn_chunk launch "
        "each), bit for bit equal to the bare service and to push_chunk")
    return {"launches": chunk + strip}


# ---------------------------------------------------------------------------
# phase: examples (the three TCN example twins, as a user runs them)
# ---------------------------------------------------------------------------

EXAMPLES = ("quickstart_torch", "serve_multitenant_torch",
            "serve_stream_torch")


def load_example(name: str):
    """examples/<name>.py as a module (the folder is not a package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_examples(dev) -> dict:
    """Each twin's ``main`` on the card (its printout), then: the
    quickstart's streamed embedding against the full forward (rtol 2e-4,
    atol 2e-5 x max(1, max|full|)) and its FSL accuracy above chance;
    serve_multitenant's predictions equal to the unfused executor's,
    alice's resumed result bit for bit equal to a never-evicted control,
    and one tcn_chunk launch per tick in both serving examples; the
    LMServer's tokens equal to a synchronous control (each request alone
    on a fresh server)."""
    import numpy as np
    from repro_torch.kernels.tcn_block import tcn_block, tcn_chunk

    qs, mt, ss = (load_example(n) for n in EXAMPLES)
    argv = ["--device", dev.type]
    zero_launch_counts()
    q = qs.main(argv)
    full, got = q["full_emb"], q["stream_emb"]
    err = allclose("quickstart stream", got, full, 2e-4,
                   2e-5 * max(1.0, float(full.abs().max())))
    if not q["acc"] > 0.20:
        raise AssertionError(f"quickstart: FSL accuracy {q['acc']} at or "
                             "below chance (0.20)")
    if any(lm_launch_counts().values()):
        raise AssertionError(f"quickstart launched {lm_launch_counts()}")

    zero_launch_counts()
    m = mt.main(argv)
    chunk, strip = tcn_chunk.launches, tcn_block.launches
    ticks = sum(m["dispatches"].values())
    if chunk != ticks or not strip:
        raise AssertionError(f"serve_multitenant: {chunk} tcn_chunk "
                             f"launches in {ticks} ticks, {strip} strip "
                             "launches")
    if not m["resume_exact"]:
        raise AssertionError("serve_multitenant: alice's resumed result "
                             "differs from a never-evicted service")
    unfused = mt.run(dev, fused=False)
    steps = ("alice", "bob", "bob_new", "alice_resumed")
    preds = [(m[k]["pred"], unfused[k]["pred"]) for k in steps]
    if any(a != b for a, b in preds):
        raise AssertionError(f"serve_multitenant: fused and unfused "
                             f"predictions differ: {preds}")
    ways = dict(m["n_ways"], alice_resumed=m["n_ways"]["alice"])
    if not all(np.isfinite(m[k]["tenant_logits"][..., :ways[k]]).all()
               for k in steps):
        raise AssertionError("serve_multitenant: non-finite logits of an "
                             "enrolled way")
    launches = chunk + strip

    zero_launch_counts()
    s = ss.main(argv)
    if tcn_chunk.launches != s["dispatches"] or s["dispatches"] != 4:
        raise AssertionError(f"serve_stream: {tcn_chunk.launches} tcn_chunk "
                             f"launches in {s['dispatches']} ticks (want 4)")
    launches += tcn_chunk.launches + tcn_block.launches
    if not np.isfinite(s["logits"]).all():
        raise AssertionError("serve_stream: non-finite logits")
    for name, steps_ in (("r1", ss.LM_STEPS), ("r2", ss.LM_STEPS),
                         ("r3", 1)):
        ctl = ss.lm_server(dev)
        sid = ctl.open_session(np.array(ss.LM_PROMPTS[name], np.int32))
        for _ in range(steps_):
            ctl.step()
        if list(ctl.outputs[sid]) != s["lm"][name]:
            raise AssertionError(f"serve_stream: LMServer request {name} "
                                 f"{s['lm'][name]} differs from a "
                                 f"synchronous control {ctl.outputs[sid]}")
    log(f"examples: quickstart stream err {err:.3g}, FSL acc {q['acc']:.2f};"
        f" serve_multitenant {ticks} ticks = {chunk} tcn_chunk launches, "
        f"{strip} strip launches, predictions {[p for p, _ in preds]} "
        "equal to the unfused executor's, alice's resume bit-exact; "
        f"serve_stream {s['dispatches']} ticks, LM tokens equal to "
        "synchronous controls")
    return {"launches": launches}


# ---------------------------------------------------------------------------
# phase: ops (log2_matmul and dilated_conv, repro_torch.kernels.ops)
# ---------------------------------------------------------------------------

# (M, K, N): benchmarks/kernel_bench.py's full and smoke sizes, decode
# shapes (M = 1 and 4 take the decode path), and tests/test_kernels.py's
# shapes with ragged tiles
MATMUL_SHAPES = ((256, 2048, 2048), (64, 256, 256), (1, 2048, 2048),
                 (16, 2048, 8192), (100, 64, 130), (1, 256, 64), (8, 32, 16),
                 (4, 2048, 8192))
# tests/test_kernels.py's tolerances: log2_matmul fp32 (bf16 x is upcast
# exactly on both sides, so the fp32 one applies), dilated_conv
MATMUL_RTOL, MATMUL_ATOL = 1e-4, 1e-3
CONV_RTOL = CONV_ATOL = 1e-4
# tests/test_kernels.py's conv shapes (B, T, Cin, Cout, K, d); the last has
# T < (K-1)*d
CONV_TEST_SHAPES = ((2, 37, 4, 8, 3, 1), (3, 128, 16, 32, 7, 4),
                    (1, 200, 8, 100, 2, 16), (2, 64, 28, 24, 3, 2),
                    (2, 20, 4, 100, 7, 8))
AUDIO_B, AUDIO_LEN = 8, 16_000  # whole 1 s clips at 16 kHz


def packed_weight(rng, K, N, dev):
    """(codes (K, N/2) uint8, scale ()) of a random (K, N) weight."""
    import torch
    from repro_torch.models.tcn import _bake_weight

    w = torch.from_numpy((rng.normal(size=(K, N)) * 0.05).astype("float32"))
    p = _bake_weight(w, True)[1]
    return p["codes"].to(dev), p["scale"].to(dev)


def conv_shapes(cfg, B, T):
    """(name, B, T, Cin, Cout, K, d) of every conv of the TCN forward."""
    out, c_in, k = [], cfg.tcn_in_channels, cfg.tcn_kernel
    for i, c in enumerate(cfg.tcn_channels):
        d = 2 ** i
        out.append((f"b{i}.conv1", B, T, c_in, c, k, d))
        out.append((f"b{i}.conv2", B, T, c, c, k, d))
        if c_in != c:
            out.append((f"b{i}.down", B, T, c_in, c, 1, 1))
        c_in = c
    return out


def conv_inputs(rng, B, T, Cin, Cout, K, dev):
    import torch

    t = lambda a: torch.from_numpy(a.astype("float32")).to(dev)
    return (t(rng.normal(size=(B, T, Cin))),
            t(rng.normal(size=(K, Cin, Cout)) * (K * Cin) ** -0.5),
            t(rng.normal(size=(Cout,)) * 0.1))


def matmul_work(M, K, N, x_bytes):
    """(bytes, flops) of one log2_matmul: x, packed W and the scale in,
    the fp32 output out."""
    return M * K * x_bytes + K * N // 2 + 4 + M * N * 4, 2 * M * K * N


def matmul_bound(M, K, N, x_bytes) -> tuple[float, str, str]:
    """(bound ms, what bounds it, the peak used) of one log2_matmul: the
    tile path runs parts * 2MKN bf16 operations on the tensor cores (an
    fp32 x is three bf16 parts, a bf16 x one), the decode path 2MKN fp32
    operations on the CUDA cores."""
    from repro_torch.kernels.log2_matmul import DECODE_MAX_M

    nb, fl = matmul_work(M, K, N, x_bytes)
    if M <= DECODE_MAX_M:
        peak = PEAK_FP32_FLOPS
    else:
        peak, fl = PEAK_BF16_TC_FLOPS, fl * (3 if x_bytes == 4 else 1)
    return (*bound(nb, fl, peak), PEAK_NAMES[peak])


def conv_work(B, T, Cin, Cout, K):
    """(bytes, flops) of one dilated_conv."""
    return ((B * T * (Cin + Cout) + K * Cin * Cout + Cout) * 4,
            2 * B * T * K * Cin * Cout)


def phase_ops(dev, audio_cfg, fsl_cfg, seed: int = 3):
    """log2_matmul and dilated_conv against their plain versions at every
    listed shape, the identity decode and the conv's causality bit for
    bit."""
    import numpy as np
    import torch
    from repro_torch.kernels.dilated_conv import dilated_conv
    from repro_torch.kernels.log2_matmul import log2_matmul
    from repro_torch.kernels.ref import dilated_conv_ref, log2_matmul_ref
    from repro_torch.quant.log2 import dequantize_log2, unpack_nibbles

    rng = np.random.default_rng(seed)
    errs = {"log2_matmul": 0.0, "dilated_conv": 0.0}
    n_cases = 0
    for (M, K, N) in MATMUL_SHAPES:
        codes, scale = packed_weight(rng, K, N, dev)
        x32 = torch.from_numpy(rng.normal(size=(M, K)).astype("float32")).to(dev)
        for x in (x32, x32.to(torch.bfloat16)):
            got = log2_matmul(x, codes, scale)
            want = log2_matmul_ref(x, codes, scale)
            sync(dev)
            errs["log2_matmul"] = max(errs["log2_matmul"], allclose(
                f"log2_matmul {M}x{K}x{N} {x.dtype}", got, want,
                MATMUL_RTOL, MATMUL_ATOL))
            n_cases += 1
    codes, scale = packed_weight(rng, 256, 256, dev)
    got = log2_matmul(torch.eye(256, device=dev), codes, scale)
    if not torch.equal(got, dequantize_log2(unpack_nibbles(codes), scale)):
        raise AssertionError("log2_matmul: I @ W is not the decoded W bit "
                             "for bit")
    shapes = (conv_shapes(audio_cfg, AUDIO_B, AUDIO_LEN)
              + conv_shapes(fsl_cfg, N_WAYS * K_SHOTS, STREAM_LEN)
              + [("test", *sh) for sh in CONV_TEST_SHAPES])
    for (name, B, T, Cin, Cout, K, d) in shapes:
        x, w, b = conv_inputs(rng, B, T, Cin, Cout, K, dev)
        got = dilated_conv(x, w, b, d)
        want = dilated_conv_ref(x, w, b, d)
        sync(dev)
        errs["dilated_conv"] = max(errs["dilated_conv"], allclose(
            f"dilated_conv {name} B={B} T={T} {Cin}->{Cout} K={K} d={d}",
            got, want, CONV_RTOL, CONV_ATOL))
        n_cases += 1
    for (B, T, C, K, d, t0) in ((1, 32, 4, 3, 2, 20),
                                (AUDIO_B, AUDIO_LEN, 24, 7, 2048,
                                 AUDIO_LEN * 3 // 4)):
        x, w, b = conv_inputs(rng, B, T, C, C, K, dev)
        y1 = dilated_conv(x, w, b, d)
        x2 = x.clone()
        x2[:, t0:] = 123.0
        y2 = dilated_conv(x2, w, b, d)
        sync(dev)
        if not torch.equal(y1[:, :t0], y2[:, :t0]):
            raise AssertionError(f"dilated_conv d={d}: x[:, {t0}:] changed "
                                 f"out[:, :{t0}]")
        if torch.equal(y1[:, t0:], y2[:, t0:]):
            raise AssertionError(f"dilated_conv d={d}: x[:, {t0}:] changed "
                                 "nothing")
    log(f"ops: {n_cases} cases agree with the plain versions (max abs err "
        f"log2_matmul={errs['log2_matmul']:.3g}, dilated_conv="
        f"{errs['dilated_conv']:.3g}); I @ W decodes bit for bit; the conv "
        "is causal bit for bit (d=2 and d=2048)")
    return errs


def phase_ops_timings(dev, audio_cfg, seed: int = 4):
    """Kernel / wrapper / plain / library times of log2_matmul at every
    listed shape and of dilated_conv at every conv of the audio preset over
    8 whole clips; the JSON gets the kernel_bench size and the sum over the
    audio forward's convs."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.dilated_conv import dilated_conv
    from repro_torch.kernels.log2_matmul import log2_matmul
    from repro_torch.kernels.ref import dilated_conv_ref, log2_matmul_ref
    from repro_torch.quant.log2 import dequantize_log2, unpack_nibbles

    rng = np.random.default_rng(seed)
    mm = None
    for (M, K, N) in MATMUL_SHAPES:
        codes, scale = packed_weight(rng, K, N, dev)
        w = dequantize_log2(unpack_nibbles(codes), scale)
        x32 = torch.from_numpy(rng.normal(size=(M, K)).astype("float32")).to(dev)
        for x in (x32, x32.to(torch.bfloat16)):
            call = lambda: log2_matmul(x, codes, scale)
            row = {"ms": device_ms(call, dev),
                   "wrapper_ms": time_ms(call, dev),
                   "plain_ms": time_ms(
                       lambda: log2_matmul_ref(x, codes, scale), dev),
                   "library_ms": None}
            if x.dtype == torch.float32:
                # one PyTorch call on the decoded W; never used by the port
                row["library_ms"] = device_ms(lambda: torch.matmul(x, w), dev)
            row["bound_ms"], row["bound_by"], row["bound_peak"] = \
                matmul_bound(M, K, N, x.element_size())
            lib = "null" if row["library_ms"] is None \
                else f"{row['library_ms']:.4f}"
            log(f"timing log2_matmul {M}x{K}x{N} x={str(x.dtype)[6:]}: "
                f"ms={row['ms']:.4f} wrapper_ms={row['wrapper_ms']:.4f} "
                f"plain_ms={row['plain_ms']:.4f} library_ms={lib} "
                f"bound_ms={row['bound_ms']:.6f} bound_by={row['bound_by']} "
                f"(peak: {row['bound_peak']})")
            if mm is None:  # the kernel_bench size, fp32 x
                mm = row
    tot = {"ms": 0.0, "wrapper_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
           "bytes": 0.0, "flops": 0.0}
    convs = conv_shapes(audio_cfg, AUDIO_B, AUDIO_LEN)
    for (name, B, T, Cin, Cout, K, d) in convs:
        x, w, b = conv_inputs(rng, B, T, Cin, Cout, K, dev)
        pad = (K - 1) * d
        # the library call's operands, already padded and laid out
        # (B, Cin, T+pad) and (Cout, Cin, K)
        xl = F.pad(x, (0, 0, pad, 0)).transpose(1, 2).contiguous()
        wl = w.permute(2, 1, 0).contiguous()
        library = lambda: F.conv1d(xl, wl, b, dilation=d)
        allclose(f"conv1d library call {name}",
                 library().transpose(1, 2), dilated_conv(x, w, b, d),
                 CONV_RTOL, CONV_ATOL)
        call = lambda: dilated_conv(x, w, b, d)
        row = {"ms": device_ms(call, dev),
               "wrapper_ms": time_ms(call, dev),
               "plain_ms": time_ms(lambda: dilated_conv_ref(x, w, b, d), dev),
               "library_ms": device_ms(library, dev)}
        nb, fl = conv_work(B, T, Cin, Cout, K)
        bms, by = bound(nb, fl)
        log(f"timing dilated_conv {audio_cfg.name} {name} B={B} T={T} "
            f"{Cin}->{Cout} K={K} d={d}: ms={row['ms']:.4f} "
            f"wrapper_ms={row['wrapper_ms']:.4f} "
            f"plain_ms={row['plain_ms']:.4f} "
            f"library_ms={row['library_ms']:.4f} bound_ms={bms:.6f} "
            f"bound_by={by} (peak: {PEAK_NAMES[PEAK_FP32_FLOPS]})")
        for key in row:
            tot[key] += row[key]
        tot["bytes"] += nb
        tot["flops"] += fl
    cb, cby = bound(tot.pop("bytes"), tot.pop("flops"))
    tot["bound_ms"], tot["bound_by"] = cb, cby
    tot["bound_peak"] = PEAK_NAMES[PEAK_FP32_FLOPS]
    log(f"timing dilated_conv {audio_cfg.name} forward ({len(convs)} convs, "
        f"B={AUDIO_B}, T={AUDIO_LEN}): ms={tot['ms']:.4f} "
        f"wrapper_ms={tot['wrapper_ms']:.4f} plain_ms={tot['plain_ms']:.4f} "
        f"library_ms={tot['library_ms']:.4f} bound_ms={cb:.6f} "
        f"bound_by={cby}")
    return mm, tot


def conv_forward(params, bn, cfg, x, conv_op):
    """models/tcn.tcn_forward (eval, fp32) with every conv through
    ``conv_op``: the ops entry point driven as a whole network."""
    import torch
    from repro_torch.models.tcn import _bn

    h = x
    for i in range(len(cfg.tcn_channels)):
        p, st, d = params["blocks"][f"b{i}"], bn[f"b{i}"], 2 ** i
        y = conv_op(h, p["conv1_w"], p["conv1_b"], d)
        y = torch.relu(_bn(y, p["bn1"]["scale"], p["bn1"]["bias"],
                           st["bn1_mean"], st["bn1_var"]))
        y = conv_op(y, p["conv2_w"], p["conv2_b"], d)
        y = _bn(y, p["bn2"]["scale"], p["bn2"]["bias"], st["bn2_mean"],
                st["bn2_var"])
        res = conv_op(h, p["down_w"], p["down_b"], 1) if "down_w" in p else h
        h = torch.relu(y + res)
    emb = torch.relu(h[:, -1, :] @ params["head_w"] + params["head_b"])
    return emb, emb @ params["fc"]["w"] + params["fc"]["b"]


def scaled_close(name, got, want, rtol=2e-4, atol=2e-5) -> float:
    """allclose at the repo's fp32 precedent with atol scaled by the
    largest |want| (at least 1): the seeded, untrained nets' activations
    reach far above 1, and two fp32 summation orders then differ by a few
    ulps of that scale."""
    return allclose(name, got, want, rtol,
                    atol * max(1.0, want.abs().max().item()))


def phase_ops_main(dev, audio_cfg, seed: int = 5):
    """The ops entry point as a user calls it: kernel_bench's log2_matmul
    workloads (bf16 x, the tile path) and a decode-shaped one (the decode
    path), and the audio preset's forward over 8 whole clips with every
    conv through the conv op.  Counters are zeroed just before and read
    just after."""
    import numpy as np
    import torch
    from repro_torch.kernels import make_dilated_conv_op, make_log2_matmul_op
    from repro_torch.kernels.dilated_conv import dilated_conv
    from repro_torch.kernels.log2_matmul import log2_matmul
    from repro_torch.kernels.ref import log2_matmul_ref
    from repro_torch.models.tcn import tcn_forward

    rng = np.random.default_rng(seed)
    mm_op, conv_op = make_log2_matmul_op(), make_dilated_conv_op()
    work = []
    for (M, K, N) in MATMUL_SHAPES[:3]:
        codes, scale = packed_weight(rng, K, N, dev)
        x = torch.from_numpy(rng.normal(size=(M, K)).astype("float32")).to(
            dev, torch.bfloat16)
        work.append((x, codes, scale))
    _, params, bn = make_model(audio_cfg, dev, seed)
    clips = torch.from_numpy(rng.normal(
        size=(AUDIO_B, AUDIO_LEN, audio_cfg.tcn_in_channels)
    ).astype("float32")).to(dev)
    log2_matmul.launches = dilated_conv.launches = 0
    outs = [mm_op(*args) for args in work]
    emb, logits = conv_forward(params, bn, audio_cfg, clips, conv_op)
    sync(dev)
    launches = {"log2_matmul": log2_matmul.launches,
                "dilated_conv": dilated_conv.launches}
    if 0 in launches.values():
        raise AssertionError(f"ops: a kernel was not launched {launches}")
    for out, args in zip(outs, work):
        allclose("ops log2_matmul workload", out, log2_matmul_ref(*args),
                 MATMUL_RTOL, MATMUL_ATOL)
    de, dl, _ = tcn_forward(params, bn, audio_cfg, clips)
    err = max(scaled_close("ops conv forward emb", emb, de),
              scaled_close("ops conv forward logits", logits, dl))
    log(f"ops main path: {len(work)} log2_matmul workloads (both paths) and the "
        f"{audio_cfg.name} forward over {AUDIO_B}x{AUDIO_LEN} samples "
        f"through the conv op agree with the plain versions (forward max "
        f"abs err {err:.3g}, |emb| up to {de.abs().max().item():.3g}); "
        f"launches {launches}")
    return launches


def build_other_ops(csrc: Path):
    """Compile another tree's log2_matmul.cu, dilated_conv.cu and
    proto_extract.cu (its csrc/ directory) with this tree's nvcc flags into
    build/compare/ and bind their C entries, which take the arguments this
    tree's tile-path and conv entries take; proto_extract's one-hot entry
    takes this tree's arguments, or those and a thread count before the
    stream (its form in PRs 12-24).  Returns (log2_matmul, dilated_conv,
    proto_extract, whether proto_extract takes the thread count)."""
    import ctypes
    from repro_torch.kernels import _build

    out = ROOT / "build" / "compare"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in ("log2_matmul", "dilated_conv", "proto_extract"):
        so = out / f"lib{name}.so"
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o", str(so),
             str(csrc / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = []
    for name, (so, p) in procs.items():
        text, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {csrc / name}.cu:\n{text}")
        fn = getattr(ctypes.CDLL(str(so)), name)
        if name == "proto_extract":
            threads = "int threads" in (csrc / f"{name}.cu").read_text()
            fn.argtypes = [_build.P] * 4 + [_build.I] * 3 + [_build.F] + (
                [_build.I] if threads else []) + [_build.P]
        else:
            fn.argtypes = [_build.P] * 4 + [_build.I] * (
                4 if name == "log2_matmul" else 6) + [_build.P]
        fn.restype = ctypes.c_int
        fns.append(fn)
    return (*fns, threads)


def phase_compare(dev, audio_cfg, fsl_cfg, csrc: Path, seed: int = 7):
    """The other tree's log2_matmul, dilated_conv and proto_extract kernels
    beside this tree's, on the same inputs in this process: device ms of
    both (and of the library call: for proto_extract the matmul alone) at
    every listed op shape, proto_extract at its three main-path shapes
    with both of this tree's entries; the other kernel's output is held to
    this tree's at the ops tolerance (proto_extract's W bit for bit).
    Returns the shapes where this tree's kernel is slower."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.dilated_conv import dilated_conv
    from repro_torch.kernels.log2_matmul import log2_matmul
    from repro_torch.quant.log2 import dequantize_log2, unpack_nibbles

    old_mm, old_conv, old_pe, pe_threads = build_other_ops(csrc)
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream
    rng = np.random.default_rng(seed)
    slower = []

    def one(tag, old, new, library):
        row = [device_ms(f, dev, n=40, reps=9) for f in (old, new, library)]
        log(f"compare {tag}: other_ms={row[0]:.5f} this_ms={row[1]:.5f} "
            f"library_ms={row[2]:.5f}")
        if row[1] > row[0]:
            slower.append(tag)

    for (M, K, N) in MATMUL_SHAPES:
        codes, scale = packed_weight(rng, K, N, dev)
        w = dequantize_log2(unpack_nibbles(codes), scale)
        x32 = torch.from_numpy(rng.normal(size=(M, K)).astype("float32")).to(dev)
        for x in (x32, x32.to(torch.bfloat16)):
            o = torch.empty((M, N), device=dev)
            old = lambda: old_mm(x.data_ptr(), codes.data_ptr(), scale.data_ptr(),
                                 o.data_ptr(), M, K, N,
                                 int(x.dtype == torch.bfloat16), stream())
            if old() != 0:
                raise RuntimeError("the other log2_matmul did not launch")
            allclose(f"compare log2_matmul {M}x{K}x{N}", o,
                     log2_matmul(x, codes, scale), MATMUL_RTOL, MATMUL_ATOL)
            one(f"log2_matmul {M}x{K}x{N} x={str(x.dtype)[6:]}", old,
                lambda: log2_matmul(x, codes, scale),
                lambda: torch.matmul(x32, w))
    shapes = (conv_shapes(audio_cfg, AUDIO_B, AUDIO_LEN)
              + conv_shapes(fsl_cfg, N_WAYS * K_SHOTS, STREAM_LEN)
              + [("test", *sh) for sh in CONV_TEST_SHAPES])
    for (name, B, T, Cin, Cout, K, d) in shapes:
        x, w, b = conv_inputs(rng, B, T, Cin, Cout, K, dev)
        o = torch.empty((B, T, Cout), device=dev)
        old = lambda: old_conv(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                               o.data_ptr(), B, T, Cin, Cout, K, d, stream())
        if old() != 0:
            raise RuntimeError("the other dilated_conv did not launch")
        allclose(f"compare dilated_conv {name}", o, dilated_conv(x, w, b, d),
                 CONV_RTOL, CONV_ATOL)
        xl = F.pad(x, (0, 0, (K - 1) * d, 0)).transpose(1, 2).contiguous()
        wl = w.permute(2, 1, 0).contiguous()
        one(f"dilated_conv {name} B={B} T={T} {Cin}->{Cout} K={K} d={d}", old,
            lambda: dilated_conv(x, w, b, d),
            lambda: F.conv1d(xl, wl, b, dilation=d))
    from repro_torch.kernels.proto_extract import (
        proto_extract,
        proto_extract_labels,
    )

    for (V, k) in ((fsl_cfg.embed_dim, K_SHOTS), (1024, 1), (8192, 1)):
        labels = rng.permutation(np.repeat(np.arange(N_WAYS), k))
        emb, lab, onehot = proto_inputs(rng, labels, N_WAYS, V, dev)
        w = torch.empty((N_WAYS, V), device=dev)
        b = torch.empty((N_WAYS,), device=dev)
        threads = (max(32, 1 << (min(V, 1024) - 1).bit_length()),) \
            if pe_threads else ()
        old = lambda: old_pe(emb.data_ptr(), onehot.data_ptr(), w.data_ptr(),
                             b.data_ptr(), N_WAYS, len(labels), V,
                             1.0 / (2.0 * k), *threads, stream())
        if old() != 0:
            raise RuntimeError("the other proto_extract did not launch")
        nw, nb = proto_extract(emb, onehot, k)
        sync(dev)
        if not torch.equal(w, nw):
            raise RuntimeError(f"compare proto_extract V={V}: W differs")
        allclose(f"compare proto_extract V={V} b", b, nb, RTOL, ATOL)
        tag = f"proto_extract N={N_WAYS} Nk={len(labels)} V={V}"
        one(tag + " one-hot entry", old,
            lambda: proto_extract(emb, onehot, k),
            lambda: torch.matmul(onehot, emb))
        one(tag + " label entry", old,
            lambda: proto_extract_labels(emb, lab, N_WAYS, k),
            lambda: torch.matmul(onehot, emb))
    log(f"compare with {csrc}: this tree's kernel is slower at "
        f"{len(slower)} shapes{': ' + '; '.join(slower) if slower else ''}")
    return slower


# ---------------------------------------------------------------------------
# phase: audio (chameleon-tcn-audio served, enrolled and cone-evaluated)
# ---------------------------------------------------------------------------

AUDIO_BIG_CHUNK, AUDIO_PARK_EVERY = 160, 20


def phase_audio(cfg, dev, seed: int = 6):
    import numpy as np
    import torch
    from repro_torch.core.protonet import adapt, pn_fc_from_sums, support_sums
    from repro_torch.core.streaming import (
        cone_eval,
        cone_stats,
        ring_sizes,
        stream_state_bytes,
        ws_inference_stats,
    )
    from repro_torch.kernels import ref
    from repro_torch.kernels.proto_extract import proto_extract
    from repro_torch.kernels.tcn_block import tcn_block, tcn_chunk
    from repro_torch.models.tcn import (
        bake_stream_params,
        make_fused_forward,
        tcn_forward,
    )
    from repro_torch.sessions import StreamSessionService

    rng = np.random.default_rng(seed)
    bundle, params, bn = make_model(cfg, dev, seed)
    c_in = cfg.tcn_in_channels
    audio = rng.normal(size=(N_SLOTS, AUDIO_LEN, c_in)).astype(np.float32)
    shots = rng.normal(size=(N_WAYS, K_SHOTS, AUDIO_LEN, c_in)
                       ).astype(np.float32)
    deepest = max(n for rs in ring_sizes(cfg).values()
                  for (n, _) in rs.values())
    if AUDIO_LEN <= deepest:
        raise AssertionError(f"a {AUDIO_LEN}-sample stream does not wrap "
                             f"the {deepest}-row ring")
    # 9..16 samples a session per push, so one tick of 16 a round; then
    # 1..320-sample pushes served in ticks of 160
    small = make_schedule(rng, N_SLOTS, AUDIO_LEN, max_chunk=T_CHUNK,
                          min_chunk=9)
    big = make_schedule(rng, N_SLOTS, AUDIO_LEN,
                        max_chunk=2 * AUDIO_BIG_CHUNK)

    def service(quantize, t_chunk):
        return StreamSessionService(
            bundle, params, bn, n_slots=N_SLOTS, max_tenants=N_TENANTS,
            max_ways=8, t_chunk=t_chunk, quantize=quantize, fused=True)

    result = {"launches": 0}
    for quantize in (False, True):
        svc = service(quantize, T_CHUNK)
        tcn_block.launches = tcn_chunk.launches = proto_extract.launches = 0
        t0 = time.perf_counter()
        with counting(ref, PLAIN_CHUNK) as plain:
            main, polls = drive(svc, audio, small, shots, enroll_round=0)
        secs = time.perf_counter() - t0
        chunk, strip = check_drive_launches(f"audio quantize={quantize}", svc,
                                            cfg, plain.calls)
        result["launches"] += chunk + strip
        for s, (e, lg, tl) in main.items():
            if e.shape != (AUDIO_LEN, cfg.embed_dim) or \
                    lg.shape != (AUDIO_LEN, cfg.n_classes):
                raise AssertionError(f"audio: session {s} shapes {e.shape}, "
                                     f"{lg.shape}")
            for a in (e, lg) + ((tl[:, :N_WAYS],) if tl is not None else ()):
                if not np.isfinite(a).all():
                    raise AssertionError(f"audio: session {s} non-finite")
        if not any(np.abs(lg).max() > 0 for _, lg, _ in main.values()):
            raise AssertionError("audio: all logits are zero")
        if polls[0]["n_ways"] != N_WAYS or main[0][2] is None \
                or main[0][2].shape[0] != AUDIO_LEN:
            raise AssertionError("audio: enrollment did not reach tenant 0")
        if any(p["steps"] != AUDIO_LEN for p in polls):
            raise AssertionError("audio: a session lost steps")
        log(f"audio quantize={quantize}: {N_SLOTS} sessions x {AUDIO_LEN} "
            f"samples in {len(small)} ragged rounds, {svc.dispatches} ticks "
            f"of <= {T_CHUNK} in {secs:.1f} s, every ring wrapped (deepest "
            f"{deepest} rows), tcn_chunk launches={chunk} (one a tick), strip "
            f"launches={strip} (enrollment), plain chunk calls 0, enrolled "
            f"{polls[0]['n_ways']} ways; outputs finite")
        other_svc = service(quantize, AUDIO_BIG_CHUNK)
        other, _ = drive(other_svc, audio, big, shots, enroll_round=0)
        if not same_outputs(main, other):
            raise AssertionError(f"audio quantize={quantize}: t_chunk "
                                 f"{T_CHUNK} and {AUDIO_BIG_CHUNK} differ")
        parked_svc = service(quantize, AUDIO_BIG_CHUNK)
        parked, _ = drive(parked_svc, audio, big, shots, enroll_round=0,
                          park_every=AUDIO_PARK_EVERY)
        if not same_outputs(main, parked) or parked_svc.evictions == 0:
            raise AssertionError(f"audio quantize={quantize}: park/resume "
                                 f"changed the outputs ({parked_svc.evictions}"
                                 " evictions)")
        log(f"audio quantize={quantize}: chunk-size invariance (t_chunk "
            f"{T_CHUNK} in {len(small)} rounds vs {AUDIO_BIG_CHUNK} in "
            f"{len(big)} other ragged rounds, {other_svc.dispatches} ticks) "
            f"and park/resume ({parked_svc.evictions} evictions) bit-exact")
        del svc, other_svc, parked_svc
        if not quantize:
            tsvc = service(False, T_CHUNK)
            sids = [tsvc.open_session() for _ in range(N_SLOTS)]
            x = {sid: audio[i, :T_CHUNK] for i, sid in enumerate(sids)}
            result["tick_ms"] = time_tick(f"{cfg.name} push_audio", tsvc, x,
                                          dev)
            del tsvc
    result["launches"] += check_long_tick("audio", service, audio, cfg)
    # 5-way 5-shot enrollment of whole clips through protonet.adapt
    _, _, fp = bake_stream_params(params, bn, cfg)
    fwd = make_fused_forward(cfg, device=dev)
    embed_fn = lambda p, x: fwd(p, x)[0]
    support = torch.from_numpy(shots.reshape(-1, AUDIO_LEN, c_in)).to(dev)
    labels = torch.arange(N_WAYS, device=dev).repeat_interleave(K_SHOTS)
    tcn_block.launches = proto_extract.launches = 0
    w, b = adapt(embed_fn, fp, support, labels, N_WAYS, K_SHOTS)
    sync(dev)
    counts = (proto_extract.launches, tcn_block.launches)
    result["launches"] += counts[1]
    result["proto_launches"] = counts[0]
    if 0 in counts:
        raise AssertionError("audio fsl: a kernel was not launched "
                             f"(proto_extract, tcn_block) = {counts}")
    ws_, bs = pn_fc_from_sums(support_sums(embed_fn(fp, support), labels,
                                           N_WAYS), K_SHOTS)
    err = max(compare("audio fsl W", w, ws_, False),
              compare("audio fsl b", b, bs, False))
    enroll_ms = time_ms(lambda: adapt(embed_fn, fp, support, labels, N_WAYS,
                                      K_SHOTS), dev, n=5, warmup=1)
    log(f"audio fsl 5-way {K_SHOTS}-shot of {AUDIO_LEN}-sample clips: W "
        f"{tuple(w.shape)} matches support_sums+pn_fc_from_sums (max abs err "
        f"{err:.3g}); proto_extract launches={counts[0]} tcn_block "
        f"launches={counts[1]}; timing adapt (embed S={N_WAYS * K_SHOTS} + "
        f"extract, end to end): ms={enroll_ms:.4f}")
    # greedy cone evaluation against the dense forward's last step
    clips = torch.from_numpy(audio[:AUDIO_B]).to(dev)
    for quantize in (False, True):
        e_c, l_c, evals = cone_eval(params, bn, cfg, clips, quantize=quantize)
        e_d, l_d, _ = tcn_forward(params, bn, cfg, clips, quantize=quantize)
        sync(dev)
        err = max(scaled_close(f"cone_eval quantize={quantize} emb", e_c, e_d),
                  scaled_close(f"cone_eval quantize={quantize} logits", l_c,
                               l_d))
        dense = AUDIO_LEN * 2 * len(cfg.tcn_channels)
        if evals >= dense:
            raise AssertionError(f"cone_eval: {evals} evaluations, dense "
                                 f"{dense}")
        log(f"audio cone_eval quantize={quantize}: {AUDIO_B} clips x "
            f"{AUDIO_LEN} samples match tcn_forward's last step (max abs err "
            f"{err:.3g}, |emb| up to {e_d.abs().max().item():.3g}); "
            f"{evals} node evaluations against {dense} dense")
    ws, g = ws_inference_stats(cfg, AUDIO_LEN), cone_stats(cfg, AUDIO_LEN)
    ratios = (ws["act_entries"] / g["act_entries"], ws["macs"] / g["macs"])
    kb = g["act_entries"] * 0.5 / 1024
    if ratios[0] <= 50 or ratios[1] <= 5 or kb >= 2.5:
        raise AssertionError(f"audio accounting: {ratios}, {kb} kB")
    log(f"audio accounting at T={AUDIO_LEN}: weight-stationary / greedy cone "
        f"= {ratios[0]:.1f}x activation entries, {ratios[1]:.2f}x MACs; "
        f"cone FIFO state {kb:.3f} kB at u4; ring state "
        f"{stream_state_bytes(cfg) / 1024:.1f} kB per stream at u4, "
        f"{stream_state_bytes(cfg, 4) / 2**20:.2f} MiB at fp32")
    return result


# ---------------------------------------------------------------------------
# phase: train (meta-train chameleon-tcn, QAT, Trainer resume, Table I, serve)
# ---------------------------------------------------------------------------

# examples/fsl_episodic.py's meta-training at the full chameleon-tcn width
# on 28x28 glyphs (784-step sequences): 5-way 3-shot 3-query episodes (30
# sequences a step), AdamW 2e-3, then a QAT fine-tune; 100 glyph classes
# split 70 / 30 (the 30 unseen classes evaluate and serve)
# 150 meta-training episodes, cut from 300 to give the mesh phase's
# placed-param LM steps their time: no accuracy gates the phase, and the
# last 50 episodes' mean loss must still be below the first 50's
TRAIN_CLASSES, TRAIN_EPISODES, QAT_EPISODES = 100, 150, 40
TRAIN_SHOTS, TRAIN_QUERY, LOSS_WINDOW = 3, 3, 50
# Trainer steps of the bundle's loss_fn (grad_accum=2, int8_ef): killed
# after TRAINER_KILL steps and resumed; TRAINER_SHOTS glyphs of each of
# N_WAYS training classes a step
TRAINER_STEPS, TRAINER_KILL, TRAINER_SHOTS = 6, 3, 4
EVAL_EPISODES, EVAL_QUERY = 10, 4
DATA_WORKERS = 6  # processes rendering glyph episodes (numpy, on the host)
GLYPH = 28


class Prefetched:
    """Episodes rendered ahead in worker processes, behind the
    ``EpisodicSampler.episode`` call; ``get()`` yields them in order."""

    def __init__(self, sampler, eps, n_ways, k, q, workers=DATA_WORKERS):
        import functools
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        self.eps, self.shape = list(eps), (n_ways, k, q)
        fn = functools.partial(sampler.episode, n_ways=n_ways, k_shots=k,
                               n_query=q)
        self.pool = ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn"))
        self.futures = [self.pool.submit(fn, ep) for ep in self.eps]

    def get(self):
        for f in self.futures:
            yield f.result()

    def episode(self, ep, n_ways, k_shots, n_query):
        if (n_ways, k_shots, n_query) != self.shape:
            raise KeyError((n_ways, k_shots, n_query))
        return self.futures[self.eps.index(ep)].result()

    def close(self):
        self.pool.shutdown(cancel_futures=True)


def plain_fused_forward(cfg, fused, x, quantize: bool):
    """``make_fused_forward``'s embedding with every block through the
    strip entry's plain version (``kernels/ref.tcn_block_fused``) on the
    tensors' own device."""
    import torch
    from repro_torch.kernels.ref import expand_weight, tcn_block_fused
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


def phase_train(cfg, dev, seed: int = 13, episodes: int = TRAIN_EPISODES,
                qat: int = QAT_EPISODES, glyph: int = GLYPH,
                n_sessions: int = N_SLOTS):
    """Meta-train the FSL embedder, fine-tune it with QAT, run the
    Trainer through a kill and a resume, bake the trained embedder and
    hold it on the Table I protocol (unseen classes, 5-way 1- and 5-shot,
    fp32 and log2) and in a service against the plain versions.  Returns
    the main path's launches and the measured numbers."""
    import functools
    import shutil

    import numpy as np
    import torch
    from repro_torch.core.protonet import (
        pn_fc_from_sums,
        pn_fc_from_sums_log2,
        pn_logits,
        support_sums,
    )
    from repro_torch.data import EpisodicSampler, GlyphClasses, split_classes
    from repro_torch.kernels import ref
    from repro_torch.kernels.proto_extract import proto_extract
    from repro_torch.kernels.tcn_block import tcn_block, tcn_chunk
    from repro_torch.models import build_tcn_bundle
    from repro_torch.models.tcn import (
        bake_stream_params,
        make_fused_forward,
        tcn_empty_state,
        tcn_forward,
    )
    from repro_torch.sessions import StreamSessionService
    from repro_torch.training import TrainConfig, Trainer
    from repro_torch.training.episodic import fsl_episode, make_episode_step
    from repro_torch.training.optim import adamw

    out = {}
    bundle = build_tcn_bundle(cfg, dev)
    params = bundle.init(torch.Generator().manual_seed(seed))
    state = tcn_empty_state(cfg, dev)
    ds = GlyphClasses(TRAIN_CLASSES, seed=seed, size=glyph)
    train_cls, test_cls = split_classes(TRAIN_CLASSES, 0.7, seed=seed)
    opt = adamw(2e-3)
    opt_state = opt[0](params)
    step = {q: make_episode_step(cfg, opt, n_ways=N_WAYS, quantize=q)
            for q in (False, True)}
    eval_sampler = EpisodicSampler(ds, test_cls, seed=seed + 99)
    data = Prefetched(EpisodicSampler(ds, train_cls, seed=seed + 1),
                      range(episodes + qat), N_WAYS, TRAIN_SHOTS, TRAIN_QUERY)
    evals = {k: Prefetched(eval_sampler, range(EVAL_EPISODES), N_WAYS, k,
                           EVAL_QUERY, workers=2) for k in (1, K_SHOTS)}
    try:
        # ---- meta-training, then the QAT fine-tune ----
        losses, t0 = [], time.perf_counter()
        for ep, arrays in enumerate(data.get()):
            batch = [torch.from_numpy(a).to(dev) for a in arrays]
            if ep == episodes:
                fp32 = (params, state)  # the fp32 embedder, before QAT
                out["train_s"] = time.perf_counter() - t0
                t0 = time.perf_counter()
            params, state, opt_state, loss, _ = step[ep >= episodes](
                params, state, opt_state, *batch)
            losses.append(loss)
        out["qat_s"] = time.perf_counter() - t0
        losses = torch.stack(losses).cpu().numpy()
        if not np.isfinite(losses).all():
            raise AssertionError("train: a non-finite episode loss")
        first = float(losses[:LOSS_WINDOW].mean())
        last = float(losses[episodes - LOSS_WINDOW:episodes].mean())
        q_first, q_last = float(losses[episodes]), float(losses[-1])
        if not last < first:
            raise AssertionError(f"train: the mean loss of the last "
                                 f"{LOSS_WINDOW} episodes ({last:.4f}) is not "
                                 f"below the first {LOSS_WINDOW}'s "
                                 f"({first:.4f})")
        log(f"train {cfg.name}: {episodes} episodes (5-way {TRAIN_SHOTS}-shot"
            f" {TRAIN_QUERY}-query, {glyph}x{glyph} glyphs, {glyph ** 2} "
            f"steps) in {out['train_s']:.1f} s, mean loss first "
            f"{LOSS_WINDOW} {first:.4f} -> last {LOSS_WINDOW} {last:.4f}; "
            f"QAT {qat} episodes in {out['qat_s']:.1f} s, loss {q_first:.4f}"
            f" -> {q_last:.4f}")
        out.update(loss_first=first, loss_last=last)

        # ---- one step: repeats bit for bit; its time, launches, idle ----
        fp_params, fp_state = fp32
        fp_opt = opt[0](fp_params)
        batch = [torch.from_numpy(a).to(dev) for a in data.episode(
            0, N_WAYS, TRAIN_SHOTS, TRAIN_QUERY)]
        one = step[False](fp_params, fp_state, fp_opt, *batch)
        two = step[False](fp_params, fp_state, fp_opt, *batch)
        if not tree_equal(list(one), list(two)):
            raise AssertionError("train: one episode step twice on the same "
                                 "inputs gave different bits")
        run = lambda: step[False](fp_params, fp_state, fp_opt, *batch)
        out["step_ms"] = time_ms(run, dev, n=10, warmup=2)
        log(f"timing train step ({N_WAYS * (TRAIN_SHOTS + TRAIN_QUERY)} x "
            f"{glyph ** 2} samples, forward + backward + AdamW): "
            f"ms={out['step_ms']:.3f} (median of 10, CUDA events); the same "
            "inputs twice give the same bits")
        if dev.type == "cuda":
            out["step_profile"] = profile_tick(run, ticks=5,
                                               name="train step")

        # ---- Trainer: grad_accum=2 and int8_ef, killed and resumed ----
        @functools.lru_cache(maxsize=None)
        def trainer_batch(i):
            x = np.concatenate([ds.sample(int(c), TRAINER_SHOTS, seed=5000 + i)
                                for c in train_cls[:N_WAYS]])
            y = np.repeat(np.arange(N_WAYS), TRAINER_SHOTS).astype(np.int32)
            perm = np.random.default_rng(i).permutation(len(y))
            return x[perm].reshape(2, -1, *x.shape[1:]), y[perm].reshape(2, -1)

        def trainer(d):
            return Trainer(bundle.loss_fn, fp_params, TrainConfig(
                steps=TRAINER_STEPS, grad_accum=2, grad_compression="int8_ef",
                ckpt_dir=str(d), ckpt_every=2, log_every=1),
                lambda i: {k: torch.from_numpy(v).to(dev) for k, v in zip(
                    ("x", "labels"), trainer_batch(i))},
                optimizer=adamw(1e-3), model_state=fp_state)

        ckpt = ROOT / "build" / "train_ckpt"
        shutil.rmtree(ckpt, ignore_errors=True)
        whole, hist = trainer(ckpt / "whole").run()
        trainer(ckpt / "killed").run(steps=TRAINER_KILL)
        resumed = trainer(ckpt / "killed")
        at = resumed.maybe_resume()
        if at != TRAINER_KILL:
            raise AssertionError(f"train: resumed at step {at}, expected "
                                 f"{TRAINER_KILL}")
        again, _ = resumed.run()
        if not tree_equal(whole, again):
            raise AssertionError("train: the killed and resumed Trainer's "
                                 "state differs from the whole run's")
        shutil.rmtree(ckpt, ignore_errors=True)
        log(f"train Trainer (grad_accum=2, int8_ef): {TRAINER_STEPS} steps, "
            f"loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}; killed "
            f"after {TRAINER_KILL}, resumed from its checkpoint: params, "
            "optimizer, BN and error-feedback state bit for bit equal")

        # ---- Table I on unseen classes through the kernels ----
        tcn_block.launches = tcn_chunk.launches = proto_extract.launches = 0
        acc, checks = {}, []
        for log2, (p, st) in ((False, fp32), (True, (params, state))):
            scan_p, scan_bn, fused = bake_stream_params(p, st, cfg,
                                                        quantize=log2)
            fwd = make_fused_forward(cfg, quantize=log2, device=dev)
            for k in (1, K_SHOTS):
                accs = []
                for e in range(EVAL_EPISODES):
                    a, t = fsl_episode(lambda x: fwd(fused, x)[0], evals[k],
                                       e, N_WAYS, k, n_query=EVAL_QUERY,
                                       log2=log2, device=dev)
                    accs.append(a)
                    checks.append((log2, k, p, st, t))
                acc[(log2, k)] = float(np.mean(accs))
        out["fsl_launches"] = (tcn_block.launches, proto_extract.launches)
        if 0 in out["fsl_launches"]:
            raise AssertionError("train: a kernel was not launched in the "
                                 f"evaluation (tcn_block, proto_extract) = "
                                 f"{out['fsl_launches']}")
        err = {"emb": 0.0, "raw": 0.0, "wb": 0.0}
        agree = total = 0
        qat_equal, qat_agree = [], []
        for log2, k, p, st, t in checks:
            tag = f"train Table I {'log2' if log2 else 'fp32'} {k}-shot"
            scan_p, scan_bn, fused = bake_stream_params(p, st, cfg,
                                                        quantize=log2)
            # the fused forward's plain version on the same inputs (the
            # kernels' summation order: the existing tolerances)
            plain = {s: plain_fused_forward(cfg, fused, t[s + "x"], log2)
                     for s in ("s", "q")}
            for s in ("s", "q"):
                err["emb"] = max(err["emb"], compare(
                    f"{tag} emb_{s} vs the fused forward's plain version",
                    t[f"emb_{s}"], plain[s], log2))
            extract = pn_fc_from_sums_log2 if log2 else pn_fc_from_sums
            if not log2:
                # and the eval forward on the raw trained params: BN
                # folding reassociates (the repo's folded-vs-raw tolerance)
                for s in ("s", "q"):
                    err["raw"] = max(err["raw"], scaled_close(
                        f"{tag} emb_{s} vs the eval forward on the raw "
                        "params", t[f"emb_{s}"],
                        tcn_forward(p, st, cfg, t[s + "x"])[0]))
            else:
                # the QAT eval forward on the baked params sums in another
                # order, and a u4 rounding flip propagates: its agreement
                # is reported, not gated
                q = {s: tcn_forward(scan_p, scan_bn, cfg, t[s + "x"],
                                    quantize=True)[0] for s in ("s", "q")}
                qat_equal += [(q[s] == t[f"emb_{s}"]).float().mean()
                              for s in ("s", "q")]
                wq, bq = extract(support_sums(q["s"], t["sy"], N_WAYS), k)[:2]
                qat_agree.append((pn_logits(q["q"], wq, bq).argmax(-1)
                                  == t["pred"]).float().mean())
            sums = support_sums(t["emb_s"], t["sy"], N_WAYS)
            ws, bs = extract(sums, k)[:2]
            err["wb"] = max(err["wb"], allclose(tag + " W", t["w"], ws, 1e-5,
                                                1e-6),
                            allclose(tag + " b", t["b"], bs, 1e-5, 1e-6))
            # the plain path end to end: plain embeddings, plain extraction
            wp, bp = extract(support_sums(plain["s"], t["sy"], N_WAYS), k)[:2]
            logits = pn_logits(plain["q"], wp, bp)
            pred = logits.argmax(-1)
            for r in torch.nonzero(pred != t["pred"]).flatten().tolist():
                la, lb = logits[r, t["pred"][r]], logits[r, pred[r]]
                if abs(la - lb) > 1e-4 * (abs(la) + abs(lb)):
                    raise AssertionError(f"{tag}: query {r} classified "
                                         f"{int(t['pred'][r])} by the kernels"
                                         f", {int(pred[r])} by the plain "
                                         "path, not a near tie")
            agree += int((pred == t["pred"]).sum())
            total += len(pred)
        out["acc"] = acc
        out["emb_max"] = max(float(t["emb_s"].abs().max())
                             for log2, *_, t in checks if not log2)
        log(f"train Table I (unseen classes, {EVAL_EPISODES} episodes of "
            f"5-way k-shot, {EVAL_QUERY} queries a way): accuracy fp32 "
            f"1-shot {acc[(False, 1)]:.4f} 5-shot {acc[(False, K_SHOTS)]:.4f}"
            f", log2 (QAT, Eq. 8) 1-shot {acc[(True, 1)]:.4f} 5-shot "
            f"{acc[(True, K_SHOTS)]:.4f}; fused forward vs its plain version "
            f"max abs err {err['emb']:.3g}, fp32 vs "
            f"the eval forward on the raw params {err['raw']:.3g}, log2 vs "
            f"the QAT eval forward on the baked params (reported) "
            f"{float(torch.stack(qat_equal).mean()):.4f} of the embeddings "
            f"bit-equal and argmax agreement "
            f"{float(torch.stack(qat_agree).mean()):.4f}, adapt W/b vs support_sums"
            f" + pn_fc_from_sums max abs err {err['wb']:.3g}, argmax agreement"
            f" {agree}/{total} (the rest near ties); tcn_block launches="
            f"{out['fsl_launches'][0]} proto_extract launches="
            f"{out['fsl_launches'][1]}; trained fp32 |emb| up to "
            f"{out['emb_max']:.3g}")

        # ---- serve the trained quantized embedder ----
        rng = np.random.default_rng(seed)
        audio = np.concatenate([ds.sample(int(test_cls[i % len(test_cls)]),
                                          1, seed=9000 + i)
                                for i in range(n_sessions)]).astype(np.float32)
        shots = np.stack([ds.sample(int(test_cls[j]), K_SHOTS, seed=9500 + j)
                          for j in range(N_WAYS)]).astype(np.float32)
        schedule = make_schedule(rng, n_sessions, glyph ** 2)

        def service(t_chunk):
            return StreamSessionService(
                bundle, params, state, n_slots=n_sessions,
                max_tenants=N_TENANTS, max_ways=8, t_chunk=t_chunk,
                quantize=True, fused=True)

        svc = service(T_CHUNK)
        tcn_block.launches = tcn_chunk.launches = proto_extract.launches = 0
        with counting(ref, PLAIN_CHUNK) as plain_calls:
            main, _ = drive(svc, audio, schedule, shots)
        chunk, strip = check_drive_launches("train serve", svc, cfg,
                                            plain_calls.calls)
        out["serve_launches"] = chunk + strip
        if not same_outputs(main, drive(service(1), audio, schedule,
                                        shots)[0]):
            raise AssertionError(f"train serve: t_chunk {T_CHUNK} and 1 "
                                 "differ")
        parked_svc = service(T_CHUNK)
        if not same_outputs(main, drive(parked_svc, audio, schedule, shots,
                                        park_every=4)[0]):
            raise AssertionError("train serve: park/resume changed the "
                                 "outputs")
        _, _, fused_q = bake_stream_params(params, state, cfg, quantize=True)
        e_full, _ = make_fused_forward(cfg, quantize=True, device=dev)(
            fused_q, torch.from_numpy(audio).to(dev))
        last = torch.from_numpy(np.stack([main[s][0][-1]
                                          for s in range(n_sessions)]))
        serr = compare("train serve: each stream's last step vs the "
                       "full-sequence fused forward", last, e_full.cpu(), True)
        log(f"train serve (trained log2 embedder, quantize=True): "
            f"{n_sessions} streams of {glyph ** 2}-step unseen-class glyphs,"
            f" {svc.dispatches} ticks, tcn_chunk launches={chunk}, strip "
            f"launches={strip}; chunk-size invariance (t_chunk {T_CHUNK} vs "
            f"1) and park/resume ({parked_svc.evictions} evictions) bit-exact;"
            f" every stream's last step equals the full-sequence fused "
            f"forward (max abs err {serr:.3g}, |emb| up to "
            f"{e_full.abs().max().item():.3g})")
    finally:
        data.close()
        for p in evals.values():
            p.close()
    return out


# ---------------------------------------------------------------------------
# phase: lm (the dense LM family through LMServer / LMSessionService)
# ---------------------------------------------------------------------------

LM_SLOTS, LM_SEQ_CAP, LM_T_CHUNK, LM_PREFILL_CHUNK = 8, 1024, 16, 64
LM_BLOCK, LM_WAVE_SESSIONS = 16, 16
LM_PROMPT_LEN, LM_SHARED, LM_SHARERS = (37, 300), 128, 4
LM_GEN, LM_SPILL_EXTRA, LM_TIMED = 64, 8, 20


def lm_prompts(rng, n: int, vocab: int, shared) -> list:
    """``n`` prompts of 37-300 tokens; the first LM_SHARERS start with the
    ``shared`` 128-token prefix (so the paged service's registry shares
    its 8 full blocks)."""
    import numpy as np

    lo, hi = LM_PROMPT_LEN
    out = []
    for i in range(n):
        if i < LM_SHARERS:
            tail = int(rng.integers(lo - 28, hi - LM_SHARED + 1))
            body = np.concatenate([shared, rng.integers(0, vocab, tail)])
        else:
            body = rng.integers(0, vocab, int(rng.integers(lo, hi + 1)))
        out.append(body.astype(np.int32))
    return out


def lm_server(bundle, params, **kw):
    from repro_torch.serving import LMServer, ServeConfig

    svc_kw = {k: kw.pop(k) for k in ("paged", "block_len", "device_counters")
              if k in kw}
    cfg = ServeConfig(**{"max_batch": LM_SLOTS, "seq_cap": LM_SEQ_CAP,
                         "decode_chunk": LM_T_CHUNK,
                         "prefill_chunk": LM_PREFILL_CHUNK, **kw})
    return LMServer(bundle, params, cfg, **svc_kw)


def lm_open(srv, prompts, dev) -> tuple[list, float]:
    """Open every prompt (chunked prefill at open); (sids, seconds)."""
    sync(dev)
    t0 = time.perf_counter()
    sids = [srv.open_session(p) for p in prompts]
    sync(dev)
    return sids, time.perf_counter() - t0


def lm_kv(srv, sids) -> list:
    """Every session's cache rows [0, steps) as uint16 bits."""
    from repro_torch.convert import numpy_bits

    return [numpy_bits(srv.service.live_column(s)) for s in sids]


def same_kv(a: list, b: list) -> bool:
    import numpy as np

    from repro_torch.utils.trees import tree_leaves

    return all(np.array_equal(x, y) for ta, tb in zip(a, b)
               for x, y in zip(tree_leaves(ta), tree_leaves(tb)))


def lm_launch_counts() -> dict:
    from repro_torch.kernels import dilated_conv, log2_matmul
    from repro_torch.kernels.proto_extract import proto_extract
    from repro_torch.kernels.tcn_block import tcn_block, tcn_chunk

    return {"tcn_block": tcn_block.launches + tcn_chunk.launches,
            "proto_extract": proto_extract.launches,
            "log2_matmul": log2_matmul.launches,
            "dilated_conv": dilated_conv.launches}


def zero_launch_counts() -> None:
    from repro_torch.kernels import dilated_conv, log2_matmul
    from repro_torch.kernels.proto_extract import (
        proto_extract,
        proto_extract_labels,
    )
    from repro_torch.kernels.tcn_block import tcn_block, tcn_chunk

    for k in (tcn_block, tcn_chunk, proto_extract, proto_extract_labels,
              log2_matmul, dilated_conv):
        k.launches = 0


def lm_kv_layers(kv: list) -> dict:
    """Per cache leaf ("k", "v", or MLA's "c_kv", "k_rope"), one fp32 array
    per layer in model order (the dense stack, then the MoE stack) of
    every session's rows, concatenated: uint16 bf16 bits back to
    values."""
    import numpy as np
    import torch

    out = {}
    for part in ("dense", "moe"):
        for key in kv[0].get(part, {}):
            bits = np.concatenate([t[part][key] for t in kv], axis=1)
            vals = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
            out.setdefault(key, []).extend(vals.float().numpy())
    return out


def clone_tree(tree):
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    return tree.clone()


def lm_next_logits(srv, sids, bundle, dev):
    """Logits of each session's next step (its pending token at its
    position) on a copy of the server's cache."""
    import torch

    svc = srv.service
    tok = torch.zeros((svc.n_slots, 1), dtype=torch.int32)
    pos = torch.zeros(svc.n_slots, dtype=torch.int32)
    for s in sids:
        sess, slot = svc.sessions[s], svc.sched.slot_of[s]
        tok[slot, 0] = int(sess.prompt[sess.steps])
        pos[slot] = sess.steps
    with torch.no_grad():
        lg, _ = bundle.decode_fn(svc._params, clone_tree(svc.cache),
                                 {"tokens": tok.to(dev), "pos": pos.to(dev)})
    return lg[[svc.sched.slot_of[s] for s in sids]].cpu().numpy()


def lm_schedule(bundle, params, prompts, dev, gen, name) -> dict:
    """The chunk-schedule contract (64-token chunks against token-at-a-time
    prefill, the same prompts): a chunk's GEMMs run at M=64 where the
    decode's run at M=8, and the bf16 casts after them (the residual, the
    softmax probabilities) turn fp32 rounding into bf16 ulps that later
    layers carry on, so the two are not bit-identical.  Held: layer 0's
    cache rows (a GEMM of the embedded tokens, no attention before it)
    within one bf16 ulp of the layer's scale; every layer's rows, and the
    next-step logits, within 5e-2 of their scale (the bf16 tolerance of
    the parity tests).  A MoE model holds layer 0 (dense) only: a 64-token
    chunk's expert capacity (the reference's) drops tokens that a
    one-token step never drops, so its later layers and logits are
    reported, not held.  Reported: the per-layer spread in ulps of the
    layer's scale, the share of elements that differ, and the greedy
    streams' agreement (the first step where they part, against the
    top-2 margin there)."""
    import numpy as np

    moe = bool(bundle.cfg.n_experts)
    chunked = lm_server(bundle, params)
    c_sids, _ = lm_open(chunked, prompts, dev)
    scan = lm_server(bundle, params, prefill_chunk=0)
    s_sids, _ = lm_open(scan, prompts, dev)
    scan.push({s: 0 for s in s_sids})
    a = lm_kv_layers(lm_kv(chunked, c_sids))
    b = lm_kv_layers(lm_kv(scan, s_sids))
    exact = all(np.array_equal(x, y) for k in a for x, y in zip(a[k], b[k]))
    worst, rel, held, shares = 0.0, 0.0, 0.0, []
    for key in a:
        for layer, (x, y) in enumerate(zip(a[key], b[key])):
            scale = float(np.abs(x).max())
            ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
            d = float(np.abs(x - y).max())
            if layer == 0 and d > ulp:
                raise RuntimeError(f"{name}: layer-0 {key} rows differ by "
                                   f"{d / ulp:.1f} ulps of their scale")
            worst, rel = max(worst, d / ulp), max(rel, d / scale)
            if layer == 0 or not moe:
                held = max(held, d / scale)
            shares.append(float((x != y).mean()))
    la = lm_next_logits(chunked, c_sids, bundle, dev)
    lb = lm_next_logits(scan, s_sids, bundle, dev)
    dl = float(np.abs(la - lb).max())
    lscale = max(1.0, float(np.abs(la).max()))
    chunked.step(gen)
    scan.step(gen)
    parts = []
    for c, s in zip(c_sids, s_sids):
        x, y = chunked.outputs[c], scan.outputs[s]
        parts.append(next((j for j in range(gen) if x[j] != y[j]), gen))
    top = np.sort(la, axis=-1)[:, -2:]
    margins = top[:, 1] - top[:, 0]
    log(f"{name}: chunk schedule (64-token chunks vs token at a time): "
        f"cache {'bit-exact' if exact else 'not bit-exact'}; layer 0 within "
        f"1 ulp of its scale; worst layer {worst:.1f} ulps of its scale "
        f"({rel:.2e} of it); elements differing per layer "
        f"{min(shares):.2e}-{max(shares):.2e}; next-step logits differ by "
        f"{dl:.3g} (scale {lscale:.3g}, top-2 margins "
        f"{margins.min():.3g}-{margins.max():.3g}); greedy streams equal "
        f"for {sum(p == gen for p in parts)} of {len(parts)} requests over "
        f"{gen} tokens, first parting steps {parts}"
        + ("; held on layer 0 only (MoE capacity drops in 64-token chunks)"
           if moe else ""))
    if held > 5e-2 or (not moe and dl > 5e-2 * lscale):
        raise RuntimeError(f"{name}: chunk-schedule contract broken (cache "
                           f"{held:.3g} of scale, logits {dl:.3g})")
    return {"max_ulps": worst, "exact": exact, "logit_diff": dl,
            "rel": rel, "parts": parts}


def moe_chunk_drops(bundle, params, prompts, dev) -> dict:
    """``moe_dropped`` (the share of (token, expert) pairs past capacity,
    averaged over the MoE layers) of every whole 64-token prefill chunk
    of the prompts, each chunk run as the service runs it: one
    ``step_fn``-shaped call at its position on the prompt's own cache."""
    import numpy as np
    import torch
    from repro_torch.models.transformer import backbone, embed_tokens

    cfg, per = bundle.cfg, []
    with torch.no_grad():
        for p in prompts:
            cache = bundle.empty_cache(1, LM_SEQ_CAP)
            for off in range(0, len(p) - LM_PREFILL_CHUNK + 1,
                             LM_PREFILL_CHUNK):
                toks = torch.from_numpy(
                    p[None, off:off + LM_PREFILL_CHUNK]).to(dev)
                _, m = backbone(params, cfg, embed_tokens(params, cfg, toks),
                                torch.tensor(off, device=dev), cache)
                per.append(float(m["moe_dropped"]))
    return {"chunks": len(per), "mean": float(np.mean(per)),
            "max": float(np.max(per)), "min": float(np.min(per))}


def moe_step_bytes(bundle, params, srv, sids, dev) -> dict:
    """The bytes a decode step must move: the weights every token reads
    (embedding and head tables, attention, norms, dense and shared FFNs,
    routers), the experts the step's router picked (each read once,
    whatever the number of lanes that chose it) and the live cache rows.
    The picks come from one decode step of the server's lanes on a copy
    of its cache."""
    import torch
    from repro_torch.models import transformer as tr
    from repro_torch.models.moe import route
    from repro_torch.utils.trees import tree_leaves

    cfg, svc = bundle.cfg, srv.service
    picked = []
    orig = tr.moe_ffn

    def recording(p, c, x):
        picked.append(torch.unique(route(p, c, x)[2]).numel())
        return orig(p, c, x)

    tok = torch.zeros((svc.n_slots, 1), dtype=torch.int32)
    pos = torch.zeros(svc.n_slots, dtype=torch.int32)
    for s in sids:
        sess, slot = svc.sessions[s], svc.sched.slot_of[s]
        tok[slot, 0], pos[slot] = sess.tok, sess.steps
    tr.moe_ffn = recording
    try:
        with torch.no_grad():
            bundle.decode_fn(svc._params, clone_tree(svc.cache),
                             {"tokens": tok.to(dev), "pos": pos.to(dev)})
    finally:
        tr.moe_ffn = orig
    expert = 3 * cfg.d_model * cfg.d_ff_expert * 2  # wg, wi, wd in bf16
    total = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    all_experts = sum(
        layer["mlp"][k].numel() * layer["mlp"][k].element_size()
        for layer in params.get("moe_layers", []) for k in ("wg", "wi", "wd"))
    live = sum(svc.sessions[s].steps for s in sids)
    kv = svc.kv_park_bytes(1) * live
    return {"bytes": total - all_experts + expert * sum(picked) + kv,
            "picked": picked, "all_weights": total, "kv": kv}


def phase_lm(cfg, dev, smi: str, seed: int = 20, gen: int = LM_GEN,
             wave: bool = True, depth_note: str = "full depth"):
    """An LM (dense or MoE family) served through LMServer on seeded random
    weights (drawn on the device, baked to the activation dtype once):
    dense and paged (block_len 16) services side by side, 8 requests of
    37-300 tokens (four sharing a 128-token prefix), ``gen`` greedy tokens
    each; t_chunk 16 == 1 and paged == dense bit for bit (tokens and cache
    rows), the chunk-schedule contract (``lm_schedule``), and with
    ``wave`` a second wave of 16 sessions over the 8 slots (parking and
    resuming) bit-equal to never-parked controls and a spill/restore
    bit-equal to a never-spilled continuation; every logit finite; for
    MLA, the absorbed decode against the baseline (``mla_absorb_check``);
    prefill tokens/s, decode ms per token, launches and idle share of a
    decode step, cache bytes per token, pool blocks live and the bytes
    bound of a decode step (for MoE, of the experts the step picked), and
    for MoE the drop share of 64-token prefill chunks."""
    import numpy as np
    import torch
    from repro_torch.models import build_bundle
    from repro_torch.models.params import param_count
    from repro_torch.models.transformer import bake_lm_params
    from repro_torch.utils.trees import tree_leaves

    name = f"lm {cfg.name} ({cfg.n_layers} layers, {depth_note})"
    bundle = build_bundle(cfg, dev)
    t0 = time.perf_counter()
    raw = bundle.init(torch.Generator(device=dev).manual_seed(seed))
    params = bake_lm_params(raw, cfg)
    sync(dev)
    n_params = param_count(bundle.param_defs)
    w_bytes = sum(t.numel() * t.element_size() for t in
                  tree_leaves(params))
    log(f"{name}: {n_params:,} params drawn on the card and baked to "
        f"{cfg.act_dtype} ({w_bytes / 1e9:.3f} GB) in "
        f"{time.perf_counter() - t0:.2f} s [{smi}]")
    # the baked tree against the reference's per-use cast: one decode
    # step on the fp32 tree and on the baked one, bit for bit
    rng = np.random.default_rng(seed)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (LM_SLOTS, 1))
                           .astype(np.int32)).to(dev)
    pos = torch.zeros(LM_SLOTS, dtype=torch.int32, device=dev)
    with torch.no_grad():
        la, _ = bundle.decode_fn(raw, bundle.empty_cache(LM_SLOTS, 32),
                                 {"tokens": tok, "pos": pos})
        lb, _ = bundle.decode_fn(params, bundle.empty_cache(LM_SLOTS, 32),
                                 {"tokens": tok, "pos": pos})
    if not torch.equal(la, lb):
        raise RuntimeError(f"{name}: the baked tree's decode differs from "
                           "the per-use cast's")
    del raw, la, lb
    torch.cuda.empty_cache()

    shared = rng.integers(0, cfg.vocab_size, LM_SHARED).astype(np.int32)
    prompts = lm_prompts(rng, LM_SLOTS, cfg.vocab_size, shared)
    n_prefill = sum(len(p) - 1 for p in prompts)
    zero_launch_counts()
    dense = lm_server(bundle, params)
    paged = lm_server(bundle, params, paged=True, block_len=LM_BLOCK)
    d_sids, d_s = lm_open(dense, prompts, dev)
    p_sids, p_s = lm_open(paged, prompts, dev)
    st = paged.stats()["paged"]
    hits = paged.metrics()["prefix_block_hits_total"][0]["value"]
    log(f"{name}: prefill {n_prefill} prompt tokens (8 prompts of "
        f"{min(map(len, prompts))}-{max(map(len, prompts))}) dense "
        f"{d_s * 1e3:.1f} ms = {n_prefill / d_s:,.0f} tokens/s, paged "
        f"{p_s * 1e3:.1f} ms = {(n_prefill - hits * LM_BLOCK) / p_s:,.0f} "
        f"tokens/s ({hits} prefix blocks adopted, "
        f"{st['blocks_cow_shared']} shared) [{smi}]")
    if hits < (LM_SHARERS - 1) * LM_SHARED // LM_BLOCK:
        raise RuntimeError(f"{name}: prefix sharing adopted {hits} blocks")
    dense.step(gen)
    paged.step(gen)
    d_out = [dense.outputs[s] for s in d_sids]
    if [paged.outputs[s] for s in p_sids] != d_out \
            or any(len(o) != gen for o in d_out):
        raise RuntimeError(f"{name}: paged tokens differ from dense")
    d_kv = lm_kv(dense, d_sids)
    if not same_kv(lm_kv(paged, p_sids), d_kv):
        raise RuntimeError(f"{name}: paged KV rows differ from dense")
    st = paged.stats()["paged"]
    log(f"{name}: paged == dense bit for bit ({gen} tokens x 8, KV rows); "
        f"pool blocks live {st['blocks_live']}/{st['n_blocks']}, "
        f"CoW-shared {st['blocks_cow_shared']}, prefix entries "
        f"{st['prefix_entries']}")
    del paged
    # t_chunk = 1: the same tokens and KV bits
    one = lm_server(bundle, params, decode_chunk=1)
    o_sids, _ = lm_open(one, prompts, dev)
    one.step(gen)
    if [one.outputs[s] for s in o_sids] != d_out \
            or not same_kv(lm_kv(one, o_sids), d_kv):
        raise RuntimeError(f"{name}: t_chunk=1 differs from t_chunk=16")
    log(f"{name}: t_chunk=16 == t_chunk=1 bit for bit (tokens, KV rows; "
        f"{one.service.dispatches} vs {dense.service.dispatches} "
        "dispatches)")
    del one
    # the chunk-schedule contract, on the same 8 prompts: 64-token prefill
    # chunks against token-at-a-time prefill (prefill_chunk=0, the body fed
    # through the decode scan by a zero-token push)
    sched = lm_schedule(bundle, params, prompts, dev, gen, name)
    ulps, exact = sched["max_ulps"], sched["exact"]
    # every logit finite: each prompt's prefill and a batched decode step
    with torch.no_grad():
        for p in prompts:
            lg, _ = bundle.prefill_fn(params, {"tokens": torch.from_numpy(
                p[None]).to(dev)})
            if not bool(torch.isfinite(lg).all()):
                raise RuntimeError(f"{name}: non-finite prefill logits")
        last = torch.tensor([o[-1] for o in d_out], dtype=torch.int32,
                            device=dev)[:, None]
        pos = torch.tensor([dense.service.sessions[s].steps
                            for s in d_sids], dtype=torch.int32, device=dev)
        batch = {"tokens": last, "pos": pos}
        lg, _ = bundle.decode_fn(params, clone_tree(dense.service.cache),
                                 batch)
        if not bool(torch.isfinite(lg).all()):
            raise RuntimeError(f"{name}: non-finite decode logits")
        result = {}
        if cfg.use_mla:
            result["absorb"] = mla_absorb_check(cfg, dev, params, dense,
                                                batch, lg, name)
    if wave:
        result.update(lm_wave(bundle, params, cfg, dev, rng, shared, prompts,
                              dense, d_sids, gen, name))
    # timings on the dense server: a T=1 dispatch is one token per lane
    sids = [s for s in d_sids if not dense.service.sessions[s].done]
    one_tok = lambda: dense.push({s: 1 for s in sids})
    chunk = lambda: dense.push({s: LM_T_CHUNK for s in sids})
    ms1 = time_ms(one_tok, dev, n=LM_TIMED)
    ms16 = time_ms(chunk, dev, n=LM_TIMED // 4) / LM_T_CHUNK
    prof = profile_tick(one_tok, ticks=10, name=f"{name} decode step")
    kv_tok = dense.service.kv_park_bytes(1)
    live = sum(dense.service.sessions[s].steps for s in sids)
    kv_full = kv_tok * LM_SLOTS * LM_SEQ_CAP
    step_w, what = w_bytes, f"baked weights {w_bytes / 1e9:.3f} GB"
    if cfg.n_experts:
        mb = moe_step_bytes(bundle, params, dense, sids, dev)
        step_w = mb["bytes"] - mb["kv"]
        what = (f"weights {step_w / 1e9:.3f} GB: the experts the step's "
                f"router picked ({mb['picked']} of {cfg.n_experts} a MoE "
                f"layer) and every other weight")
        result.update(picked=mb["picked"], step_weight_bytes=step_w)
    lo = (step_w + kv_tok * live) / PEAK_BYTES * 1e3
    hi = (step_w + kv_full) / PEAK_BYTES * 1e3
    log(f"{name}: decode p50 {ms1:.3f} ms per token (T=1 dispatch of "
        f"{len(sids)} lanes, {LM_TIMED} timed), {ms16:.3f} ms per token in "
        f"T={LM_T_CHUNK} dispatches; {prof['launches']:.0f} launches and "
        f"idle share {1 - prof['busy_ms'] / prof['wall_ms']:.4f} a step; "
        f"cache {kv_tok:,} bytes a token"
        f"{' (MLA latent c_kv + k_rope)' if cfg.use_mla else ''}; bytes "
        f"bound of a step {lo:.3f} ms ({what} + the {live} live cache rows)"
        f" to {hi:.3f} ms (+ the full {LM_SEQ_CAP}-row columns the masked "
        f"attention reads) at 3.35 TB/s [{smi}]")
    if cfg.n_experts:
        from repro_torch.models.moe import expert_capacity

        drops = moe_chunk_drops(bundle, params, prompts, dev)
        log(f"{name}: moe_dropped of the {drops['chunks']} whole 64-token "
            f"prefill chunks of the 8 prompts (capacity "
            f"{expert_capacity(LM_PREFILL_CHUNK, cfg)} a expert, factor "
            f"{cfg.capacity_factor}): mean {drops['mean']:.4f}, min "
            f"{drops['min']:.4f}, max {drops['max']:.4f} of the (token, "
            f"expert) pairs; a one-token step drops none")
        result["chunk_drops"] = drops
    # where a prefill's time goes: a 129-token prompt opened (two 64-token
    # chunks) and closed on the dense server
    dense.close(sids[0])
    body = np.concatenate([shared, shared[:1]])
    prof_p = profile_tick(lambda: dense.close(dense.open_session(body)),
                          ticks=5, name=f"{name} open (2 prefill chunks)")
    counts = lm_launch_counts()
    if any(counts.values()):
        raise RuntimeError(f"{name}: the LM path launched a port kernel "
                           f"{counts}; it should reach none")
    log(f"{name}: launches of the four port kernels on this path: {counts}")
    result.update(prefill_tps=n_prefill / d_s, ms_per_token=ms1,
                  ms_per_token_t16=ms16, launches=prof["launches"],
                  idle=1 - prof["busy_ms"] / prof["wall_ms"],
                  bound_ms=(lo, hi), kv_bytes_per_token=kv_tok,
                  ulps=ulps, exact=exact,
                  prefill_launches=prof_p["launches"] / 2)
    del dense
    torch.cuda.empty_cache()
    return result


def mla_absorb_check(cfg, dev, params, dense, batch, lg, name) -> dict:
    """MLA's absorbed decode (``mla_absorb=True``: attention in the latent
    space) against the up-projection baseline.  Held at the reference's
    test configuration (tests/test_archs_smoke.py::test_mla_absorbed_
    decode_matches_baseline: the ``smoke()`` cut, 2 lanes, a 16-token
    prefix, CPU-drawn seed-0 weights) on the card: logits within atol
    0.06, argmax equal.  At full width, on the served cache and batch
    (``lg`` the baseline's logits): the gap is reported, and an argmax
    may differ only at a near tie, a baseline top-2 margin below 0.12
    (twice that atol).  The 0.06 gap itself is not held there: the
    reference's own formulation passes it at 2 layers and 16 rows, not
    at more depth or rows (bf16 rounds the two paths at different
    points)."""
    import numpy as np
    import torch
    from repro_torch.models import build_bundle

    small = cfg.smoke()
    p = _to(build_bundle(small, "cpu").init(torch.Generator().manual_seed(0)),
            dev)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, small.vocab_size, (2, 17)).astype(np.int32)).to(dev)
    b0 = build_bundle(small, dev)
    b1 = build_bundle(small.replace(mla_absorb=True), dev)
    with torch.no_grad():
        c0 = b0.empty_cache(2, 17)
        b0.step_fn(p, c0, {"tokens": toks[:, :-1], "pos": 0})
        sb = {"tokens": toks[:, -1:],
              "pos": torch.tensor(16, dtype=torch.int32, device=dev)}
        s0, _ = b0.decode_fn(p, clone_tree(c0), sb)
        s1, _ = b1.decode_fn(p, c0, sb)
        absorbed = build_bundle(cfg.replace(mla_absorb=True), dev)
        la, _ = absorbed.decode_fn(params, clone_tree(dense.service.cache),
                                   batch)
    small_diff = float((s0 - s1).abs().max())
    if small_diff > 0.06 or not torch.equal(s0.argmax(-1), s1.argmax(-1)):
        raise RuntimeError(f"{name}: absorbed MLA decode at the reference's "
                           f"test configuration differs by {small_diff}")
    diff = float((la - lg).abs().max())
    flips = (la.argmax(-1) != lg.argmax(-1)).nonzero().flatten().tolist()
    top = lg.topk(2, dim=-1).values
    margins = (top[:, 0] - top[:, 1]).tolist()
    log(f"{name}: MLA absorbed decode vs the up-projection baseline: "
        f"{small_diff:.4g} apart at the reference test's configuration "
        f"(atol 0.06, argmax equal); at full width {diff:.4g} apart, argmax "
        f"differs in lanes {flips} (baseline top-2 margins "
        f"{[round(margins[i], 4) for i in flips]}; all lanes "
        f"{min(margins):.3g}-{max(margins):.3g})")
    if any(margins[i] >= 0.12 for i in flips):
        raise RuntimeError(f"{name}: absorbed MLA decode changes an argmax "
                           "away from a near tie")
    return {"small_diff": small_diff, "max_diff": diff, "flips": flips}


def lm_wave(bundle, params, cfg, dev, rng, shared, prompts, dense, d_sids,
            gen, name) -> dict:
    """16 sessions over the 8 slots (``max_sessions=16``), dense and
    paged: every session parks and resumes between two ``step(gen // 2)``
    calls; each equals its never-parked control.  Then 2 sessions spill
    through checkpoint/store into a fresh service and continue bit for
    bit with their never-spilled twins."""
    import numpy as np

    second = lm_prompts(rng, LM_WAVE_SESSIONS - LM_SLOTS, cfg.vocab_size,
                        shared)
    ctl2 = lm_server(bundle, params)
    c2_sids, _ = lm_open(ctl2, second, dev)
    ctl2.step(gen)
    want = [dense.outputs[s] for s in d_sids] \
        + [ctl2.outputs[s] for s in c2_sids]
    del ctl2
    out = {}
    for paged in (False, True):
        kw = {"paged": True, "block_len": LM_BLOCK} if paged else {}
        srv = lm_server(bundle, params, max_sessions=LM_WAVE_SESSIONS, **kw)
        sids, _ = lm_open(srv, prompts + second, dev)
        srv.step(gen // 2)
        srv.step(gen - gen // 2)
        got = [srv.outputs[s] for s in sids]
        ev = srv.stats()["evictions"]
        if got != want or ev < LM_WAVE_SESSIONS:
            raise RuntimeError(f"{name}: the {'paged' if paged else 'dense'}"
                               f" wave differs from its controls (evictions"
                               f" {ev})")
        log(f"{name}: {'paged' if paged else 'dense'} wave of "
            f"{LM_WAVE_SESSIONS} sessions on {LM_SLOTS} slots: {ev} "
            f"evictions, every stream bit-equal to its never-parked "
            f"control; parked bytes now {srv.stats()['parked_blob_bytes']:,}")
        out[f"wave_{'paged' if paged else 'dense'}"] = srv
    # spill two of the dense wave's sessions, restore, continue
    srv = out.pop("wave_dense")
    paged_srv = out.pop("wave_paged")
    del paged_srv
    keep = [0, LM_SLOTS]  # one of each wave
    spill = ROOT / "build" / "lm_spill.npz"
    for i, sid in enumerate(sorted(srv.service.sessions)):
        if i not in keep:
            srv.close(sid)
    t0 = time.perf_counter()
    srv.service.spill_parking(str(spill), include_bound=True)
    t_spill = time.perf_counter() - t0
    from repro_torch.serving import LMServer, ServeConfig

    fresh = LMServer(bundle, params, ServeConfig(
        max_batch=LM_SLOTS, seq_cap=LM_SEQ_CAP, decode_chunk=LM_T_CHUNK,
        prefill_chunk=LM_PREFILL_CHUNK, max_sessions=LM_WAVE_SESSIONS))
    t0 = time.perf_counter()
    restored = fresh.service.restore_parking(str(spill))
    t_restore = time.perf_counter() - t0
    twin = lm_server(bundle, params)
    t_sids, _ = lm_open(twin, [(prompts + second)[i] for i in keep], dev)
    twin.step(gen)
    cont = fresh.push({s: LM_SPILL_EXTRA for s in restored})
    want2 = twin.push({s: LM_SPILL_EXTRA for s in t_sids})
    if [cont[s] for s in restored] != [want2[s] for s in t_sids]:
        raise RuntimeError(f"{name}: restored sessions differ from their "
                           "never-spilled twins")
    size = spill.stat().st_size
    spill.unlink()
    log(f"{name}: spilled {len(restored)} sessions ({size:,} bytes, "
        f"{t_spill:.2f} s), restored ({t_restore:.2f} s), "
        f"{LM_SPILL_EXTRA} more tokens each bit-equal to never-spilled "
        "twins")
    return {"spill_bytes": size}


# ---------------------------------------------------------------------------
# phase: spec (speculative decoding through LMServer)
# ---------------------------------------------------------------------------

SPEC_K, SPEC_GEN, SPEC_SHORT, SPEC_EXTRA = 4, 32, 12, 8


def spec_drafters(prompts, streams, vocab) -> dict:
    """The drafter zoo over known streams: the oracle (the true
    continuation), always-wrong (off by one), random (seeded by the
    history's length) and the n-gram self-draft.  A history is matched to
    its request by its prompt (the longest that prefixes it)."""
    import numpy as np
    from repro_torch.sessions import ngram_drafter

    def stream_of(hist):
        best = max((i for i, p in enumerate(prompts) if len(hist) >= len(p)
                    and np.array_equal(hist[:len(p)], p)),
                   key=lambda i: len(prompts[i]))
        return len(prompts[best]), streams[best]

    def oracle(hist, k):
        n, ref = stream_of(hist)
        return np.asarray(ref[len(hist) - n:len(hist) - n + k], np.int32)

    def wrong(hist, k):
        return (oracle(hist, k) + 1) % vocab

    def rand(hist, k):
        return np.random.default_rng(len(hist)).integers(
            0, vocab, size=k).astype(np.int32)

    return {"oracle": oracle, "always-wrong": wrong, "random": rand,
            "ngram": ngram_drafter()}


def spec_run(bundle, params, prompts, dev, n, drafter=None, park=False,
             **kw):
    """A speculating LMServer over the prompts, ``step(n // 2)`` then
    ``step(n - n // 2)`` (with ``park``, every session parked between the
    two), timed: (server, sids, streams, seconds).  Parallel mode's stream
    depends on the drafts, and a call cuts its last drafts to its budget,
    so runs compared with each other share this schedule."""
    srv = lm_server(bundle, params, speculative=SPEC_K, **kw)
    if drafter is not None:
        srv.spec.drafter = drafter
    sids, _ = lm_open(srv, prompts, dev)
    sync(dev)
    t0 = time.perf_counter()
    srv.step(n // 2)
    if park:
        for s in sids:
            srv.park(s)
    srv.step(n - n // 2)
    sync(dev)
    return srv, sids, [srv.outputs[s] for s in sids], \
        time.perf_counter() - t0


def spec_blocks_trimmed(srv, sids, name) -> int:
    """Every paged session holds exactly the blocks of its position after
    a speculative call (the rejected suffix's went back to the pool)."""
    svc = srv.service
    for s in sids:
        want = -(-svc.sessions[s].steps // svc.block_len)
        if len(svc._blocks.get(s, [])) != want:
            raise RuntimeError(f"{name}: session {s} holds "
                               f"{len(svc._blocks.get(s, []))} blocks at "
                               f"position {svc.sessions[s].steps}")
    svc.pool.check()
    return svc.pool.n_live


def phase_spec(cfg, dev, smi: str, seed: int = 21,
               depth_note: str = "full depth") -> dict:
    """Speculative decoding through LMServer(ServeConfig(max_batch=8,
    seq_cap=1024, decode_chunk=16, prefill_chunk=64, speculative=4,
    spec_verify=...)), dense and paged, on seeded random weights, 8
    requests of 37-300 tokens.  Scan mode: the stream equals plain
    decode's bit for bit for the oracle, always-wrong, random and n-gram
    drafters; paged sessions hold the blocks of their position only after
    every call; parking every session mid-draft and spilling two to disk
    (restored into a fresh speculating server) leave the streams
    unchanged.  Parallel mode: exact emission counts, paged == dense, and
    invariance to parking mid-draft.  With device counters, the device
    acceptance count equals the host's in both modes.  Tokens/s and
    acceptance at K=4 for plain decode and both modes (oracle and n-gram).
    The path launches none of the four port kernels."""
    import numpy as np
    import torch
    from repro_torch.models import build_bundle
    from repro_torch.models.transformer import bake_lm_params
    from repro_torch.serving import LMServer, ServeConfig

    name = f"spec {cfg.name} ({cfg.n_layers} layers, {depth_note})"
    bundle = build_bundle(cfg, dev)
    params = bake_lm_params(bundle.init(
        torch.Generator(device=dev).manual_seed(seed)), cfg)
    torch.cuda.empty_cache()
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, cfg.vocab_size, LM_SHARED).astype(np.int32)
    prompts = lm_prompts(rng, LM_SLOTS, cfg.vocab_size, shared)
    n_tok = LM_SLOTS * SPEC_GEN
    zero_launch_counts()
    plain = lm_server(bundle, params)
    p_sids, _ = lm_open(plain, prompts, dev)
    sync(dev)
    t0 = time.perf_counter()
    plain.step(SPEC_GEN)
    sync(dev)
    rates = {"plain": n_tok / (time.perf_counter() - t0)}
    plain.step(SPEC_EXTRA)
    full = [plain.outputs[s] for s in p_sids]
    want = [o[:SPEC_GEN] for o in full]
    del plain
    zoo = spec_drafters(prompts, full, cfg.vocab_size)
    acc = {}
    for paged in (False, True):
        kw = {"paged": True, "block_len": LM_BLOCK} if paged else {}
        lay = "paged" if paged else "dense"
        for dname, dr in zoo.items():
            n = SPEC_GEN if dname in ("oracle", "ngram") else SPEC_SHORT
            srv, sids, got, sec = spec_run(bundle, params, prompts, dev, n,
                                           dr, **kw)
            if got != [w[:n] for w in want]:
                raise RuntimeError(f"{name}: {lay} scan-mode speculation "
                                   f"with the {dname} drafter differs from "
                                   "plain decode")
            live = spec_blocks_trimmed(srv, sids, name) if paged else None
            acc[f"scan {dname} {lay}"] = srv.spec.acceptance_rate
            if n == SPEC_GEN:
                rates[f"scan {dname} {lay}"] = LM_SLOTS * n / sec
            log(f"{name}: scan mode ({lay}) with the {dname} drafter: "
                f"{LM_SLOTS}x{n} tokens bit-equal to plain decode, "
                f"acceptance {srv.spec.acceptance_rate:.4f}, "
                f"{srv.service.dispatches} dispatches, "
                f"{LM_SLOTS * n / sec:,.1f} tokens/s"
                + (f", pool blocks live {live} (the blocks of the "
                   f"positions only)" if paged else "") + f" [{smi}]")
            del srv
        # park every session mid-draft, then spill two to disk
        srv, sids, got, _ = spec_run(bundle, params, prompts, dev, SPEC_GEN,
                                     park=True, **kw)
        if got != want:
            raise RuntimeError(f"{name}: {lay} speculation changed across "
                               "park/resume")
        for s in sids[2:]:
            srv.close(s)
        spill = ROOT / "build" / "spec_spill.npz"
        srv.service.spill_parking(str(spill), include_bound=True)
        fresh = LMServer(bundle, params, ServeConfig(
            max_batch=LM_SLOTS, seq_cap=LM_SEQ_CAP, decode_chunk=LM_T_CHUNK,
            prefill_chunk=LM_PREFILL_CHUNK, speculative=SPEC_K), **kw)
        restored = fresh.service.restore_parking(str(spill))
        spill.unlink()
        fresh.step(SPEC_EXTRA)
        if [fresh.outputs[s] for s in restored] != full[:2]:
            raise RuntimeError(f"{name}: {lay} speculation differs after "
                               "spill/restore")
        if paged:
            spec_blocks_trimmed(fresh, restored, name)
        log(f"{name}: scan mode ({lay}): all {LM_SLOTS} sessions parked "
            f"mid-draft and resumed, two spilled ({len(restored)} restored) "
            f"into a fresh server, {SPEC_EXTRA} more tokens each: bit-equal "
            "to plain decode")
        del srv, fresh
    # parallel mode: paged == dense, exact counts, park/resume invariance
    par = {}
    for paged in (False, True):
        kw = {"paged": True, "block_len": LM_BLOCK} if paged else {}
        lay = "paged" if paged else "dense"
        srv, sids, got, sec = spec_run(bundle, params, prompts, dev,
                                       SPEC_GEN, spec_verify="parallel", **kw)
        if any(len(g) != SPEC_GEN for g in got):
            raise RuntimeError(f"{name}: parallel mode emitted "
                               f"{[len(g) for g in got]} tokens")
        if paged:
            spec_blocks_trimmed(srv, sids, name)
        par[lay] = got
        acc[f"parallel ngram {lay}"] = srv.spec.acceptance_rate
        rates[f"parallel ngram {lay}"] = LM_SLOTS * SPEC_GEN / sec
        log(f"{name}: parallel mode ({lay}), n-gram drafter: "
            f"acceptance {srv.spec.acceptance_rate:.4f}, "
            f"{srv.service.dispatches} dispatches, "
            f"{LM_SLOTS * SPEC_GEN / sec:,.1f} tokens/s; streams equal to "
            f"plain decode's for {sum(g == w for g, w in zip(got, want))} "
            f"of {LM_SLOTS} [{smi}]")
        del srv
    if par["paged"] != par["dense"]:
        raise RuntimeError(f"{name}: parallel mode: paged differs from "
                           "dense")
    srv, _, got, _ = spec_run(bundle, params, prompts, dev, SPEC_GEN,
                              park=True, spec_verify="parallel")
    if got != par["dense"]:
        raise RuntimeError(f"{name}: parallel mode changed across "
                           "park/resume")
    del srv
    srv, sids, got, sec = spec_run(bundle, params, prompts, dev, SPEC_GEN,
                                   zoo["oracle"], spec_verify="parallel")
    acc["parallel oracle dense"] = srv.spec.acceptance_rate
    rates["parallel oracle dense"] = LM_SLOTS * SPEC_GEN / sec
    log(f"{name}: parallel mode (dense) with the oracle (plain decode's "
        f"stream): acceptance {srv.spec.acceptance_rate:.4f}, "
        f"{srv.service.dispatches} dispatches, "
        f"{LM_SLOTS * SPEC_GEN / sec:,.1f} tokens/s, streams equal to plain "
        f"decode's for {sum(g == w for g, w in zip(got, want))} of "
        f"{LM_SLOTS} [{smi}]")
    del srv
    # the device acceptance count against the host's, both modes
    for verify in ("scan", "parallel"):
        srv, _, _, _ = spec_run(bundle, params, prompts, dev, SPEC_GEN,
                                spec_verify=verify, paged=True,
                                block_len=LM_BLOCK, device_counters=True)
        dev_acc = srv.metrics()["spec_device_accepted_total"][0]["value"]
        if dev_acc != srv.spec.accepted:
            raise RuntimeError(f"{name}: {verify} device acceptance "
                               f"{dev_acc} != host {srv.spec.accepted}")
        log(f"{name}: {verify} mode with device counters: device-counted "
            f"acceptance {dev_acc:.0f} == host {srv.spec.accepted} of "
            f"{srv.spec.drafted} drafted")
        del srv
    counts = lm_launch_counts()
    if any(counts.values()):
        raise RuntimeError(f"{name}: the LM path launched a port kernel "
                           f"{counts}; it should reach none")
    log(f"{name}: tokens/s at K={SPEC_K} "
        + ", ".join(f"{k} {v:,.1f}" for k, v in rates.items())
        + "; acceptance " + ", ".join(f"{k} {v:.4f}" for k, v in acc.items())
        + f"; launches of the four port kernels {counts} [{smi}]")
    torch.cuda.empty_cache()
    return {"rates": rates, "acceptance": acc}


# ---------------------------------------------------------------------------
# phase: recurrent (rwkv6-1.6b and the zamba2-1.2b hybrid through LMServer)
# ---------------------------------------------------------------------------

REC_SEQ_CAP, REC_PROMPT_LEN, REC_GEN, REC_EXTRA = 256, (16, 48), 32, 8
REC_SPEC_GEN, REC_TIMED = 16, 10


def rec_prompts(rng, n: int, vocab: int) -> list:
    """``n`` prompts of REC_PROMPT_LEN tokens (no shared prefix: a
    recurrent service shares none)."""
    import numpy as np

    lo, hi = REC_PROMPT_LEN
    return [rng.integers(0, vocab, int(rng.integers(lo, hi + 1)))
            .astype(np.int32) for _ in range(n)]


def rec_server(bundle, params, **kw):
    """An LMServer of the recurrent phase: the lm phase's geometry with
    seq_cap REC_SEQ_CAP (prompts, generation and drafts stay far below)."""
    return lm_server(bundle, params, **{"seq_cap": REC_SEQ_CAP, **kw})


def rec_open(srv, prompts, dev) -> tuple[list, float]:
    """Open the prompts and feed them token by token (a zero-token push
    feeds every prompt but its last token, which the first decode step
    feeds): (sids, seconds of the feed)."""
    sids = [srv.open_session(p) for p in prompts]
    sync(dev)
    t0 = time.perf_counter()
    srv.push({s: 0 for s in sids})
    sync(dev)
    return sids, time.perf_counter() - t0


def rec_columns(srv, sids) -> list:
    """Every session's cache column as host bits: recurrent leaves whole,
    KV rows [0, steps)."""
    return lm_kv(srv, sids)


def rec_step_bytes(bundle, params, svc, sids) -> dict:
    """The bytes a decode step must move: every baked weight once, each
    lane's recurrent leaves read and written, and the KV rows its
    attention reads (live rows; the full columns as the upper end)."""
    from repro_torch.utils.trees import tree_leaves

    w = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    rec = svc._park_fixed * svc.n_slots * 2
    live = sum(svc.sessions[s].steps for s in sids)
    kv = svc._park_per_pos * live
    kv_full = svc._park_per_pos * svc.n_slots * svc.seq_cap
    return {"weights": w, "recurrent_rw": rec, "kv_live": kv,
            "kv_full": kv_full,
            "lo_ms": (w + rec + kv) / PEAK_BYTES * 1e3,
            "hi_ms": (w + rec + kv_full) / PEAK_BYTES * 1e3}


def rec_chunk_report(bundle, params, prompts, dev, name) -> dict:
    """Reported, not gated: ``step_fn`` over the first 16 tokens of the 8
    prompts at once (the chunked WKV/SSD form) against 16 token-by-token
    ``decode_fn`` steps from the same empty cache: the last position's
    logits and every recurrent leaf, as a share of their scale.  The
    chunk form reassociates the recurrence, in the reference too."""
    import numpy as np
    import torch

    n = REC_PROMPT_LEN[0]
    toks = torch.from_numpy(np.stack([p[:n] for p in prompts])).to(dev)
    B = toks.shape[0]
    with torch.no_grad():
        lg_c, c_chunk = bundle.step_fn(
            params, bundle.empty_cache(B, REC_SEQ_CAP),
            {"tokens": toks, "pos": torch.zeros(B, dtype=torch.int32,
                                                device=dev)})
        cache = bundle.empty_cache(B, REC_SEQ_CAP)
        for j in range(n):
            lg_s, cache = bundle.decode_fn(
                params, cache, {"tokens": toks[:, j:j + 1],
                                "pos": torch.full((B,), j, dtype=torch.int32,
                                                  device=dev)})
    a, b = lg_c[:, -1].float(), lg_s.float()
    if not bool(torch.isfinite(lg_c).all() & torch.isfinite(b).all()):
        raise RuntimeError(f"{name}: non-finite step or decode logits")
    out = {"logits": float((a - b).abs().max()) / max(1.0, float(
        b.abs().max())),
           "argmax_equal": int((a.argmax(-1) == b.argmax(-1)).sum())}
    leaves = {}

    def walk(x, y, key=""):
        if isinstance(x, dict):
            for k in x:
                walk(x[k], y[k], f"{key}/{k}")
            return
        x, y = x.float(), y.float()
        leaves[key] = float((x - y).abs().max()) / max(
            1e-30, float(y.abs().max()))

    walk({k: v for k, v in c_chunk.items() if k != "attn"},
         {k: v for k, v in cache.items() if k != "attn"})
    out["leaves"] = leaves
    log(f"{name}: step_fn over {n} tokens x {B} lanes (chunked form) "
        f"against {n} decode steps (reported, not gated): last logits "
        f"{out['logits']:.3e} of their scale apart, argmax equal on "
        f"{out['argmax_equal']} of {B} lanes; recurrent leaves apart by "
        + ", ".join(f"{k} {v:.3e}" for k, v in leaves.items())
        + " of their scale")
    return out


def rec_spec(bundle, params, prompts, full, dev, name, smi, **kw) -> dict:
    """Scan-mode speculation (K=SPEC_K) through LMServer(speculative=...)
    over the 8 prompts, lane i drafting with the zoo's drafter i % 4
    (oracle, always-wrong, random, n-gram), device counters on; every
    session parked mid-draft (between two step calls): each stream
    equals plain decode's bit for bit and the device acceptance count
    the host's.  Returns acceptance and tokens/s."""
    zoo = spec_drafters(prompts, full, bundle.cfg.vocab_size)
    names = list(zoo)

    def mixed(hist, k):
        i = max((i for i, p in enumerate(prompts) if len(hist) >= len(p)
                 and (hist[:len(p)] == p).all()),
                key=lambda i: len(prompts[i]))
        return zoo[names[i % len(names)]](hist, k)

    lay = "paged" if kw.get("paged") else "dense"
    srv, sids, got, sec = spec_run(
        bundle, params, prompts, dev, REC_SPEC_GEN, mixed, park=True,
        seq_cap=REC_SEQ_CAP, device_counters=True, **kw)
    want = [f[:REC_SPEC_GEN] for f in full]
    if got != want:
        bad = [names[i % 4] for i, (g, w) in enumerate(zip(got, want))
               if g != w]
        raise RuntimeError(f"{name}: {lay} scan-mode speculation differs "
                           f"from plain decode (drafters {bad})")
    dev_acc = srv.metrics()["spec_device_accepted_total"][0]["value"]
    if dev_acc != srv.spec.accepted:
        raise RuntimeError(f"{name}: device acceptance {dev_acc} != host "
                           f"{srv.spec.accepted}")
    if kw.get("paged"):
        spec_blocks_trimmed(srv, sids, name)
    per = {names[i]: sum(srv.spec.accepts.get(s, 0) for j, s in
                         enumerate(sids) if j % 4 == i) for i in range(4)}
    log(f"{name}: scan mode ({lay}), K={SPEC_K}, lanes drafting with the "
        f"oracle, always-wrong, random and n-gram drafters (two lanes "
        f"each), every session parked mid-draft: {len(sids)}x"
        f"{REC_SPEC_GEN} tokens bit-equal to plain decode; accepted "
        f"{per} of {srv.spec.drafted} drafted (device count {dev_acc:.0f}"
        f" == host); {srv.service.dispatches} dispatches, "
        f"{len(sids) * REC_SPEC_GEN / sec:,.1f} tokens/s (prompt feed "
        f"included) [{smi}]")
    out = {"acceptance": srv.spec.acceptance_rate, "per_drafter": per,
           "tps": len(sids) * REC_SPEC_GEN / sec}
    del srv
    return out


def phase_recurrent(cfg, dev, smi: str, seed: int = 22,
                    depth_note: str = "full depth") -> dict:
    """A recurrent LM (rwkv6-1.6b, or the zamba2-1.2b hybrid) served
    through LMServer on seeded random weights baked to bf16 (the baked
    tree's decode equal to the fp32 tree's per-use cast), 8 requests of
    REC_PROMPT_LEN tokens fed token by token, REC_GEN greedy tokens each.
    Bit for bit: t_chunk 16 == 1 (tokens and every cache leaf); a ragged
    dispatch (one lane masked) leaves the other lanes' bits as a full
    dispatch's and the masked lane's cache as it was; a second wave of 16
    sessions over the 8 slots (every session parks and resumes) against
    never-parked controls; two sessions spilled and restored into a fresh
    server against their never-spilled continuations; zamba paged
    (block_len 16) == dense, RWKV's paged=True server stays dense; scan
    speculation equal to plain decode (``rec_spec``), dense and (zamba)
    paged; parallel verify refused with ValueError.  Reported: the chunk
    form against the steps, ms per token at T=1 and in T=16 dispatches,
    launches and idle share of a step, prefill tokens/s, park bytes and
    the bytes bound of a step.  No port kernel launches."""
    import numpy as np
    import torch
    from repro_torch.models import build_bundle
    from repro_torch.models.params import param_count
    from repro_torch.models.transformer import bake_lm_params
    from repro_torch.serving import LMServer, ServeConfig
    from repro_torch.utils.trees import tree_leaves

    hybrid = cfg.family == "hybrid"
    name = f"recurrent {cfg.name} ({cfg.n_layers} layers, {depth_note})"
    bundle = build_bundle(cfg, dev)
    t0 = time.perf_counter()
    raw = bundle.init(torch.Generator(device=dev).manual_seed(seed))
    params = bake_lm_params(raw, cfg)
    sync(dev)
    w_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    log(f"{name}: {param_count(bundle.param_defs):,} params drawn on the "
        f"card and baked to {cfg.act_dtype} ({w_bytes / 1e9:.3f} GB; the "
        f"leaves cast to fp32 at use stay fp32) in "
        f"{time.perf_counter() - t0:.2f} s [{smi}]")
    rng = np.random.default_rng(seed)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (LM_SLOTS, 1))
                           .astype(np.int32)).to(dev)
    pos = torch.zeros(LM_SLOTS, dtype=torch.int32, device=dev)
    with torch.no_grad():
        la, ca = bundle.decode_fn(raw, bundle.empty_cache(LM_SLOTS, 32),
                                  {"tokens": tok, "pos": pos})
        lb, cb = bundle.decode_fn(params, bundle.empty_cache(LM_SLOTS, 32),
                                  {"tokens": tok, "pos": pos})
    if not torch.equal(la, lb) or not all(
            torch.equal(x, y) for x, y in zip(tree_leaves(ca),
                                              tree_leaves(cb))):
        raise RuntimeError(f"{name}: the baked tree's decode differs from "
                           "the per-use cast's")
    del raw, la, lb, ca, cb
    torch.cuda.empty_cache()

    prompts = rec_prompts(rng, LM_SLOTS, cfg.vocab_size)
    n_prefill = sum(len(p) - 1 for p in prompts)
    zero_launch_counts()
    dense = rec_server(bundle, params)
    svc = dense.service
    if svc.parallel_safe or svc.prefill_chunk:
        raise RuntimeError(f"{name}: a recurrent service must not chunk "
                           "its prefill")
    d_sids, d_s = rec_open(dense, prompts, dev)
    dense.step(REC_GEN)
    d_out = [list(dense.outputs[s]) for s in d_sids]  # copies: it goes on
    if any(len(o) != REC_GEN for o in d_out):
        raise RuntimeError(f"{name}: {[len(o) for o in d_out]} tokens")
    d_cols = rec_columns(dense, d_sids)
    log(f"{name}: prefill token by token, {n_prefill} prompt tokens (8 "
        f"prompts of {min(map(len, prompts))}-{max(map(len, prompts))}) "
        f"in {d_s * 1e3:.1f} ms = {n_prefill / d_s:,.1f} tokens/s "
        f"({svc.dispatches} dispatches so far) [{smi}]")
    # t_chunk = 1: the same tokens and cache bits
    one = rec_server(bundle, params, decode_chunk=1)
    o_sids, _ = rec_open(one, prompts, dev)
    one.step(REC_GEN)
    if [one.outputs[s] for s in o_sids] != d_out \
            or not same_kv(rec_columns(one, o_sids), d_cols):
        raise RuntimeError(f"{name}: t_chunk=1 differs from t_chunk=16")
    log(f"{name}: t_chunk=16 == t_chunk=1 bit for bit (tokens, every cache "
        f"leaf; {one.service.dispatches} vs {svc.dispatches} dispatches)")
    # a ragged dispatch: lane 0 masked on the t_chunk=1 twin, every lane
    # decoded on the dense server; the masked lane keeps its bits
    before = rec_columns(one, o_sids[:1])
    got = one.push({s: REC_EXTRA for s in o_sids[1:]})
    want = dense.push({s: REC_EXTRA for s in d_sids})
    if [got[s] for s in o_sids[1:]] != [want[s] for s in d_sids[1:]] \
            or not same_kv(rec_columns(one, o_sids[1:]),
                           rec_columns(dense, d_sids[1:])) \
            or not same_kv(rec_columns(one, o_sids[:1]), before):
        raise RuntimeError(f"{name}: a masked lane perturbed its "
                           "neighbours or itself")
    log(f"{name}: ragged dispatch (lane 0 masked, {REC_EXTRA} tokens): "
        f"the 7 other lanes bit-equal to a full dispatch's, lane 0's "
        f"cache bit-frozen")
    del one
    # paging: zamba's KV pools beside dense Mamba leaves; RWKV stays dense
    paged = rec_server(bundle, params, paged=True, block_len=LM_BLOCK)
    if not hybrid:
        if paged.service.paged:
            raise RuntimeError(f"{name}: a paged=True RWKV server paged")
        log(f"{name}: paged=True server stayed dense (no sequence-axis "
            "leaf to page)")
    else:
        p_sids, _ = rec_open(paged, prompts, dev)
        paged.step(REC_GEN)
        if [paged.outputs[s] for s in p_sids] != d_out \
                or not same_kv(rec_columns(paged, p_sids), d_cols):
            raise RuntimeError(f"{name}: paged differs from dense")
        st = paged.stats()["paged"]
        log(f"{name}: paged == dense bit for bit ({REC_GEN} tokens x 8, "
            f"Mamba leaves and KV rows); pool blocks live "
            f"{st['blocks_live']}/{st['n_blocks']}")
    del paged
    # the second wave: 16 sessions over 8 slots, dense (and paged)
    second = rec_prompts(rng, LM_WAVE_SESSIONS - LM_SLOTS, cfg.vocab_size)
    ctl2 = rec_server(bundle, params)
    c2_sids, _ = rec_open(ctl2, second, dev)
    ctl2.step(REC_GEN)
    wave_want = d_out + [list(ctl2.outputs[s]) for s in c2_sids]
    spilled = None
    for pg in ((False, True) if hybrid else (False,)):
        kw = {"paged": True, "block_len": LM_BLOCK} if pg else {}
        srv = rec_server(bundle, params, max_sessions=LM_WAVE_SESSIONS, **kw)
        sids = [srv.open_session(p) for p in prompts + second]
        srv.step(REC_GEN // 2)
        srv.step(REC_GEN - REC_GEN // 2)
        ev = srv.stats()["evictions"]
        if [srv.outputs[s] for s in sids] != wave_want \
                or ev < LM_WAVE_SESSIONS:
            raise RuntimeError(f"{name}: the {'paged' if pg else 'dense'} "
                               f"wave differs from its controls ({ev} "
                               "evictions)")
        log(f"{name}: {'paged' if pg else 'dense'} wave of "
            f"{LM_WAVE_SESSIONS} sessions on {LM_SLOTS} slots: {ev} "
            f"evictions, every stream bit-equal to its never-parked "
            f"control; parked bytes {srv.stats()['parked_blob_bytes']:,}")
        if not pg:
            spilled = (srv, sids)
    # spill one session of each wave, restore into a fresh server
    srv, sids = spilled
    keep = [sids[0], sids[LM_SLOTS]]
    for s in sids:
        if s not in keep:
            srv.close(s)
    spill = ROOT / "build" / "rec_spill.npz"
    t0 = time.perf_counter()
    srv.service.spill_parking(str(spill), include_bound=True)
    t_spill = time.perf_counter() - t0
    del srv, spilled
    fresh = LMServer(bundle, params, ServeConfig(
        max_batch=LM_SLOTS, seq_cap=REC_SEQ_CAP, decode_chunk=LM_T_CHUNK,
        max_sessions=LM_WAVE_SESSIONS))
    restored = fresh.service.restore_parking(str(spill))
    size = spill.stat().st_size
    spill.unlink()
    cont = fresh.push({s: REC_EXTRA for s in restored})
    twin = ctl2.push({c2_sids[0]: REC_EXTRA})
    want = [dense.outputs[d_sids[0]][REC_GEN:REC_GEN + REC_EXTRA],
            twin[c2_sids[0]]]
    if [cont[s] for s in restored] != want:
        raise RuntimeError(f"{name}: restored sessions differ from their "
                           "never-spilled continuations")
    log(f"{name}: spilled 2 sessions ({size:,} bytes, {t_spill:.2f} s), "
        f"restored, {REC_EXTRA} more tokens each bit-equal to the "
        "never-spilled continuations")
    del fresh, ctl2
    # every logit finite: each prompt's prefill (the chunked form) and a
    # decode step
    with torch.no_grad():
        for p in prompts:
            lg, _ = bundle.prefill_fn(params, {"tokens": torch.from_numpy(
                p[None]).to(dev)})
            if not bool(torch.isfinite(lg).all()):
                raise RuntimeError(f"{name}: non-finite prefill logits")
    chunk = rec_chunk_report(bundle, params, prompts, dev, name)
    # speculation: scan mode equal to plain decode, dense and paged;
    # parallel mode refused
    spec = {"dense": rec_spec(bundle, params, prompts, d_out, dev, name,
                              smi)}
    if hybrid:
        spec["paged"] = rec_spec(bundle, params, prompts, d_out, dev, name,
                                 smi, paged=True, block_len=LM_BLOCK)
    try:
        rec_server(bundle, params, speculative=SPEC_K,
                   spec_verify="parallel")
    except ValueError as e:
        log(f"{name}: verify='parallel' refused: {e}")
    else:
        raise RuntimeError(f"{name}: parallel verify was not refused")
    # timings on the dense server (8 lanes at their positions)
    one_tok = lambda: dense.push({s: 1 for s in d_sids})
    chunk16 = lambda: dense.push({s: LM_T_CHUNK for s in d_sids})
    ms1 = time_ms(one_tok, dev, n=REC_TIMED)
    ms16 = time_ms(chunk16, dev, n=2, warmup=1) / LM_T_CHUNK
    prof = profile_tick(one_tok, ticks=5, name=f"{name} decode step")
    sb = rec_step_bytes(bundle, params, svc, d_sids)
    fixed, per_tok = svc._park_fixed, svc._park_per_pos
    log(f"{name}: decode p50 {ms1:.3f} ms per token (T=1 dispatch of 8 "
        f"lanes, {REC_TIMED} timed), {ms16:.3f} ms per token in "
        f"T={LM_T_CHUNK} dispatches; {prof['launches']:.0f} launches and "
        f"idle share {1 - prof['busy_ms'] / prof['wall_ms']:.4f} a step; "
        f"park bytes a session {fixed:,} fixed + {per_tok:,} a token; "
        f"bytes bound of a step {sb['lo_ms']:.4f} ms (weights "
        f"{sb['weights'] / 1e9:.3f} GB + recurrent state read and written "
        f"{sb['recurrent_rw'] / 1e6:.1f} MB + live KV rows "
        f"{sb['kv_live'] / 1e6:.2f} MB) to {sb['hi_ms']:.4f} ms (+ the "
        f"full {REC_SEQ_CAP}-row KV columns) at 3.35 TB/s [{smi}]")
    counts = lm_launch_counts()
    if any(counts.values()):
        raise RuntimeError(f"{name}: the recurrent path launched a port "
                           f"kernel {counts}; it should reach none")
    log(f"{name}: launches of the four port kernels on this path: {counts}")
    del dense
    torch.cuda.empty_cache()
    return {"prefill_tps": n_prefill / d_s, "ms_per_token": ms1,
            "ms_per_token_t16": ms16, "launches": prof["launches"],
            "idle": 1 - prof["busy_ms"] / prof["wall_ms"],
            "park_fixed": fixed, "park_per_token": per_tok,
            "bound_ms": (sb["lo_ms"], sb["hi_ms"]), "chunk": chunk,
            "spec": spec}


# ---------------------------------------------------------------------------
# phases: encdec and vlm (the front-end families through their bundles,
# LMServer and few-shot enrollment)
# ---------------------------------------------------------------------------

FE_GEN, FE_WAYS = 32, 5


def fe_front(cfg, rng, B: int, dev):
    """The front end's seeded embeddings on the card in the activation
    dtype (the reference's stubs): ("frames", (B, ENCDEC_ENC_LEN, D)) or
    ("patches", (B, n_patches, D)), unit variance."""
    import torch
    from repro_torch.configs import ENCDEC_ENC_LEN

    from repro_torch.models.transformer import act_dtype

    key, n = ("patches", cfg.n_patches) if cfg.family == "vlm" \
        else ("frames", ENCDEC_ENC_LEN)
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    x = torch.randn((B, n, cfg.d_model), generator=g, device=dev)
    return key, x.to(act_dtype(cfg))


def fe_step_weights(params) -> int:
    """Bytes of the baked weights a decode step reads: the decoder layers,
    the final norm and the LM head (the encoder and the embedding table,
    of which a step reads one row a lane, excluded)."""
    from repro_torch.utils.trees import tree_leaves

    return sum(t.numel() * t.element_size()
               for k in ("layers", "final_norm", "lm_head")
               for t in tree_leaves(params.get(k)))


def fe_grow(cache, rows: int, extra: int):
    """The cache's sequence-axis leaves (those ``rows`` long on axis 2)
    grown by ``extra`` zero rows; the cross leaves as they are."""
    import torch
    from repro_torch.utils.trees import tree_map

    return tree_map(lambda a: torch.nn.functional.pad(
        a, (0, 0, 0, 0, 0, extra)) if a.shape[2] == rows else a, cache)


def fe_inputs(cfg, rng, dev) -> dict:
    """The bundle drive's inputs: 8 prompts of 16-48 tokens, right-padded
    with seeded tokens to the longest (S), behind the front end's seeded
    embeddings (4,096 frames or 1,024 patches a lane)."""
    import numpy as np
    import torch

    lo, hi = REC_PROMPT_LEN
    lens = rng.integers(lo, hi + 1, LM_SLOTS)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (LM_SLOTS, int(lens.max()))).astype(np.int32))
    key, emb = fe_front(cfg, rng, LM_SLOTS, dev)
    return {"key": key, "emb": emb, "toks": toks.to(dev), "lens": lens,
            "P": emb.shape[1] if cfg.family == "vlm" else 0}


def fe_contract(bundle, params, inp) -> dict:
    """The reference's cache contract (tests/test_archs_smoke.py:46):
    prefill(tokens[:S]) last logits against prefill(tokens[:S-1]) and one
    ``decode_fn`` step at the position after it (vlm: counting the
    patches).  Returns the max |gap|, the logits' scale (max(1, max
    |logit|)), whether every logit is finite and whether the reference's
    rtol 3e-2 / atol 3e-2 holds."""
    import torch
    from repro_torch.models.transformer import act_dtype

    key, toks, P = inp["key"], inp["toks"], inp["P"]
    emb = inp["emb"].to(act_dtype(bundle.cfg))
    S = toks.shape[1]
    with torch.no_grad():
        full, _ = bundle.prefill_fn(params, {key: emb, "tokens": toks})
        _, short = bundle.prefill_fn(params, {key: emb,
                                              "tokens": toks[:, :-1]})
        step, _ = bundle.decode_fn(params, fe_grow(short, P + S - 1, 1), {
            "tokens": toks[:, -1:], "pos": P + S - 1})
    return {"gap": float((full - step).abs().max()),
            "scale": max(1.0, float(full.abs().max())),
            "finite": bool(torch.isfinite(full).all()
                           & torch.isfinite(step).all()),
            "held": bool(torch.allclose(full, step, rtol=3e-2, atol=3e-2))}


def fe_bundle(bundle, params, cfg, dev, inp, name, smi) -> dict:
    """The bundle's own entry points at 8 lanes (``fe_inputs``).  The
    cache contract (``fe_contract``) on the served bf16 tree, held at 5e-2
    of the logits' scale (the bf16 parity tolerance): a prefill's GEMMs
    run at another M than a decode step's and round otherwise in bf16,
    which 24 layers carry on (the reference's rtol/atol 3e-2 is held in
    fp32 by ``phase_frontend`` and reported here).  Then 32 greedy
    ``decode_fn`` steps of every lane from its own prompt end (per-lane
    positions; the padded rows are overwritten before any read) on the
    self cache grown to fit, every logit finite.  Reported: the encoder's
    ms (8 x 4,096 frames), the prefill's ms and positions/s, ms a decode
    step, launches and idle share of a step and its bytes bound."""
    import torch
    from repro_torch.models.transformer import run_encoder
    from repro_torch.utils.trees import tree_leaves

    key, emb, toks, lens, P = (inp[k] for k in ("key", "emb", "toks",
                                                "lens", "P"))
    S = toks.shape[1]
    batch = {key: emb, "tokens": toks}
    out = {}
    with torch.no_grad():
        if cfg.is_encdec:
            out["encoder_ms"] = time_ms(
                lambda: run_encoder(params, cfg, emb), dev, n=3, warmup=1)
        out["prefill_ms"] = time_ms(lambda: bundle.prefill_fn(params, batch),
                                    dev, n=3, warmup=1)
        _, cache = bundle.prefill_fn(params, batch)
    if cfg.is_encdec and cache["self"]["cross"]["k"].shape[2] \
            != emb.shape[1]:
        raise RuntimeError(f"{name}: the cross cache is not the frames' "
                           "length")
    c = fe_contract(bundle, params, inp)
    out["contract_bf16"] = c
    if not c["finite"] or c["gap"] > 5e-2 * c["scale"]:
        raise RuntimeError(f"{name}: bf16 prefill(tokens[:S]) differs from "
                           f"prefill(tokens[:S-1]) + decode beyond 5e-2 of "
                           f"the logits' scale ({c})")
    with torch.no_grad():
        cache = fe_grow(cache, P + S, FE_GEN)
        last = torch.from_numpy(lens - 1).to(dev)
        pos = (P + last).to(torch.int32)
        tok = toks[torch.arange(LM_SLOTS, device=dev), last][:, None]
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(FE_GEN):
            lg, cache = bundle.decode_fn(params, cache, {"tokens": tok,
                                                         "pos": pos})
            tok = torch.argmax(lg, dim=-1).to(torch.int32)[:, None]
            pos = pos + 1
            if not bool(torch.isfinite(lg).all()):
                raise RuntimeError(f"{name}: non-finite decode logits")
        sync(dev)
        out["decode_ms"] = (time.perf_counter() - t0) * 1e3 / FE_GEN
        one = lambda: bundle.decode_fn(params, cache, {"tokens": tok,
                                                       "pos": pos})
        prof = profile_tick(one, ticks=5, name=f"{name} bundle decode step")
    cross = sum(t.numel() * t.element_size() for t in tree_leaves(
        cache.get("self", {}).get("cross")))
    per_pos = sum(t[:, :1, :1].numel() * t.element_size()
                  for k, t in (cache.get("self") or cache["dense"]).items()
                  if k != "cross")
    live = int((pos.to(torch.int64) + 1).sum())
    w = fe_step_weights(params)
    bound_ms = (w + cross + per_pos * live) / PEAK_BYTES * 1e3
    n_pos = LM_SLOTS * (P + S)
    out.update(launches=prof["launches"],
               idle=1 - prof["busy_ms"] / prof["wall_ms"],
               busy_ms=prof["busy_ms"], bound_ms=bound_ms,
               prefill_pos_per_s=n_pos / out["prefill_ms"] * 1e3,
               step_weights=w, cross_bytes=cross)
    log(f"{name}: bundle serve, 8 lanes of {key} {tuple(emb.shape[1:])} "
        f"and prompts of {int(lens.min())}-{S} tokens: "
        + (f"encoder {out['encoder_ms']:.2f} ms (8 x {emb.shape[1]} "
           f"frames); " if cfg.is_encdec else "")
        + f"prefill {out['prefill_ms']:.2f} ms = "
        f"{out['prefill_pos_per_s']:,.0f} positions/s ({n_pos} positions); "
        f"bf16 prefill(tokens[:S]) vs prefill(tokens[:S-1]) + decode: max "
        f"|gap| {c['gap']:.4g} at a logit scale of {c['scale']:.4g} (within "
        f"5e-2 of it; the reference's rtol/atol 3e-2 "
        f"{'held' if c['held'] else 'not met'}); {FE_GEN} greedy "
        f"decode_fn steps {out['decode_ms']:.2f} ms each; a step "
        f"{prof['launches']:.0f} launches, busy {prof['busy_ms']:.3f} ms, "
        f"idle share {out['idle']:.4f}; bytes bound of a step "
        f"{bound_ms:.4f} ms (weights {w / 1e9:.3f} GB + cross K/V "
        f"{cross / 1e9:.3f} GB + {live} live self rows x {per_pos:,} B) at "
        f"3.35 TB/s [{smi}]")
    return out


def fe_column(srv, sid) -> dict:
    """A session's cache column, for comparing two servers bit for bit:
    the KV rows [0, steps) as host bits (gathered through the block table
    when paged), each leaf without a sequence axis (the seamless cross
    K/V, 403 MB a session at full size) as a copy on the card."""
    import numpy as np
    from repro_torch.sessions.state import gather_column, map_tree, \
        pack_column
    from repro_torch.utils.host import BF16_HOST

    svc = srv.service
    steps, slot = svc.sessions[sid].steps, svc.sched.slot_of[sid]
    row = svc._device_table()[slot][None] if svc.paged else None

    def leaf(a, bax, sax):
        if sax < 0:
            return a.select(bax, slot).clone()
        col = gather_column(a, row, bax) if svc.paged else a
        h = pack_column({"x": col}, {"x": bax}, 0 if svc.paged else slot,
                        trunc_axes={"x": sax}, trunc_len=steps)["x"]
        return h.view(np.uint16) if h.dtype == BF16_HOST else h

    return map_tree(leaf, svc.cache, svc._batch_axes, svc._seq_axes)


def fe_same(a: list, b: list) -> bool:
    """``fe_column``s of two servers' sessions equal bit for bit."""
    import numpy as np
    import torch
    from repro_torch.utils.trees import tree_leaves

    def eq(x, y):
        if isinstance(x, torch.Tensor):
            return torch.equal(x, y)
        return np.array_equal(x, y)

    return all(eq(x, y) for ta, tb in zip(a, b)
               for x, y in zip(tree_leaves(ta), tree_leaves(tb)))


def fe_serve(bundle, params, cfg, dev, rng, name, smi) -> dict:
    """LMServer(ServeConfig(max_batch=8, seq_cap=256)) over 8 token
    prompts of 16-48 tokens (no session entry point takes frames or
    patches: the seamless cross leaves stay zero, dense per slot, and its
    prompts go token by token), 32 greedy tokens each.  Bit for bit:
    t_chunk 16 == 1 and paged == dense (tokens and every cache leaf), a
    ragged dispatch, a second wave of 16 sessions over the 8 slots (dense
    and paged) against never-parked controls, two sessions spilled and
    restored against their never-spilled continuations; seamless: scan
    speculation (K=4, the drafter zoo: oracle, always-wrong, random,
    n-gram) equal to plain decode, parallel verify refused.  Reported:
    park bytes, ms a token, launches and idle share of a step, its bytes
    bound."""
    from repro_torch.serving import LMServer, ServeConfig

    prompts = rec_prompts(rng, LM_SLOTS, cfg.vocab_size)
    zero_launch_counts()
    dense = rec_server(bundle, params)
    svc = dense.service
    if svc.parallel_safe == cfg.is_encdec:
        raise RuntimeError(f"{name}: parallel_safe={svc.parallel_safe}")
    sync(dev)
    t0 = time.perf_counter()  # the prompt feed: prefill at open (vlm) or
    d_sids, _ = rec_open(dense, prompts, dev)  # token by token (encdec)
    d_s = time.perf_counter() - t0
    dense.step(FE_GEN)
    d_out = [list(dense.outputs[s]) for s in d_sids]
    if any(len(o) != FE_GEN for o in d_out):
        raise RuntimeError(f"{name}: {[len(o) for o in d_out]} tokens")
    d_cols = [fe_column(dense, s) for s in d_sids]
    n_prefill = sum(len(p) - 1 for p in prompts)
    one = rec_server(bundle, params, decode_chunk=1)
    o_sids, _ = rec_open(one, prompts, dev)
    one.step(FE_GEN)
    if [one.outputs[s] for s in o_sids] != d_out or not fe_same(
            [fe_column(one, s) for s in o_sids], d_cols):
        raise RuntimeError(f"{name}: t_chunk=1 differs from t_chunk=16")
    # a ragged dispatch: lane 0 masked on the t_chunk=1 twin
    before = [fe_column(one, o_sids[0])]
    got = one.push({s: REC_EXTRA for s in o_sids[1:]})
    want = dense.push({s: REC_EXTRA for s in d_sids})
    if [got[s] for s in o_sids[1:]] != [want[s] for s in d_sids[1:]] \
            or not fe_same([fe_column(one, s) for s in o_sids[1:]],
                           [fe_column(dense, s) for s in d_sids[1:]]) \
            or not fe_same([fe_column(one, o_sids[0])], before):
        raise RuntimeError(f"{name}: a masked lane perturbed its "
                           "neighbours or itself")
    del one, before
    paged = rec_server(bundle, params, paged=True, block_len=LM_BLOCK)
    p_sids, _ = rec_open(paged, prompts, dev)
    paged.step(FE_GEN)
    if not paged.service.paged or [paged.outputs[s] for s in p_sids] \
            != d_out or not fe_same([fe_column(paged, s) for s in p_sids],
                                    d_cols):
        raise RuntimeError(f"{name}: paged differs from dense")
    st = paged.stats()["paged"]
    del paged, d_cols
    log(f"{name}: LMServer, 8 prompts of {min(map(len, prompts))}-"
        f"{max(map(len, prompts))} tokens "
        f"({'token by token' if cfg.is_encdec else 'chunked prefill'}), "
        f"{FE_GEN} tokens each: t_chunk 16 == 1, paged == dense (pool "
        f"blocks live {st['blocks_live']}/{st['n_blocks']}) and a ragged "
        f"dispatch (lane 0 masked, its column frozen) bit for bit, tokens "
        f"and every cache leaf; prompt feed {d_s * 1e3:.1f} ms = "
        f"{n_prefill / d_s:,.1f} tokens/s [{smi}]")
    # the second wave: 16 sessions over the 8 slots, dense and paged
    second = rec_prompts(rng, LM_WAVE_SESSIONS - LM_SLOTS, cfg.vocab_size)
    ctl2 = rec_server(bundle, params)
    c2_sids, _ = rec_open(ctl2, second, dev)
    ctl2.step(FE_GEN)
    wave_want = d_out + [list(ctl2.outputs[s]) for s in c2_sids]
    spilled = None
    for pg in (False, True):
        kw = {"paged": True, "block_len": LM_BLOCK} if pg else {}
        srv = rec_server(bundle, params, max_sessions=LM_WAVE_SESSIONS, **kw)
        sids = [srv.open_session(p) for p in prompts + second]
        srv.step(FE_GEN // 2)
        srv.step(FE_GEN - FE_GEN // 2)
        ev = srv.stats()["evictions"]
        if [srv.outputs[s] for s in sids] != wave_want \
                or ev < LM_WAVE_SESSIONS:
            raise RuntimeError(f"{name}: the {'paged' if pg else 'dense'} "
                               f"wave differs from its controls ({ev} "
                               "evictions)")
        log(f"{name}: {'paged' if pg else 'dense'} wave of "
            f"{LM_WAVE_SESSIONS} sessions on {LM_SLOTS} slots: {ev} "
            f"evictions (park/resume), every stream bit-equal to its "
            f"never-parked control; parked bytes "
            f"{srv.stats()['parked_blob_bytes']:,}")
        if not pg:
            spilled = (srv, sids)
        else:
            del srv
    # spill two sessions (one of each wave), restore into a fresh server
    srv, sids = spilled
    keep = [sids[0], sids[LM_SLOTS]]
    for s in sids:
        if s not in keep:
            srv.close(s)
    spill = ROOT / "build" / "fe_spill.npz"
    t0 = time.perf_counter()
    srv.service.spill_parking(str(spill), include_bound=True)
    t_spill = time.perf_counter() - t0
    del srv, spilled
    fresh = LMServer(bundle, params, ServeConfig(
        max_batch=LM_SLOTS, seq_cap=REC_SEQ_CAP, decode_chunk=LM_T_CHUNK,
        prefill_chunk=LM_PREFILL_CHUNK, max_sessions=LM_WAVE_SESSIONS))
    t0 = time.perf_counter()
    restored = fresh.service.restore_parking(str(spill))
    t_restore = time.perf_counter() - t0
    size = spill.stat().st_size
    spill.unlink()
    cont = fresh.push({s: REC_EXTRA for s in restored})
    twin = ctl2.push({c2_sids[0]: REC_EXTRA})
    want = [dense.outputs[d_sids[0]][FE_GEN:FE_GEN + REC_EXTRA],
            twin[c2_sids[0]]]
    if [cont[s] for s in restored] != want:
        raise RuntimeError(f"{name}: restored sessions differ from their "
                           "never-spilled continuations")
    log(f"{name}: spilled 2 sessions ({size:,} bytes, {t_spill:.2f} s), "
        f"restored ({t_restore:.2f} s), {REC_EXTRA} more tokens each "
        "bit-equal to the never-spilled continuations")
    del fresh, ctl2
    out = {}
    if cfg.is_encdec:
        out["spec"] = rec_spec(bundle, params, prompts, d_out, dev, name,
                               smi)
        try:
            rec_server(bundle, params, speculative=SPEC_K,
                       spec_verify="parallel")
        except ValueError as e:
            log(f"{name}: verify='parallel' refused: {e}")
        else:
            raise RuntimeError(f"{name}: parallel verify was not refused")
    sids = [s for s in d_sids if not svc.sessions[s].done]
    one_tok = lambda: dense.push({s: 1 for s in sids})
    ms1 = time_ms(one_tok, dev, n=REC_TIMED)
    ms16 = time_ms(lambda: dense.push({s: LM_T_CHUNK for s in sids}), dev,
                   n=2, warmup=1) / LM_T_CHUNK
    prof = profile_tick(one_tok, ticks=5, name=f"{name} server decode step")
    fixed, per_tok = svc._park_fixed, svc._park_per_pos
    w = fe_step_weights(params)
    live = sum(svc.sessions[s].steps for s in sids)
    bound_ms = (w + fixed * LM_SLOTS + per_tok * live) / PEAK_BYTES * 1e3
    log(f"{name}: server decode p50 {ms1:.3f} ms per token (T=1 dispatch "
        f"of {len(sids)} lanes, {REC_TIMED} timed), {ms16:.3f} ms per token"
        f" in T={LM_T_CHUNK} dispatches; {prof['launches']:.0f} launches, "
        f"busy {prof['busy_ms']:.3f} ms, idle share "
        f"{1 - prof['busy_ms'] / prof['wall_ms']:.4f} a step; park bytes a "
        f"session {fixed:,} fixed + {per_tok:,} a token; bytes bound of a "
        f"step {bound_ms:.4f} ms (weights {w / 1e9:.3f} GB + fixed leaves "
        f"{fixed * LM_SLOTS / 1e9:.3f} GB + {live} live rows) at 3.35 TB/s "
        f"[{smi}]")
    counts = lm_launch_counts()
    if any(counts.values()):
        raise RuntimeError(f"{name}: the serving path launched a port "
                           f"kernel {counts}; it should reach none")
    del dense
    out.update(prefill_tps=n_prefill / d_s, ms_per_token=ms1,
               ms_per_token_t16=ms16, launches=prof["launches"],
               busy_ms=prof["busy_ms"],
               idle=1 - prof["busy_ms"] / prof["wall_ms"],
               park_fixed=fixed, park_per_token=per_tok, bound_ms=bound_ms)
    return out


def fe_fewshot(bundle, params, cfg, dev, rng, name, smi, floors) -> dict:
    """A 5-way 1-shot ``protonet.adapt`` over the bundle's ``embed_fn``
    (each shot: the front end's embeddings and 16 tokens; bf16 embeddings
    upcast to fp32, V = d_model), counters zeroed just before and read
    just after (one proto_extract launch); W/b against support_sums +
    pn_fc_from_sums at rtol 1e-5, atol 1e-6; the kernel against its plain
    version on the same embeddings, both entries, W bit for bit;
    proto_extract's two entries timed at this shape and adapt's device ops
    after the embedder counted (``time_proto_extract``)."""
    import numpy as np
    import torch
    from repro_torch.core import protonet
    from repro_torch.kernels.proto_extract import (
        proto_extract,
        proto_extract_labels,
    )
    from repro_torch.kernels.ref import proto_extract_ref

    key, emb_in = fe_front(cfg, rng, FE_WAYS, dev)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (FE_WAYS, 16))
                            .astype(np.int32)).to(dev)
    batch = {key: emb_in, "tokens": toks}
    labels = torch.from_numpy(rng.permutation(FE_WAYS).astype(np.int32)).to(
        dev)
    with torch.no_grad():
        zero_launch_counts()
        sync(dev)
        t0 = time.perf_counter()
        w, b = protonet.adapt(bundle.embed_fn, params, batch, labels,
                              FE_WAYS, 1)
        sync(dev)
        t_adapt = time.perf_counter() - t0
        counts = lm_launch_counts()
        emb = bundle.embed_fn(params, batch).to(torch.float32).contiguous()
    if counts["proto_extract"] != 1 or sum(counts.values()) != 1:
        raise RuntimeError(f"{name}: adapt launched {counts}")
    pw, pb = protonet.pn_fc_from_sums(
        protonet.support_sums(emb, labels, FE_WAYS), 1)
    err = max(allclose(f"{name} adapt W", w, pw, 1e-5, 1e-6),
              allclose(f"{name} adapt b", b, pb, 1e-5, 1e-6))
    onehot = (labels.long()[None, :] == torch.arange(
        FE_WAYS, device=dev)[:, None]).to(torch.float32)
    rw, rb = proto_extract_ref(emb, onehot, 1)
    for entry, (kern_w, kern_b) in (
            ("onehot", proto_extract(emb, onehot, 1)),
            ("labels", proto_extract_labels(emb, labels, FE_WAYS, 1))):
        if not torch.equal(kern_w, rw):
            raise RuntimeError(f"{name}: proto_extract's {entry} entry W "
                               "differs from its plain version")
        err = max(err, allclose(f"{name} proto_extract {entry} b", kern_b,
                                rb, 1e-5, 1e-6))
    t = time_proto_extract(emb, labels, onehot, 1, dev, floors, smi, name)
    log(f"{name}: 5-way 1-shot adapt over embed_fn ({key} + 16 tokens a "
        f"shot) in {t_adapt * 1e3:.1f} ms, 1 proto_extract launch, W/b "
        f"within rtol 1e-5 / atol 1e-6 of the plain version (max |err| "
        f"{err:.3g}); proto_extract at V={emb.shape[1]} timed above")
    return {"launches": counts["proto_extract"], "err": err, "timing": t}


def phase_frontend(cfg, dev, smi: str, floors: dict, seed: int = 24,
                   depth_note: str = "full depth") -> dict:
    """A front-end family at full width on seeded random weights drawn on
    the card and baked to bf16 (the baked decode equal to the fp32 tree's
    per-use cast): seamless-m4t-large-v2 (the encoder-decoder: 24 encoder
    and 24 decoder layers, d 1024, 16 heads x 64, ReLU MLP 8192, vocab
    256,206) or internvl2-76b (vlm: d 8192, GQA 64/8 with attn_kv_repeat,
    SwiGLU 28,672, vocab 128,256, 1,024 patches; its depth cut).  The
    bundle's entry points (``fe_bundle``), LMServer (``fe_serve``) and
    few-shot enrollment through ``embed_fn`` (``fe_fewshot``).  The cache
    contract is held in fp32 on the drawn tree first (``fe_contract``)."""
    import numpy as np
    import torch
    from repro_torch.models import build_bundle
    from repro_torch.models.params import param_count
    from repro_torch.models.transformer import bake_lm_params
    from repro_torch.utils.trees import tree_leaves

    name = f"{cfg.family} {cfg.name} ({cfg.n_layers} decoder layers, " \
        f"{depth_note})"
    bundle = build_bundle(cfg, dev)
    t0 = time.perf_counter()
    raw = bundle.init(torch.Generator(device=dev).manual_seed(seed))
    params = bake_lm_params(raw, cfg)
    sync(dev)
    w_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    log(f"{name}: {param_count(bundle.param_defs):,} params drawn on the "
        f"card and baked to {cfg.act_dtype} ({w_bytes / 1e9:.3f} GB) in "
        f"{time.perf_counter() - t0:.2f} s [{smi}]")
    rng = np.random.default_rng(seed)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (LM_SLOTS, 1))
                           .astype(np.int32)).to(dev)
    pos = torch.zeros(LM_SLOTS, dtype=torch.int32, device=dev)
    with torch.no_grad():
        la, _ = bundle.decode_fn(raw, bundle.empty_cache(LM_SLOTS, 32),
                                 {"tokens": tok, "pos": pos})
        lb, _ = bundle.decode_fn(params, bundle.empty_cache(LM_SLOTS, 32),
                                 {"tokens": tok, "pos": pos})
    if not torch.equal(la, lb):
        raise RuntimeError(f"{name}: the baked tree's decode differs from "
                           "the per-use cast's")
    del la, lb
    # the cache contract in fp32 on the drawn tree, the served dispatcher
    inp = fe_inputs(cfg, rng, dev)
    zero_launch_counts()
    c32 = fe_contract(build_bundle(cfg.replace(act_dtype="float32"), dev),
                      raw, inp)
    if not (c32["finite"] and c32["held"]):
        raise RuntimeError(f"{name}: fp32 prefill(tokens[:S]) differs from "
                           f"prefill(tokens[:S-1]) + decode ({c32})")
    log(f"{name}: fp32 (the drawn tree): prefill(tokens[:S]) vs "
        f"prefill(tokens[:S-1]) + decode, max |gap| {c32['gap']:.4g} at a "
        f"logit scale of {c32['scale']:.4g} (rtol 3e-2, atol 3e-2 held)")
    del raw
    torch.cuda.empty_cache()
    out = {"bundle": fe_bundle(bundle, params, cfg, dev, inp, name, smi)}
    out["bundle"]["contract_fp32"] = c32
    counts = lm_launch_counts()
    if any(counts.values()):
        raise RuntimeError(f"{name}: the bundle path launched a port kernel "
                           f"{counts}; it should reach none")
    torch.cuda.empty_cache()
    out["serve"] = fe_serve(bundle, params, cfg, dev, rng, name, smi)
    torch.cuda.empty_cache()
    out["fewshot"] = fe_fewshot(bundle, params, cfg, dev, rng, name, smi,
                                floors)
    del params
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the launch floor: device time of a kernel that does nothing
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase: lm_train
# ---------------------------------------------------------------------------

LMT_REPEAT = ("olmo-1b", "deepseek-v2-lite-16b", "rwkv6-1.6b", "zamba2-1.2b",
              "seamless-m4t-large-v2")
LMT_FAMILY_STEPS = 3
LMT_RESUME_STEPS, LMT_RESUME_KILL = 6, 3
LMT_COPY_STEPS, LMT_COPY_WINDOW = 60, 5
LMT_TINY = dict(n_layers=2, d_model=32, d_ff=64, vocab_size=128, head_dim=16)
LMT_BATCH, LMT_SEQ = 8, 512
LMT_WARMUP, LMT_TIMED, LMT_PROFILED = 2, 10, 3


def host_to(batch: dict, dev) -> dict:
    import torch

    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def lm_copy_data(vocab: int, batch: int, seq: int, dev, accum: int = 1):
    """``data.lm_batch`` by step on ``dev``, with a leading micro-batch
    axis of ``accum``."""
    from repro_torch.data import lm_batch

    def data(step):
        b = lm_batch(step, batch, seq, vocab)
        return host_to({k: v.reshape(accum, -1, seq) if accum > 1 else v
                        for k, v in b.items()}, dev)

    return data


def phase_lm_train(dev, smi: str, seed: int = 26) -> dict:
    """LM training on the card.  Every family at ``smoke()``: ``loss_fn``'s
    loss, metrics and gradients in fp32 (TF32 off) against the same call
    on the CPU (rtol 1e-4, atol 1e-5 x max(1, max|want|)), then three
    ``Trainer`` steps at the config's own activation dtype with a finite
    loss; a step twice bit for bit (olmo, deepseek, rwkv, zamba, seamless);
    olmo-1b's ``Trainer`` (grad_accum=2, int8_ef) killed after 3 of 6 steps
    and resumed, bit for bit; the copy task (``tests/test_trainer.py``'s
    tiny config, 60 AdamW 3e-3 steps on lm_batch(step, 8, 64): the last 5
    steps' mean loss at least 0.2 below the first 5's); then olmo-1b at
    full width and depth, remat on, lm_batch(step, 8, 512): step ms p50 of
    10 (CUDA events, after 2 warm-up steps), tokens/s, MFU and the
    hardware-FLOP share against the bf16 tensor-core peak, launches and
    idle share (3 profiled steps), peak memory, a finite loss at every
    step and the same bits for the same state and batch."""
    import shutil

    import numpy as np
    import torch
    from repro_torch.configs import ASSIGNED, get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.core.costmodel import H100_PEAK_FLOPS_BF16, model_flops
    from repro_torch.data import arch_batch
    from repro_torch.launch import analytic
    from repro_torch.models import build_bundle
    from repro_torch.training import (
        TrainConfig,
        Trainer,
        TrainState,
        make_train_step,
        value_and_grad,
    )
    from repro_torch.training.optim import adamw
    from repro_torch.utils.trees import tree_leaves

    out = {}
    zero_launch_counts()
    cpu = torch.device("cpu")

    # ---- every family at smoke(): the card against the CPU, 3 steps ----
    worst = 0.0
    for base in ASSIGNED:
        cfg = base.smoke().replace(act_dtype="float32")
        params = build_bundle(cfg, cpu).init(
            torch.Generator().manual_seed(seed))
        batch = arch_batch(cfg)
        want = value_and_grad(build_bundle(cfg, cpu).loss_fn, params,
                              host_to(batch, cpu))
        got = value_and_grad(build_bundle(cfg, dev).loss_fn,
                             _to(params, dev), host_to(batch, dev))
        pairs = [("loss", got[0], want[0])] \
            + [(k, got[1][k], want[1][k]) for k in sorted(want[1])] \
            + [(f"grad {i}", g, w) for i, (g, w) in enumerate(zip(
                tree_leaves(got[2]), tree_leaves(want[2])))]
        if set(got[1]) != set(want[1]):
            raise AssertionError(f"lm_train {base.name}: metrics "
                                 f"{sorted(got[1])} vs {sorted(want[1])}")
        for what, g, w in pairs:
            w = w.float()
            err = float((g.float().cpu() - w).abs().max())
            scale = max(1.0, float(w.abs().max()))
            if not torch.allclose(g.float().cpu(), w, rtol=1e-4,
                                  atol=1e-5 * scale):
                raise AssertionError(f"lm_train {base.name} fp32 card vs "
                                     f"CPU: {what} off by {err:.3g}")
            worst = max(worst, err / scale)
        cfg = base.smoke()
        b = build_bundle(cfg, dev)
        _, hist = Trainer(b.loss_fn, b.init(torch.Generator(
            device=dev).manual_seed(seed)), TrainConfig(
            steps=LMT_FAMILY_STEPS, log_every=1),
            lambda s, cfg=cfg: host_to(arch_batch(cfg, seed=s), dev),
            optimizer=adamw(1e-3)).run()
        losses = [h["loss"] for h in hist]
        if len(losses) != LMT_FAMILY_STEPS or not np.all(np.isfinite(losses)):
            raise AssertionError(f"lm_train {base.name}: losses {losses}")
        log(f"lm_train {base.name} smoke(): fp32 loss {float(want[0]):.6f}, "
            f"{len(pairs) - 1} metrics and gradient leaves on the card within"
            f" rtol 1e-4 / atol 1e-5 x scale of the CPU; {LMT_FAMILY_STEPS} "
            f"Trainer steps ({cfg.act_dtype}) loss "
            + ", ".join(f"{x:.4f}" for x in losses))
    out["worst_card_vs_cpu"] = worst

    # ---- a step twice, bit for bit ----
    for name in LMT_REPEAT:
        cfg = get_config(name).smoke()
        b = build_bundle(cfg, dev)
        params = b.init(torch.Generator(device=dev).manual_seed(seed))
        opt = adamw(1e-3)
        step = make_train_step(b.loss_fn, opt)
        state = TrainState(params, opt[0](params), {}, {},
                           torch.zeros((), dtype=torch.int32, device=dev))
        batch = host_to(arch_batch(cfg, B=4, S=64, seed=1), dev)
        if not tree_equal(list(step(state, batch)),
                          list(step(state, batch))):
            raise AssertionError(f"lm_train {name}: one step twice on the "
                                 "same state and batch gave other bits")
    log(f"lm_train: one step twice bit for bit (params, AdamW state, loss, "
        f"metrics) for {', '.join(LMT_REPEAT)}")

    # ---- kill and resume ----
    cfg = get_config("olmo-1b").smoke()
    b = build_bundle(cfg, dev)
    params = b.init(torch.Generator(device=dev).manual_seed(seed))

    def trainer(d):
        return Trainer(b.loss_fn, params, TrainConfig(
            steps=LMT_RESUME_STEPS, grad_accum=2, grad_compression="int8_ef",
            ckpt_dir=str(d), ckpt_every=2, log_every=1),
            lm_copy_data(cfg.vocab_size, 8, 64, dev, accum=2),
            optimizer=adamw(3e-3))

    ckpt = ROOT / "build" / "lm_train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    whole, hist = trainer(ckpt / "whole").run()
    trainer(ckpt / "killed").run(steps=LMT_RESUME_KILL)
    resumed = trainer(ckpt / "killed")
    at = resumed.maybe_resume()
    again, rest = resumed.run()
    shutil.rmtree(ckpt, ignore_errors=True)
    if at != LMT_RESUME_KILL or not tree_equal(whole, again) \
            or rest != hist[LMT_RESUME_KILL:]:
        raise AssertionError(f"lm_train: the killed Trainer resumed at {at}"
                             " and differs from the whole run")
    log(f"lm_train olmo-1b smoke() Trainer (grad_accum=2, int8_ef): "
        f"{LMT_RESUME_STEPS} steps, loss {hist[0]['loss']:.4f} -> "
        f"{hist[-1]['loss']:.4f}; killed after {LMT_RESUME_KILL}, resumed: "
        "params, AdamW and error-feedback state and logged metrics bit for "
        "bit equal")

    # ---- the copy task ----
    cfg = get_config("olmo-1b").smoke().replace(**LMT_TINY)
    b = build_bundle(cfg, dev)
    t0 = time.perf_counter()
    _, hist = Trainer(b.loss_fn, b.init(torch.Generator(
        device=dev).manual_seed(seed)), TrainConfig(
        steps=LMT_COPY_STEPS, log_every=1),
        lm_copy_data(cfg.vocab_size, 8, 64, dev),
        optimizer=adamw(3e-3)).run()
    first = float(np.mean([h["loss"] for h in hist[:LMT_COPY_WINDOW]]))
    last = float(np.mean([h["loss"] for h in hist[-LMT_COPY_WINDOW:]]))
    if not last < first - 0.2:
        raise AssertionError(f"lm_train copy task: {first:.4f} -> {last:.4f}")
    log(f"lm_train copy task (olmo-1b cut to {LMT_TINY}): "
        f"{LMT_COPY_STEPS} AdamW 3e-3 steps in "
        f"{time.perf_counter() - t0:.1f} s, mean loss of the first "
        f"{LMT_COPY_WINDOW} {first:.4f} -> last {LMT_COPY_WINDOW} "
        f"{last:.4f}")
    out["copy"] = (first, last)

    # ---- olmo-1b at full width and depth ----
    # what earlier phases left allocated, so the step's own peak shows
    base = torch.cuda.memory_allocated(dev)
    cfg = get_config("olmo-1b")
    b = build_bundle(cfg, dev)
    params = b.init(torch.Generator(device=dev).manual_seed(seed))
    opt = adamw(3e-4)
    step = make_train_step(b.loss_fn, opt)
    state = TrainState(params, opt[0](params), {}, {},
                       torch.zeros((), dtype=torch.int32, device=dev))
    del params
    # every step's batch on the card before the first step: a pageable
    # upload inside a step would wait there for the step before it
    data = lm_copy_data(cfg.vocab_size, LMT_BATCH, LMT_SEQ, dev)
    n_steps = LMT_WARMUP + LMT_TIMED + LMT_PROFILED + 1
    batches = [data(i) for i in range(n_steps)]
    counts = analytic.count_cell(cfg, b.param_defs, ShapeSpec(
        "lm_train", "train", LMT_SEQ, LMT_BATCH))
    tokens = LMT_BATCH * LMT_SEQ
    losses = []

    def run(i):
        nonlocal state
        state, m = step(state, batches[i])
        losses.append(m["loss"])
        return m

    for i in range(LMT_WARMUP):
        run(i)
    sync(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for i in range(LMT_WARMUP, LMT_WARMUP + LMT_TIMED):
        batch = batches[i]
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        state, m = step(state, batch)
        z.record()
        z.synchronize()
        losses.append(m["loss"])
        times.append(a.elapsed_time(z))
    peak = torch.cuda.max_memory_allocated(dev)
    # the same state and batch twice: the same bits
    one, two = step(state, batches[0])[1], step(state, batches[0])[1]
    if not tree_equal(one, two):
        raise AssertionError("lm_train olmo-1b: a full-width step twice on "
                             "the same state gave other bits")
    del one, two
    ticks = iter(range(LMT_WARMUP + LMT_TIMED, n_steps))
    prof = profile_tick(lambda: run(next(ticks)), ticks=LMT_PROFILED,
                        name="lm_train olmo-1b step")
    losses = [float(x) for x in losses]
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"lm_train olmo-1b: losses {losses}")
    ms = statistics.median(times)
    mf = model_flops(counts.n_params_active, tokens)
    out.update(step_ms=ms, tokens_per_s=tokens / ms * 1e3,
               mfu=mf / (ms / 1e3 * H100_PEAK_FLOPS_BF16),
               hw_share=counts.flops_global / (ms / 1e3
                                               * H100_PEAK_FLOPS_BF16),
               peak_gb=peak / 1e9, own_peak_gb=(peak - base) / 1e9,
               profile=prof,
               launches=lm_launch_counts())
    log(f"timing lm_train olmo-1b (full: {cfg.n_layers} layers, d "
        f"{cfg.d_model}, vocab {cfg.vocab_size}, {counts.n_params:,} params;"
        f" remat {cfg.remat_policy}, {cfg.act_dtype}; lm_batch {LMT_BATCH} x "
        f"{LMT_SEQ}; AdamW): step ms p50={ms:.2f} (of {LMT_TIMED}, CUDA "
        f"events; min {min(times):.2f}, max {max(times):.2f}) "
        f"tokens/s={out['tokens_per_s']:.0f} MFU={out['mfu']:.4f} "
        f"(6 N tokens = {mf:.4g} FLOP at 989 TFLOP/s bf16) "
        f"hardware_flop_share={out['hw_share']:.4f} (fwd x "
        f"{analytic._train_mult(cfg)} = {counts.flops_global:.4g} FLOP) "
        f"peak_memory_gb={out['peak_gb']:.2f} (the run's own "
        f"{out['own_peak_gb']:.2f} over {base / 1e9:.2f} GB left by earlier "
        f"phases) launches_per_step="
        f"{prof['launches']:.0f} idle_share="
        f"{1 - prof['busy_ms'] / prof['wall_ms']:.4f} (profiled; against "
        f"the unprofiled p50 {1 - prof['busy_ms'] / ms:.4f}); loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}, finite at every step; the "
        f"same state and batch twice give the same bits [{smi}]")
    if any(out["launches"].values()):
        raise AssertionError(f"lm_train launched a port kernel: "
                             f"{out['launches']}")
    return out


# ---------------------------------------------------------------------------
# mesh: the services over a device mesh, one NCCL rank per card
# ---------------------------------------------------------------------------

MESH_TIMEOUT = 600  # s: the join of the mesh phase's ranks
MESH_LM_LAYERS, MESH_LM_GEN, MESH_LM_SEQ = 2, 32, 256
MESH_TICK_ROUNDS = 4  # alternated timings of the mesh and the bare tick
MESH_SPEC_K, MESH_SPEC_GEN = 4, 16  # speculation over the mesh LM service
MESH_TRAIN_STEPS = 3  # olmo-1b at full width, params placed, vs unsharded
MESH_DECODE_LANES, MESH_DECODE_STEPS, MESH_DECODE_CAP = 8, 16, 64


def mesh_rows(tree, axes=None) -> set:
    """{(local extent, global extent, placements)} of a tree of DTensors
    along each leaf's sharded axis (axis 0 unless ``axes`` says)."""
    from repro_torch.utils.trees import tree_leaves

    leaves = tree_leaves(tree)
    axes = [0] * len(leaves) if axes is None else tree_leaves(axes)
    return {(a.to_local().shape[ax], a.shape[ax], repr(a.placements))
            for a, ax in zip(leaves, axes)}


def mesh_digest(outs: dict) -> str:
    """A digest of a drive's outputs (every rank's must be the same)."""
    import hashlib

    h = hashlib.sha256()
    for s in sorted(outs):
        for a in outs[s]:
            h.update(b"none" if a is None else a.tobytes())
    return h.hexdigest()


def mesh_tcn(rank, world, data, model, dev, seed) -> dict:
    """The serve phase's drive through StreamSessionService(mesh=) at the
    full chameleon-tcn width: 64 slots over ``data`` (64 / world a rank),
    counted; tcn_chunk at this rank's shape against its plain version;
    the bank over ``model``; t_chunk 1; park/resume across ranks; every
    rank's outputs the same; rank 0 holds them against the unsharded
    service and times the 64 x 16 tick through the mesh and bare."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels.ref import tcn_chunk_plain
    from repro_torch.kernels.tcn_block import tcn_block, tcn_chunk
    from repro_torch.sessions import StreamSessionService

    cfg = get_config("chameleon-tcn")
    rng = np.random.default_rng(seed)
    bundle, params, bn = make_model(cfg, dev, seed)
    audio = rng.normal(size=(N_SLOTS, STREAM_LEN, cfg.tcn_in_channels)
                       ).astype(np.float32)
    shots = rng.normal(size=(N_WAYS, K_SHOTS, STREAM_LEN,
                             cfg.tcn_in_channels)).astype(np.float32)
    schedule = make_schedule(rng, N_SLOTS, STREAM_LEN)
    per = N_SLOTS // world

    def service(mesh, t_chunk=T_CHUNK):
        return StreamSessionService(
            bundle, params, bn, n_slots=N_SLOTS, max_tenants=N_TENANTS,
            max_ways=8, t_chunk=t_chunk, fused=True, mesh=mesh)

    out = {"per_rank": per}
    # the kernel at the shape each rank's tick gives it
    g = torch.Generator(device=dev).manual_seed(seed + rank)
    for T in CHUNK_TS:
        for quantize in (False, True):
            blocks, grid, x, lengths = chunk_inputs(g, cfg, per, T, False,
                                                    dev)
            kw = dict(k=cfg.tcn_kernel, act_scale=cfg.act_scale,
                      quantize=quantize)
            want, hr = tcn_chunk_plain(blocks, grid, x, lengths, **kw)
            got, h = tcn_chunk(blocks, grid, x, lengths, inplace=True, **kw)
            sync(dev)
            if not (torch.equal(h, hr) and same_grid(got, want)):
                raise AssertionError(f"mesh rank {rank}: tcn_chunk S={per} "
                                     f"T={T} quantize={quantize} differs "
                                     "from the plain version")
    svc = service(data)
    tcn_block.launches = tcn_chunk.launches = 0
    with counting(ref, PLAIN_CHUNK) as plain:
        main, polls = drive(svc, audio, schedule, shots)
    chunk, strip = check_drive_launches(f"mesh rank {rank}", svc, cfg,
                                        plain.calls)
    out["launches"] = chunk + strip
    out["ticks"] = svc.dispatches
    rows = mesh_rows(svc.states)
    # sharded on every world size: a world of one runs the same gathers
    if rows != {(per, N_SLOTS, repr(svc.states["t"].placements))} or \
            "Shard(dim=0)" not in next(iter(rows))[2]:
        raise AssertionError(f"mesh rank {rank}: grid rows {rows}")
    if any(p["steps"] != STREAM_LEN for p in polls) or \
            polls[0]["n_ways"] != N_WAYS:
        raise AssertionError(f"mesh rank {rank}: steps or ways lost")
    digest = mesh_digest(main)
    if world > 1:  # the bank over model: 8 / world tenants a rank
        bsvc = service(model)
        banked, _ = drive(bsvc, audio, schedule, shots)
        brows = mesh_rows(bsvc.bank)
        if {r[:2] for r in brows} != {(N_TENANTS // world, N_TENANTS)}:
            raise AssertionError(f"mesh rank {rank}: bank rows {brows}")
        if not same_outputs(main, banked):
            raise AssertionError(f"mesh rank {rank}: the bank over model "
                                 "changed the outputs")
    one, _ = drive(service(data, 1), audio, schedule, shots)
    if not same_outputs(main, one):
        raise AssertionError(f"mesh rank {rank}: t_chunk {T_CHUNK} and 1 "
                             "differ")
    psvc = service(data)
    moves = {}  # sid -> [owner rank of its park slot, of its resume slot]
    pack, unpack = psvc._pack, psvc._unpack

    def rec_pack(slot, sid):
        moves.setdefault(sid, [slot // per, None])
        return pack(slot, sid)

    def rec_unpack(slot, blob):
        m = moves.get(psvc.sched.sid_of[slot])
        if m is not None:
            m[1] = slot // per
        return unpack(slot, blob)

    psvc._pack, psvc._unpack = rec_pack, rec_unpack
    parked, _ = drive(psvc, audio, schedule, shots, park_every=4)
    if not same_outputs(main, parked):
        raise AssertionError(f"mesh rank {rank}: park/resume changed the "
                             "outputs")
    out["evictions"] = psvc.evictions
    out["cross_rank_resumes"] = sum(1 for a, b in moves.values()
                                    if b is not None and a != b)
    if len(schedule) >= 4 and (not psvc.evictions or (
            world > 1 and not out["cross_rank_resumes"])):
        raise AssertionError(f"mesh rank {rank}: no session resumed in "
                             "another slot (rank)")
    digests = [None] * world
    dist.all_gather_object(digests, digest)
    if len(set(digests)) != 1:
        raise AssertionError(f"mesh: ranks returned different outputs "
                             f"{digests}")
    if rank == 0:  # the unsharded service on rank 0's card
        bare = service(None)
        want, _ = drive(bare, audio, schedule, shots)
        if not same_outputs(main, want):
            raise AssertionError("mesh: the sharded service differs from "
                                 "the unsharded one")
        sids = [bare.open_session() for _ in range(N_SLOTS)]
        xb = {sid: audio[i, :T_CHUNK] for i, sid in enumerate(sids)}
    sids = [svc.open_session() for _ in range(N_SLOTS)]
    x = {sid: audio[i, :T_CHUNK] for i, sid in enumerate(sids)}
    tcn_block.launches = tcn_chunk.launches = 0
    svc.push_audio(x)
    if (tcn_chunk.launches, tcn_block.launches) != (1, 0):
        raise AssertionError(f"mesh rank {rank}: a tick launched tcn_chunk "
                             f"{tcn_chunk.launches} times")
    # mesh and bare ticks alternated (every rank times the mesh's; the
    # others wait in its first collective while rank 0 times the bare)
    mesh_ms, bare_ms = [], []
    for _ in range(MESH_TICK_ROUNDS):
        mesh_ms.append(time_ms(lambda: svc.push_audio(x), dev))
        if rank == 0:
            bare_ms.append(time_ms(lambda: bare.push_audio(xb), dev))
    out["tick_ms"] = statistics.median(mesh_ms)
    if rank == 0:
        out["bare_tick_ms"] = statistics.median(bare_ms)
    dist.barrier()
    return out


def mesh_lm(rank, world, data, dev, seed) -> dict:
    """olmo-1b at full width (MESH_LM_LAYERS of its 16 layers) through
    LMSessionService(mesh=): 8 lanes over ``data``, two waves of greedy
    tokens; the cache still sharded after them; rank 0 holds the tokens
    against the unsharded service bit for bit; paged=True refused."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.models import build_bundle
    from repro_torch.sessions import LMSessionService
    from repro_torch.sessions.spec import SpeculativeDecoder, ngram_drafter

    cfg = get_config("olmo-1b").replace(n_layers=MESH_LM_LAYERS)
    bundle = build_bundle(cfg, dev)
    params = bundle.init(torch.Generator(device=dev).manual_seed(seed))
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(37, 120)))
               .astype(np.int32) for _ in range(LM_SLOTS)]

    def run(mesh):
        svc = LMSessionService(bundle, params, n_slots=LM_SLOTS,
                               seq_cap=MESH_LM_SEQ, t_chunk=LM_T_CHUNK,
                               mesh=mesh)
        sids = [svc.open_session(p) for p in prompts]
        waves = [svc.decode({s: MESH_LM_GEN // 2 for s in sids})
                 for _ in range(2)]
        return svc, [[w[s] for s in sids] for w in waves]

    svc, toks = run(data)
    rows = mesh_rows(svc.cache, svc._batch_axes)
    per = LM_SLOTS // world
    if {r[:2] for r in rows} != {(per, LM_SLOTS)}:
        raise AssertionError(f"mesh rank {rank}: LM cache rows {rows}")
    try:
        LMSessionService(bundle, params, n_slots=LM_SLOTS,
                         seq_cap=MESH_LM_SEQ, mesh=data, paged=True)
        raise AssertionError("mesh: paged=True with a mesh was accepted")
    except ValueError:
        pass
    every = [None] * world
    dist.all_gather_object(every, toks)
    if any(t != toks for t in every):
        raise AssertionError("mesh: ranks returned different LM tokens")
    out = {"lm_tokens": sum(len(t) for w in toks for t in w)}
    if rank == 0:
        _, want = run(None)
        if toks != want:
            raise AssertionError("mesh: the sharded LM service differs from "
                                 "the unsharded one")

    def speculate(mesh):
        s = svc if mesh is not None else run(None)[0]
        sp = SpeculativeDecoder(s, ngram_drafter(), k=MESH_SPEC_K,
                                verify="scan")
        sids = sorted(s.sessions)
        got = sp.decode({i: MESH_SPEC_GEN for i in sids})
        return [got[i] for i in sids], sp.accepted, sp.drafted

    spec = speculate(data)
    if spec != speculate(None):
        raise AssertionError("mesh: speculation over the mesh service "
                             "differs from the unsharded decoder's")
    out.update(spec_tokens=sum(len(t) for t in spec[0]),
               spec_accepted=spec[1], spec_drafted=spec[2])
    dist.barrier()
    return out


def mesh_placed(world, mesh, dev, seed) -> dict:
    """olmo-1b at full width and depth with its parameters placed on
    ``mesh``: the Trainer's step on params and AdamW state placed by
    param_pspecs / train_state_pspecs, the batch by batch_pspecs, under
    shard_ctx, against the unsharded step (the two runs one after the
    other, the first freed: a step peaks at ~46 GB); the launcher's
    ``--mesh 1x1`` against the same call without it; decode_fn on placed
    params and a placed cache against the replicated twin.  Bit for bit
    on a world of one; with more ranks the products run at other M, so
    the losses, params and logits are held at the LM train tolerance of
    PERF.md section 2 instead."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.specs import (
        batch_pspecs,
        cache_pspecs,
        named,
        place_tree,
        train_state_pspecs,
    )
    from repro_torch.models import build_bundle
    from repro_torch.sharding.ctx import shard_ctx
    from repro_torch.sharding.rules import (
        DEFAULT_RULES,
        param_pspecs,
        resolve_rules,
    )
    from repro_torch.training import TrainState, make_train_step
    from repro_torch.training.optim import adamw
    from repro_torch.utils.hlo import CollectiveRecorder, collective_bytes
    from repro_torch.utils.trees import tree_leaves

    exact = world == 1
    whole = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t

    def same(what, got, want) -> None:
        got, want = whole(got), whole(want)
        if exact and torch.equal(got, want):
            return
        scale = max(1.0, float(want.float().abs().max()))
        if exact or not torch.allclose(got.float(), want.float(),
                                       rtol=5e-2, atol=5e-2 * scale):
            err = float((got.float() - want.float()).abs().max())
            raise AssertionError(f"mesh placed olmo-1b: {what} differs from "
                                 f"the unsharded twin by {err:.3g}")

    cfg = get_config("olmo-1b")
    b = build_bundle(cfg, dev)
    pspecs = param_pspecs(b.param_defs, resolve_rules(DEFAULT_RULES, mesh),
                          mesh)
    opt = adamw(3e-4)
    step = make_train_step(b.loss_fn, opt)
    data = lm_copy_data(cfg.vocab_size, LMT_BATCH, LMT_SEQ, dev)
    batches = [data(i) for i in range(MESH_TRAIN_STEPS)]
    out = {}

    def train(placed: bool):
        params = b.init(torch.Generator(device=dev).manual_seed(seed))
        state = TrainState(params, opt[0](params), {}, {},
                           torch.zeros((), dtype=torch.int32, device=dev))
        del params
        ctx, bs = contextlib.nullcontext(), batches
        if placed:
            state = place_tree(named(mesh, train_state_pspecs(
                pspecs, state.opt_state)), state)
            bs = [place_tree(named(mesh, batch_pspecs(cfg, x, mesh)), x)
                  for x in batches]
            ctx = shard_ctx(mesh, DEFAULT_RULES)
        losses, times, rec = [], [], CollectiveRecorder()
        with ctx:
            for i, batch in enumerate(bs):
                a = torch.cuda.Event(enable_timing=True)
                z = torch.cuda.Event(enable_timing=True)
                with rec if i == 0 else contextlib.nullcontext():
                    a.record()
                    state, m = step(state, batch)
                    z.record()
                z.synchronize()
                losses.append(whole(m["loss"]).float().cpu())
                if i:  # the first step records the collectives
                    times.append(a.elapsed_time(z))
            # where the step's time goes: device busy against wall
            prof = profile_tick(lambda: step(state, bs[0]), ticks=1,
                                top=5, name="mesh " + ("placed" if placed
                                                       else "unsharded")
                                + " olmo-1b train step")
        return [whole(p) for p in tree_leaves(state.params)], losses, \
            statistics.median(times), collective_bytes(rec.records), prof

    t0 = time.perf_counter()
    want_p, want_l, plain_ms, _, plain_prof = train(False)
    torch.cuda.empty_cache()
    got_p, got_l, placed_ms, coll, placed_prof = train(True)
    for i, (g, w) in enumerate(zip(got_l, want_l)):
        same(f"step {i} loss", g, w)
    for i, (g, w) in enumerate(zip(got_p, want_p)):
        same(f"param {i} after {MESH_TRAIN_STEPS} steps", g, w)
    del got_p, want_p
    torch.cuda.empty_cache()
    out.update(train_s=time.perf_counter() - t0, placed_ms=placed_ms,
               plain_ms=plain_ms, collectives=coll, placed_prof=placed_prof,
               plain_prof=plain_prof,
               losses=[float(x) for x in got_l])

    # ---- the launcher, --mesh 1x1 against no mesh ----
    t0 = time.perf_counter()
    argv = ["--arch", "olmo-1b", "--steps", str(MESH_TRAIN_STEPS),
            "--batch", str(LMT_BATCH), "--seq", str(LMT_SEQ), "--device",
            dev.type]
    runs = []
    for extra in (["--mesh", f"{world}x1"], []):
        st, hist = launch_train.main(argv + extra)
        runs.append(([torch.tensor(h["loss"]) for h in hist],
                     [whole(p) for p in tree_leaves(st.params)]))
        del st
        torch.cuda.empty_cache()
    (mesh_l, mesh_p), (bare_l, bare_p) = runs
    for i, (g, w) in enumerate(zip(mesh_l, bare_l)):
        same(f"launcher logged loss {i}", g, w)
    for i, (g, w) in enumerate(zip(mesh_p, bare_p)):
        same(f"launcher param {i}", g, w)
    out.update(launch_s=time.perf_counter() - t0,
               launch_losses=[float(x) for x in mesh_l])
    del runs, mesh_p, bare_p
    torch.cuda.empty_cache()

    # ---- decode_fn on placed params and cache, against the replicated ----
    t0 = time.perf_counter()
    params = b.init(torch.Generator(device=dev).manual_seed(seed + 1))
    rng = np.random.default_rng(seed)
    first = torch.from_numpy(rng.integers(0, cfg.vocab_size, (
        MESH_DECODE_LANES, 1)).astype(np.int32)).to(dev)

    def decode(placed: bool):
        p, ctx = params, contextlib.nullcontext()
        cache = b.empty_cache(MESH_DECODE_LANES, MESH_DECODE_CAP)
        place = lambda specs, x: x
        if placed:
            place = lambda specs, x: place_tree(named(mesh, specs), x)
            p = place(pspecs, params)
            cache = place(cache_pspecs(cfg, cache, mesh), cache)
            ctx = shard_ctx(mesh, DEFAULT_RULES)
        tok, toks = first, []
        with ctx, torch.no_grad():
            for j in range(MESH_DECODE_STEPS):
                batch = {"tokens": tok,
                         "pos": torch.tensor(j, dtype=torch.int32,
                                             device=dev)}
                logits, cache = b.decode_fn(p, cache, place(
                    batch_pspecs(cfg, batch, mesh), batch))
                tok = whole(logits).argmax(-1).to(torch.int32)[:, None]
                toks.append(tok.cpu())
        return torch.cat(toks, 1), [whole(c) for c in tree_leaves(cache)]

    want_t, want_c = decode(False)
    got_t, got_c = decode(True)
    if not torch.equal(got_t, want_t):
        raise AssertionError("mesh placed olmo-1b decode: tokens differ "
                             "from the replicated twin's")
    for i, (g, w) in enumerate(zip(got_c, want_c)):
        same(f"decode cache leaf {i}", g, w)
    out.update(decode_s=time.perf_counter() - t0,
               decode_tokens=int(got_t.numel()))
    del params, got_c, want_c
    torch.cuda.empty_cache()
    dist.barrier()
    return out


def mesh_rank(rank: int, world: int, rdv: str, out: str, seed: int,
              device_type: str = "cuda") -> None:
    """One rank of the mesh phase: its own card and NCCL (gloo and the CPU
    when ``device_type`` is "cpu", for a rehearsal), the meshes (world, 1)
    and (1, world) over ("data", "model")."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = device_type == "cuda"
    if cuda:
        torch.cuda.set_device(rank)
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"file://{rdv}", rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=MESH_TIMEOUT))
    try:
        dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
        data = make_mesh((world, 1), ("data", "model"),
                         device_type=device_type)
        model = make_mesh((1, world), ("data", "model"),
                          device_type=device_type) if world > 1 else data
        t0 = time.perf_counter()
        res = mesh_tcn(rank, world, data, model, dev, seed)
        res["tcn_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res.update(mesh_lm(rank, world, data, dev, seed + 1))
        res["lm_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        zero_launch_counts()
        res["placed"] = mesh_placed(world, data, dev, seed + 2)
        res["placed"]["launches"] = lm_launch_counts()
        res["placed_s"] = time.perf_counter() - t0
        every = [None] * world
        dist.all_gather_object(every, res)
        if rank == 0:
            Path(out).write_text(json.dumps(every))
    finally:
        dist.destroy_process_group()


def phase_mesh(dev, smi: str, seed: int = 28) -> dict:
    """Spawn one NCCL rank per card this process sees (a world of one on
    one card runs the same code) and run ``mesh_rank`` in each; a rank
    that fails or outlives MESH_TIMEOUT fails the phase.  Returns the
    tcn_block launches of every rank's main drive."""
    import torch
    import torch.multiprocessing as mp

    world = torch.cuda.device_count()
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    rdv, out = build / "mesh_rdv", build / "mesh_result.json"
    for f in (rdv, out):
        f.unlink(missing_ok=True)
    torch.cuda.empty_cache()
    ctx = mp.start_processes(mesh_rank, args=(world, str(rdv), str(out),
                                              seed),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + MESH_TIMEOUT
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"mesh: {world} ranks still running after "
                                   f"{MESH_TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(10)
        rdv.unlink(missing_ok=True)
    ranks = json.loads(out.read_text())
    out.unlink()
    r0 = ranks[0]
    log(f"mesh_ranks {world}")
    log(f"mesh chameleon-tcn: {N_SLOTS} slots over data ({r0['per_rank']} a "
        f"rank), {N_SLOTS} ragged {STREAM_LEN}-sample streams in "
        f"{r0['ticks']} ticks, tcn_chunk on every rank's slots (launches "
        f"{[r['launches'] for r in ranks]} by rank, strip entry included), "
        f"bit for bit equal to the unsharded service, to t_chunk 1 and to "
        f"park/resume ({r0['evictions']} evictions, "
        f"{r0['cross_rank_resumes']} resumes on another rank)"
        + ("; the bank over model equal" if world > 1 else ""))
    log(f"mesh olmo-1b ({MESH_LM_LAYERS} of 16 layers, full width): "
        f"{LM_SLOTS} lanes over data, {r0['lm_tokens']} greedy tokens bit "
        "for bit equal to the unsharded service; the cache still sharded "
        "after the waves; paged=True refused")
    log(f"mesh speculation over the olmo-1b mesh service (scan, K="
        f"{MESH_SPEC_K}, n-gram): {r0['spec_tokens']} tokens, "
        f"{r0['spec_accepted']} of {r0['spec_drafted']} drafts accepted, "
        "bit for bit equal to the unsharded decoder's")
    pl = r0["placed"]
    log(f"mesh placed olmo-1b (full: 16 layers, d 2048, vocab 50,304; "
        f"params and AdamW state by param_pspecs / train_state_pspecs, "
        f"lm_batch {LMT_BATCH} x {LMT_SEQ} by batch_pspecs, shard_ctx): "
        f"{MESH_TRAIN_STEPS} steps, loss "
        + ", ".join(f"{x:.6f}" for x in pl["losses"])
        + ", every loss and param "
        + ("bit for bit" if world == 1 else "within the LM tolerance")
        + f" against the unsharded trainer's; launcher --mesh {world}x1 "
        f"losses " + ", ".join(f"{x:.6f}" for x in pl["launch_losses"])
        + " equal to the call without --mesh; decode_fn on placed params "
        f"and cache: {pl['decode_tokens']} greedy tokens at "
        f"{MESH_DECODE_LANES} lanes and every cache leaf equal to the "
        f"replicated twin's; port kernel launches {pl['launches']}; "
        f"one step's collectives {pl['collectives']['by_type']} "
        f"({pl['collectives']['count']} ops, "
        f"{pl['collectives']['total']} bytes); seconds: train "
        f"{pl['train_s']:.1f}, launcher {pl['launch_s']:.1f}, decode "
        f"{pl['decode_s']:.1f}")
    log(f"timing mesh placed olmo-1b train step (full width and depth, "
        f"{LMT_BATCH} x {LMT_SEQ}, AdamW; CUDA events, p50 of steps 2-"
        f"{MESH_TRAIN_STEPS}): placed ms={pl['placed_ms']:.2f}; unsharded "
        f"ms={pl['plain_ms']:.2f} [{smi}]")
    for tag in ("placed", "plain"):
        p = pl[f"{tag}_prof"]
        log(f"profile mesh {tag} olmo-1b train step (one profiled step): "
            f"wall_ms={p['wall_ms']:.2f} device_busy_ms={p['busy_ms']:.2f} "
            f"host_only_ms={p['wall_ms'] - p['busy_ms']:.2f} launches="
            f"{p['launches']:.0f} [{smi}]")
    if any(pl["launches"].values()):
        raise AssertionError(f"mesh placed olmo-1b launched a port kernel: "
                             f"{pl['launches']}")
    log(f"timing mesh tick ({N_SLOTS}x{T_CHUNK} samples, end to end, "
        f"{world} rank(s), median of {MESH_TICK_ROUNDS} medians alternated "
        f"with the bare service's): ms={r0['tick_ms']:.4f}; bare service "
        f"ms={r0['bare_tick_ms']:.4f} [{smi}]")
    return {"launches": sum(r["launches"] for r in ranks), "world": world,
            "tick_ms": r0["tick_ms"], "bare_tick_ms": r0["bare_tick_ms"],
            "placed_ms": pl["placed_ms"], "plain_ms": pl["plain_ms"],
            "placed_prof": pl["placed_prof"], "plain_prof": pl["plain_prof"],
            "placed_s": r0["placed_s"]}


EMPTY_KERNEL = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
__global__ void store_kernel(float* p) { *p = 1.0f; }
extern "C" int launch_empty(void* stream) {
  empty_kernel<<<1, 1, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
extern "C" int launch_store(void* p, void* stream) {
  store_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((float*)p);
  return (int)cudaGetLastError();
}
"""


def start_empty_build():
    """Start nvcc on an empty kernel (with the port's flags, beside the
    port's own builds); returns (library, process)."""
    from repro_torch.kernels import _build

    out = ROOT / "build" / "launch_floor"
    out.mkdir(parents=True, exist_ok=True)
    src, so = out / "empty.cu", out / "libempty.so"
    src.write_text(EMPTY_KERNEL)
    return so, subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def launch_floor(build, dev) -> dict:
    """Device ms per launch, timed as every kernel's ``ms`` is
    (``device_ms``: 20 launches captured in a CUDA graph), of the empty
    kernel ("empty": the launch floor) and of one thread storing one float
    ("store": the least a kernel that writes its output takes)."""
    import ctypes

    import torch

    so, proc = build
    text, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the empty kernel:\n{text}")
    lib = ctypes.CDLL(str(so))
    lib.launch_empty.argtypes = [ctypes.c_void_p]
    lib.launch_store.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.launch_empty.restype = lib.launch_store.restype = ctypes.c_int
    cell = torch.zeros(1, device=dev)

    def call(fn, *args):
        if fn(*args, torch.cuda.current_stream(dev).cuda_stream) != 0:
            raise RuntimeError(f"{fn.__name__} did not launch")

    floors = {"empty": device_ms(lambda: call(lib.launch_empty), dev),
              "store": device_ms(lambda: call(lib.launch_store,
                                              cell.data_ptr()), dev)}
    log(f"launch floor: an empty kernel (1 thread) takes device ms="
        f"{floors['empty']:.5f} a launch, one storing one float "
        f"{floors['store']:.5f}, timed as every kernel's ms (CUDA-graph "
        "replay)")
    return floors


# ---------------------------------------------------------------------------

def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--compare-with", type=Path, metavar="DIR",
                    help="another tree's csrc/ directory: time its "
                         "log2_matmul, dilated_conv and proto_extract "
                         "beside this tree's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi)  # the card's name and power limit, as nvidia-smi gives them
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    empty = start_empty_build()
    libs = _build.build_all()
    log(f"build: {len(libs)} kernel libraries in "
        f"{time.perf_counter() - t0:.1f} s into {_build.build_dir()}")
    for name, text in _build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    dev = torch.device("cuda")
    floors = launch_floor(empty, dev)
    cfg = get_config("chameleon-tcn")
    audio_cfg = get_config("chameleon-tcn-audio")
    kws_cfg = get_config("chameleon-tcn-kws")

    def phase(name, fn, *args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        log(f"phase {name}: {time.perf_counter() - t:.1f} s")
        return out

    errs = phase("kernels", phase_kernels, cfg, dev,
                 embed_s=(K_SHOTS, CL_SHOTS, N_WAYS * K_SHOTS))
    tb_time, pe_time = phase("timings", phase_timings, cfg, dev, floors,
                             smi)
    serve = phase("serve", phase_serve, cfg, dev)
    mesh = phase("mesh", phase_mesh, dev, smi)
    fsl = phase("fsl", phase_fsl, cfg, dev)
    train = phase("train", phase_train, cfg, dev)
    cl = phase("cl", phase_cl, cfg, dev)
    plane = phase("plane", phase_plane, cfg, dev)
    phase("spill", phase_spill, plane)
    kws_errs = phase("kws kernels", phase_kernels, kws_cfg, dev,
                     embed_t=KWS_WINDOW, ts=(1, 2, 4, 8, T_CHUNK, KWS_WINDOW))
    kws = phase("kws serve", phase_serve, kws_cfg, dev,
                stream_len=4 * KWS_WINDOW, shot_len=KWS_WINDOW,
                long_tick=False)
    kws_server = phase("kws server", phase_kws_server, kws_cfg, dev)
    examples = phase("examples", phase_examples, dev)
    op_errs = phase("ops", phase_ops, dev, audio_cfg, cfg)
    mm_time, conv_time = phase("ops timings", phase_ops_timings, dev,
                               audio_cfg)
    op_launches = phase("ops main path", phase_ops_main, dev, audio_cfg)
    audio_errs = phase("audio kernels", phase_kernels, audio_cfg, dev,
                       embed_t=AUDIO_LEN,
                       ts=(1, 2, 4, 8, T_CHUNK, AUDIO_LEN))
    phase("audio timings", phase_timings, audio_cfg, dev, floors, smi,
          embed_t=AUDIO_LEN)
    audio = phase("audio", phase_audio, audio_cfg, dev)
    phase("lm", phase_lm, get_config("olmo-1b"), dev, smi)
    phase("lm qwen", phase_lm, get_config("qwen2.5-32b").replace(
        n_layers=2), dev, smi, gen=16, wave=False,
        depth_note="depth cut to 2 of its 64 layers")
    deepseek = get_config("deepseek-v2-lite-16b").replace(n_layers=4)
    deepseek_note = "depth cut to 4 of its 27 layers: 1 dense + 3 MoE"
    phase("moe", phase_lm, deepseek, dev, smi, depth_note=deepseek_note)
    phase("moe moonshot", phase_lm, get_config(
        "moonshot-v1-16b-a3b").replace(n_layers=2), dev, smi, gen=16,
        wave=False, depth_note="depth cut to 2 of its 48 layers: 1 dense + "
        "1 MoE")
    phase("spec", phase_spec, get_config("olmo-1b"), dev, smi)
    phase("spec deepseek", phase_spec, deepseek, dev, smi,
          depth_note=deepseek_note)
    phase("recurrent", phase_recurrent, get_config("rwkv6-1.6b"), dev, smi)
    phase("recurrent zamba", phase_recurrent, get_config("zamba2-1.2b"),
          dev, smi)
    encdec = phase("encdec", phase_frontend,
                   get_config("seamless-m4t-large-v2"), dev, smi, floors)
    vlm = phase("vlm", phase_frontend, get_config("internvl2-76b").replace(
        n_layers=4), dev, smi, floors,
        depth_note="depth cut to 4 of its 80 layers")
    fewshot = [encdec["fewshot"], vlm["fewshot"]]
    phase("lm_train", phase_lm_train, dev, smi)
    if args.compare_with is not None:
        phase("compare", phase_compare, dev, audio_cfg, cfg,
              args.compare_with.resolve())
    kernels = [
        # launches of both entries (tcn_chunk and the strip entry); the
        # times are the serve tick's tcn_chunk launch
        {"name": "tcn_block", "route": "cuda",
         "source": "src/repro_torch/csrc/tcn_block.cu",
         "replaces": "src/repro/kernels/tcn_block.py:166",
         "launches": serve["launches"] + mesh["launches"]
         + sum(c[1] for c in fsl.values())
         + cl["launches"] + plane["launches"] + kws["launches"]
         + kws_server["launches"] + examples["launches"]
         + audio["launches"]
         + train["fsl_launches"][0] + train["serve_launches"],
         "max_abs_err": max(errs["tcn_block"], audio_errs["tcn_block"],
                            kws_errs["tcn_block"]),
         "bound_peak": PEAK_NAMES[PEAK_FP32_FLOPS], **tb_time},
        {"name": "proto_extract", "route": "cuda",
         "source": "src/repro_torch/csrc/proto_extract.cu",
         "replaces": "src/repro/kernels/proto_extract.py:31",
         "launches": sum(c[0] for c in fsl.values())
         + audio["proto_launches"] + train["fsl_launches"][1]
         + sum(f["launches"] for f in fewshot),
         "max_abs_err": max([errs["proto_extract"]]
                            + [f["err"] for f in fewshot]),
         # the label entry's times (adapt's launch) at N=5, Nk=25, V=64,
         # the one-hot entry's under "onehot"
         "bound_peak": PEAK_NAMES[PEAK_FP32_FLOPS], **pe_time,
         # the encdec and vlm phases' adapt over embed_fn (N=5, Nk=5)
         "at_lm_widths": [f["timing"] for f in fewshot]},
        {"name": "log2_matmul", "route": "cuda",
         "source": "src/repro_torch/csrc/log2_matmul.cu",
         "replaces": "src/repro/kernels/log2_matmul.py:43",
         "launches": op_launches["log2_matmul"],
         "max_abs_err": op_errs["log2_matmul"], **mm_time},
        {"name": "dilated_conv", "route": "cuda",
         "source": "src/repro_torch/csrc/dilated_conv.cu",
         "replaces": "src/repro/kernels/dilated_conv.py:35",
         "launches": op_launches["dilated_conv"],
         "max_abs_err": op_errs["dilated_conv"], **conv_time},
    ]
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
