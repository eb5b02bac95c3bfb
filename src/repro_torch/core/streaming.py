"""Ring-buffer streaming TCN execution — the paper's §III-B contribution.

The port of ``repro/core/streaming.py``: per conv layer only the last
(k-1)·d activations are kept, in a ring indexed by a step counter mod its
length, so a stream's whole state is O(receptive field).  State layout is
the reference's: ``{"t": int32, "blocks": {"b<i>": {"ring1": (…, n, Cin),
"ring2": (…, n, C)}}}``.

Two executors advance a stream (a third serving mode, ``cone_eval``,
evaluates only the last step's dependency cone, with the Fig. 8(c)
accounting beside it):

  * the per-step path (``stream_step`` and its single-session and
    per-chunk wrappers), a Python loop over samples;
  * the fused chunk (``make_fused_chunk``): the whole TCN body over a
    chunk in one ``tcn_chunk`` kernel launch per span of at most
    ``max_chunk_len`` steps, which reads the ring taps in place and writes
    only the new ring rows.

Both sum every conv in the kernels' fixed order (``kernels/ref.tap_sum``)
and apply the head and FC one time step at a time on (S, C) rows, so an
output never depends on the chunk length: on baked params the two
executors agree bit for bit, and a stream gives the same bits whatever
chunks it is pushed in.

Ownership of the rings: every function here is functional, as in the
reference (a caller's state is never changed), except a fused chunk built
with ``inplace=True``, which writes the chunk's new ring rows and t into
the state it is given.  Only a caller that owns its grid asks for that
(``StreamSessionService``); it saves a pass over every ring per tick.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.dispatch import require_device
from repro_torch.kernels.ref import expand_weight, tap_sum
from repro_torch.models.config import ArchConfig
from repro_torch.models.tcn import BN_EPS
from repro_torch.obs.trace import Tracer
from repro_torch.quant.log2 import fake_quant_act_u4, fake_quant_log2


def ring_sizes(cfg: ArchConfig) -> dict:
    """Per-layer FIFO depths: (k-1)*d for each of the two convs per block."""
    k = cfg.tcn_kernel
    out = {}
    c_in = cfg.tcn_in_channels
    for i, c in enumerate(cfg.tcn_channels):
        d = 2 ** i
        out[f"b{i}"] = {"ring1": ((k - 1) * d, c_in), "ring2": ((k - 1) * d, c)}
        c_in = c
    return out


def stream_state_bytes(cfg: ArchConfig, bytes_per_act: float = 0.5) -> float:
    """Total streaming activation memory (the paper counts 4-bit = 0.5 B)."""
    return sum(n * c * bytes_per_act
               for b in ring_sizes(cfg).values() for (n, c) in b.values())


def stream_init(cfg: ArchConfig, batch: int, device="cuda") -> dict:
    """Batched stream state sharing one step counter."""
    dev = require_device(device)
    return {"t": torch.zeros((), dtype=torch.int32, device=dev),
            "blocks": {name: {ring: torch.zeros((batch, n, c), device=dev)
                              for ring, (n, c) in rs.items()}
                       for name, rs in ring_sizes(cfg).items()}}


def stream_init_single(cfg: ArchConfig, device="cuda") -> dict:
    """Single-session state with NO batch axis: rings (n, c), t ()."""
    dev = require_device(device)
    return {"t": torch.zeros((), dtype=torch.int32, device=dev),
            "blocks": {name: {ring: torch.zeros((n, c), device=dev)
                              for ring, (n, c) in rs.items()}
                       for name, rs in ring_sizes(cfg).items()}}


def _taps(ring, x_t, t, dilation: int, k: int):
    """The k conv taps for the current step, oldest (w[0]) to newest: ring
    rows at times t-(k-1-j)*d, then x_t itself.  t is () or (B,)."""
    B, n = ring.shape[0], ring.shape[1]
    rows = torch.arange(B, device=ring.device)
    taps = []
    for j in range(k - 1):
        idx = torch.remainder(t - (k - 1 - j) * dilation, n).long()
        taps.append(ring[rows, idx.expand(B)])
    taps.append(x_t)
    return taps


def _write(ring, x_t, t):
    B, n = ring.shape[0], ring.shape[1]
    out = ring.clone()
    out[torch.arange(B, device=ring.device),
        torch.remainder(t, n).long().expand(B)] = x_t
    return out


def _bn_inf(x, p, st, which):
    inv = torch.rsqrt(st[f"{which}_var"] + BN_EPS)
    return (x - st[f"{which}_mean"]) * inv * p[which]["scale"] \
        + p[which]["bias"]


def stream_step(params, bn_state, cfg: ArchConfig, state: dict, x_t, *,
                quantize: bool = False):
    """Advance the TCN one timestep.  x_t: (B, C_in); state["t"] is () or
    a per-row (B,) counter.  Returns (new_state, emb (B, V), logits)."""
    qw = fake_quant_log2 if quantize else (lambda w: w)
    qa = (lambda a: fake_quant_act_u4(a, cfg.act_scale)) if quantize \
        else (lambda a: a)
    t = state["t"]
    k = cfg.tcn_kernel
    new_blocks = {}
    h = x_t
    for i in range(len(cfg.tcn_channels)):
        name = f"b{i}"
        p = params["blocks"][name]
        st = bn_state[name]
        rings = state["blocks"][name]
        d = 2 ** i
        y = tap_sum(_taps(rings["ring1"], h, t, d, k), qw(p["conv1_w"])) \
            + p["conv1_b"]
        y = qa(torch.relu(_bn_inf(y, p, st, "bn1")))
        y2 = tap_sum(_taps(rings["ring2"], y, t, d, k), qw(p["conv2_w"])) \
            + p["conv2_b"]
        y2 = _bn_inf(y2, p, st, "bn2")
        if "down_w" in p:
            res = tap_sum([h], qw(p["down_w"])) + p["down_b"]
        else:
            res = h
        new_blocks[name] = {"ring1": _write(rings["ring1"], h, t),
                            "ring2": _write(rings["ring2"], y, t)}
        h = qa(torch.relu(y2 + res))
    emb = qa(torch.relu(h @ qw(params["head_w"]) + params["head_b"]))
    logits = emb @ params["fc"]["w"] + params["fc"]["b"]
    return {"t": t + 1, "blocks": new_blocks}, emb, logits


def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(tr[k] for tr in trees)) for k in trees[0]}
    return fn(*trees)


def stream_step_single(params, bn_state, cfg: ArchConfig, state: dict, x_t,
                       *, quantize: bool = False):
    """``stream_step`` for one session: x_t (C_in,), rings (n, c)."""
    st = {"t": state["t"], "blocks": _map(lambda a: a[None], state["blocks"])}
    new, emb, logits = stream_step(params, bn_state, cfg, st, x_t[None],
                                   quantize=quantize)
    return ({"t": new["t"], "blocks": _map(lambda a: a[0], new["blocks"])},
            emb[0], logits[0])


def stream_scan_single(params, bn_state, cfg: ArchConfig, state: dict,
                       x_chunk, valid, *, quantize: bool = False):
    """Advance one session over a time chunk.  x_chunk: (T, C_in); valid:
    (T,) bool — steps with valid=False leave the state unchanged (their
    outputs are computed but meaningless).  Returns (state, embs (T, V),
    logits (T, n_classes))."""
    embs, logits = [], []
    for i in range(x_chunk.shape[0]):
        stepped, e, lg = stream_step_single(params, bn_state, cfg, state,
                                            x_chunk[i], quantize=quantize)
        v = valid[i]
        state = _map(lambda n_, o: torch.where(v, n_, o), stepped, state)
        embs.append(e)
        logits.append(lg)
    return state, torch.stack(embs), torch.stack(logits)


# ---------------------------------------------------------------------------
# Fused chunk executor: whole-chunk block evaluation over ring-buffer taps
# ---------------------------------------------------------------------------

def _head_steps(h, head_w, head_b, fc_w, fc_b, qa):
    """Head and FC applied one time step at a time: h (S, T, C) -> (emb
    (S, T, V), logits (S, T, n)).  Every step is the same (S, C) product,
    so the bits of a step do not depend on the chunk length."""
    embs, logits = [], []
    for i in range(h.shape[1]):
        e = qa(torch.relu(h[:, i].contiguous() @ head_w + head_b))
        embs.append(e)
        logits.append(e @ fc_w + fc_b)
    return torch.stack(embs, dim=1), torch.stack(logits, dim=1)


def make_fused_chunk(cfg: ArchConfig, *, quantize: bool = False,
                     backend: str | None = None, device="cuda",
                     inplace: bool = False, tracer: Tracer | None = None):
    """Build the fused chunk executor (kernel backend resolved ONCE for
    ``device``).

    Returns ``fused_chunk(fused_params, states, x, lengths)`` advancing a
    slot grid over a chunk: ``states`` is the SoA grid (rings (S, n, c),
    t (S,)); x: (S, T, C_in); lengths: (S,) valid-prefix lengths.  Returns
    (new_states, embs (S, T, V), logits (S, T, n_classes)); outputs at
    positions >= lengths are meaningless and the state freezes there.

    The TCN body is ``kernels/tcn_block.tcn_chunk``: on CUDA tensors one
    kernel launch for all blocks, reading the rings in place; on CPU
    tensors its plain version (time-ordered strips through
    ``tcn_block_fused``, rings re-laid by ``_ring_advance``).  A chunk
    longer than the kernel's shared memory takes (``max_chunk_len``: 313
    steps at ``chameleon-tcn``'s widths, 222 at ``chameleon-tcn-audio``'s)
    is split, on either device, into consecutive spans of at most that
    length, each span's end state feeding the next; chunk-size invariance
    makes the split bit-exact.  So a 784-step tick makes ⌈784/313⌉ = 3
    ``tcn_chunk`` calls on the FSL preset and ⌈784/222⌉ = 4 on the audio
    preset.  By default the caller's ``states`` stay unchanged (the
    reference's functional contract: the first span works on copies of
    the rings, a full pass over them).  ``inplace=True`` is for a caller
    that owns the grid: the new rows are written into ``states``' own
    rings and t, nothing else moves, and ``states`` itself is
    returned.  ``tracer`` (obs/trace.py; none: a disabled one) times each
    call's ``tcn_chunk`` spans as a ``chunk`` span (args ``spans``, the
    kernel calls) and the head as a ``head`` span (``steps``)."""
    from repro_torch.kernels.tcn_block import make_chunk_fn, max_chunk_len

    chunk_fn = make_chunk_fn(backend or cfg.kernel_backend,
                             require_device(device))
    k = cfg.tcn_kernel
    span = max(1, max_chunk_len([(rs["ring1"][0], rs["ring1"][1],
                                  rs["ring2"][1],
                                  rs["ring1"][1] != rs["ring2"][1])
                                 for rs in ring_sizes(cfg).values()], k))
    qa = (lambda a: fake_quant_act_u4(a, cfg.act_scale)) if quantize \
        else (lambda a: a)
    tracer = Tracer() if tracer is None else tracer

    def fused_chunk(fused_params, states, x, lengths):
        lengths = lengths.to(states["t"].dtype)
        T = x.shape[1]
        hs = []
        with tracer.span("chunk", cat="tcn", spans=-(-T // span)):
            for a in range(0, T, span):
                b = min(a + span, T)
                if b - a < T:
                    xs = x[:, a:b].contiguous()
                    ls = (lengths - a).clamp(0, b - a)
                else:
                    xs, ls = x, lengths
                # after the first span the states are this call's own copies
                states, h = chunk_fn(fused_params["blocks"], states, xs, ls,
                                     k=k, act_scale=cfg.act_scale,
                                     quantize=quantize,
                                     inplace=inplace or a > 0)
                hs.append(h)
            h = hs[0] if len(hs) == 1 else torch.cat(hs, dim=1)
        with tracer.span("head", cat="tcn", steps=T):
            emb, logits = _head_steps(h, expand_weight(
                fused_params["head_w"]), fused_params["head_b"],
                fused_params["fc"]["w"], fused_params["fc"]["b"], qa)
        return states, emb, logits

    return fused_chunk


# ---------------------------------------------------------------------------
# Greedy dilation-aware execution (paper Fig. 8a/c)
#
# To emit only the FINAL timestep's embedding, a dilated TCN needs, at layer
# l, just the positions in the backward dependency cone — the dilation grid
# {T-1 - j*d_l}.  Deeper layers are evaluated exponentially more sparsely,
# the steady-state FIFO per conv is k-1 entries independent of dilation, and
# the total activation state is sum_l (k-1)*C ~ 2 kB for the raw-audio
# model.  Both serving modes give the full conv's outputs.
# ---------------------------------------------------------------------------

def _cone_positions(cfg: ArchConfig, T: int) -> list:
    """Needed positions per block, top down: a list of sorted int64 numpy
    arrays, index 0 = input positions, index nb = [T-1]."""
    k = cfg.tcn_kernel
    nb = len(cfg.tcn_channels)
    need = {nb: np.array([T - 1])}
    for b in range(nb - 1, -1, -1):
        d = 2 ** b
        # two stacked convs with the same dilation: offsets 0..2(k-1)d
        offs = np.arange(0, 2 * (k - 1) * d + 1, d)
        prev = (need[b + 1][:, None] - offs[None, :]).reshape(-1)
        need[b] = np.unique(prev[prev >= 0])
    return [need[b] for b in range(nb + 1)]


def _cone_taps(pos_set, source_pos, source_vals, d: int, k: int):
    """The k causal conv taps at ``pos_set`` (oldest first) read from values
    known at the sorted ``source_pos``; a position before 0 reads zero."""
    cols = []
    for j in range(k):
        q = pos_set - (k - 1 - j) * d
        i = np.minimum(np.searchsorted(source_pos, q), len(source_pos) - 1)
        hit = source_pos[i] == q
        rows = torch.from_numpy(np.where(hit, i, 0)).to(source_vals.device)
        mask = torch.from_numpy(hit.astype(np.float32)).to(source_vals.device)
        cols.append(source_vals[:, rows] * mask[None, :, None])
    return cols


def cone_eval(params, bn_state, cfg: ArchConfig, x, *, quantize: bool = False):
    """Greedy dilation-aware evaluation of the FINAL timestep's embedding:
    computes only the backward cone (paper Fig. 8a), as tensor ops on x's
    device.  x: (B, T, Cin).  Returns (embedding (B, V), logits (B, n),
    node evaluations)."""
    qw = fake_quant_log2 if quantize else (lambda w: w)
    qa = (lambda a: fake_quant_act_u4(a, cfg.act_scale)) if quantize \
        else (lambda a: a)
    T = x.shape[1]
    k = cfg.tcn_kernel
    need = _cone_positions(cfg, T)
    total_evals = 0
    # h holds block-b input values at positions need[b]
    h = x[:, torch.from_numpy(need[0]).to(x.device)]
    for b in range(len(cfg.tcn_channels)):
        d = 2 ** b
        p = params["blocks"][f"b{b}"]
        st = bn_state[f"b{b}"]
        pos_in, pos_out = need[b], need[b + 1]
        # conv1 at the mid grid: positions needed by conv2 of this block
        mid = np.unique((pos_out[:, None]
                         - np.arange(0, (k - 1) * d + 1, d)[None]).reshape(-1))
        mid = mid[mid >= 0]
        w1 = qw(p["conv1_w"])
        y1 = sum(c @ w1[j] for j, c in enumerate(
            _cone_taps(mid, pos_in, h, d, k))) + p["conv1_b"]
        y1 = qa(torch.relu(_bn_inf(y1, p, st, "bn1")))
        total_evals += len(mid)
        w2 = qw(p["conv2_w"])
        y2 = sum(c @ w2[j] for j, c in enumerate(
            _cone_taps(pos_out, mid, y1, d, k))) + p["conv2_b"]
        y2 = _bn_inf(y2, p, st, "bn2")
        total_evals += len(pos_out)
        # residual: block input at pos_out (a subset of pos_in)
        ridx = torch.from_numpy(np.searchsorted(pos_in, pos_out)).to(x.device)
        res_src = h[:, ridx]
        if "down_w" in p:
            res = res_src @ qw(p["down_w"])[0] + p["down_b"]
        else:
            res = res_src
        h = qa(torch.relu(y2 + res))
    feat = h[:, -1, :]
    emb = qa(torch.relu(feat @ qw(params["head_w"]) + params["head_b"]))
    logits = emb @ params["fc"]["w"] + params["fc"]["b"]
    return emb, logits, total_evals


def cone_stats(cfg: ArchConfig, seq_len: int) -> dict:
    """Steady-state greedy-execution accounting for a length-T window:
    per-conv FIFO depth k-1 (dilation-independent!), per-layer evaluations
    = T / dilation."""
    k = cfg.tcn_kernel
    acts = 0
    macs = 0
    c_in = cfg.tcn_in_channels
    for i, c in enumerate(cfg.tcn_channels):
        d = 2 ** i
        evals = max(seq_len // d, 1)
        macs += evals * k * (c_in * c + c * c)
        acts += (k - 1) * (c_in + c)  # two FIFOs per block
        c_in = c
    return {"act_entries": acts, "macs": macs}


def ws_inference_stats(cfg: ArchConfig, seq_len: int) -> dict:
    """Weight-stationary baseline accounting for the Fig. 8(c) comparison
    (paper: ~90x memory / ~10x compute at 16k steps): activation memory is a
    full-sequence buffer (WS requires pre-loading the sequence), and compute
    evaluates every layer densely at every timestep (no dilation-aware
    skipping of the unused cone complement)."""
    k = cfg.tcn_kernel
    cmax = max(max(cfg.tcn_channels), cfg.tcn_in_channels)
    acts = seq_len * cmax
    macs = 0
    c_in = cfg.tcn_in_channels
    for c in cfg.tcn_channels:
        macs += seq_len * k * (c_in * c + c * c)
        c_in = c
    return {"act_entries": acts, "macs": macs}


def greedy_inference_stats(cfg: ArchConfig, seq_len: int) -> dict:
    """Chameleon-style streaming accounting: FIFO state + dilation-aware
    compute (only real taps, no zero-padding work)."""
    k = cfg.tcn_kernel
    acts = sum(n * c for b in ring_sizes(cfg).values() for (n, c) in b.values())
    macs = 0
    c_in = cfg.tcn_in_channels
    for c in cfg.tcn_channels:
        macs += seq_len * k * (c_in * c + c * c)
        c_in = c
    return {"act_entries": acts, "macs": macs}
