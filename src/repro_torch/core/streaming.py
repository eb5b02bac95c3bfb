"""Ring-buffer streaming TCN execution — the paper's §III-B contribution.

The port of ``repro/core/streaming.py``: per conv layer only the last
(k-1)·d activations are kept, in a ring indexed by a step counter mod its
length, so a stream's whole state is O(receptive field).  State layout is
the reference's: ``{"t": int32, "blocks": {"b<i>": {"ring1": (…, n, Cin),
"ring2": (…, n, C)}}}``.

Two executors advance a stream:

  * the per-step path (``stream_step`` and its single-session and
    per-chunk wrappers), a Python loop over samples;
  * the fused chunk (``make_fused_chunk``), one ``tcn_block`` kernel call
    per block over a whole chunk, fed by the ring taps.

Both sum every conv in the kernels' fixed order (``kernels/ref.tap_sum``)
and apply the head and FC one time step at a time on (S, C) rows, so an
output never depends on the chunk length: on baked params the two
executors agree bit for bit, and a stream gives the same bits whatever
chunks it is pushed in.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.dispatch import require_device
from repro_torch.kernels.ref import expand_weight, tap_sum
from repro_torch.models.config import ArchConfig
from repro_torch.models.tcn import BN_EPS
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

def _gather_rows(a, idx):
    """a: (S, L, c); idx: (S, m) row indices -> (S, m, c)."""
    return torch.gather(a, 1, idx[:, :, None].expand(-1, -1, a.shape[2]))


def _ordered_history(ring, t):
    """Time-order one ring's circular layout.  ring: (S, n, c); t: (S,).
    Row i of the result is the sample at time t-n+i; rows not yet written
    read their zero init, which is exactly causal left-padding."""
    n = ring.shape[1]
    ar = torch.arange(n, device=ring.device)
    return _gather_rows(ring, torch.remainder(t.long()[:, None] + ar[None], n))


def _ring_advance(strip, t, lengths, n):
    """New circular ring contents after consuming ``lengths`` samples.
    strip: (S, n+T, c) time-ordered [history | chunk]; L=0 reproduces the
    old ring exactly (the inactive-slot freeze), with no branch."""
    ar = torch.arange(n, device=strip.device)[None]
    lengths = lengths.long()
    window = _gather_rows(strip, lengths[:, None] + ar)
    perm = torch.remainder(ar - (t.long() + lengths)[:, None], n)
    return _gather_rows(window, perm)


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
                     backend: str | None = None, device="cuda"):
    """Build the fused chunk executor (kernel backend resolved ONCE for
    ``device``).

    Returns ``fused_chunk(fused_params, states, x, lengths)`` advancing a
    slot grid over a chunk through kernels/tcn_block.py: ``states`` is
    the SoA grid (rings (S, n, c), t (S,)); x: (S, T, C_in); lengths:
    (S,) valid-prefix lengths.  Returns (new_states, embs (S, T, V),
    logits (S, T, n_classes)); outputs at positions >= lengths are
    meaningless and the state freezes there."""
    from repro_torch.kernels.tcn_block import make_block_fn

    block_fn = make_block_fn(backend or cfg.kernel_backend,
                             require_device(device))
    k = cfg.tcn_kernel
    qa = (lambda a: fake_quant_act_u4(a, cfg.act_scale)) if quantize \
        else (lambda a: a)

    def fused_chunk(fused_params, states, x, lengths):
        t = states["t"]
        lengths = lengths.to(t.dtype)
        new_blocks = {}
        h = x
        for i in range(len(cfg.tcn_channels)):
            name = f"b{i}"
            d = 2 ** i
            rings = states["blocks"][name]
            hist2 = _ordered_history(rings["ring2"], t)
            strip1 = torch.cat([_ordered_history(rings["ring1"], t), h], dim=1)
            h, mid = block_fn(strip1, hist2, fused_params["blocks"][name],
                              dilation=d, k=k, act_scale=cfg.act_scale,
                              quantize=quantize)
            strip2 = torch.cat([hist2, mid], dim=1)
            new_blocks[name] = {
                "ring1": _ring_advance(strip1, t, lengths,
                                       rings["ring1"].shape[1]),
                "ring2": _ring_advance(strip2, t, lengths,
                                       rings["ring2"].shape[1]),
            }
        emb, logits = _head_steps(h, expand_weight(fused_params["head_w"]),
                                 fused_params["head_b"],
                                 fused_params["fc"]["w"],
                                 fused_params["fc"]["b"], qa)
        return {"t": t + lengths, "blocks": new_blocks}, emb, logits

    return fused_chunk
