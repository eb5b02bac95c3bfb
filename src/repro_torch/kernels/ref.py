"""Plain PyTorch versions of the port's kernels (the correctness contract).

``tcn_block``'s (``tcn_block_fused`` for the strip entry,
``tcn_chunk_plain`` for the chunk entry) and ``proto_extract``'s versions
(``proto_extract_ref``, and ``proto_extract_labels_ref`` for the label entry)
sum in the same fixed order as their CUDA kernels — taps j = 0..k-1
outside, input channels in order inside, a separately rounded multiply
and add per term (the kernels use ``__fmul_rn``/``__fadd_rn``, which the
compiler never contracts into an FMA).  So every output element depends
on its own inputs only, never on T or S: the chunk-size invariance and
park/resume exactness the service relies on hold on the CPU as they do
on the card.  ``log2_matmul_ref`` and ``dilated_conv_ref`` are the
reference's semantics as plain products (no invariant rests on their
bits), so their kernels are held to them with a tolerance.
"""

from __future__ import annotations

import torch

from repro_torch.quant.log2 import (
    dequantize_act_u4,
    dequantize_log2,
    quantize_act_u4,
    unpack_nibbles,
)


def expand_weight(w):
    """Nibble-packed log2 codes -> fp32 weights; fp32 tensors pass through."""
    if isinstance(w, dict):
        return dequantize_log2(unpack_nibbles(w["codes"]), w["scale"])
    return w


def qa_value(x: torch.Tensor, act_scale: float) -> torch.Tensor:
    """Value form of quant.log2.fake_quant_act_u4 (inference: no STE)."""
    xq = dequantize_act_u4(quantize_act_u4(x, act_scale), act_scale,
                           dtype=x.dtype)
    return x + (xq - x)


def tap_sum(taps, w: torch.Tensor) -> torch.Tensor:
    """sum_j taps[j] @ w[j] in the kernels' fixed order.

    taps: list of k tensors (..., Cin); w: (k, Cin, Cout).  Returns
    (..., Cout)."""
    acc = None
    for j, tp in enumerate(taps):
        for ci in range(w.shape[1]):
            term = tp[..., ci:ci + 1] * w[j, ci]
            acc = term if acc is None else acc + term
    return acc


def tcn_block_fused(strip1, hist2, p, *, dilation: int, k: int,
                    act_scale: float = 0.25, quantize: bool = False):
    """One fused TCN residual block over a chunk, batched over slots.

    strip1 (S, n+T, Cin) time-ordered [ring1 history | chunk]; hist2
    (S, n, C); p the baked block dict (fp32 or ``{"codes","scale"}``
    weights).  Returns (h (S, T, C), mid (S, T, C))."""
    d = dilation
    n = (k - 1) * d
    T = strip1.shape[1] - n
    qa = (lambda a: qa_value(a, act_scale)) if quantize else (lambda a: a)
    w1 = expand_weight(p["conv1_w"])
    y = tap_sum([strip1[:, j * d:j * d + T] for j in range(k)], w1)
    y = qa(torch.relu(y + p["conv1_b"]))
    strip2 = torch.cat([hist2, y], dim=1)
    w2 = expand_weight(p["conv2_w"])
    y2 = tap_sum([strip2[:, j * d:j * d + T] for j in range(k)], w2)
    y2 = y2 + p["conv2_b"]
    x_cur = strip1[:, n:]
    if "down_w" in p:
        res = tap_sum([x_cur], expand_weight(p["down_w"])) + p["down_b"]
    else:
        res = x_cur
    return qa(torch.relu(y2 + res)), y


def _gather_rows(a, idx):
    """a: (S, L, c); idx: (S, m) row indices -> (S, m, c)."""
    return torch.gather(a, 1, idx[:, :, None].expand(-1, -1, a.shape[2]))


def ordered_history(ring, t):
    """Time-order one ring's circular layout.  ring: (S, n, c); t: (S,).
    Row i of the result is the sample at time t-n+i; rows not yet written
    read their zero init, which is exactly causal left-padding."""
    n = ring.shape[1]
    ar = torch.arange(n, device=ring.device)
    return _gather_rows(ring, torch.remainder(t.long()[:, None] + ar[None], n))


def ring_advance(strip, t, lengths, n):
    """New circular ring contents after consuming ``lengths`` samples.
    strip: (S, n+T, c) time-ordered [history | chunk]; L=0 reproduces the
    old ring exactly (the inactive-slot freeze), with no branch."""
    ar = torch.arange(n, device=strip.device)[None]
    lengths = lengths.long()
    window = _gather_rows(strip, lengths[:, None] + ar)
    perm = torch.remainder(ar - (t.long() + lengths)[:, None], n)
    return _gather_rows(window, perm)


def tcn_chunk_plain(blocks, states, x, lengths, *, k: int,
                    act_scale: float = 0.25, quantize: bool = False,
                    inplace: bool = False):
    """The whole TCN body of a slot grid over one chunk: the chunk kernel's
    plain version.  blocks: {"b<i>": baked block params}; states: the grid
    ({"t": (S,) int32, "blocks": {"b<i>": {"ring1": (S, n, Cin), "ring2":
    (S, n, C)}}}, block i's dilation n/(k-1)); x (S, T, Cin); lengths (S,)
    valid-prefix lengths.  Each block time-orders its rings, runs
    ``tcn_block_fused`` over [history | chunk] and re-lays the rings.
    Returns (new_states, h (S, T, C)); ``inplace`` writes the new rings and
    t into ``states``' tensors and returns ``states``."""
    t = states["t"]
    lengths = lengths.to(t.dtype)
    new_blocks = {}
    h = x
    for i in range(len(states["blocks"])):
        name = f"b{i}"
        rings = states["blocks"][name]
        n = rings["ring1"].shape[1]
        hist2 = ordered_history(rings["ring2"], t)
        strip1 = torch.cat([ordered_history(rings["ring1"], t), h], dim=1)
        h, mid = tcn_block_fused(strip1, hist2, blocks[name],
                                 dilation=n // (k - 1), k=k,
                                 act_scale=act_scale, quantize=quantize)
        strip2 = torch.cat([hist2, mid], dim=1)
        new_blocks[name] = {"ring1": ring_advance(strip1, t, lengths, n),
                            "ring2": ring_advance(strip2, t, lengths, n)}
    if not inplace:
        return {"t": t + lengths, "blocks": new_blocks}, h
    t.add_(lengths)
    for name, rings in new_blocks.items():
        for r, v in rings.items():
            states["blocks"][name][r].copy_(v)
    return states, h


def tcn_block_ref(strip1, hist2, w1, b1, w2, b2, down_w=None, down_b=None,
                  *, dilation: int, k: int, act_scale: float = 0.25,
                  quantize: bool = False):
    """Per-POSITION oracle of the fused block: a Python loop over t with
    explicit tap gathers — structurally the ``stream_step`` path, not the
    batched form.  Weights arrive expanded fp32.  Returns (h, mid)."""
    d = dilation
    n = (k - 1) * d
    T = strip1.shape[1] - n
    qa = (lambda a: qa_value(a, act_scale)) if quantize else (lambda a: a)
    buf2 = torch.cat([hist2, hist2.new_zeros(
        (strip1.shape[0], T, hist2.shape[2]))], dim=1)
    hs, mids = [], []
    for pos in range(T):
        y = tap_sum([strip1[:, pos + j * d] for j in range(k)], w1) + b1
        y = qa(torch.relu(y))
        buf2[:, n + pos] = y
        y2 = tap_sum([buf2[:, pos + j * d] for j in range(k)], w2) + b2
        x_cur = strip1[:, n + pos]
        res = tap_sum([x_cur], down_w) + down_b if down_w is not None \
            else x_cur
        hs.append(qa(torch.relu(y2 + res)))
        mids.append(y)
    return torch.stack(hs, dim=1), torch.stack(mids, dim=1)


def proto_extract_ref(emb: torch.Tensor, onehot: torch.Tensor, k: int):
    """PN parameter extraction (Eq. 3+6).  emb (Nk, V); onehot (N, Nk)
    class-dispatch matrix.  Returns (W (N, V) = class-wise sums in shot
    order, b (N,) = -(||W||^2) * 1/(2k))."""
    w = None
    for i in range(onehot.shape[1]):
        term = onehot[:, i:i + 1] * emb[i]
        w = term if w is None else w + term
    b = -(w * w).sum(dim=-1) * (1.0 / (2.0 * k))
    return w, b


def proto_extract_labels_ref(emb: torch.Tensor, labels: torch.Tensor,
                             n_ways: int, k: int):
    """``proto_extract_ref`` on the one-hot of ``labels`` (Nk,), built by
    comparison as ``core/protonet.support_sums`` builds it: a label outside
    [0, n_ways) gets a zero column, as ``jax.nn.one_hot`` gives it."""
    ways = torch.arange(n_ways, device=labels.device)
    onehot = (labels.long()[None, :] == ways[:, None]).to(emb.dtype)
    return proto_extract_ref(emb, onehot.to(emb.device), k)


def log2_matmul_ref(x: torch.Tensor, w_packed: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """x (M, K) fp32 or bf16; w_packed (K, N/2) uint8 nibble-packed log2
    codes; scale ().  Returns (M, N) fp32 = x @ dequant(w)."""
    w = dequantize_log2(unpack_nibbles(w_packed), scale)
    return x.float() @ w


def dilated_conv_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     dilation: int) -> torch.Tensor:
    """Causal dilated conv1d.  x (B, T, Cin); w (K, Cin, Cout); b (Cout,).
    Left-pads by (K-1)*dilation and sums K tap-shifted products (no cuDNN,
    so no TF32 on the card)."""
    k = w.shape[0]
    pad = (k - 1) * dilation
    T = x.shape[1]
    xp = torch.nn.functional.pad(x, (0, 0, pad, 0))
    y = sum(xp[:, j * dilation:j * dilation + T] @ w[j] for j in range(k))
    return y + b
