"""Plain PyTorch versions of the port's kernels (the correctness contract).

Each sums in the same fixed order as its CUDA kernel — taps j = 0..k-1
outside, input channels in order inside, a separately rounded multiply
and add per term (the kernels use ``__fmul_rn``/``__fadd_rn``, which the
compiler never contracts into an FMA).  So every output element depends
on its own inputs only, never on T or S: the chunk-size invariance and
park/resume exactness the service relies on hold on the CPU as they do
on the card.
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
