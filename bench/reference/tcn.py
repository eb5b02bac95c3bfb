"""Plain reference of the Chameleon TCN as the benchmark serves it.

Written from the paper (arXiv 2505.24852, §III) for this benchmark alone:
it imports torch and nothing of the program under test.  From the raw
parameters, the BN running statistics and the inputs that the harness
made, it works out again everything the program derives:

* the BN fold into each conv's weights and bias (deployment, §IV-A);
* the 4-bit signed log2 weights (§III-C): a per-tensor scale max|w|, codes
  round(-log2(|w| / scale)) clipped to 7 (positive) or 8 (negative)
  levels, the value sign(w) * 2^-e * scale, 0 below the last level;
* the u4 activations at the fixed scale: q = clip(round(x / s), 0, 15) and
  the value x + (q s - x), the straight-through form;
* the whole causal forward of every stream from its first sample (a stream
  whose rings start at zero is the causal conv with zero left-padding);
* prototypes from the enrollment shots embedded again, W = s / k and
  b = -||W||^2 / 2, and the banked logits emb . W + b (-inf for ways not
  yet enrolled).

Every dot product sums in one fixed order (conv taps oldest first, input
channels in order inside; the head, FC and banked logits over the input
index), one rounding per product and per sum, so its bits do not depend
on batch or sequence length.  ``precision="tf32"`` rounds both operands of
every product to TF32 (10 mantissa bits, to nearest, ties to even) before
the product, as the tensor cores do with TF32 on: the control that must
come out as not correct.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
PRECISIONS = ("fp32", "tf32")


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round fp32 values to TF32's 10 mantissa bits (nearest, ties even)."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & -0x2000
    return b.view(torch.float32)


def _operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    return to_tf32(x) if precision == "tf32" else x


def u4(x: torch.Tensor, scale: float) -> torch.Tensor:
    q = torch.clamp(torch.round(x / scale), 0.0, 15.0)
    return x + (q * scale - x)


def log2_weight(w: torch.Tensor) -> torch.Tensor:
    """The decoded 4-bit log2 value of every weight of one tensor."""
    scale = torch.clamp(w.abs().max(), min=1e-12)
    e = torch.round(-torch.log2(torch.clamp(w.abs() / scale, min=2.0 ** -12)))
    e = torch.clamp(e, min=0.0)
    top = torch.where(w > 0, torch.full_like(e, 6.0), torch.full_like(e, 7.0))
    val = torch.sign(w) * torch.exp2(-e) * scale
    return torch.where((e > top) | (w == 0), torch.zeros_like(val), val)


def prepare(raw: dict, bn: dict, n_blocks: int, *, quantize: bool) -> dict:
    """The served weights from the raw ones: the BN fold, then (when
    quantized) the log2 values of every conv and of the head.  ``raw`` is
    {"blocks": {"b<i>": {conv1_w, conv1_b, conv2_w, conv2_b, bn1, bn2
    [, down_w, down_b]}}, head_w, head_b, fc: {w, b}}; ``bn`` is {"b<i>":
    {bn1_mean, bn1_var, bn2_mean, bn2_var}}."""
    q = log2_weight if quantize else (lambda w: w)
    blocks = []
    for i in range(n_blocks):
        p, st = raw["blocks"][f"b{i}"], bn[f"b{i}"]
        blk = {}
        for conv, norm in (("conv1", "bn1"), ("conv2", "bn2")):
            scale = p[norm]["scale"] / torch.sqrt(st[f"{norm}_var"] + BN_EPS)
            blk[f"{conv}_w"] = q(p[f"{conv}_w"] * scale[None, None, :])
            blk[f"{conv}_b"] = (p[f"{conv}_b"] - st[f"{norm}_mean"]) * scale \
                + p[norm]["bias"]
        if "down_w" in p:
            blk["down_w"], blk["down_b"] = q(p["down_w"]), p["down_b"]
        blocks.append(blk)
    return {"blocks": blocks, "head_w": q(raw["head_w"]),
            "head_b": raw["head_b"], "fc_w": raw["fc"]["w"],
            "fc_b": raw["fc"]["b"]}


def _dot_last(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sum_c x[..., c] * w[c, :] in channel order: (..., C) x (C, N)."""
    acc = None
    for c in range(w.shape[0]):
        term = x[..., c:c + 1] * w[c]
        acc = term if acc is None else acc + term
    return acc


def causal_conv(h: torch.Tensor, w: torch.Tensor, d: int) -> torch.Tensor:
    """Causal dilated conv without bias: h (B, T, Cin), w (k, Cin, Cout);
    the sum of every output runs over taps oldest first, then channels."""
    k, cin = w.shape[0], w.shape[1]
    T = h.shape[1]
    # a tap reaching back T steps or more reads only the zero padding: its
    # terms are zeros, and adding a zero leaves every sum as it was
    taps = [j for j in range(k) if (k - 1 - j) * d < T]
    pad = (k - 1 - taps[0]) * d
    hp = F.pad(h, (0, 0, pad, 0))
    acc = None
    for j in taps:
        a = pad - (k - 1 - j) * d
        for c in range(cin):
            term = hp[:, a:a + T, c:c + 1] * w[j, c]
            acc = term if acc is None else acc + term
    return acc


def forward(served: dict, x: torch.Tensor, *, act_scale: float,
            quantize: bool, precision: str = "fp32"):
    """Every step of streams that start at zero: x (B, T, Cin) ->
    (emb (B, T, V), logits (B, T, n_classes))."""
    rnd = lambda t: _operand(t, precision)
    qa = (lambda a: u4(a, act_scale)) if quantize else (lambda a: a)
    h = rnd(x)
    for i, blk in enumerate(served["blocks"]):
        d = 2 ** i
        mid = qa(torch.relu(causal_conv(h, rnd(blk["conv1_w"]), d)
                            + blk["conv1_b"]))
        y2 = causal_conv(rnd(mid), rnd(blk["conv2_w"]), d) + blk["conv2_b"]
        if "down_w" in blk:
            res = _dot_last(h, rnd(blk["down_w"][0])) + blk["down_b"]
        else:
            res = h
        h = rnd(qa(torch.relu(y2 + res)))
    emb = qa(torch.relu(_dot_last(h, rnd(served["head_w"]))
                        + served["head_b"]))
    logits = _dot_last(rnd(emb), rnd(served["fc_w"])) + served["fc_b"]
    return emb, logits


class Bank:
    """One tenant's prototypes: running sums and shot counts per way."""

    def __init__(self, sums: torch.Tensor, counts: torch.Tensor):
        self.dim, self.device = sums.shape[1], sums.device
        self.sums = [row.clone() for row in sums]
        self.counts = [float(c) for c in counts]

    def enroll(self, way: int, shot_emb: torch.Tensor) -> None:
        """Fold (k, V) shot embeddings into ``way`` (a new way when it is
        the next one)."""
        s = shot_emb[0].clone()
        for row in shot_emb[1:]:
            s = s + row
        if way == len(self.sums):
            self.sums.append(s)
            self.counts.append(float(shot_emb.shape[0]))
        else:
            self.sums[way] = self.sums[way] + s
            self.counts[way] += float(shot_emb.shape[0])

    def fc(self, max_ways: int):
        """W (max_ways, V) = s / k and b (max_ways,) = -||W||^2 / 2; ways
        not enrolled have W = 0 and b = -inf."""
        V, dev = self.dim, self.device
        w = torch.zeros((max_ways, V), device=dev)
        n = len(self.sums)
        if n:
            w[:n] = torch.stack(self.sums) / torch.tensor(self.counts,
                                                         device=dev)[:, None]
        sq = None
        for v in range(V):
            term = w[:, v] * w[:, v]
            sq = term if sq is None else sq + term
        b = -sq / 2.0
        b[n:] = -torch.inf
        return w, b


def banked_logits_rows(emb: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       precision: str = "fp32") -> torch.Tensor:
    """Each stream's steps against its own bank: emb (K, T, V), w (K, N, V),
    b (K, N) -> (K, T, N) = emb . W + b, summed over V in order."""
    emb, w = _operand(emb, precision), _operand(w, precision)
    acc = None
    for v in range(w.shape[-1]):
        term = emb[:, :, v:v + 1] * w[:, None, :, v]
        acc = term if acc is None else acc + term
    return acc + b[:, None, :]
