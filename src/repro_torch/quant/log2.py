"""4-bit signed log2 ("power-of-two") weight quantization — the paper's
§III-C — and 4-bit unsigned activations, on PyTorch tensors.

The port of ``repro/quant/log2.py``; same codebook, same layouts:

    value(q) = 0                                   if q == 0
             = sign(q) * 2^(1 - |q|) * scale       otherwise

with q a two's-complement nibble in [-8, 7], two codes per byte, the even
index along the last axis in the low nibble.  The straight-through
estimator is ``x + (xq - x).detach()``.  ``torch.round`` rounds half to
even like ``jnp.round``; ``torch.log2`` and XLA's ``log2`` may differ by
an ulp, so a weight sitting exactly on a ``round(-log2 a)`` tie may get a
neighbouring code in the two packages (the one documented difference).
"""

from __future__ import annotations

import torch

# Positive codes reach |q|=7 (exp -6); negative codes reach |q|=8 (exp -7),
# mirroring int8's mild asymmetry.
_MAX_POS_CODE = 7
_MAX_NEG_CODE = 8


def compute_scale(w: torch.Tensor) -> torch.Tensor:
    """Per-tensor symmetric scale: maps max|w| to the top code (2^0 * scale)."""
    return torch.clamp(w.abs().max(), min=1e-12)


def quantize_log2(w: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Quantize real weights to int8 nibble codes in [-8, 7]."""
    a = w.abs() / scale
    # e = round(-log2(a)); magnitudes below 2^-(max_code-0.5) round to zero.
    e = torch.round(-torch.log2(torch.clamp(a, min=2.0 ** -12)))
    pos = w > 0
    max_e = torch.where(pos, torch.tensor(_MAX_POS_CODE - 1.0, device=w.device),
                        torch.tensor(_MAX_NEG_CODE - 1.0, device=w.device))
    code = (torch.minimum(torch.clamp(e, min=0.0), max_e) + 1).to(torch.int8)
    code = torch.where(pos, code, -code)
    zero = (e > max_e) | (w == 0)
    return torch.where(zero, torch.zeros_like(code), code)


def dequantize_log2(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    """Decode nibble codes back to real values."""
    qf = q.to(torch.float32)
    val = torch.sign(qf) * torch.exp2(1.0 - qf.abs()) * scale
    return torch.where(q == 0, torch.zeros_like(val), val).to(dtype)


def fake_quant_log2(w: torch.Tensor, scale: torch.Tensor | None = None):
    """Straight-through-estimator fake quantization for QAT."""
    if scale is None:
        scale = compute_scale(w).detach()
    wq = dequantize_log2(quantize_log2(w, scale), scale, dtype=w.dtype)
    return w + (wq - w).detach()


# ---------------------------------------------------------------------------
# 4-bit unsigned uniform activations (post-ReLU), per-tensor scale.
# ---------------------------------------------------------------------------

def quantize_act_u4(x: torch.Tensor, scale) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), 0, 15).to(torch.uint8)


def dequantize_act_u4(q: torch.Tensor, scale, dtype=torch.float32):
    return q.to(dtype) * scale


def fake_quant_act_u4(x: torch.Tensor, scale=None) -> torch.Tensor:
    """STE fake-quant for activations; also simulates the 4-bit clip."""
    if scale is None:
        scale = torch.clamp(x.max() / 15.0, min=1e-12).detach()
    xq = dequantize_act_u4(quantize_act_u4(x, scale), scale, dtype=x.dtype)
    return x + (xq - x).detach()


# ---------------------------------------------------------------------------
# Nibble packing: two 4-bit codes per uint8 (even nibble = low bits).
# ---------------------------------------------------------------------------

def pack_nibbles(q: torch.Tensor) -> torch.Tensor:
    """Pack int8 codes in [-8,7] into uint8 pairs along the last axis.

    The last axis must be even; output last axis is half the size.
    """
    if q.shape[-1] % 2 != 0:
        raise ValueError(f"last axis must be even, got {tuple(q.shape)}")
    u = (q.to(torch.int32) & 0xF).to(torch.uint8)
    return u[..., 0::2] | (u[..., 1::2] << 4)


def unpack_nibbles(p: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_nibbles: uint8 -> int8 codes in [-8,7] (sign-extended)."""
    lo = (p & 0xF).to(torch.int32)
    hi = ((p >> 4) & 0xF).to(torch.int32)
    both = torch.stack([lo, hi], dim=-1).reshape(*p.shape[:-1], p.shape[-1] * 2)
    return ((both ^ 8) - 8).to(torch.int8)  # sign-extend nibble
