"""Assigned input shapes (one set, shared by all 10 LM-family archs); a copy
of ``repro/configs/shapes.py``."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

# long_500k needs sub-quadratic decode state; only constant/log-state archs
# run it. Full-attention archs are recorded as SKIP.
LONG_CONTEXT_ARCHS = {"rwkv6-1.6b", "zamba2-1.2b", "chameleon-tcn"}

# Encoder-decoder: fixed encoder length for serve shapes.
ENCDEC_ENC_LEN = 4096


def cells(arch_names):
    """All 40 (arch x shape) cells, with skip annotations."""
    out = []
    for a in arch_names:
        for s in SHAPES.values():
            skip = s.name == "long_500k" and a not in LONG_CONTEXT_ARCHS
            out.append((a, s.name, skip))
    return out
