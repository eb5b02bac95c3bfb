"""The yardstick's arithmetic: published H100 peaks and the operations and
bytes a push needs, computed from shapes.

Frozen copies, so a change to the program cannot move them: the peaks of
``repro_torch/core/costmodel.py`` (NVIDIA H100 data sheet, SXM part, dense
rates, at the full 700 W) and ``chunk_work`` of ``chip_smoke.py``.
"""

from __future__ import annotations

PEAK_FP32_FLOPS = 67e12   # fp32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12  # HBM3, bytes per second


def block_shapes(sizes: dict) -> list[tuple[int, int, int, int, bool]]:
    """(block, dilation, Cin, C, has_down) along the TCN."""
    out, c_in = [], sizes["tcn_in_channels"]
    for i, c in enumerate(sizes["tcn_channels"]):
        out.append((i, 2 ** i, c_in, c, c_in != c))
        c_in = c
    return out


def step_flops(sizes: dict) -> int:
    """FLOPs of the TCN body for one step of one stream."""
    k = sizes["tcn_kernel"]
    return sum(2 * k * cin * c + 2 * k * c * c + (2 * cin * c if down else 0)
               for (_, _, cin, c, down) in block_shapes(sizes))


def chunk_work(sizes: dict, S: int, T: int, packed: bool) -> tuple[float, float]:
    """(bytes, flops) one in-place tcn_chunk call must move and do: the
    weights, x in and h out, t and the lengths, and per conv of every slot
    the (k-1)*min(d, T) history rows its taps read and the min(T, n) ring
    rows it writes."""
    k = sizes["tcn_kernel"]
    wbytes = 0.5 if packed else 4.0
    nbytes = S * T * (sizes["tcn_in_channels"] + sizes["tcn_channels"][-1]) \
        * 4 + 3 * S * 4
    for (_, d, Cin, C, has_down) in block_shapes(sizes):
        n = (k - 1) * d
        w_elems = k * Cin * C + k * C * C + (Cin * C if has_down else 0)
        nbytes += w_elems * wbytes + (3 if has_down else 2) * C * 4
        nbytes += S * ((k - 1) * min(d, T) + min(T, n)) * (Cin + C) * 4
    return nbytes, S * T * step_flops(sizes)


def bound_s(nbytes: float, flops: float) -> float:
    """Least seconds for the work on one H100: bytes at the HBM rate or the
    operations at the fp32 peak, whichever is longer."""
    return max(nbytes / PEAK_HBM_BYTES, flops / PEAK_FP32_FLOPS)


def push_flops(sizes: dict, S: int, T: int, personalized: int,
               ways: int) -> float:
    """Model FLOPs of one push of T steps to S streams: the TCN body, the
    head (C -> V) and the FC (V -> classes) of every step, and the banked
    logits (V -> ways) of the ``personalized`` streams' steps."""
    V, C = sizes["embed_dim"], sizes["tcn_channels"][-1]
    per_step = step_flops(sizes) + 2 * C * V + 2 * V * sizes["n_classes"]
    return S * T * per_step + personalized * T * 2 * V * ways


def enroll_flops(sizes: dict, k: int, T: int) -> float:
    """Model FLOPs of embedding k shots of T steps: the TCN body over every
    step and the head (C -> V) of the last step, whose output is the
    shot's embedding."""
    V, C = sizes["embed_dim"], sizes["tcn_channels"][-1]
    return k * (T * step_flops(sizes) + 2 * C * V)
