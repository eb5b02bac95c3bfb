"""The whole push's share of the H100's fp32 peak, in %: the model FLOPs of
the window's pushes outside the profiler (bench/harness/work.py
``push_flops``: the TCN body, head and FC of every step, and the banked
logits of the personalized streams) over their wall time times 67
TFLOP/s.  The arithmetic is fp32 (log2 weights decode to fp32)."""

from bench.harness import work


def read(ctx):
    walls = ctx.walls.get("push", [])
    if not walls:
        return None
    flops = sum(work.push_flops(ctx.sizes, S, T, personal, ctx.ways)
                for S, T, personal in ctx.push_shapes)
    return 100.0 * flops / (sum(walls) * work.PEAK_FP32_FLOPS)
