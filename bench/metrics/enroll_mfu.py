"""The whole enrollment's share of the H100's fp32 peak, in %: the model
FLOPs of the window's enrollments outside the profiler (bench/harness/work.py
``enroll_flops``: the TCN body over every step of every shot and the head
of its last step) over their wall time times 67 TFLOP/s."""

from bench.harness import work


def read(ctx):
    walls = ctx.walls.get("enroll", [])
    if not walls:
        return None
    flops = sum(work.enroll_flops(ctx.sizes, k, T)
                for k, T in ctx.enroll_shapes)
    return 100.0 * flops / (sum(walls) * work.PEAK_FP32_FLOPS)
