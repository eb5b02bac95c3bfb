"""``chunk_kernel`` (kernels/tcn_block.py ``tcn_chunk``) against its
roofline, in %: the least time the TCN body of the traced pushes needs on
one H100 (bench/harness/work.py ``chunk_work`` of each push's whole
length, so its history rows count once) over the kernel's device time in
those pushes.  Nothing when the kernel did not run."""

from bench.harness import profile, work


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.pushes:
        return None
    us = profile.busy_us(tr, tr.pushes, "chunk_kernel")
    if us <= 0:
        return None
    least = sum(work.bound_s(*work.chunk_work(ctx.sizes, S, T,
                                              ctx.sizes["quantize"]))
                for S, T, _ in ctx.traced_push_shapes)
    return 100.0 * least / (us * 1e-6)
