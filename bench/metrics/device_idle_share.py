"""The share of the traced pushes' wall time in which no kernel, copy or
set ran on the device, in %."""

from bench.harness import profile


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.pushes or not tr.device:
        return None
    wall = sum(b - a for a, b in tr.pushes)
    return 100.0 * (1.0 - profile.busy_us(tr, tr.pushes) / wall)
