"""Device time of the copies back to the host (``Memcpy DtoH``) in a traced
push, in ms."""

from bench.harness import profile


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.pushes:
        return None
    us = profile.busy_us(tr, tr.pushes, "Memcpy DtoH")
    return us * 1e-3 / len(tr.pushes) if us > 0 else None
