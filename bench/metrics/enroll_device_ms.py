"""Device busy time of one ``enroll_shots`` call (the embedder through the
``tcn_block`` strip kernel, then the bank update), in ms, over the traced
enrollments.  Nothing in a cell that does not enroll."""

from bench.harness import profile


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.enrolls:
        return None
    us = profile.busy_us(tr, tr.enrolls)
    return us * 1e-3 / len(tr.enrolls) if us > 0 else None
