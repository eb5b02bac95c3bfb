"""Kernel launches the host makes in a traced push (the fused chunk, the
per-step head and FC of core/streaming.py, the banked logits of
core/protonet.pn_logits_rows), counted as torch.profiler sees the CUDA
runtime and driver launch calls."""

from bench.harness import profile


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.pushes:
        return None
    n = profile.count_in(tr.runtime, tr.pushes, profile.LAUNCHES)
    return n / len(tr.pushes) if n else None
