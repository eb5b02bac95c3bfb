"""Host time of a push (sessions/service.py ``push_audio``): its wall time
less its ``dispatch`` spans, which cover the upload, the kernels and the
copies back.  What is left is the per-stream packing, binding and result
building.  Mean over the window's pushes outside the profiler, in ms."""


def read(ctx):
    pairs = list(zip(ctx.walls.get("push", []), ctx.push_dispatch))
    if not pairs:
        return None
    return 1e3 * sum(w - d for w, d in pairs) / len(pairs)
