"""Host-to-device copy time per batch (ms): the profiler's HtoD memcpy
intervals in the sub-window over the batches it spans."""


def read(ctx):
    if ctx.trace is None or ctx.sub.steps <= 0:
        return None
    s = ctx.trace.copy_s("HtoD")
    return 1e3 * s / ctx.sub.steps if s > 0 else None
