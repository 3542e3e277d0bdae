"""Share of the profiled sub-window in which the device ran nothing:
1 - (union of kernel, copy and set intervals) / the sub-window's wall time."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0 or ctx.trace.busy_s <= 0:
        return None
    return 1.0 - ctx.trace.busy_s / ctx.trace.window_s
