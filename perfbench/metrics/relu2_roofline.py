"""The non-gated experts' squared ReLU's share of its roofline (%): the
least time of every ``relu2`` call in the sub-window (its input in and its
output out, by bytes at the memory rate) over the device time of the work
launched inside those calls' ranges."""


def read(ctx):
    if ctx.trace is None or not ctx.work.get("relu2_calls"):
        return None
    dev = ctx.trace.device_s_under(["relu2"])
    return 100.0 * ctx.work["relu2_bound_s"] / dev if dev > 0 else None
