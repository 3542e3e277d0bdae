"""The KDA recurrence's share of its roofline (%): the least time of every
``kda_recurrent`` call in the sub-window (the f32 state of each row and
head read and written once, the token's q, k, v, g and beta in and o out,
at the memory rate; its f32 products at the f32 peak; the larger)
over the device time of the work launched inside those calls' ranges."""


def read(ctx):
    if ctx.trace is None or not ctx.work.get("kda_calls"):
        return None
    dev = ctx.trace.device_s_under(["kda_recurrent"])
    return 100.0 * ctx.work["kda_bound_s"] / dev if dev > 0 else None
