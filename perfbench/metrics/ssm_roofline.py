"""The Mamba-2 recurrence's share of its roofline (%): the least time of
every ``ssm_recurrent`` call in the sub-window (the f32 state of each row
and head read and written once, the token's x, B, C and step in and y out,
at the memory rate; its f32 products at the f32 peak; the larger; a
prefill's real tokens from the program's ``ssm.token_updates``) over the
device time of the work launched inside those calls' ranges."""


def read(ctx):
    if ctx.trace is None or not ctx.work.get("ssm_calls"):
        return None
    dev = ctx.trace.device_s_under(["ssm_recurrent"])
    return 100.0 * ctx.work["ssm_bound_s"] / dev if dev > 0 else None
