"""The latent decode attention's share of its roofline (%): the least time
by bytes of every ``mla_decode_attention`` call in the sub-window (the
latent cache rows of the S slots the call is given, q_lat and q_pe in, the
output out, at the memory rate) over the device time of the work launched
inside those calls' ranges."""


def read(ctx):
    if ctx.trace is None or not ctx.work.get("mla_calls"):
        return None
    dev = ctx.trace.device_s_under(["mla_decode_attention"])
    return 100.0 * ctx.work["mla_bound_s"] / dev if dev > 0 else None
