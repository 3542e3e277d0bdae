"""95th percentile of a request's wait in the serving runtime's queue (ms):
the program's ``serve.queue`` spans (enqueue to the batcher's pickup) of the
requests picked up inside the profiled sub-window."""

import math

from perfbench import program_spans


def read(ctx):
    spans = program_spans.window(ctx)
    if spans is None:
        return None
    lo, hi = ctx.trace.lo, ctx.trace.hi
    waits = sorted(s.ms for s in spans if s.name == "serve.queue" and lo <= s.b <= hi)
    return waits[math.ceil(0.95 * len(waits)) - 1] if waits else None
