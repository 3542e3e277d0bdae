"""95th percentile of a request's time from when it was sent to when its
answer returned, over every answered request of the window (host clock).
With every client waiting on an answer this is the runtime's queue and
step; the time from when a request was due also holds the generator's
wait for a free client."""

import numpy as np


def read(ctx):
    ms = ctx.work.get("answer_ms")
    if ms is None or len(ms) == 0:
        return None
    return float(ms[int(np.ceil(0.95 * len(ms))) - 1])
