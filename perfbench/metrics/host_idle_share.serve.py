"""Share of the profiled sub-window in which the device ran nothing while
the serving runtime's batcher was in one of the serving layer's own host
stages: ``serve.form`` (collecting a micro-batch, the deadline wait too),
``serve.assemble`` (concatenating and padding the images) or
``serve.deliver`` (scattering the scores to the requests). Each moment of
device-idle time goes to the batcher's innermost span then
(``program_spans.idle_by_span``), so the detector's own host work
(``detect.*``), the rest of ``serve.batch`` and the wait on an empty queue
(``serve.wait``) are left out. The batcher is the thread that records
``serve.batch``; ``serve.queue``, a request's wait that the batcher records
at pickup, is not its work."""

from perfbench import program_spans

STAGES = ("serve.form", "serve.assemble", "serve.deliver")


def read(ctx):
    spans = program_spans.window(ctx)
    if spans is None or ctx.trace.window_s <= 0:
        return None
    batcher = {s.tid for s in spans if s.name == "serve.batch"}
    if len(batcher) != 1:
        return None
    split = program_spans.idle_by_span(ctx, [s for s in spans if s.tid in batcher and s.name != "serve.queue"])
    return sum(split.get(n, 0.0) for n in STAGES) * 1e-6 / ctx.trace.window_s
