"""Mean host time of the pipeline's ``detection`` stage over the window's
batches (ms), read from ``PipelineProfiler``: the detector's serving step,
which ends on host arrays."""


def read(ctx):
    return ctx.work.get("detection_ms")
