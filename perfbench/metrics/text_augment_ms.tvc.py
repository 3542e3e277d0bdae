"""Host time of the pipeline's text augmentation per batch (ms): the mean
``pipeline.text_augment`` span (the paraphrase decode's dispatch, which
runs the decode up to its last queued chunk) plus the mean
``pipeline.text_augment.finalize`` span (readback, detokenization, host
strategies), over those that started in the profiled sub-window."""

from perfbench import program_spans


def read(ctx):
    dispatch = program_spans.mean_ms(ctx, "pipeline.text_augment")
    finalize = program_spans.mean_ms(ctx, "pipeline.text_augment.finalize")
    return dispatch + finalize if dispatch is not None and finalize is not None else None
