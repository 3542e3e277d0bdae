"""Host time of the detector's fused path before its serving step, per
``detect_batch`` call (ms): the mean, over the program's ``detect.batch``
spans that started in the profiled sub-window, of their ``detect.tokenize``
(captions and variants to token ids) and ``detect.stage`` (bucketing, EOT
pinning, contiguous copies, the serving step's lookup) children."""

from perfbench import program_spans


def read(ctx):
    return program_spans.children_ms(ctx, "detect.batch", ("detect.tokenize", "detect.stage"))
