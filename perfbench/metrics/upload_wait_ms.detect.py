"""Host time a ``detect_batch`` call blocks on its pixels' upload (ms): the
mean, over the program's ``detect.batch`` spans that started in the
profiled sub-window, of their ``detect.upload_wait`` children (the serving
step waiting for the pinned stager's worker to have copied the pixels into
its buffer and issued their copy to the card). The part of the upload that
the host's text stage did not hide. Nothing is read where no ``detect.batch``
of the window has a ``detect.upload_wait`` child: a program without the
stager, or one whose uploads all took the plain copy."""

from perfbench import program_spans


def read(ctx):
    spans = program_spans.window(ctx)
    if spans is None:
        return None
    batches = {s.id for s in program_spans.started(ctx, spans, "detect.batch")}
    if not any(s.name == "detect.upload_wait" and s.parent in batches for s in spans):
        return None
    return program_spans.children_ms(ctx, "detect.batch", ("detect.upload_wait",))
