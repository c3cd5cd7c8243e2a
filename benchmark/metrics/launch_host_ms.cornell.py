"""The kernel wrappers' host work (``kernel.launch``, from the wrapper's
entry to the launch queued, the table packs inside) per cornell frame, in ms
(``program_spans.span_ms``)."""

from benchmark.program_spans import LAUNCH_HOST, span_ms


def read(run):
    return span_ms(run, LAUNCH_HOST)
