"""The job's hand-offs between threads per demo2 frame, in ms: the manager's
and the worker's queue waits, the worker's pulls from the scheduler round
and the manager's finish (``program_spans.span_ms``)."""

from benchmark.program_spans import HANDOFF, span_ms


def read(run):
    return span_ms(run, HANDOFF)
