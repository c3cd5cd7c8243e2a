"""The job path's host time per demo2 frame, in ms (``readers.job_overhead_ms``)."""

from benchmark.readers import job_overhead_ms


def read(run):
    return job_overhead_ms(run)
