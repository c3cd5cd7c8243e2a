"""The job path's host time per preview frame, in ms (``readers.job_overhead_ms``)."""

from benchmark.readers import job_overhead_ms


def read(run):
    return job_overhead_ms(run)
