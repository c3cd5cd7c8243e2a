"""The median of every frame of the window, from ``schedule_job`` to its
last unit at the sink, in ms."""

import statistics

from benchmark.readers import frame_ms


def read(run):
    times = frame_ms(run)
    return statistics.median(times) if times else None
