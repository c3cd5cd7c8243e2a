"""The 95th percentile of every frame of the window, from ``schedule_job``
to its last unit at the sink, in ms; None below 20 frames."""

import statistics

from benchmark.readers import frame_ms


def read(run):
    times = frame_ms(run)
    return statistics.quantiles(times, n=20, method="inclusive")[18] if len(times) >= 20 else None
