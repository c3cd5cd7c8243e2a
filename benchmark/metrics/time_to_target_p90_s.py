"""The 90th percentile of the seconds each render of the window took, from
building its renderer to its stop."""

import statistics


def read(run):
    renders = getattr(run, "renders", None)
    if not renders or len(renders) < 10:
        return None
    return statistics.quantiles([r.t_end - r.t_start for r in renders], n=10, method="inclusive")[8]
