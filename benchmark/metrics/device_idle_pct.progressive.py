"""The share of the traced window of progressive renders in which no
kernel, copy or set ran on the device, in %."""

from benchmark.readers import idle_pct


def read(run):
    return idle_pct(run) if getattr(run, "renders", None) else None
