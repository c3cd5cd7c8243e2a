"""The cornell cell's kernel against its float32 roofline, in %
(``readers.kernel_roofline_pct``)."""

from benchmark.readers import kernel_roofline_pct


def read(run):
    return kernel_roofline_pct(run)
