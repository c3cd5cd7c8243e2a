"""Primary samples of every cornell frame the window completed, over the
window's whole time, in millions a second (``readers.msamples_per_s``)."""

from benchmark.readers import msamples_per_s


def read(run):
    return msamples_per_s(run)
