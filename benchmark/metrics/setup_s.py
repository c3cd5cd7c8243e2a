"""Seconds from the process's start to the first timed frame: imports, the
CUDA context, loading (or, in a new checkout, building) the kernels, the
scene, and one warm frame or pass of the cell's own shape."""


def read(run):
    return run.setup_s
