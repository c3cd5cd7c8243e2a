"""The mean of the benchmark's spans around each ``max_rel_stderr``, in ms."""


def read(run):
    s = run.spans.seconds("stop_check") if getattr(run, "renders", None) else []
    return sum(s) / len(s) * 1e3 if s else None
