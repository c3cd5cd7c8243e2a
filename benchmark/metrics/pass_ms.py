"""The mean of the benchmark's spans around each ``render_pass``, in ms."""


def read(run):
    s = run.spans.seconds("pass") if getattr(run, "renders", None) else []
    return sum(s) / len(s) * 1e3 if s else None
