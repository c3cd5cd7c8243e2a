"""The window's seconds over the renders it completed to the noise target:
the wall time to a clean image."""


def read(run):
    renders = getattr(run, "renders", None)
    if not renders:
        return None
    return run.window_s / len(renders)
