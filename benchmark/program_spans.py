"""Per-frame sums of the program's own spans (``flux_tpu_torch.metrics``),
which the program records while the traced run's profiler window is open,
in the harness's process and in the driver's child processes.

A program without the recorder, or a run off the card, gives None, and so
does a window in which none of the spans was recorded."""

# The spans each metric sums; a span inside another of its list is not
# listed (``kernel.launch`` holds its ``kernel.pack_tables``).
RENDERER_BUILD = ("worker.renderer_build",)
LAUNCH_HOST = ("kernel.launch",)
HANDOFF = ("manager.queue_wait", "worker.queue_wait", "sched.pull", "manager.finish")


def span_ms(run, names) -> float:
    """The time of the spans ``names`` that start inside the window's frames,
    from the first frame's ``schedule_job`` to the last frame's end, over
    the number of frames, in ms: the harness's own spans and those of the
    driver's child processes (``run.process_spans``, on the same clock). A
    span is taken by its start because the last frame's ``manager.finish``
    sets the job's handle done inside it, so it may end after that frame's
    end."""
    frames = getattr(run, "frames", None)
    if run.device["platform"] != "gpu" or not frames:
        return None
    try:
        from flux_tpu_torch.metrics import spans
    except ImportError:
        return None
    lo, hi = frames[0].t_schedule * 1e9, frames[-1].t_end * 1e9
    got = [s.end_ns - s.start_ns for s in spans() + list(getattr(run, "process_spans", ()))
           if s.name in names and lo <= s.start_ns <= hi]
    return sum(got) / len(frames) / 1e6 if got else None
