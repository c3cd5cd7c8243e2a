"""Arithmetic that several metric readers share."""

import json


def idle_pct(run):
    """The share of the traced window in which a card ran nothing, in %,
    the mean over the cell's cards (``trace.TraceSummary.busy_s``); None
    off the card or without a trace."""
    if run.device["platform"] != "gpu" or run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def job_overhead_ms(run):
    """Per frame, the span from ``schedule_job`` to the last unit at the
    sink less a card's busy time (the mean over the cell's cards), in ms:
    the mean over the window's frames. Every device operation of the
    window belongs to one of its frames, which run one at a time, so the
    frames' busy time is the trace's."""
    frames = getattr(run, "frames", None)
    if run.device["platform"] != "gpu" or run.trace is None or not frames:
        return None
    spans = sum(f.t_last_unit - f.t_schedule for f in frames)
    return (spans - run.trace.busy_s) / len(frames) * 1e3


def frame_ms(run):
    """Each frame of the window, from ``schedule_job`` to its last unit at
    the sink, in ms."""
    return [(f.t_last_unit - f.t_schedule) * 1e3 for f in getattr(run, "frames", None) or []]


def msamples_per_s(run):
    """Primary samples of every frame the window completed, over the
    window's whole time, in millions a second."""
    frames = getattr(run, "frames", None)
    return sum(f.samples for f in frames) / run.window_s / 1e6 if frames else None


def kernel_roofline_pct(run):
    """The cell's kernel against its float32 roofline, in %: the frozen
    float32 operations of the window's frames (``frozen/<cell>.json``,
    counted once from the kernel's counting launch, never from the program
    at run time) over the card's float32 peak (``peaks.json``) times the
    device seconds of the cell's kernel in the trace. None off the card,
    without a frozen count, a peak for the card, or the kernel in the
    trace."""
    frames = getattr(run, "frames", None)
    path = run.base / "frozen" / f"{run.cell['name']}.json"
    if run.device["platform"] != "gpu" or run.trace is None or not frames or not path.is_file():
        return None
    frozen = json.loads(path.read_text())
    peaks = json.loads((run.base / "peaks.json").read_text())
    peak = next((p["fp32_flops"] for k, p in peaks.items() if k in (run.device.get("kind") or "")), None)
    seconds = run.trace.kernel_seconds(frozen["kernel"])
    if peak is None or seconds <= 0:
        return None
    return 100.0 * frozen["ops_per_frame"] * len(frames) / (peak * seconds)
