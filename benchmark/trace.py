"""From a ``torch.profiler`` window to the numbers the per-layer metrics
read: the seconds in which the device ran anything, the device time of
each kernel by name, and the idle gaps between device work, each named by
what the host was doing in it.

:func:`events` takes the intervals out of a finished profiler;
:func:`reduce` works on plain ``(start_ns, end_ns, name)`` lists, so that
the arithmetic is tested on a fixed trace without a card.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field

__all__ = ["TraceSummary", "events", "reduce", "union_ns"]

# Of the host events that cover a gap's midpoint the innermost names it;
# the search looks back at most this many events that started before it.
_LOOKBACK = 400
_NAME_CHARS = 96


@dataclass
class TraceSummary:
    busy_s: float  # union of the device's kernels, copies and sets
    window_s: float  # the traced window, on the host's clock
    kernel_s: dict = field(default_factory=dict)  # device seconds by event name
    device_ops: list = field(default_factory=list)  # [[name, s]], the 10 longest in all
    idle_gaps: list = field(default_factory=list)  # [[host activity, s]], the 10 largest sums

    def kernel_seconds(self, part: str) -> float:
        """Device seconds of every event whose name contains ``part``."""
        return sum(s for name, s in self.kernel_s.items() if part in name)


def _span(e):
    start = e.start_ns() if hasattr(e, "start_ns") else int(e.start_us() * 1000)
    if hasattr(e, "end_ns"):
        return start, e.end_ns()
    if hasattr(e, "duration_ns"):
        return start, start + e.duration_ns()
    return start, start + int(e.duration_us() * 1000)


def events(prof):
    """(device, host) interval lists of a finished ``torch.profiler``:
    every event on a CUDA device (kernels, copies, sets), and every host
    event (operators, runtime calls, the benchmark's own ranges)."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        start, end = _span(e)
        if end <= start:
            continue
        if e.device_type() != DeviceType.CUDA:
            host.append((start, end, e.name()))
        elif not (getattr(e, "is_user_annotation", lambda: False)() or e.name().startswith("bench.")):
            # A host range is mirrored on the device's timeline as an
            # annotation over the work it launched; it is not work.
            dev.append((start, end, e.name()))
    return dev, host


def union_ns(intervals):
    """Merged (start, end) intervals of ``(start, end, ...)`` tuples."""
    merged = []
    for s, e, *_ in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def _short(name: str) -> str:
    return name if len(name) <= _NAME_CHARS else name[: _NAME_CHARS - 3] + "..."


def _innermost(host_sorted, starts, t):
    """Name of the host event that covers ``t`` and started last."""
    i = bisect.bisect_right(starts, t)
    for k in range(i - 1, max(i - 1 - _LOOKBACK, -1), -1):
        s, e, name = host_sorted[k]
        if e >= t:
            return name
    return "host: no traced call"


def reduce(dev, host, window_s: float) -> TraceSummary:
    """The summary of one traced window of ``window_s`` seconds from its
    device and host intervals (ns)."""
    merged = union_ns(dev)
    busy_ns = sum(e - s for s, e in merged)
    kernel = defaultdict(float)
    for s, e, name in dev:
        kernel[_short(name)] += (e - s) * 1e-9
    host_sorted = sorted(host)
    starts = [h[0] for h in host_sorted]
    gaps = defaultdict(float)
    for (_, end), (nxt, _) in zip(merged, merged[1:]):
        gaps[_short(_innermost(host_sorted, starts, (end + nxt) // 2))] += (nxt - end) * 1e-9
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return TraceSummary(busy_s=busy_ns * 1e-9, window_s=window_s, kernel_s=dict(kernel),
                        device_ops=top(kernel), idle_gaps=top(gaps))
