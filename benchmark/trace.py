"""From a ``torch.profiler`` window to the numbers the per-layer metrics
read: the seconds in which each card ran anything, the device time of
each kernel by name, and the idle gaps between one card's device work,
each named by what the host was doing in it.

:func:`events` takes the intervals out of a finished profiler;
:func:`reduce` works on plain ``(start_ns, end_ns, name, card)`` lists, so
that the arithmetic is tested on a fixed trace without a card.
:func:`combine` merges the summaries of several processes, each tracing
its own card (``procs.py``).

Several cards are several cards: a card's busy time is the union of its
own intervals, and ``busy_s`` is the mean over the cards, a card that ran
nothing counting as idle. Device seconds by kernel and idle gaps are sums
over the cards. On one card every number is the union over all intervals,
as it was before cards were told apart.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field

__all__ = ["TraceSummary", "events", "reduce", "combine", "union_ns"]

# Of the host events that cover a gap's midpoint the innermost names it;
# the search looks back at most this many events that started before it.
_LOOKBACK = 400
_NAME_CHARS = 96


@dataclass
class TraceSummary:
    busy_s: float  # mean over the cards of the union of each card's kernels, copies and sets
    window_s: float  # the traced window, on the host's clock
    kernel_s: dict = field(default_factory=dict)  # device seconds by event name, summed over cards
    device_ops: list = field(default_factory=list)  # [[name, s]], the 10 longest in all
    idle_gaps: list = field(default_factory=list)  # [[host activity, s]], the 10 largest sums
    busy_by_card: dict = field(default_factory=dict)  # card -> busy seconds, of the cards that ran something
    gap_s: dict = field(default_factory=dict)  # host activity -> idle seconds, summed over cards

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


def events(prof, card=None):
    """(device, host) interval lists of a finished ``torch.profiler``:
    every event on a CUDA device (kernels, copies, sets) with its card,
    and every host event (operators, runtime calls, the benchmark's own
    ranges). The card is the profiler's device index, or ``card`` for a
    process that sees one card only (``CUDA_VISIBLE_DEVICES``)."""
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
            dev.append((start, end, e.name(), e.device_index() if card is None else card))
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


def _top(d: dict) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]


def _n_cards(by_card: dict, cards: int) -> int:
    """How many cards the mean busy time is over: ``0 .. cards - 1``, each
    idle where it is missing from ``by_card``, and any other card that ran
    something."""
    return max(len(set(range(cards)) | set(by_card)), 1)


def reduce(dev, host, window_s: float, cards: int = 1) -> TraceSummary:
    """The summary of one traced window of ``window_s`` seconds from its
    device and host intervals (ns). A device interval is ``(start, end,
    name, card)``; without a card it is on card 0. The window had
    ``cards`` cards, ``0 .. cards - 1``, each idle where it ran nothing;
    ``cards=0`` counts only the cards that ran something."""
    by_card = defaultdict(list)
    for ev in dev:
        by_card[ev[3] if len(ev) > 3 else 0].append(ev)
    busy_ns = {}
    kernel = defaultdict(float)
    for ev in dev:
        kernel[_short(ev[2])] += (ev[1] - ev[0]) * 1e-9
    host_sorted = sorted(host)
    starts = [h[0] for h in host_sorted]
    gaps = defaultdict(float)
    for card in sorted(by_card):
        merged = union_ns(by_card[card])
        busy_ns[card] = sum(e - s for s, e in merged)
        for (_, end), (nxt, _) in zip(merged, merged[1:]):
            gaps[_short(_innermost(host_sorted, starts, (end + nxt) // 2))] += (nxt - end) * 1e-9
    busy_s = {card: ns * 1e-9 for card, ns in busy_ns.items()}
    # The sum in integer ns before the one conversion: on one card, the
    # union's seconds exactly.
    mean_s = sum(busy_ns.values()) * 1e-9 / _n_cards(busy_ns, cards)
    return TraceSummary(busy_s=mean_s, window_s=window_s, kernel_s=dict(kernel), device_ops=_top(kernel),
                        idle_gaps=_top(gaps), busy_by_card=busy_s, gap_s=dict(gaps))


def combine(summaries, cards: int, window_s: float = None) -> TraceSummary:
    """One summary of the processes that traced the same window, each its
    own cards: busy seconds added by card (two processes on one card would
    count their overlap twice, so a cell gives each process a card of its
    own), ``busy_s`` their mean over ``cards`` cards as in :func:`reduce`,
    device seconds and idle gaps summed by name. The window is
    ``window_s``, by default the longest of theirs."""
    by_card, kernel, gaps = defaultdict(float), defaultdict(float), defaultdict(float)
    for s in summaries:
        for card, b in s.busy_by_card.items():
            by_card[card] += b
        for name, v in s.kernel_s.items():
            kernel[name] += v
        for name, v in s.gap_s.items():
            gaps[name] += v
    window_s = max(s.window_s for s in summaries) if window_s is None else window_s
    return TraceSummary(busy_s=sum(by_card.values()) / _n_cards(by_card, cards), window_s=window_s, kernel_s=dict(kernel),
                        device_ops=_top(kernel), idle_gaps=_top(gaps), busy_by_card=dict(by_card),
                        gap_s=dict(gaps))
