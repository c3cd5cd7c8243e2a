"""The program's spans, and the profiling hook
(``flux_tpu/metrics.py``).

The reference's observability is ``d_println`` timestamps plus wall-clock
prints from the event sinks. Here:

* :func:`span` (a context manager), :func:`stamp`/:func:`record` (a span
  whose start another thread took) and :func:`held` (a span that overlaps
  the next one of its name on its thread) time the job path's host work on
  the threads that do it: the manager, the workers, the kernel launches. They
  record only while a ``torch.profiler`` window is open anywhere in the
  process, which is what ``torch.autograd.profiler._is_profiler_enabled``
  says on every thread; the profiler itself records host work only on the
  thread that opened it. Outside a window a span site reads that flag and
  nothing else: no clock, no allocation.
* :func:`profile_trace` wraps ``torch.profiler`` so that a render is
  captured as a Chrome trace (Perfetto readable), the program's spans on
  each thread's track among the profiler's own events, on its clock.

A span's times are ``time.perf_counter_ns()``; :func:`clock_offset_ns` moves
them onto the Unix-epoch nanoseconds that the profiler stamps host events
with.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import NamedTuple, Optional

import torch.autograd.profiler as _profiler

__all__ = ["Span", "span", "held", "stamp", "record", "spans", "clear", "clock_offset_ns", "profile_trace"]

# The process-wide flag that torch.profiler.profile sets when its window
# starts and clears when it stops (the thread-local
# torch.autograd._profiler_enabled() reads False on other threads).
PROFILER_FLAG = "_is_profiler_enabled"


class Span(NamedTuple):
    """One recorded span. ``parent`` is the ``id`` of the span that enclosed
    it on its thread, None for a thread's outermost span, whose parent is
    the job."""

    id: int
    name: str
    start_ns: int  # time.perf_counter_ns()
    end_ns: int
    thread: int  # threading.get_native_id()
    thread_ident: int  # threading.get_ident(), the pthread id
    thread_name: str
    job: object  # the JobID, shared by every span of one job
    parent: Optional[int]
    attrs: dict


class _Open:
    """A span being timed; the context :func:`span` returns while recording."""

    __slots__ = ("name", "job", "attrs", "id", "parent", "start_ns")

    def __init__(self, name: str, job):
        self.name, self.job, self.attrs = name, job, None

    def set(self, key: str, value) -> None:
        """Attach an attribute (kept in ``Span.attrs``)."""
        if self.attrs is None:
            self.attrs = {}
        self.attrs[key] = value

    def _start(self) -> None:
        stack = _stack()
        outer = stack[-1] if stack else None
        self.parent = None if outer is None else outer.id
        if self.job is None and outer is not None:
            self.job = outer.job
        self.id = _begin()
        self.start_ns = time.perf_counter_ns()

    def __enter__(self):
        self._start()
        _stack().append(self)
        return self

    def __exit__(self, *exc) -> bool:
        end = time.perf_counter_ns()
        _stack().pop()
        self._keep(end)
        return False

    def _keep(self, end: int) -> None:
        t = threading.current_thread()
        _SPANS.append(Span(self.id, self.name, self.start_ns, end, t.native_id, t.ident, t.name, self.job,
                           self.parent, self.attrs or {}))


class _Held(_Open):
    """A span opened when it is made and recorded by :meth:`close`; each
    ``with`` block on it makes it the enclosing span of the spans opened
    inside, on its thread."""

    __slots__ = ()

    def __init__(self, name: str, job):
        super().__init__(name, job)
        self._start()

    def __enter__(self):
        _stack().append(self)
        return self

    def __exit__(self, *exc) -> bool:
        _stack().pop()
        return False

    def close(self) -> None:
        """Record the span, from when it was made to now."""
        self._keep(time.perf_counter_ns())


class _Off:
    """The shared context a span site gets outside a profiler window."""

    __slots__ = ()

    def set(self, key: str, value) -> None:
        pass

    def close(self) -> None:
        pass

    def __bool__(self) -> bool:
        return False

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()
_SPANS: list = []
_LOCAL = threading.local()
_ids = itertools.count()
_offset_ns: Optional[int] = None


def _stack() -> list:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


def _begin() -> int:
    """A new span's id; the first span after :func:`clear` also takes the
    clock offset (two threads that both take it get the same value)."""
    global _offset_ns
    if _offset_ns is None:
        _offset_ns = _measure_offset()
    return next(_ids)


def _measure_offset(pairs: int = 5) -> int:
    """``time.time_ns() - time.perf_counter_ns()`` from the tightest of a
    few back-to-back readings."""
    best = None
    for _ in range(pairs):
        a = time.perf_counter_ns()
        wall = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, wall - (a + b) // 2)
    return best[1]


def span(name: str, job=None):
    """A context manager timing its block as the span ``name`` of ``job``
    (by default the job of the enclosing span on this thread). The context
    it yields takes attributes with ``.set(key, value)`` and is false
    outside a profiler window, where nothing is recorded."""
    if not getattr(_profiler, PROFILER_FLAG, False):
        return _OFF
    return _Open(name, job)


def held(name: str, job=None):
    """The span ``name`` of ``job`` (by default the job of the enclosing
    span on this thread), from now to its ``.close()``, for work that
    overlaps the next span of its name on the same thread: a unit still in
    flight while the next is queued. Each ``with`` block on it, of which
    there may be several, makes it the parent of the spans opened inside.
    It takes attributes with ``.set(key, value)``; outside a profiler window
    it is the shared context that records nothing."""
    if not getattr(_profiler, PROFILER_FLAG, False):
        return _OFF
    return _Held(name, job)


def stamp() -> Optional[int]:
    """The start of a span that :func:`record` ends, perhaps on another
    thread: the clock while recording, else None."""
    return time.perf_counter_ns() if getattr(_profiler, PROFILER_FLAG, False) else None


def record(name: str, start_ns: Optional[int], job=None) -> None:
    """Record the span ``name`` from ``start_ns`` (:func:`stamp`) to now on
    this thread; nothing where the stamp is None or no window is open."""
    if start_ns is None or not getattr(_profiler, PROFILER_FLAG, False):
        return
    end = time.perf_counter_ns()
    stack = _stack()
    outer = stack[-1] if stack else None
    if job is None and outer is not None:
        job = outer.job
    t = threading.current_thread()
    _SPANS.append(Span(_begin(), name, start_ns, end, t.native_id, t.ident, t.name, job,
                       None if outer is None else outer.id, {}))


def spans() -> list:
    """The spans recorded since :func:`clear`, each as it ended."""
    return list(_SPANS)


def clear() -> None:
    """Forget the recorded spans; the next span measures the clock offset
    again."""
    global _offset_ns
    _SPANS.clear()
    _offset_ns = None


def clock_offset_ns() -> Optional[int]:
    """What to add to a span's ``perf_counter_ns`` times to get the Unix-epoch
    nanoseconds of the profiler's host events; None before the first span."""
    return _offset_ns


def _track(s: Span, used: set) -> int:
    """The tid of ``s``'s thread in a trace whose events use the tids
    ``used``: its native id where the profiler recorded the thread's host
    events, else the tid under which the profiler put the thread's CUDA
    runtime calls (the low 32 bits of its pthread id as a signed number,
    without the sign, in torch 2.11), else its native id."""
    low = s.thread_ident & 0xFFFFFFFF
    signed = low - (1 << 32) if low >= 1 << 31 else low
    return next((tid for tid in (s.thread, abs(signed), signed, low) if tid in used), s.thread)


def _write_spans(path: str, recorded: list) -> None:
    """Add ``recorded`` to the Chrome trace at ``path``: complete events on
    their threads' tracks, moved onto the trace's clock (the profiler
    writes microseconds from its ``baseTimeNanoseconds``)."""
    if not recorded or _offset_ns is None:
        return
    with open(path) as f:
        doc = json.load(f)
    events = doc.setdefault("traceEvents", [])
    pid = os.getpid()
    shift = _offset_ns - int(doc.get("baseTimeNanoseconds", 0))
    used = {e.get("tid") for e in events if e.get("ph") == "X"}
    named = {e.get("tid") for e in events if e.get("ph") == "M" and e.get("name") == "thread_name"}
    tracks = {}
    for s in recorded:
        tid = tracks.setdefault(s.thread, _track(s, used))
        if tid not in named:
            named.add(tid)
            events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid, "args": {"name": s.thread_name}})
        args = {"span": s.id, "parent": s.parent, "job": None if s.job is None else str(s.job), **s.attrs}
        events.append({"ph": "X", "cat": "flux", "name": s.name, "pid": pid, "tid": tid,
                       "ts": (s.start_ns + shift) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3, "args": args})
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of everything inside the block:
    host operations, and on a CUDA card the kernels and copies of every
    thread of the process (CUPTI sees the megakernels, which are launched
    through ctypes and not through PyTorch), with the program's spans on
    the threads that ran them. Writes ``<log_dir>/trace-<pid>-<ms>.json``
    (Chrome trace format) when the block ends; yields the profiler, whose
    ``trace_path`` is set then."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.trace_path = None
    clear()
    with prof:
        yield prof
    path = os.path.join(log_dir, f"trace-{os.getpid()}-{int(time.time() * 1000)}.json")
    prof.export_chrome_trace(path)
    _write_spans(path, spans())
    prof.trace_path = path
