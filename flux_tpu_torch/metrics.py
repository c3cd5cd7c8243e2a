"""Metrics, progress reporting and profiling hooks (``flux_tpu/metrics.py``).

The reference's observability is ``d_println`` timestamps plus wall-clock
prints from the event sinks. Here the same event stream (``manager.py``)
feeds a structured :class:`ProgressReporter` — rows done, sample
throughput, ETA — and :func:`profile_trace` wraps ``torch.profiler`` so that
a render can be captured as a Chrome trace (Perfetto readable) without
touching renderer code.
"""

from __future__ import annotations

import contextlib
import os
import queue
import threading
import time

import numpy as np
from dataclasses import dataclass
from typing import Optional

from .manager import ImageInfo, RenderingFinished, RenderingStarted, RowsReady

__all__ = ["RenderStats", "ProgressReporter", "profile_trace"]


@dataclass
class RenderStats:
    """Aggregated statistics of one render job."""

    scene_name: str = ""
    width: int = 0
    height: int = 0
    sample_root: int = 0
    rows_done: int = 0
    units_done: int = 0
    start_monotonic: Optional[float] = None
    end_monotonic: Optional[float] = None

    @property
    def duration(self) -> Optional[float]:
        if self.start_monotonic is None:
            return None
        end = self.end_monotonic if self.end_monotonic is not None else time.monotonic()
        return end - self.start_monotonic

    @property
    def fraction_done(self) -> float:
        return self.rows_done / self.height if self.height else 0.0

    def samples_per_sec(self) -> Optional[float]:
        """Primary-sample throughput so far (needs sample_root)."""
        d = self.duration
        if not d or not self.sample_root:
            return None
        return self.rows_done * self.width * self.sample_root**2 / d

    def eta_seconds(self) -> Optional[float]:
        d = self.duration
        if not d or not self.rows_done or not self.height:
            return None
        return d * (self.height - self.rows_done) / self.rows_done


class ProgressReporter:
    """Event sink computing live throughput/ETA; optionally prints a line
    per work unit (the structured upgrade of ConsoleResultReporter)."""

    def __init__(self, sample_root: int = 0, print_progress: bool = False):
        self.stats = RenderStats(sample_root=sample_root)
        self._print = print_progress
        self._q: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._run, name="ProgressReporter", daemon=True)
        self._thread.start()

    def sender(self) -> "queue.Queue":
        return self._q

    def snapshot(self) -> RenderStats:
        with self._lock:
            return RenderStats(**vars(self.stats))

    def _run(self) -> None:
        while True:
            ev = self._q.get()
            if ev is None:
                return
            with self._lock:
                s = self.stats
                if isinstance(ev, ImageInfo):
                    s.scene_name, s.width, s.height = ev.scene_name, ev.width, ev.height
                    s.rows_done = s.units_done = 0
                    s.start_monotonic = s.end_monotonic = None
                elif isinstance(ev, RenderingStarted):
                    s.start_monotonic = ev.monotonic
                elif isinstance(ev, RowsReady):
                    # Count only FULL blocks (a short block from a dying
                    # node is retried, and counting it would double rows).
                    # Short blocks are retried, so counting them would also
                    # double-count the unit when the full retry lands.
                    if (
                        np.shape(ev.result.rows)[0]
                        == ev.result.work_unit.num_rows
                    ):
                        s.rows_done += ev.result.work_unit.num_rows
                        s.units_done += 1
                    if self._print:
                        sps = s.samples_per_sec()
                        eta = s.eta_seconds()
                        extra = ""
                        if sps:
                            extra = f", {sps / 1e6:.1f} Msamples/s"
                        if eta is not None:
                            extra += f", ETA {eta:.1f}s"
                        print(
                            f"progress: {s.rows_done}/{s.height} rows"
                            f" ({100 * s.fraction_done:.0f}%){extra}"
                        )
                elif isinstance(ev, RenderingFinished):
                    s.end_monotonic = ev.monotonic

    def stop(self) -> None:
        self._q.put(None)
        self._thread.join(timeout=10)


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of everything inside the block:
    host operations, and on a CUDA card the kernels and copies of every
    thread of the process (CUPTI sees the megakernels, which are launched
    through ctypes and not through PyTorch). Writes
    ``<log_dir>/trace-<pid>-<ms>.json`` (Chrome trace format) when the
    block ends; yields the profiler, whose ``trace_path`` is set then."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.trace_path = None
    with prof:
        yield prof
    path = os.path.join(log_dir, f"trace-{os.getpid()}-{int(time.time() * 1000)}.json")
    prof.export_chrome_trace(path)
    prof.trace_path = path
