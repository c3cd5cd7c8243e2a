"""Render scheduling: job queue, work-unit distribution, events, sinks
(``flux_tpu/manager.py``; fluxcore/src/manager.rs).

The structure of the reference is kept: a scheduler thread per manager, a
*pull-based* shared work-unit queue with capacity 1 as the dynamic load
balancer (manager.rs:100,120-141), a cancel listener draining the unit
iterator (manager.rs:365-393), an event stream with pluggable sinks
(``ConsoleResultReporter``, ``ImageBuilder``; manager.rs:238-363), and a
barrier released when every worker finishes its pulls. A worker drives the
megakernels on a CUDA card, or their plain version on the CPU
(``workers.py``), and the events carry numpy row blocks. Event types,
classes and their fields are ``flux_tpu.manager``'s.

Deviations from the reference, as in ``flux_tpu``:

* A dead worker raises an error on the scheduler thread but the manager
  survives, and the units it lost are retried on the others; the reference
  panics the whole process (manager.rs:158-161).
* ``ImageBuilder`` handles any number of sequential jobs; the reference's
  builder thread exits on a second ImageInfo (manager.rs:291-299).
* Events carry wall-clock *and* monotonic timestamps.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from .debug import d_println
from .image import Image, write_png, write_ppm
from .job import Job, JobConfiguration, JobID, JobIDAllocator, WorkUnit
from .metrics import record, stamp
from .scene import SceneData

__all__ = [
    "RenderEvent",
    "ImageInfo",
    "RenderingStarted",
    "WorkUnitResult",
    "RowsReady",
    "RenderingFinished",
    "JobFailed",
    "WaitGroup",
    "WorkerHandle",
    "WorkerInfo",
    "JobHandle",
    "RenderManager",
    "ConsoleResultReporter",
    "ImageBuilder",
    "MultiSink",
]


# ---------------------------------------------------------------------------
# Events (manager.rs:16-27)


@dataclass(frozen=True)
class ImageInfo:
    scene_name: str
    width: int
    height: int


@dataclass(frozen=True)
class RenderingStarted:
    job_id: JobID
    start_time: float  # wall clock (s since epoch)
    monotonic: float


@dataclass(frozen=True)
class WorkUnitResult:
    work_unit: WorkUnit
    rows: np.ndarray  # (num_rows, width, 3) float32, final pixels


@dataclass(frozen=True)
class RowsReady:
    result: WorkUnitResult


@dataclass(frozen=True)
class RenderingFinished:
    end_time: float
    monotonic: float


@dataclass(frozen=True)
class JobFailed:
    """A worker could not render this job (emitted into the event stream so
    remote masters hear about node-side failures; see node.py). The
    reference has no failure reporting — a dead worker panics the whole
    master process (manager.rs:158-161). ``worker`` identifies the failing
    worker so retry rounds can route around it (empty when unknown, e.g. a
    node-side report relayed over the wire)."""

    reason: str
    worker: str = ""


RenderEvent = object  # union of the five dataclasses above


# ---------------------------------------------------------------------------
# Synchronization


class WaitGroup:
    """Counter barrier (crossbeam WaitGroup analog, manager.rs:101)."""

    def __init__(self):
        self._count = 0
        self._cond = threading.Condition()

    def add(self, n: int = 1) -> None:
        with self._cond:
            self._count += n

    def done(self) -> None:
        with self._cond:
            self._count -= 1
            if self._count <= 0:
                self._cond.notify_all()

    def wait(self, timeout: Optional[float] = None) -> bool:
        with self._cond:
            return self._cond.wait_for(lambda: self._count <= 0, timeout=timeout)


@dataclass(frozen=True)
class WorkerInfo:
    """Worker capability report (manager.rs:221-230); threads become
    devices, and ``platform`` is ``"cuda"`` or ``"cpu"``."""

    num_devices: int
    platform: str = "unknown"
    description: str = ""


class WorkerHandle:
    """Typed sender of work requests to a worker loop (manager.rs:38-53).

    A request is ``None`` (shutdown) or ``(job, unit_queue, event_sink,
    waitgroup, sent)``; the worker pulls WorkUnits from ``unit_queue`` until
    it yields ``None``. ``sent`` is the :func:`~flux_tpu_torch.metrics.stamp`
    of the send, which starts the worker's ``worker.queue_wait`` span.
    """

    _uid_seq = itertools.count()

    def __init__(self, request_queue: "queue.Queue", name: str = "worker"):
        self._q = request_queue
        self.name = name
        # Failure attribution key. Display names can collide (two
        # NetworkWorkers against the same endpoint label), and routing
        # retries by name would blacklist a healthy namesake alongside its
        # failed twin — so events carry this unique token instead.
        self.uid = f"{name}#{next(WorkerHandle._uid_seq)}"
        self._dead = threading.Event()

    def send(self, job: Job, unit_queue, event_sink, wg: WaitGroup) -> None:
        if self._dead.is_set():
            raise RuntimeError(f"worker {self.name} is stopped")
        self._q.put((job, unit_queue, event_sink, wg, stamp()))

    def send_stop(self) -> None:
        self._dead.set()
        self._q.put(None)

    def mark_dead(self) -> None:
        """Workers call this on unrecoverable failure (e.g. a dropped node
        connection); the manager stops dispatching to this handle."""
        self._dead.set()

    @property
    def alive(self) -> bool:
        return not self._dead.is_set()


# ---------------------------------------------------------------------------
# Job handle (manager.rs:55-70)


class JobHandle:
    def __init__(self, job_id: JobID, done: threading.Event, cancel: threading.Event):
        self.job_id = job_id
        self._done = done
        self._cancel = cancel
        self.error: Optional[str] = None  # set before done when the job failed
        # Retry rounds the job needed, and the units they re-dispatched.
        self.retry_rounds = 0
        self.retried_units = 0

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    def cancel(self) -> None:
        d_println(f"Job cancellation request for {self.job_id}")
        self._cancel.set()

    def done(self) -> bool:
        return self._done.is_set()

    @property
    def ok(self) -> bool:
        """True iff the job finished without a reported failure."""
        return self._done.is_set() and self.error is None


# ---------------------------------------------------------------------------
# Event sinks


class MultiSink:
    """Fan one event stream out to several sinks (queue-alikes with put)."""

    def __init__(self, sinks: Sequence):
        self._sinks = list(sinks)

    def put(self, item) -> None:
        for s in self._sinks:
            s.put(item)


class ConsoleResultReporter:
    """Prints a line per event (manager.rs:238-276)."""

    def __init__(self):
        self._q: "queue.Queue" = queue.Queue()
        self._thread = threading.Thread(
            target=self._run, name="ConsoleResultReporter", daemon=True
        )
        self._thread.start()

    def sender(self) -> "queue.Queue":
        return self._q

    def _run(self) -> None:
        while True:
            ev = self._q.get()
            if ev is None:
                return
            if isinstance(ev, RenderingStarted):
                print(f"ConsoleResultReporter: job {ev.job_id} started")
            elif isinstance(ev, ImageInfo):
                print(f"ConsoleResultReporter: scene: {ev.scene_name}")
                print(f"ConsoleResultReporter: image {ev.width} x {ev.height} pixels")
            elif isinstance(ev, RowsReady):
                n = int(np.shape(ev.result.rows)[0])
                print(f"ConsoleResultReporter: image fragment done, {n} rows")
            elif isinstance(ev, JobFailed):
                print(f"ConsoleResultReporter: worker failed: {ev.reason}")
            elif isinstance(ev, RenderingFinished):
                print("ConsoleResultReporter: rendering finished")

    def stop(self) -> None:
        self._q.put(None)
        self._thread.join(timeout=5)


class ImageBuilder:
    """Accumulates RowsReady into an Image; writes ``{scene}.ppm`` (and
    optionally ``.png``) at RenderingFinished (manager.rs:278-363)."""

    def __init__(self, output_dir: str = ".", write_png_too: bool = False,
                 filename: Optional[str] = None):
        self._q: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self._image: Optional[Image] = None
        self._scene_name = ""
        self._start_mono: Optional[float] = None
        self.last_duration: Optional[float] = None
        self.last_path: Optional[str] = None
        self._output_dir = output_dir
        self._write_png = write_png_too
        self._filename = filename
        self._finished = threading.Event()
        self._thread = threading.Thread(target=self._run, name="ImageBuilder", daemon=True)
        self._thread.start()

    def sender(self) -> "queue.Queue":
        return self._q

    def get_image(self) -> Optional[Image]:
        """Snapshot of the in-progress image (live preview polls this, the
        SDL path of flux/src/main.rs:249-283)."""
        with self._lock:
            return self._image

    def wait_finished(self, timeout: Optional[float] = None) -> bool:
        return self._finished.wait(timeout)

    def _run(self) -> None:
        import os

        while True:
            ev = self._q.get()
            if ev is None:
                return
            if isinstance(ev, ImageInfo):
                with self._lock:
                    self._image = Image(ev.width, ev.height)
                    self._scene_name = ev.scene_name
                self._finished.clear()
            elif isinstance(ev, RenderingStarted):
                self._start_mono = ev.monotonic
            elif isinstance(ev, RowsReady):
                with self._lock:
                    if self._image is not None:
                        try:
                            self._image.set_rows(
                                ev.result.work_unit.row_start, ev.result.rows
                            )
                        except ValueError as e:
                            # A malformed block must not kill the builder
                            # thread; the completion tracker leaves the unit
                            # in the retry set, so dropping it here is safe.
                            d_println(f"ImageBuilder: dropping bad rows: {e}")
            elif isinstance(ev, RenderingFinished):
                if self._start_mono is not None:
                    self.last_duration = ev.monotonic - self._start_mono
                    print(
                        f"rendering finished, total time "
                        f"{self.last_duration:.3f}s"
                    )
                with self._lock:
                    img = self._image
                if img is not None:
                    base = self._filename or (self._scene_name + ".ppm")
                    path = os.path.join(self._output_dir, base)
                    write_ppm(path, img)
                    self.last_path = path
                    if self._write_png:
                        write_png(path.rsplit(".", 1)[0] + ".png", img)
                self._finished.set()

    def stop(self) -> None:
        self._q.put(None)
        self._thread.join(timeout=30)


class _CompletionTracker:
    """Pass-through sink feeding the scheduler round's completion ledger —
    the bookkeeping behind lost-unit retry. ``round`` is swapped by the
    manager as dispatch rounds begin.

    A unit only counts as complete when the result actually contains its
    full row band: a short block (e.g. from a buggy or dying node) must
    leave the unit in the missing set for retry, not punch a silent hole
    in a "successful" image."""

    def __init__(self, sink, width=None):
        self._sink = sink
        self.round = None
        self.failed_workers = set()
        # The expected row width comes from the job at construction: the
        # ImageInfo event is emitted on the raw sink before this tracker
        # exists, so it can never arrive through put() below.
        self._width = width

    def put(self, ev) -> None:
        if isinstance(ev, ImageInfo):
            self._width = ev.width
        elif isinstance(ev, RowsReady) and self.round is not None:
            unit = ev.result.work_unit
            # The FULL shape must match, not just the row count: the
            # ImageBuilder drops wrong-width blocks, so counting one here
            # would punch a silent hole in a "successful" image.
            shape = np.shape(ev.result.rows)
            ok = shape[0] == unit.num_rows and (
                self._width is None or shape[1:] == (self._width, 3)
            )
            if ok:
                self.round.complete_row(unit.row_start)
        elif isinstance(ev, JobFailed) and ev.worker:
            self.failed_workers.add(ev.worker)
        self._sink.put(ev)


# ---------------------------------------------------------------------------
# The manager (manager.rs:72-219)


class RenderManager:
    def __init__(self, workers: List[WorkerHandle]):
        if not workers:
            raise ValueError("RenderManager: must provide at least one worker handle")
        self._workers = workers
        self._allocator = JobIDAllocator()
        self._job_queue: "queue.Queue" = queue.Queue()
        self._released = None  # stamp() of the last round's barrier release
        self._thread = threading.Thread(target=self._run, name="RenderManager", daemon=True)
        self._thread.start()

    # The scheduler loop: one job at a time, in submission order. Its spans:
    # manager.queue_wait (schedule_job's put to the take), manager.dispatch
    # (through the sends of each round) and manager.finish (a round's barrier
    # released, through the handle set done).
    def _run(self) -> None:
        d_println("Render manager: awaiting job")
        while True:
            item = self._job_queue.get()
            if item is None:
                d_println("Render manager: shutting down")
                return
            job, handle, cancel, sink, put = item
            record("manager.queue_wait", put, job.id)
            d_println(f"Render manager: got job {job.id}")
            self._released = None
            try:
                self._run_job(job, cancel, sink, handle)
            except Exception as e:  # worker failure — record it, serve on
                d_println(f"Render manager: job {job.id} failed: {e!r}")
                handle.error = f"{type(e).__name__}: {e}"
            handle._done.set()
            record("manager.finish", self._released, job.id)

    def _dispatch_round(self, job: Job, units, cancel, tracker, start=None) -> "SchedulerRound":
        """One pull-dispatch round over the currently-alive workers — the
        reference's bounded(1) shared queue + cancellable producer + barrier
        (manager.rs:100-166), run by ``sched.SchedulerRound`` on the native
        scheduler core (``csrc/fluxnative.cpp``). The round object is both
        the unit queue workers drain and the wait group the manager blocks
        on; the caller closes it once it has read ``missing()`` (no worker
        touches a round after its barrier is released). The round's
        ``manager.dispatch`` span runs from ``start`` (a
        :func:`~flux_tpu_torch.metrics.stamp`, by default this call's) through
        the sends."""
        from .sched import SchedulerRound

        start = stamp() if start is None else start

        workers = [w for w in self._workers if w.alive]
        if not workers:
            raise RuntimeError("no alive workers")
        # Retry rounds route around workers that already failed THIS job
        # (they would fail its retry the same way and can claim every
        # remaining unit before slower healthy workers pull any). If that
        # excludes everyone, fall back to all alive workers — the failure
        # may have been transient.
        healthy = [w for w in workers if w.uid not in tracker.failed_workers]
        if healthy:
            workers = healthy
        rnd = SchedulerRound(units, len(workers), cancel_event=cancel)
        tracker.round = rnd

        # A worker may die between the alive filter and the send (its link
        # thread marks it dead); release that worker's barrier slot and let
        # the survivors carry the round instead of aborting the job.
        sent = 0
        for w in workers:
            try:
                w.send(job, rnd, tracker, rnd)
                sent += 1
            except RuntimeError:
                rnd.done()
        record("manager.dispatch", start, job.id)
        if sent == 0:
            rnd.close()
            raise RuntimeError("no alive workers")

        d_println("Render manager: waiting for job completion or cancellation")
        rnd.wait()
        self._released = stamp()
        return rnd

    def _run_job(self, job: Job, cancel: threading.Event, sink, handle: JobHandle) -> None:
        start = stamp()
        sink.put(
            ImageInfo(
                scene_name=job.scene_data.scene_name,
                width=job.scene_data.output_settings.image_width,
                height=job.scene_data.output_settings.image_height,
            )
        )

        units = job.work_units()
        tracker = _CompletionTracker(
            sink, job.scene_data.output_settings.image_width
        )

        sink.put(
            RenderingStarted(
                job_id=job.id, start_time=time.time(), monotonic=time.monotonic()
            )
        )

        try:
            rnd = self._dispatch_round(job, units, cancel, tracker, start)

            # Fault tolerance the reference lacks (it panics on a dead
            # worker, manager.rs:158-161): units lost to failed workers are
            # re-dispatched to the survivors. Retry rounds continue as long
            # as each round makes strict progress (a persistently-failing
            # worker can pull-and-lose a few units per round; the healthy
            # workers still shrink the missing set every time); a round
            # with no progress ends the retries, which also guarantees
            # termination — the missing count strictly decreases otherwise.
            missing = rnd.missing()
            rnd.close()
            # A round where healthy workers complete exactly as many units
            # as a flaky worker newly loses is still forward progress
            # (the missing SET changed even though its size didn't), so
            # equal-size rounds get a bounded allowance instead of an
            # immediate abort; only the strict count decrease resets it,
            # which keeps termination guaranteed.
            stalled_rounds = 0
            while missing and not cancel.is_set():
                d_println(
                    f"Render manager: retrying {len(missing)} lost work units"
                )
                handle.retry_rounds += 1
                handle.retried_units += len(missing)
                rnd = self._dispatch_round(job, missing, cancel, tracker)
                still_missing = rnd.missing()
                rnd.close()
                if len(still_missing) < len(missing):
                    stalled_rounds = 0
                else:
                    stalled_rounds += 1
                missing = still_missing
                if stalled_rounds >= 2:
                    break
            if missing and not cancel.is_set():
                # Don't let a hole in the image masquerade as success.
                raise RuntimeError(
                    f"{len(missing)} work units lost after retry"
                )
        finally:
            d_println("Render manager: all workers done")
            sink.put(
                RenderingFinished(end_time=time.time(), monotonic=time.monotonic())
            )

    def schedule_job(
        self, scene_data: SceneData, config: JobConfiguration, result_sink
    ) -> JobHandle:
        job = Job(id=self._allocator.next_id(), scene_data=scene_data, config=config)
        done = threading.Event()
        cancel = threading.Event()
        handle = JobHandle(job.id, done, cancel)
        self._job_queue.put((job, handle, cancel, result_sink, stamp()))
        return handle

    def stop(self) -> None:
        self._job_queue.put(None)
        self._thread.join(timeout=30)
