"""Execution backends: the local worker and the network worker
(``flux_tpu/workers.py``; fluxcore/src/workers.rs).

``LocalWorker`` renders on this process's devices, CUDA cards or the CPU
(the rayon-pool replacement, workers.rs:25-88; several make a device
mesh, ``parallel/``): per job it builds a renderer through its factory
and pulls work units from the shared queue until it is drained. On one
device its default factory keeps the :class:`~flux_tpu_torch.render.SceneState`
of the last scene it rendered, for the worker's lifetime: a job whose scene
compares equal, with the same ``nee``, renders on it, so the scene is
compiled and its device tables packed and copied once, not once a job;
any other job builds a new state, which replaces it. ``NetworkWorker`` proxies the same pull loop to a
remote render node over TCP (workers.rs:105-243), keeping the reference's
pipeline depth of 2 — two units are in flight before the first result is
awaited (workers.rs:161-201) — so that the link and the remote card
overlap. The node may run either package: the frames are the same
(``wire.py``).
"""

from __future__ import annotations

import queue
import socket
import threading
from typing import Callable

from .constants import DEFAULT_PORT
from .debug import d_println
from .job import Job
from .manager import (
    JobFailed,
    RowsReady,
    WorkerHandle,
    WorkerInfo,
    WorkUnitResult,
)
from . import wire
from .metrics import held, record, span
from .render import SceneState, resolve_device

__all__ = ["KeptScene", "LocalWorker", "NetworkWorker", "default_renderer_factory"]


class _NodeJobError(Exception):
    """The node reported it cannot render this job; the connection itself is
    still synchronized (a clean job_error frame), so the worker survives and
    the lost units go to the manager's retry round."""


class KeptScene:
    """The scene state of the last job a worker rendered on one device: one
    entry, kept until a job of another scene, device, ``accel`` or ``nee``
    replaces it. ``reused`` says whether the last :meth:`get` found it."""

    def __init__(self):
        self.state = None
        self.reused = False

    def get(self, scene_data, device=None, accel=None, nee=False):
        """The kept :class:`~flux_tpu_torch.render.SceneState` where it
        matches, else a new one, kept in its place once it is built (a build
        that raises keeps the old one)."""
        self.reused = self.state is not None and self.state.matches(scene_data, device, accel, nee)
        if not self.reused:
            self.state = SceneState.build(scene_data, device, accel, nee)
        return self.state


def default_renderer_factory(job: Job, device=None, accel=None, devices=None, kept: KeptScene = None):
    """The renderer for ``job`` with its sample root, depth, seed and
    estimator: the port's single-device
    :class:`~flux_tpu_torch.render.Renderer` on ``device`` (the CUDA card
    unless the caller names the CPU), built on ``kept``'s scene state where
    one is given, or, where ``devices`` lists more than one, a
    :class:`~flux_tpu_torch.parallel.MeshRenderer` over them, its shape
    picked from the frame (sample shards, rows where the frame is tall;
    ``flux_tpu/workers.py``)."""
    from .render import Renderer

    devs = list(devices) if devices is not None else [device]
    if len(devs) > 1:
        from .parallel import MeshRenderer, make_mesh

        out = job.scene_data.output_settings
        return MeshRenderer(
            job.scene_data,
            sample_root=job.config.sample_root,
            max_depth=job.config.max_trace_depth,
            seed=job.config.seed,
            mesh=make_mesh(devs, rows_shards=None, n_rows_hint=out.image_height, n_cols_hint=out.image_width),
            accel=accel,
            nee=job.config.nee,
            physical=job.config.physical,
        )
    return Renderer(
        job.scene_data,
        sample_root=job.config.sample_root,
        max_depth=job.config.max_trace_depth,
        seed=job.config.seed,
        device=devs[0],
        accel=accel,
        nee=job.config.nee,
        physical=job.config.physical,
        state=None if kept is None else kept.get(job.scene_data, devs[0], accel, job.config.nee),
    )


class LocalWorker:
    """Pulls work units and renders them on the local devices
    (workers.rs:25-88). Each job gets a renderer of its own; on one device
    with the default factory, the renderers of consecutive jobs of one scene
    share its scene state (:class:`KeptScene`). On a CUDA card a renderer
    that splits its render (``queue_rows``, ``wait_rows``) has the next
    unit's kernel queued while the host reads back and delivers a unit; any
    other renders one unit at a time."""

    def __init__(self, renderer_factory: Callable[[Job], object] = None, name="local",
                 device=None, devices=None):
        """``devices`` are the devices the factory renders on, which
        ``info`` reports; by default ``[device]`` (the CUDA card unless the
        CPU is named). The default factory is
        :func:`default_renderer_factory` on them, on one device with the
        worker's :class:`KeptScene`."""
        self.devices = [resolve_device(d) for d in devices] if devices else [resolve_device(device)]
        self.device = self.devices[0]
        self._kept = None
        if renderer_factory is None:
            if len(self.devices) == 1:
                self._kept = KeptScene()
                kw = {"device": self.device, "kept": self._kept}
            else:
                kw = {"devices": self.devices}

            def renderer_factory(job):
                return default_renderer_factory(job, **kw)

        self._factory = renderer_factory
        self._requests: "queue.Queue" = queue.Queue()
        self._handle = WorkerHandle(self._requests, name=name)
        self._busy = threading.Event()
        self.units_done = 0  # units rendered and sent, over every job
        self._thread = threading.Thread(
            target=self._run, name=f"LocalWorker[{name}]", daemon=True
        )
        self._thread.start()

    def handle(self) -> WorkerHandle:
        return self._handle

    @property
    def busy(self) -> bool:
        """True while a job is being rendered (node-status reporting)."""
        return self._busy.is_set()

    @property
    def queued_jobs(self) -> int:
        """Job requests waiting behind the active one (approximate)."""
        return self._requests.qsize()

    def info(self) -> WorkerInfo:
        """The devices the factory renders on, and their type: ``"cuda"``
        or ``"cpu"``."""
        return WorkerInfo(num_devices=len(self.devices), platform=self.device.type, description="local")

    def _run(self) -> None:
        while True:
            req = self._requests.get()
            if req is None:
                d_println("LocalWorker: shutting down")
                return
            job, unit_queue, sink, wg, sent = req
            record("worker.queue_wait", sent, job.id)
            d_println(f"LocalWorker: got job {job.id}")
            self._busy.set()
            try:
                with span("worker.renderer_build", job.id) as sp:
                    renderer = self._factory(job)
                    sp.set("reused", self._kept is not None and self._kept.reused)
                self._render(job, renderer, unit_queue, sink)
            except Exception as e:
                # Keep serving future jobs (the manager retries lost units);
                # the reference would panic the whole process here
                # (manager.rs:158-161). The failure goes into the event
                # stream so remote masters hear about it (node.py forwards
                # it as a job_error frame). Deliberately do NOT drain the
                # unit queue: the manager's SchedulerRound is pull-based
                # (no producer to unblock), so stopping our pulls leaves
                # every unclaimed unit for the surviving workers instead of
                # discarding them into the retry round.
                d_println(f"LocalWorker: job {job.id} failed: {e!r}")
                try:
                    sink.put(
                        JobFailed(
                            reason=f"{type(e).__name__}: {e}",
                            worker=self._handle.uid,
                        )
                    )
                except Exception:
                    pass
            finally:
                self._busy.clear()
                wg.done()

    def _render(self, job: Job, renderer, unit_queue, sink) -> None:
        """The units of a job, delivered in the order they were pulled. A
        renderer that queues ahead (:func:`_queues_ahead`) holds one unit in
        flight: the next is pulled and its kernel queued before the host
        waits on the held unit's copy and delivers it, so that the card runs
        one unit while the host reads back, delivers and pulls around it
        (``NetworkWorker``'s depth of 2). The next unit is taken ahead only
        where the queue hands it over without waiting, since a node's queue
        may wait on the very rows held; else the held unit is delivered
        first. Where queueing a unit raises, the held one is delivered
        first. Any other renderer renders each unit and delivers it before
        the next pull. A unit's ``worker.unit`` span runs from its pull to
        its delivery, so that those of consecutive units may overlap;
        ``ahead`` says whether the unit was queued while the one before it
        was still in flight."""
        ahead = _queues_ahead(renderer)

        def deliver(unit, sp, pending) -> None:
            with sp:
                if ahead:
                    with span("unit.wait"):
                        pending = renderer.wait_rows(pending)
                with span("unit.deliver"):
                    sink.put(RowsReady(WorkUnitResult(work_unit=unit, rows=pending)))
            sp.close()
            self.units_done += 1

        in_flight = None  # (unit, its span, its handle): queued, not yet delivered
        try:
            while True:
                unit = _NOT_READY
                if in_flight is not None:
                    with span("sched.pull", job.id):
                        unit = _pull_ready(unit_queue)
                    if unit is _NOT_READY:
                        before, in_flight = in_flight, None
                        deliver(*before)
                if unit is _NOT_READY:
                    with span("sched.pull", job.id):
                        unit = unit_queue.get()
                if unit is None:
                    return
                sp = held("worker.unit", job.id)
                sp.set("row_start", unit.row_start)
                sp.set("rows", unit.num_rows)
                sp.set("ahead", in_flight is not None)
                d_println(f"LocalWorker: rendering {unit}")
                with sp:
                    if ahead:
                        pending = renderer.queue_rows(unit.row_start, unit.num_rows)
                    else:
                        pending = renderer.render_rows(unit.row_start, unit.num_rows)
                before, in_flight = in_flight, (unit, sp, pending)
                if not ahead:
                    before, in_flight = in_flight, None
                if before is not None:
                    deliver(*before)
        finally:
            if in_flight is not None:
                deliver(*in_flight)

    def stop(self) -> None:
        self._handle.send_stop()
        self._thread.join(timeout=30)


_NOT_READY = object()  # what _pull_ready gives where no unit is there yet


def _pull_ready(unit_queue):
    """The next unit of ``unit_queue`` (None where it is drained), or
    ``_NOT_READY`` where none is there yet: nothing here waits."""
    try:
        return unit_queue.get_nowait()
    except queue.Empty:
        return _NOT_READY


def _queues_ahead(renderer) -> bool:
    """True where a worker queues a unit before it delivers the one before:
    the renderer splits its render into ``queue_rows`` and ``wait_rows`` and
    renders on a CUDA card, whose launches return before the kernel ends. A
    mesh, a renderer with ``render_rows`` alone and any renderer on the CPU,
    whose render has ended when it returns, take one unit at a time."""
    device = getattr(renderer, "device", None)
    return (hasattr(renderer, "queue_rows") and hasattr(renderer, "wait_rows")
            and getattr(device, "type", None) == "cuda")


class NetworkWorker:
    """TCP proxy worker: ships the job to a remote node and pipelines work
    units over the link (workers.rs:118-243).

    Connects eagerly and performs the WorkerInfo handshake in the
    constructor, like the reference (workers.rs:126-143); raises on failure
    (the CLI exits, flux/src/main.rs:54-57).
    """

    PIPELINE_DEPTH = 2  # workers.rs:161-175

    def __init__(self, endpoint: str, connect_timeout: float = 10.0, io_timeout: float = None):
        """``io_timeout``: seconds a send or a wait for a result may take
        before the link is given up (None: no limit, as a long unit may
        take long)."""
        host, _, port = endpoint.partition(":")
        self.endpoint = endpoint
        self._sock = socket.create_connection(
            (host, int(port) if port else DEFAULT_PORT), timeout=connect_timeout
        )
        hello = wire.recv_msg(self._sock)  # within connect_timeout
        if hello.get("type") != "worker_info":
            raise RuntimeError(f"bad handshake from {endpoint}: {hello!r}")
        self._sock.settimeout(io_timeout)
        self._info = WorkerInfo(
            num_devices=int(hello.get("num_devices", 1)),
            platform=str(hello.get("platform", "remote")),
            description=f"node {endpoint}",
        )
        self.units_done = 0  # units whose rows came back, over every job
        self._requests: "queue.Queue" = queue.Queue()
        self._handle = WorkerHandle(self._requests, name=f"net:{endpoint}")
        self._thread = threading.Thread(
            target=self._run, name=f"NetworkWorker[{endpoint}]", daemon=True
        )
        self._thread.start()

    def handle(self) -> WorkerHandle:
        return self._handle

    def info(self) -> WorkerInfo:
        return self._info

    def _run(self) -> None:
        while True:
            req = self._requests.get()
            if req is None:
                try:
                    wire.send_msg(self._sock, {"type": "shutdown"})
                    self._sock.close()
                except OSError:
                    pass
                return
            job, unit_queue, sink, wg, _ = req
            try:
                self._run_job(job, unit_queue, sink)
            except _NodeJobError as e:
                # Clean failure frame: the socket is still synchronized and
                # the node sends no more rows for this job. Stop pulling —
                # unclaimed units stay in the round for surviving workers
                # (SchedulerRound is pull-based; nothing needs draining).
                d_println(f"NetworkWorker[{self.endpoint}]: node job error: {e}")
                try:
                    sink.put(JobFailed(reason=str(e), worker=self._handle.uid))
                except Exception:
                    pass
                try:
                    wire.send_msg(self._sock, {"type": "done"})
                except OSError:
                    self._handle.mark_dead()
            except Exception as e:
                d_println(f"NetworkWorker[{self.endpoint}]: job failed: {e!r}")
                # Any mid-protocol exception leaves the byte stream in an
                # unknown state (stale frames would corrupt the next job);
                # always retire the connection. Unclaimed units stay in the
                # round for surviving workers.
                self._handle.mark_dead()
            finally:
                wg.done()
                if not self._handle.alive:
                    return

    def _run_job(self, job: Job, unit_queue, sink) -> None:
        sock = self._sock
        wire.send_msg(
            sock,
            # caps advertises what result encodings this master can decode
            # (the node only deflates row blocks when it sees zlib-rows).
            {"type": "set_job", "job": job.to_dict(), "caps": ["zlib-rows"]},
        )

        def send_unit(u) -> None:
            wire.send_msg(
                sock,
                {"type": "work_unit", "row_start": u.row_start, "row_end": u.row_end},
            )

        width = job.scene_data.output_settings.image_width

        def recv_result(expect: dict) -> None:
            msg = wire.recv_msg(sock)
            if msg.get("type") == "job_error":
                raise _NodeJobError(msg.get("reason", "unknown node error"))
            if msg.get("type") != "rows_ready":
                raise RuntimeError(f"unexpected node message: {msg.get('type')!r}")
            u = expect.pop(msg["row_start"])
            rows = wire.decode_rows(msg)
            # Validate before the frame reaches the ImageBuilder: a
            # truncated/mis-shaped block from a buggy node must turn into a
            # clean job error (→ the manager retries the unit elsewhere),
            # not a corrupted image. The frame itself decoded fine, so the
            # byte stream is still synchronized — _NodeJobError keeps the
            # connection for future jobs.
            shape = rows.shape
            if shape[1:] != (width, 3) or shape[0] > u.num_rows:
                raise _NodeJobError(
                    f"malformed rows_ready frame for unit {u.row_start}: "
                    f"shape {shape}, expected ({u.num_rows}, {width}, 3)"
                )
            sink.put(RowsReady(WorkUnitResult(work_unit=u, rows=rows)))
            self.units_done += 1

        in_flight: dict = {}
        # Prime the pipeline (workers.rs:161-175).
        for _ in range(self.PIPELINE_DEPTH):
            u = unit_queue.get()
            if u is None:
                # Fewer units than pipeline depth; drain and finish.
                for _ in range(len(in_flight)):
                    recv_result(in_flight)
                wire.send_msg(sock, {"type": "done"})
                return
            send_unit(u)
            in_flight[u.row_start] = u

        # Lock-step: one result in, one unit out (workers.rs:179-201).
        while True:
            u = unit_queue.get()
            if u is None:
                break
            recv_result(in_flight)
            send_unit(u)
            in_flight[u.row_start] = u

        # Drain outstanding results (workers.rs:203-222).
        while in_flight:
            recv_result(in_flight)
        wire.send_msg(sock, {"type": "done"})

    def stop(self) -> None:
        self._handle.send_stop()
        self._thread.join(timeout=30)
