"""The local worker's units two deep on the CPU: a fake renderer that offers
the split calls (``queue_rows``, ``wait_rows``) and reports a CUDA device
has the next unit queued before the one before it is waited on and
delivered; units arrive once each, in the order they were pulled; a unit
whose queueing raises leaves the one before it delivered and only itself
to the retry round; a cancelled job ends with the unit in hand delivered
and ``RenderingFinished`` last. A render node with such a renderer ends
its jobs, cancelled ones too: its unit queue waits on the master, so it
takes a unit ahead only where one is there already. A renderer on the CPU,
or one with ``render_rows`` alone, keeps one unit at a time.

This file imports neither JAX nor ``flux_tpu``. Every wait has a timeout."""

import contextlib
import queue
import socket
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from flux_tpu_torch.job import JobConfiguration
from flux_tpu_torch.manager import JobFailed, MultiSink, RenderingFinished, RenderManager, RowsReady
from flux_tpu_torch import node
from flux_tpu_torch import workers as workers_mod
from flux_tpu_torch.scene import loads_scene
from flux_tpu_torch.workers import LocalWorker, NetworkWorker

REPO = Path(__file__).resolve().parent.parent
WAIT = 60


def _scene(w=16, h=12):
    doc = yaml.safe_load((REPO / "scenes" / "demo2.yml").read_text())
    doc["output_settings"].update(image_width=w, image_height=h, pixel_size=0.5 * 800 / w)
    return loads_scene(yaml.safe_dump(doc))


def _rows(row0, n_rows, width):
    """The pixels the fakes render: each row's index over 256."""
    r = np.arange(row0, row0 + n_rows, dtype=np.float32)[:, None, None]
    return np.broadcast_to(r / 256, (n_rows, width, 3)).copy()


class Split:
    """A renderer with the split calls on ``device``, logging each call as
    ``(call, row0)``; queueing a unit whose ``row0`` is in ``fail`` raises
    and takes it out of the list (shared by the renderers of every round),
    and the first ``wait_rows`` sets ``waiting`` and waits for ``hold``."""

    def __init__(self, job, log, device="cuda", fail=(), hold=None, waiting=None):
        self.device = torch.device(device)
        self.width = job.scene_data.output_settings.image_width
        self.log, self.fail, self.hold, self.waiting = log, fail, hold, waiting

    def queue_rows(self, row0, n_rows):
        self.log.append(("queue", row0))
        if row0 in self.fail:
            self.fail.remove(row0)
            raise RuntimeError("injected launch failure")
        return row0, n_rows

    def wait_rows(self, pending):
        row0, n_rows = pending
        self.log.append(("wait", row0))
        if self.hold is not None and not self.waiting.is_set():
            self.waiting.set()
            assert self.hold.wait(WAIT)
        return _rows(row0, n_rows, self.width)

    def render_rows(self, row0, n_rows):
        self.log.append(("render", row0))
        return _rows(row0, n_rows, self.width)


class Whole:
    """A renderer with ``render_rows`` alone, on a CUDA device."""

    device = torch.device("cuda")

    def __init__(self, job, log):
        self.width = job.scene_data.output_settings.image_width
        self.log = log

    def render_rows(self, row0, n_rows):
        self.log.append(("render", row0))
        return _rows(row0, n_rows, self.width)


class Log(list):
    """The calls of a fake renderer and the sink's deliveries, in order."""

    def put(self, ev):
        if isinstance(ev, RowsReady):
            self.append(("deliver", ev.result.work_unit.row_start))


def _job(factory, cfg, log):
    """One job on a fresh manager and worker; returns (handle, events,
    worker)."""
    worker = LocalWorker(renderer_factory=factory, device="cpu")
    manager = RenderManager([worker.handle()])
    events = queue.Queue()
    try:
        handle = manager.schedule_job(_scene(), cfg, MultiSink([events, log]))
        assert handle.wait(timeout=WAIT), "the job did not end"
    finally:
        manager.stop()
        worker.stop()
    return handle, [events.get_nowait() for _ in range(events.qsize())], worker


def _delivered(evs):
    return [e.result.work_unit.row_start for e in evs if isinstance(e, RowsReady)]


def test_a_unit_is_queued_before_the_one_before_it_is_waited_on_and_delivered():
    log = Log()
    handle, evs, worker = _job(lambda job: Split(job, log), JobConfiguration(1, 1, 2), log)
    starts = list(range(0, 12, 2))
    assert handle.ok and handle.retry_rounds == 0 and worker.units_done == 6
    assert [r for c, r in log if c == "queue"] == starts
    assert _delivered(evs) == starts  # once each, in the order pulled
    at = {entry: i for i, entry in enumerate(log)}
    for before, unit in zip(starts, starts[1:]):
        assert at["queue", unit] < at["wait", before] < at["deliver", before] < at["wait", unit], log
    for e in evs:
        if isinstance(e, RowsReady):
            u = e.result.work_unit
            assert np.array_equal(e.result.rows, _rows(u.row_start, u.num_rows, 16))
    assert isinstance(evs[-1], RenderingFinished)


@pytest.mark.parametrize("make", [lambda job, log: Split(job, log, device="cpu"), Whole],
                         ids=["split calls on the CPU", "render_rows alone"])
def test_other_renderers_render_one_unit_at_a_time(make):
    log = Log()
    handle, evs, worker = _job(lambda job: make(job, log), JobConfiguration(1, 1, 5), log)
    assert handle.ok and worker.units_done == 3
    assert log == [("render", 0), ("deliver", 0), ("render", 5), ("deliver", 5), ("render", 10), ("deliver", 10)]


def test_a_failed_launch_delivers_the_unit_before_it_and_retries_itself_alone():
    log, fail = Log(), [10]
    handle, evs, worker = _job(lambda job: Split(job, log, fail=fail), JobConfiguration(1, 1, 2), log)
    assert handle.ok, handle.error
    assert handle.retry_rounds == 1 and handle.retried_units == 1
    failed = next(i for i, e in enumerate(evs) if isinstance(e, JobFailed))
    # The units before the last were delivered before the failure, unit 8
    # after unit 10's launch raised; the retry round queues unit 10 alone.
    assert _delivered(evs[:failed]) == [0, 2, 4, 6, 8] and _delivered(evs[failed:]) == [10]
    assert [r for c, r in log if c == "queue"] == [0, 2, 4, 6, 8, 10, 10]
    assert "injected launch failure" in next(e for e in evs if isinstance(e, JobFailed)).reason
    assert isinstance(evs[-1], RenderingFinished) and worker.units_done == 6


def test_a_cancelled_job_delivers_the_unit_in_hand_and_ends():
    log, hold, waiting = Log(), threading.Event(), threading.Event()
    sd = _scene(h=64)
    worker = LocalWorker(renderer_factory=lambda job: Split(job, log, hold=hold, waiting=waiting), device="cpu")
    manager = RenderManager([worker.handle()])
    events = queue.Queue()
    try:
        handle = manager.schedule_job(sd, JobConfiguration(1, 1, 1), MultiSink([events, log]))
        assert waiting.wait(WAIT)  # unit 0 is waited on, unit 1 queued behind it
        handle.cancel()
        hold.set()
        assert handle.wait(timeout=WAIT), "the job did not end"
    finally:
        hold.set()
        manager.stop()
        worker.stop()
    evs = [events.get_nowait() for _ in range(events.qsize())]
    assert _delivered(evs) == [0, 1]
    assert [c for c, _ in log] == ["queue", "queue", "wait", "deliver", "wait", "deliver"]
    assert isinstance(evs[-1], RenderingFinished) and not any(isinstance(e, JobFailed) for e in evs)
    assert handle.error is None


@contextlib.contextmanager
def _node(monkeypatch, factory):
    """A render node on a free loopback port, in a thread, for one master,
    its default renderer factory replaced by ``factory``; yields a
    :class:`NetworkWorker` on it, and joins both."""
    monkeypatch.setattr(workers_mod, "default_renderer_factory", lambda job, **kw: factory(job))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ready = threading.Event()
    t = threading.Thread(target=node.serve, kwargs=dict(host="127.0.0.1", port=port, max_connections=1,
                                                        ready_event=ready, device="cpu"), daemon=True)
    t.start()
    assert ready.wait(timeout=WAIT)
    net = NetworkWorker(f"127.0.0.1:{port}", connect_timeout=10, io_timeout=WAIT)
    try:
        yield net
    finally:
        net.stop()
        t.join(timeout=WAIT)
    assert not t.is_alive(), "the node did not end"


@pytest.mark.parametrize("height", [2, 12], ids=["one unit", "six units"])
def test_a_node_that_queues_ahead_serves_a_job_to_its_end(monkeypatch, height):
    """The master sends ``done`` only once every unit it sent has come back,
    so a node that waited for the next unit with one held would never end
    its job (a unit short of the master's depth of 2, or the last)."""
    log = []
    with _node(monkeypatch, lambda job: Split(job, log)) as net:
        manager = RenderManager([net.handle()])
        events = queue.Queue()
        try:
            handle = manager.schedule_job(_scene(h=height), JobConfiguration(1, 1, 2), events)
            assert handle.wait(timeout=WAIT), "the job did not end"
        finally:
            manager.stop()
    evs = [events.get_nowait() for _ in range(events.qsize())]
    starts = list(range(0, height, 2))
    assert handle.ok and handle.retry_rounds == 0, handle.error
    assert sorted(_delivered(evs)) == starts and isinstance(evs[-1], RenderingFinished)
    assert [r for c, r in log if c == "queue"] == starts and [r for c, r in log if c == "wait"] == starts
    for e in evs:
        if isinstance(e, RowsReady):
            u = e.result.work_unit
            assert np.array_equal(e.result.rows, _rows(u.row_start, u.num_rows, 16))


def test_a_node_that_queues_ahead_ends_a_cancelled_job():
    """Cancelled while the node waits on its first unit, the job ends with
    every unit the node took delivered and ``RenderingFinished`` last."""
    log, hold, waiting = [], threading.Event(), threading.Event()
    monkeypatch = pytest.MonkeyPatch()
    try:
        with _node(monkeypatch, lambda job: Split(job, log, hold=hold, waiting=waiting)) as net:
            manager = RenderManager([net.handle()])
            events = queue.Queue()
            try:
                handle = manager.schedule_job(_scene(h=64), JobConfiguration(1, 1, 1), events)
                assert waiting.wait(WAIT)
                handle.cancel()
                hold.set()
                assert handle.wait(timeout=WAIT), "the job did not end"
            finally:
                hold.set()
                manager.stop()
    finally:
        monkeypatch.undo()
    evs = [events.get_nowait() for _ in range(events.qsize())]
    queued = [r for c, r in log if c == "queue"]
    assert queued == list(range(len(queued))) and len(queued) < 64  # the master stopped sending
    assert [r for c, r in log if c == "wait"] == queued and _delivered(evs) == queued
    assert isinstance(evs[-1], RenderingFinished) and not any(isinstance(e, JobFailed) for e in evs)
