"""The program's spans (``flux_tpu_torch.metrics``) on the CPU: nothing is
recorded, and no clock read, without a ``torch.profiler`` window; inside
one, a job through the manager and a local worker records every span of
the job path that the CPU runs with its job, thread and parent; a table
pack is a span under its launch; and ``profile_trace`` writes the spans
into its Chrome trace on the trace's own clock. The card's spans
(``kernel.launch``, ``kernel.pack_tables``) in a job are tested in
``tests/test_torch_cuda.py``.

This file imports neither JAX nor ``flux_tpu``. Every wait has a timeout."""

import json
import sys
import threading
import time
from pathlib import Path

import pytest
import torch
import torch.autograd.profiler
import yaml
from torch.profiler import ProfilerActivity, profile, record_function

from flux_tpu_torch import cli, metrics
from flux_tpu_torch.job import JobConfiguration
from flux_tpu_torch.manager import RenderManager
from flux_tpu_torch.ops import scene_kernel
from flux_tpu_torch.render import Renderer
from flux_tpu_torch.scene import loads_scene
from flux_tpu_torch.workers import LocalWorker

REPO = Path(__file__).resolve().parent.parent
WAIT = 60

WORKER_SPANS = {"worker.queue_wait", "worker.renderer_build", "sched.pull", "worker.unit", "unit.readback",
                "unit.deliver"}
CARD_SPANS = {"kernel.launch", "kernel.pack_tables"}  # a launch's host work: none in the CPU's plain render
MANAGER_SPANS = {"manager.queue_wait", "manager.dispatch", "manager.finish"}
CFG = JobConfiguration(2, 2, 5)  # root 2, depth 2, 5-row units: 3 units of a 12-row frame


class _Sink:
    def put(self, ev):
        pass


def tiny_doc(w=16, h=12, name="demo2"):
    doc = yaml.safe_load((REPO / "scenes" / f"{name}.yml").read_text())
    doc["output_settings"].update(image_width=w, image_height=h, pixel_size=0.5 * 800 / w)
    return doc


def _scene(name="demo2", w=16, h=12):
    return loads_scene(yaml.safe_dump(tiny_doc(w, h, name)))


def _job(sd, cfg=CFG):
    """One job through a fresh manager and CPU worker; returns its handle."""
    worker = LocalWorker(device="cpu")
    manager = RenderManager([worker.handle()])
    try:
        handle = manager.schedule_job(sd, cfg, _Sink())
        assert handle.wait(timeout=WAIT), "the job did not end"
        assert handle.ok, handle.error
        return handle
    finally:
        manager.stop()
        worker.stop()


def _window():
    return profile(activities=[ProfilerActivity.CPU])


def test_the_process_wide_profiler_flag_is_found():
    """The recorder's switch: a torch upgrade that drops the flag must fail
    here, not leave the span metrics quietly empty."""
    assert hasattr(torch.autograd.profiler, metrics.PROFILER_FLAG)

    def recording():
        return getattr(torch.autograd.profiler, metrics.PROFILER_FLAG)

    seen = []
    go, done = threading.Event(), threading.Event()

    def other():
        go.wait(WAIT)
        seen.append(recording())
        done.set()

    t = threading.Thread(target=other)
    t.start()
    assert not recording()
    with _window():
        go.set()
        assert done.wait(WAIT)
        assert recording()
    t.join(WAIT)
    assert not t.is_alive() and seen == [True]
    assert not recording()


def test_no_span_and_no_clock_read_without_a_profiler_window(monkeypatch):
    class Clock:
        reads = 0

        def perf_counter_ns(self):
            Clock.reads += 1
            return time.perf_counter_ns()

        def time_ns(self):
            Clock.reads += 1
            return time.time_ns()

    monkeypatch.setattr(metrics, "time", Clock())
    metrics.clear()
    _job(_scene())
    assert metrics.spans() == [] and Clock.reads == 0
    off = metrics.span("worker.unit")
    assert off is metrics.span("kernel.launch", job="j") and not off and metrics.stamp() is None
    with off as sp:
        sp.set("rows", 5)
    metrics.record("manager.finish", 123)
    assert metrics.spans() == [] and Clock.reads == 0
    n = 20000
    before = sys.getallocatedblocks()
    for _ in range(n):
        with metrics.span("sched.pull", "j"):
            pass
    assert sys.getallocatedblocks() - before < 50  # nothing kept or allocated per span


@pytest.mark.parametrize("name,config", [("demo2", "sweep"), ("demo5", "sweep+tri+nee+trilight")])
def test_a_job_in_a_window_records_every_span_of_the_job_path(name, config):
    """Every span but the card's (the CPU runs the plain version, which
    launches nothing and packs no table), with its job, thread and parent;
    and the configuration the card's ``kernel.launch`` would carry."""
    sd = _scene(name)
    cfg = JobConfiguration(2, 2, 5, nee=name == "demo5")
    metrics.clear()
    with _window():
        handle = _job(sd, cfg)
    got = [s for s in metrics.spans() if s.job == handle.job_id]
    assert {s.name for s in got} == WORKER_SPANS | MANAGER_SPANS
    assert not {s.name for s in metrics.spans()} & CARD_SPANS
    assert sum(s.name == "worker.renderer_build" for s in got) == 1
    by_id = {s.id: s for s in got}
    for s in got:
        assert s.start_ns <= s.end_ns
        want = "RenderManager" if s.name in MANAGER_SPANS else "LocalWorker[local]"
        assert s.thread_name == want, s
        if s.name in ("unit.readback", "unit.deliver"):
            parent = by_id[s.parent]
            assert parent.name == "worker.unit" and parent.thread == s.thread
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
        else:
            assert s.parent is None  # a thread's outermost span: its parent is the job
    units = sorted((s.attrs["row_start"], s.attrs["rows"]) for s in got if s.name == "worker.unit")
    assert units == [(0, 5), (5, 5), (10, 2)]
    assert not any(s.attrs.get("ahead", True) for s in got if s.name == "worker.unit")  # one at a time
    assert sum(s.name == "sched.pull" for s in got) == len(units) + 1  # the last pull yields None
    assert Renderer(sd, 2, 2, device="cpu", nee=cfg.nee)._launch_config(False) == config
    one = lambda n: next(s for s in got if s.name == n)  # noqa: E731
    assert one("manager.queue_wait").end_ns <= one("manager.dispatch").end_ns <= one("worker.queue_wait").end_ns
    assert one("worker.queue_wait").end_ns <= one("worker.renderer_build").start_ns
    assert max(s.end_ns for s in got if s.name == "unit.deliver") <= one("manager.finish").start_ns


class _Split:
    """A renderer with the split calls that reports a CUDA card, so that the
    worker queues each unit before it delivers the one before; its
    ``queue_rows`` opens a ``kernel.launch`` span, as the card's does."""

    device = torch.device("cuda")

    def __init__(self, job):
        self.width = job.scene_data.output_settings.image_width

    def queue_rows(self, row0, n_rows):
        with metrics.span("kernel.launch"):
            return row0, n_rows

    def wait_rows(self, pending):
        row0, n_rows = pending
        return torch.zeros(n_rows, self.width, 3).numpy()


def test_units_queued_ahead_record_their_overlap_and_wait_only_in_a_window():
    """Two deep, a unit's ``worker.unit`` runs from its pull to its delivery,
    so consecutive ones overlap, and holds its ``kernel.launch``, its
    ``unit.wait`` and its ``unit.deliver``; ``ahead`` is true on every unit
    but the first. Nothing is recorded outside a window."""

    def job():
        worker = LocalWorker(renderer_factory=_Split, device="cpu")
        manager = RenderManager([worker.handle()])
        try:
            handle = manager.schedule_job(_scene(), CFG, _Sink())
            assert handle.wait(timeout=WAIT) and handle.ok, handle.error
            return handle
        finally:
            manager.stop()
            worker.stop()

    metrics.clear()
    job()
    assert metrics.spans() == []
    with _window():
        handle = job()
    got = [s for s in metrics.spans() if s.job == handle.job_id]
    assert {s.name for s in got} == WORKER_SPANS - {"unit.readback"} | {"unit.wait", "kernel.launch"} | MANAGER_SPANS
    units = sorted((s for s in got if s.name == "worker.unit"), key=lambda s: s.start_ns)
    assert [(s.attrs["row_start"], s.attrs["ahead"]) for s in units] == [(0, False), (5, True), (10, True)]
    assert all(s.parent is None for s in units)
    for a, b in zip(units, units[1:]):
        assert a.start_ns < b.start_ns < a.end_ns < b.end_ns  # b was queued before a was delivered
    for u in units:
        kids = sorted((s for s in got if s.parent == u.id), key=lambda s: s.start_ns)
        assert [s.name for s in kids] == ["kernel.launch", "unit.wait", "unit.deliver"]
        assert all(u.start_ns <= s.start_ns <= s.end_ns <= u.end_ns and s.thread == u.thread for s in kids)


def test_a_table_pack_is_a_span_under_its_launch_and_a_count():
    """The packs are counted by their spans: one a table, its first pack
    only, since a table is kept beside its layout."""
    r = Renderer(_scene("demo5"), 2, 2, device="cpu", nee=True)
    metrics.clear()
    with _window():
        with metrics.span("kernel.launch", job="job-1"):
            scene_kernel.pack_geom(r.scene, r.isect, r.lights, torch.device("cpu"))
            scene_kernel.pack_geom(r.scene, r.isect, r.lights, torch.device("cpu"))  # packed once, kept
    got = metrics.spans()
    launch = next(s for s in got if s.name == "kernel.launch")
    packs = [s for s in got if s.name == "kernel.pack_tables"]
    assert sorted(s.attrs["table"] for s in packs) == ["lights", "triangles"]
    assert all(s.parent == launch.id and s.job == "job-1" for s in packs)


def test_a_stamped_span_ends_on_the_thread_that_records_it():
    metrics.clear()
    with _window():
        start = metrics.stamp()
        t = threading.Thread(target=metrics.record, args=("worker.queue_wait", start, "job-2"), name="taker")
        t.start()
        t.join(WAIT)
    assert not t.is_alive()
    (s,) = metrics.spans()
    assert (s.name, s.job, s.thread_name, s.parent) == ("worker.queue_wait", "job-2", "taker", None)
    assert s.start_ns == start <= s.end_ns
    off = metrics.clock_offset_ns()
    assert off is not None and abs(time.time_ns() - (time.perf_counter_ns() + off)) < 50_000_000
    metrics.clear()
    assert metrics.spans() == [] and metrics.clock_offset_ns() is None


def _flux_events(trace):
    return [e for e in trace["traceEvents"] if e.get("cat") == "flux"]


def test_profile_trace_writes_the_worker_spans_on_the_trace_clock(tmp_path):
    """The spans land inside a range the profiler itself recorded around the
    job, on the tracks of the threads that ran them."""
    metrics.clear()
    with metrics.span("stale"):
        pass
    sd = _scene()
    with metrics.profile_trace(str(tmp_path)) as prof:
        with record_function("outer"):
            time.sleep(0.005)
            handle = _job(sd)
            time.sleep(0.005)
    trace = json.loads(open(prof.trace_path).read())
    outer = next(e for e in trace["traceEvents"] if e.get("name") == "outer" and e.get("ph") == "X")
    mine = [e for e in _flux_events(trace) if e["args"]["job"] == str(handle.job_id)]
    assert {e["name"] for e in mine} == WORKER_SPANS | MANAGER_SPANS
    assert not any(e["name"] == "stale" for e in _flux_events(trace))  # the window starts a new list
    for e in mine:
        assert outer["ts"] < e["ts"] and e["ts"] + e["dur"] < outer["ts"] + outer["dur"], e
    worker_tids = {e["tid"] for e in mine if e["name"] == "worker.unit"}
    assert len(worker_tids) == 1 and worker_tids != {threading.get_native_id()}
    names = {e["tid"]: e["args"]["name"] for e in trace["traceEvents"]
             if e.get("ph") == "M" and e.get("name") == "thread_name"}
    assert names[worker_tids.pop()] == "LocalWorker[local]"


def test_cli_profile_dir_trace_holds_the_job_path_spans(tmp_path):
    scene_file = tmp_path / "tiny.yml"
    scene_file.write_text(yaml.safe_dump(tiny_doc(16, 11)))
    ran = cli.run([str(scene_file), "-r", "1", "-d", "2", "--device", "cpu", "--output-dir", str(tmp_path),
                   "--profile-dir", str(tmp_path / "prof")])
    assert ran["error"] is None
    events = _flux_events(json.loads(open(ran["trace"]).read()))
    units = [e for e in events if e["name"] == "worker.unit"]
    assert len(units) == ran["units_by_worker"]["local"] >= 1
    assert all(e["tid"] != threading.get_native_id() for e in units)
    assert {e["name"] for e in events} >= WORKER_SPANS | MANAGER_SPANS


def test_a_span_takes_the_track_of_its_threads_events_in_the_trace():
    """A thread whose host events the profiler recorded keeps its native id;
    a worker's spans go where the profiler put its CUDA runtime calls (the
    low 32 bits of its pthread id, signed, without the sign); else the
    native id."""
    s = metrics.Span(0, "worker.unit", 0, 1, 137, 0x7F3CFAFFF6C0, "LocalWorker[local]", None, None, {})
    assert metrics._track(s, {122, 83888448}) == 83888448
    assert metrics._track(s, {122, 137, 83888448}) == 137
    assert metrics._track(s, {122}) == 137
    assert metrics._track(s._replace(thread_ident=0x7F3C0000F6C0), {63168}) == 63168
