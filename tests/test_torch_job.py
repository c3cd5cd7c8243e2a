"""The port's job path on the CPU: jobs and work units, the scheduler round,
the native host code, the Image store, the manager with local workers
(events, retries, cancellation, failures), and the CLI's job path (``-L``,
``--profile-dir``), held against ``flux_tpu``'s job, image and scheduler
where both packages have them.

Every wait has a timeout, and every thread is joined with one."""

import json
import queue
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import yaml

from flux_tpu import image as j_image
from flux_tpu import job as j_job
from flux_tpu import scene as j_scene
from flux_tpu import sched as j_sched
from flux_tpu_torch import cli, debug, native
from flux_tpu_torch.image import Image, ppm_bytes, ppm_bytes_python
from flux_tpu_torch.job import Job, JobConfiguration, JobID, JobIDAllocator, WorkUnit
from flux_tpu_torch.manager import (
    ImageBuilder,
    JobFailed,
    MultiSink,
    RenderingFinished,
    RenderManager,
    RowsReady,
)
from flux_tpu_torch.ops import build
from flux_tpu_torch.render import Renderer
from flux_tpu_torch.scene import load_scene, loads_scene
from flux_tpu_torch.sched import SchedulerRound
from flux_tpu_torch.workers import LocalWorker, default_renderer_factory

REPO = Path(__file__).resolve().parent.parent
WAIT = 60


def tiny_doc(w=16, h=12, name="demo2"):
    doc = yaml.safe_load((REPO / "scenes" / f"{name}.yml").read_text())
    doc["output_settings"].update(image_width=w, image_height=h, pixel_size=0.5 * 800 / w)
    return doc


def tiny_scene(w=16, h=12, name="demo2"):
    return loads_scene(yaml.safe_dump(tiny_doc(w, h, name)))


def cpu_factory(job):
    return default_renderer_factory(job, device="cpu")


def band_loop(sd, cfg) -> np.ndarray:
    """The frame rendered band by band over the job's work units by one
    Renderer on the CPU: what every path through the manager must equal."""
    r = Renderer(sd, cfg.sample_root, cfg.max_trace_depth, seed=cfg.seed, device="cpu",
                 nee=cfg.nee, physical=cfg.physical)
    out = np.zeros((r.height, r.width, 3), np.float32)
    for u in Job(JobID(0, 0), sd, cfg).work_units():
        out[u.row_start : u.row_end + 1] = r.render_rows(u.row_start, u.num_rows)
    return out


def run_job(handles, sd, cfg, tmp_path, extra_sinks=()):
    """Schedule one job on a fresh manager; returns (handle, image, events)."""
    manager = RenderManager(handles)
    builder = ImageBuilder(output_dir=str(tmp_path))
    events = queue.Queue()
    try:
        handle = manager.schedule_job(sd, cfg, MultiSink([builder.sender(), events, *extra_sinks]))
        assert handle.wait(timeout=WAIT), "the job did not end"
        assert builder.wait_finished(timeout=WAIT)
        evs = []
        while not events.empty():
            evs.append(events.get_nowait())
        return handle, builder.get_image(), evs
    finally:
        builder.stop()
        manager.stop()


# ---- jobs -------------------------------------------------------------------


@pytest.mark.parametrize("scene, w, h, rows", [
    ("demo2", 16, 12, 5),
    ("demo2", 16, 11, 5),  # a one-row last unit
    ("demo2", 16, 12, 12),
    ("demo5", 16, 13, 4),  # a mesh: the job carries every triangle
    ("demo1", 8, 7, 50),
])
def test_work_units_and_dicts_match_the_jax_package(tmp_path, scene, w, h, rows):
    path = tmp_path / "s.yml"
    path.write_text(yaml.safe_dump(tiny_doc(w, h, scene)))
    cfg = dict(sample_root=3, max_trace_depth=4, rows_per_work_unit=rows, seed=7, nee=True, physical=False)
    job = Job(JobID(5, 2), load_scene(str(path)), JobConfiguration(**cfg))
    jjob = j_job.Job(j_job.JobID(5, 2), j_scene.load_scene(str(path)), j_job.JobConfiguration(**cfg))
    units = [(u.row_start, u.row_end, u.num_rows) for u in job.work_units()]
    assert units == [(u.row_start, u.row_end, u.num_rows) for u in jjob.work_units()]
    assert sum(n for _, _, n in units) == h
    assert job.to_dict() == jjob.to_dict()
    # Each package reads the other's dict back to its own job.
    assert Job.from_dict(jjob.to_dict()) == job
    assert j_job.Job.from_dict(job.to_dict()) == jjob


def test_invalid_rows_per_unit_and_unique_ids():
    with pytest.raises(ValueError):
        Job(JobID(1, 0), tiny_scene(), JobConfiguration(1, 1, 0)).work_units()
    a, b = JobIDAllocator(), JobIDAllocator()
    ids = [a.next_id() for _ in range(3)]
    assert len(set(ids)) == 3 and ids[0].allocator_id == ids[2].allocator_id
    assert b.next_id().allocator_id != ids[0].allocator_id
    assert JobConfiguration.from_dict({"sample_root": 2, "max_trace_depth": 3, "rows_per_work_unit": 4}) == \
        JobConfiguration(2, 3, 4)


# ---- the scheduler round ----------------------------------------------------


def _units(n):
    return [WorkUnit(row_start=i * 10, row_end=i * 10 + 9, job_id=None) for i in range(n)]


def _jax_round(units, workers, cancel=None, force_python=True):
    """``flux_tpu``'s round over the same units, on its Python core unless
    ``force_python`` is False."""
    ju = [j_job.WorkUnit(row_start=u.row_start, row_end=u.row_end, job_id=None) for u in units]
    return j_sched.SchedulerRound(ju, workers, cancel_event=cancel, force_python=force_python)


# The four rounds held to one trace: each package's native and Python core.
ROUNDS = {
    "port-native": lambda u, k, c: SchedulerRound(u, k, cancel_event=c),
    "port-python": lambda u, k, c: SchedulerRound(u, k, cancel_event=c, force_python=True),
    "flux_tpu-native": lambda u, k, c: _jax_round(u, k, c, force_python=False),
    "flux_tpu-python": _jax_round,
}


def test_native_library_builds_into_the_kernels_build_directory():
    assert native.available(), native.load_error
    path = native.library_path()
    assert path.parent == build.BUILD_DIR and path.is_file()
    assert path.name.startswith("libfluxnative-") and path.suffix == ".so"


def _script(rnd, cancel):
    """Every face of a round, in one fixed order; returns what it saw."""
    seen = [rnd.get().row_start for _ in range(3)]
    for row in (0, 20, 99999):
        rnd.complete_row(row)
    seen.append([u.row_start for u in rnd.missing()])
    seen.append(rnd.wait(0.01))
    rnd.done()
    seen.append(rnd.wait(0.01))
    cancel.set()
    seen.append(rnd.get())
    seen.append(rnd.cancelled())
    rnd.done()
    seen.append(rnd.wait(1.0))
    seen.append([u.row_start for u in rnd.missing()])
    return seen


@pytest.mark.parametrize("name", list(ROUNDS))
def test_round_behaves_as_the_jax_packages(name):
    """Every face of the round in one fixed order gives flux_tpu's Python
    core's trace, on each of the four rounds."""
    traces = {}
    for key in (name, "flux_tpu-python"):
        cancel = threading.Event()
        rnd = ROUNDS[key](_units(6), 2, cancel)
        assert rnd.native == key.endswith("native")
        traces[key] = _script(rnd, cancel)
        rnd.close()
    assert traces[name] == traces["flux_tpu-python"]
    assert traces[name] == [0, 10, 20, [10, 30, 40, 50], False, False, None, True, True, [10, 30, 40, 50]]


@pytest.mark.parametrize("n, k", [(300, 6), (7, 3)])
def test_concurrent_pulls_are_disjoint_and_complete(n, k):
    rnd = SchedulerRound(_units(n), k)
    pulled = [[] for _ in range(k)]

    def worker(i):
        while (u := rnd.get()) is not None:
            pulled[i].append(u.row_start)
            rnd.complete_row(u.row_start)
        rnd.done()

    threads = [threading.Thread(target=worker, args=(i,), daemon=True) for i in range(k)]
    for t in threads:
        t.start()
    assert rnd.wait(30.0)
    for t in threads:
        t.join(5)
    assert sorted(r for p in pulled for r in p) == [i * 10 for i in range(n)]
    assert rnd.missing() == []
    rnd.close()


@pytest.mark.parametrize("workers", [1, 2])
def test_empty_round_and_barrier_timeout(workers):
    rnd = SchedulerRound([], workers)
    assert rnd.get() is None and rnd.missing() == []
    assert not rnd.wait(0.02)
    for _ in range(workers):
        rnd.done()
    assert rnd.wait(1.0)
    rnd.close()


# ---- the native host code and the Image --------------------------------------


@pytest.mark.parametrize("frame", ["random", "edges", "demo_sized"])
def test_ppm_bytes_native_and_python_equal_the_jax_packages(frame):
    rng = np.random.default_rng(3)
    px = {
        "random": rng.random((13, 7, 3), dtype=np.float32),
        "edges": np.array([[[0.0, 1.0, 0.5], [0.9999999, 1.0, 0.25], [1e-9, 0.99999, 0.0]]], np.float32),
        "demo_sized": rng.random((60, 80, 3), dtype=np.float32),
    }[frame]
    want = j_image.ppm_bytes(px)
    assert native.ppm_encode_native(px) == want
    assert ppm_bytes_python(px) == want
    assert ppm_bytes(px) == want
    assert np.array_equal(np.asarray(want.split()[4:], np.int64).reshape(px.shape),
                          (px.astype(np.float64) * 65535.99).astype(np.int64))


def test_image_tracks_filled_rows_like_the_jax_package():
    img, jimg = Image(4, 3), j_image.Image(4, 3)
    for im in (img, jimg):
        im.set_row(1, np.full((4, 3), 0.5))
        im.set_pixel(2, 3, (0.1, 0.2, 0.3))
        assert not im.complete()
        im.set_rows(0, np.ones((1, 4, 3)))
        assert im.complete()
    assert np.array_equal(img.pixels, jimg.pixels)
    assert np.array_equal(img.filled_rows, jimg.filled_rows)
    with pytest.raises(ValueError):
        img.set_row(0, np.zeros((3, 3)))
    with pytest.raises(ValueError):
        img.set_rows(2, np.zeros((2, 4, 3)))


# ---- the manager -------------------------------------------------------------


@pytest.mark.parametrize("rows", [5, 12, 1])
def test_manager_renders_the_band_loops_bits(tmp_path, rows):
    sd = tiny_scene()
    cfg = JobConfiguration(sample_root=2, max_trace_depth=3, rows_per_work_unit=rows, seed=4)
    worker = LocalWorker(renderer_factory=cpu_factory, device="cpu")
    try:
        handle, img, evs = run_job([worker.handle()], sd, cfg, tmp_path)
    finally:
        worker.stop()
    kinds = [type(e).__name__ for e in evs]
    n_units = -(-12 // rows)
    assert kinds[:2] == ["ImageInfo", "RenderingStarted"] and kinds[-1] == "RenderingFinished"
    assert kinds.count("RowsReady") == n_units and "JobFailed" not in kinds
    assert handle.ok and handle.retry_rounds == 0 and worker.units_done == n_units
    assert img.complete()
    assert np.array_equal(img.pixels.view(np.int32), band_loop(sd, cfg).view(np.int32))
    assert (tmp_path / "demo2.ppm").read_bytes() == ppm_bytes(img.pixels)


def test_two_local_workers_share_the_queue_and_nee_travels_with_the_job(tmp_path):
    sd = tiny_scene(h=24, name="demo3")
    cfg = JobConfiguration(sample_root=2, max_trace_depth=3, rows_per_work_unit=2, seed=1, nee=True, physical=True)
    a = LocalWorker(renderer_factory=cpu_factory, name="a", device="cpu")
    b = LocalWorker(renderer_factory=cpu_factory, name="b", device="cpu")
    try:
        handle, img, _ = run_job([a.handle(), b.handle()], sd, cfg, tmp_path)
    finally:
        a.stop()
        b.stop()
    assert handle.ok and a.units_done + b.units_done == 12
    assert np.array_equal(img.pixels, band_loop(sd, cfg))


def test_sequential_jobs_on_one_manager(tmp_path):
    sd = tiny_scene()
    worker = LocalWorker(renderer_factory=cpu_factory, device="cpu")
    manager = RenderManager([worker.handle()])
    builder = ImageBuilder(output_dir=str(tmp_path))
    try:
        for root in (1, 2):
            cfg = JobConfiguration(sample_root=root, max_trace_depth=2, rows_per_work_unit=6, seed=1)
            handle = manager.schedule_job(sd, cfg, builder.sender())
            assert handle.wait(timeout=WAIT) and builder.wait_finished(timeout=WAIT)
            assert np.array_equal(builder.get_image().pixels, band_loop(sd, cfg))
    finally:
        builder.stop()
        manager.stop()
        worker.stop()


def test_cancellation_stops_early(tmp_path):
    sd = tiny_scene(h=64)
    gate = threading.Event()
    started = threading.Event()

    class Held:
        def __init__(self, job):
            self._r = cpu_factory(job)

        def render_rows(self, row0, n_rows):
            started.set()
            gate.wait(timeout=WAIT)
            return self._r.render_rows(row0, n_rows)

    worker = LocalWorker(renderer_factory=Held, device="cpu")
    manager = RenderManager([worker.handle()])
    events = queue.Queue()
    try:
        cfg = JobConfiguration(sample_root=1, max_trace_depth=1, rows_per_work_unit=1)
        handle = manager.schedule_job(sd, cfg, events)
        assert started.wait(timeout=WAIT)
        handle.cancel()
        gate.set()
        assert handle.wait(timeout=WAIT)
    finally:
        gate.set()
        manager.stop()
        worker.stop()
    evs = [events.get_nowait() for _ in range(events.qsize())]
    assert sum(isinstance(e, RowsReady) for e in evs) < 64
    assert isinstance(evs[-1], RenderingFinished)
    assert handle.error is None


def test_a_failing_factory_yields_job_failed_without_a_hang(tmp_path):
    def explode(job):
        raise RuntimeError("injected factory failure")

    worker = LocalWorker(renderer_factory=explode, name="bad", device="cpu")
    t0 = time.monotonic()
    try:
        handle, _, evs = run_job([worker.handle()], tiny_scene(), JobConfiguration(1, 1, 4), tmp_path)
    finally:
        worker.stop()
    assert time.monotonic() - t0 < WAIT
    failed = [e for e in evs if isinstance(e, JobFailed)]
    assert failed and "injected factory failure" in failed[0].reason
    assert failed[0].worker == worker.handle().uid
    assert handle.done() and not handle.ok and "lost after retry" in handle.error
    assert handle.retry_rounds >= 1


def test_units_a_flaky_worker_lost_are_retried_on_the_survivor(tmp_path):
    sd = tiny_scene()
    cfg = JobConfiguration(sample_root=2, max_trace_depth=2, rows_per_work_unit=2, seed=3)
    go = threading.Event()

    class Flaky:
        """Fails on its second unit; the first is held until the healthy
        worker has started, so that both pull in the first round."""

        def __init__(self, job):
            self._r, self._n = cpu_factory(job), 0

        def render_rows(self, row0, n_rows):
            self._n += 1
            if self._n == 2:
                raise RuntimeError("injected worker failure")
            go.wait(timeout=WAIT)
            return self._r.render_rows(row0, n_rows)

    class Healthy:
        def __init__(self, job):
            self._r = cpu_factory(job)

        def render_rows(self, row0, n_rows):
            go.set()
            return self._r.render_rows(row0, n_rows)

    flaky = LocalWorker(renderer_factory=Flaky, name="flaky", device="cpu")
    healthy = LocalWorker(renderer_factory=Healthy, name="healthy", device="cpu")
    try:
        handle, img, evs = run_job([flaky.handle(), healthy.handle()], sd, cfg, tmp_path)
    finally:
        go.set()
        flaky.stop()
        healthy.stop()
    assert handle.ok, handle.error
    assert any(isinstance(e, JobFailed) for e in evs)
    assert handle.retry_rounds == 1 and handle.retried_units == 1
    assert np.array_equal(img.pixels, band_loop(sd, cfg))


def test_debug_tracing_switch(capsys):
    debug.set_debug(True)
    try:
        debug.d_println("hello")
    finally:
        debug.set_debug(False)
    debug.d_println("silent")
    err = capsys.readouterr().err
    assert err.endswith(": hello\n") and "silent" not in err
    assert not debug.debug_enabled()


# ---- the CLI's job path -------------------------------------------------------


def _scene_file(tmp_path, **kw):
    path = tmp_path / "tiny.yml"
    path.write_text(yaml.safe_dump(tiny_doc(**kw)))
    return path


def test_cli_without_workers_says_so(tmp_path, capsys):
    assert cli.main([str(_scene_file(tmp_path)), "-L", "--output-dir", str(tmp_path)]) == 0
    assert "No workers specified" in capsys.readouterr().out
    assert not (tmp_path / "demo2.ppm").exists()


def test_cli_job_path_reports_its_job(tmp_path):
    """A frame whose height is not a multiple of -R: the last unit is short,
    and the PPM is still the band loop's bytes."""
    scene_file = _scene_file(tmp_path, h=11)
    out = tmp_path / "out"
    ran = cli.run([str(scene_file), "-r", "2", "-d", "3", "-R", "4", "--seed", "2", "--device", "cpu",
                   "--output-dir", str(out), "--verbose"])
    debug.set_debug(False)
    sd = load_scene(str(scene_file))
    assert ran["out"] == str(out / "demo2.ppm") and ran["error"] is None
    assert ran["retry_rounds"] == 0 and ran["worker_failures"] == []
    assert ran["units_by_worker"] == {"local": 3} and ran["samples"] == 16 * 11 * 4
    assert (out / "demo2.ppm").read_bytes() == ppm_bytes(band_loop(sd, JobConfiguration(2, 3, 4, seed=2)))


def test_cli_profile_dir_writes_a_trace(tmp_path):
    prof = tmp_path / "prof"
    ran = cli.run([str(_scene_file(tmp_path)), "-r", "1", "-d", "2", "--device", "cpu",
                   "--output-dir", str(tmp_path), "--profile-dir", str(prof)])
    assert ran["error"] is None
    trace = Path(ran["trace"])
    assert trace.parent == prof and trace.is_file()
    assert "traceEvents" in json.loads(trace.read_text())


def test_more_workers_than_cores_render_every_unit_once(tmp_path):
    """A stress test of the shared round: more local workers than cores, a
    short switch interval; every unit's rows arrive once and in place."""
    import os
    import sys

    class Rows:
        def __init__(self, job):
            self.width = job.scene_data.output_settings.image_width

        def render_rows(self, row0, n_rows):
            r = np.arange(row0, row0 + n_rows, dtype=np.float32)[:, None, None]
            return np.broadcast_to(r / 256, (n_rows, self.width, 3)).copy()

    n = (os.cpu_count() or 4) + 4
    workers = [LocalWorker(renderer_factory=Rows, name=f"w{i}", device="cpu") for i in range(n)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        handle, img, evs = run_job([w.handle() for w in workers], tiny_scene(h=200), JobConfiguration(1, 1, 1),
                                   tmp_path)
    finally:
        sys.setswitchinterval(old)
        for w in workers:
            w.stop()
    starts = sorted(e.result.work_unit.row_start for e in evs if isinstance(e, RowsReady))
    assert handle.ok and starts == list(range(200))
    assert sum(w.units_done for w in workers) == 200
    assert np.array_equal(img.pixels[:, 0, 0], np.arange(200, dtype=np.float32) / 256)
