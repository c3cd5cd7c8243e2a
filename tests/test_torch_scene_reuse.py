"""A LocalWorker's kept scene state on the CPU: consecutive jobs of one scene
render on one ``SceneState`` and each still gets its own frame, bit for bit
that of a fresh ``Renderer`` built for the job alone; a scene decoded from
its dict hits, and another scene, colour or ``nee`` builds a new state; a
job that fails in its factory leaves the kept state as it was; the
``worker.renderer_build`` span says whether the state was reused.

This file imports neither JAX nor ``flux_tpu``. Every wait has a timeout."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import yaml
from torch.profiler import ProfilerActivity, profile

from flux_tpu_torch import metrics, render
from flux_tpu_torch.job import Job, JobConfiguration, JobID
from flux_tpu_torch.manager import JobFailed, RenderManager, RowsReady
from flux_tpu_torch.render import Renderer, SceneState
from flux_tpu_torch.scene import SceneData, loads_scene
from flux_tpu_torch.workers import KeptScene, LocalWorker, default_renderer_factory

REPO = Path(__file__).resolve().parent.parent
WAIT = 60
CFG = JobConfiguration(sample_root=2, max_trace_depth=2, rows_per_work_unit=5, seed=1, nee=True)


def tiny_scene(name="demo5", w=16, h=12) -> SceneData:
    doc = yaml.safe_load((REPO / "scenes" / f"{name}.yml").read_text())
    out = doc["output_settings"]
    out.update(image_width=w, image_height=h, pixel_size=out["pixel_size"] * out["image_width"] / w)
    return loads_scene(yaml.safe_dump(doc))


def fresh_frame(sd: SceneData, cfg: JobConfiguration) -> np.ndarray:
    """The frame of a Renderer built for this job alone, band by band over
    the job's work units."""
    r = Renderer(sd, cfg.sample_root, cfg.max_trace_depth, seed=cfg.seed, device="cpu",
                 nee=cfg.nee, physical=cfg.physical)
    out = np.zeros((r.height, r.width, 3), np.float32)
    for u in Job(JobID(0, 0), sd, cfg).work_units():
        out[u.row_start : u.row_end + 1] = r.render_rows(u.row_start, u.num_rows)
    return out


class _Frame:
    """The event sink of one job: its rows into one array, its failures."""

    def __init__(self, sd: SceneData):
        out = sd.output_settings
        self.pixels = np.full((out.image_height, out.image_width, 3), np.nan, np.float32)
        self.failed = []

    def put(self, ev) -> None:
        if isinstance(ev, RowsReady):
            u = ev.result.work_unit
            self.pixels[u.row_start : u.row_end + 1] = ev.result.rows
        elif isinstance(ev, JobFailed):
            self.failed.append(ev.reason)


class _Jobs:
    """Jobs one after another through one manager and one CPU LocalWorker."""

    def __init__(self, **worker_kw):
        self.worker = LocalWorker(device="cpu", **worker_kw)
        self.manager = RenderManager([self.worker.handle()])
        self.ids = []

    def run(self, sd: SceneData, cfg: JobConfiguration):
        """(handle, frame) of one job."""
        frame = _Frame(sd)
        handle = self.manager.schedule_job(sd, cfg, frame)
        assert handle.wait(timeout=WAIT), "the job did not end"
        self.ids.append(handle.job_id)
        return handle, frame

    def reused(self) -> list:
        """``worker.renderer_build``'s ``reused`` of each job run in a
        profiler window, in the jobs' order."""
        builds = {s.job: s.attrs["reused"] for s in metrics.spans() if s.name == "worker.renderer_build"}
        return [builds[j] for j in self.ids]

    def close(self) -> None:
        self.manager.stop()
        self.worker.stop()


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.int32)


def test_jobs_of_one_scene_share_its_state_and_keep_their_own_parameters():
    """Three seeds, then another sample root, depth and estimator: one
    build, three reuses, and every frame that of a fresh Renderer."""
    sd = tiny_scene()
    cfgs = [dataclasses.replace(CFG, seed=s) for s in (1, 2, 3)]
    cfgs.append(JobConfiguration(sample_root=3, max_trace_depth=3, rows_per_work_unit=4, seed=9, nee=True,
                                 physical=True))
    jobs = _Jobs()
    metrics.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            frames = []
            for cfg in cfgs:
                handle, frame = jobs.run(sd, cfg)
                assert handle.ok and not frame.failed, handle.error
                frames.append(frame.pixels)
        kept = jobs.worker._kept.state
    finally:
        jobs.close()
    assert jobs.reused() == [False, True, True, True]
    assert kept.scene_data is sd and kept.lights is not None
    for cfg, got in zip(cfgs, frames):
        assert np.array_equal(_bits(got), _bits(fresh_frame(sd, cfg)))
    # The seed reaches the frame: the shared state carries none.
    assert not np.array_equal(frames[0], frames[1]) and not np.array_equal(frames[1], frames[2])


def _recoloured(sd: SceneData) -> SceneData:
    """``sd`` with its first shape's colour changed."""
    first = sd.shapes[0]
    mat = dataclasses.replace(first.material, color=(0.9, 0.1, 0.1))
    return dataclasses.replace(sd, shapes=(dataclasses.replace(first, material=mat), *sd.shapes[1:]))


@pytest.mark.parametrize("case, hit", [("from_dict", True), ("colour", False), ("nee", False)])
def test_the_kept_state_is_keyed_on_the_scene_and_nee(case, hit):
    """A second job whose scene came back through its dict hits; one with a
    shape's colour changed, or with NEE after a job without, builds its own
    state and renders its own frame."""
    sd = tiny_scene()
    first, second = dataclasses.replace(CFG, seed=4), dataclasses.replace(CFG, seed=5)
    sd2 = sd
    if case == "from_dict":
        sd2 = SceneData.from_dict(sd.to_dict())
        assert sd2 is not sd and sd2 == sd
    elif case == "colour":
        sd2 = _recoloured(sd)
    else:
        first = dataclasses.replace(first, nee=False)
    jobs = _Jobs()
    metrics.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for scene, cfg in ((sd, first), (sd2, second)):
                handle, frame = jobs.run(scene, cfg)
                assert handle.ok, handle.error
        kept = jobs.worker._kept.state
    finally:
        jobs.close()
    assert jobs.reused() == [False, hit]
    want = fresh_frame(sd2, second)
    assert np.array_equal(_bits(frame.pixels), _bits(want))
    assert kept.lights is not None
    if not hit:
        # The change shows in the frame: the first job's state would have
        # rendered another one.
        other = fresh_frame(sd, dataclasses.replace(second, nee=first.nee))
        assert not np.array_equal(want, other)


def test_a_failed_build_leaves_the_kept_state_for_the_next_job(monkeypatch):
    """A job whose scene state cannot be built fails cleanly; the state kept
    from the job before stays, and the next job of its scene reuses it and
    renders its own frame."""
    sd = tiny_scene()
    broken = dataclasses.replace(sd, scene_name="broken")
    compile_scene = render.compile_scene

    def compile_or_fail(scene_data, device):
        if scene_data.scene_name == "broken":
            raise RuntimeError("injected compile failure")
        return compile_scene(scene_data, device)

    monkeypatch.setattr(render, "compile_scene", compile_or_fail)
    cfgs = [dataclasses.replace(CFG, seed=s) for s in (6, 7, 8)]
    jobs = _Jobs()
    metrics.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            ok1, f1 = jobs.run(sd, cfgs[0])
            bad, fbad = jobs.run(broken, cfgs[1])
            ok2, f2 = jobs.run(sd, cfgs[2])
    finally:
        jobs.close()
    assert ok1.ok and ok2.ok, (ok1.error, ok2.error)
    assert not bad.ok and any("injected compile failure" in r for r in fbad.failed)
    # The failed job's builds record no attribute; the jobs around it do.
    builds = [s for s in metrics.spans() if s.name == "worker.renderer_build"]
    assert [s.attrs.get("reused") for s in builds if s.job == ok2.job_id] == [True]
    assert [s.attrs.get("reused") for s in builds if s.job == ok1.job_id] == [False]
    for cfg, got in ((cfgs[0], f1), (cfgs[2], f2)):
        assert np.array_equal(_bits(got.pixels), _bits(fresh_frame(sd, cfg)))


def test_a_callers_factory_builds_a_renderer_a_job():
    """A factory given to the worker keeps its own behaviour: nothing kept,
    every build a new one."""
    sd = tiny_scene()
    jobs = _Jobs(renderer_factory=lambda job: default_renderer_factory(job, device="cpu"))
    metrics.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for s in (1, 2):
                handle, frame = jobs.run(sd, dataclasses.replace(CFG, seed=s))
                assert handle.ok, handle.error
    finally:
        jobs.close()
    assert jobs.reused() == [False, False] and jobs.worker._kept is None
    assert np.array_equal(_bits(frame.pixels), _bits(fresh_frame(sd, dataclasses.replace(CFG, seed=2))))


def test_a_renderer_takes_only_a_state_built_for_its_arguments():
    sd = tiny_scene()
    state = SceneState.build(sd, "cpu", None, True)
    r = Renderer(SceneData.from_dict(sd.to_dict()), 2, 2, seed=3, device="cpu", nee=True, state=state)
    assert r.state is state and r.isect is state.isect and r.lights is state.lights and r.nee
    for kw in ({"nee": False}, {"nee": True, "accel": "scan"}):
        with pytest.raises(ValueError, match="scene state"):
            Renderer(sd, 2, 2, device="cpu", state=state, **kw)
    with pytest.raises(ValueError, match="scene state"):
        Renderer(_recoloured(sd), 2, 2, device="cpu", nee=True, state=state)
    kept = KeptScene()
    assert kept.get(sd, "cpu", None, True) is kept.get(sd, "cpu", None, True) and kept.reused
    assert kept.get(sd, "cpu", "scan", True) is not state and not kept.reused
