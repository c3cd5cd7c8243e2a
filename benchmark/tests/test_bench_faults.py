"""The check's own proof: the control (the reference with its state in
bfloat16, one precision below the configurations' float32, in the
program's place) and faults planted in the timed path each come out as not
correct, at a size a CPU test can hold. Every run but the look for a chip
goes as a real run goes; the limits are the cells' own."""

import json

import numpy as np
import pytest

from benchmark import harness
from benchmark.harness import load_json, load_module, run_cell

JOB_CELLS = ["demo2.final_16384spp", "cornell.final_1024spp_nee", "demo2.preview_1spp"]
PROGRESSIVE = "demo2.adaptive_0.12"


def _over_limit(checks: dict, limits: dict) -> list:
    return [k for k, v in checks.items() if v > limits[k]]


@pytest.mark.parametrize("cell", JOB_CELLS + [PROGRESSIVE])
def test_the_control_fails_the_check(spec_all, tiny, cell):
    w = next(x for x in spec_all["workloads"] if x["name"] == cell)
    config, mix = load_json("configs", w["config"], tiny), load_json("mixes", w["traffic"], tiny)
    drv = load_module("drivers", mix["driver"], tiny).Driver(
        config=config, mix=mix, scene_path=str(tiny / "configs" / config["scene"]), device="cpu", seed=99,
        spans=harness.Spans())
    drv.setup()
    drv.window(0.3)
    drv.close()
    limits = load_json("limits", cell, tiny)
    assert not _over_limit(drv.verify(), limits)
    assert _over_limit(drv.verify(control=True), limits)


# Faults planted in the program, underneath the timed path. A job frame's
# unit comes from Renderer.render_rows; a progressive pass from
# ProgressiveRenderer.render_pass.

def _unchanged_rows(self, row0, n_rows):
    # The unit's accumulator returned as it started: nothing added.
    return np.zeros((n_rows, self.width, 3), np.float32)


def _half_rows(self, row0, n_rows):
    # Half of the samples left out, the mean taken over the rest.
    from flux_tpu_torch.color import max_to_one

    n = (self.root * self.root) // 2
    acc = self.render_rows_sum_range(row0, n_rows, 0, n)
    return max_to_one(acc * (1.0 / n)).cpu().numpy()


def _altered_rows(original):
    def render_rows(self, row0, n_rows):
        out = original(self, row0, n_rows)
        if row0 == 0:
            out = out * np.float32(1.1)  # one unit's answer altered where it is produced
        return out
    return render_rows


def _unchanged_pass(original):
    def render_pass(self, n):
        acc, lum = self.acc.copy(), self.lum_sq.copy()
        done = original(self, n)
        self.acc, self.lum_sq = acc, lum  # the pass leaves its state as it was
        return done
    return render_pass


def _half_pass(original):
    def render_pass(self, n):
        done = original(self, max(n // 2, 1))
        self.samples_done += n - done  # counted as a whole pass
        return n
    return render_pass


def _altered_pass(original):
    def render_pass(self, n):
        done = original(self, n)
        self.acc[:2] *= np.float32(1.02)
        return done
    return render_pass


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", JOB_CELLS)
def test_a_fault_in_the_job_path_fails_the_check(spec_all, tiny, monkeypatch, cell, fault):
    from flux_tpu_torch.render import Renderer

    if fault == "half" and json.loads((tiny / "mixes" / f"{cell.split('.')[1]}.json").read_text())[
            "sample_root"] == 1:
        pytest.skip("a frame of one sample a pixel has no half to leave out")
    patch = {"unchanged": _unchanged_rows, "half": _half_rows,
             "altered": _altered_rows(Renderer.render_rows)}[fault]
    monkeypatch.setattr(Renderer, "render_rows", patch)
    out = run_cell(spec_all, cell, 5, 0.3, False, device="cpu", base=tiny)
    assert not out["correct"]


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_fault_in_the_progressive_loop_fails_the_check(spec_all, tiny, monkeypatch, fault):
    from flux_tpu_torch.checkpoint import ProgressiveRenderer

    wrap = {"unchanged": _unchanged_pass, "half": _half_pass, "altered": _altered_pass}[fault]
    monkeypatch.setattr(ProgressiveRenderer, "render_pass", wrap(ProgressiveRenderer.render_pass))
    out = run_cell(spec_all, PROGRESSIVE, 5, 0.3, False, device="cpu", base=tiny)
    assert not out["correct"]


def test_a_stop_past_the_target_fails_the_check(spec_all, tiny, monkeypatch):
    """The stop decision is judged: a statistic that reads high makes the
    render run past the pass that met the target."""
    from flux_tpu_torch.checkpoint import ProgressiveRenderer

    original = ProgressiveRenderer.max_rel_stderr
    monkeypatch.setattr(ProgressiveRenderer, "max_rel_stderr", lambda self, p=99.0: 1.5 * original(self, p))
    out = run_cell(spec_all, PROGRESSIVE, 5, 0.3, False, device="cpu", base=tiny)
    assert not out["correct"]
