"""Each driver end to end on the CPU at a tiny size (the plain version
renders there), the files found by name, and the import rule."""

import json
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.harness import REPO_DIR, cell_metrics, forbidden_modules, load_module, run_cell

CELLS = ["demo2.final_16384spp", "cornell.final_1024spp_nee", "demo2.preview_1spp", "demo2.adaptive_0.12"]
SEED = 2**31 + 12345  # wider than 32 signed bits, as the driver's seeds are


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_and_is_correct_on_the_cpu(spec_all, tiny, cell, trace):
    out = run_cell(spec_all, cell, SEED, 2.0, bool(trace), device="cpu", base=tiny)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in out["checks"].values())
    want = {m["name"] for m in cell_metrics(spec_all, cell, bool(trace))}
    got = set(out["metrics"])
    if trace:
        # A CPU run writes no device number; the host spans remain.
        assert got <= want and got == {n for n in want if n in ("pass_ms", "stop_check_ms")}
        assert out["device"]["busy_s"] == 0.0
    else:
        assert got == want and all(m["value"] > 0 for m in out["metrics"].values())
    assert json.loads(json.dumps(out)) == out


def test_same_seed_same_frames(spec_all, tiny):
    """The seed fixes the inputs: two runs with one seed render the same
    frame seeds, in the same order, and judge the same pixels."""
    mix = json.loads((tiny / "mixes" / "final_16384spp.json").read_text())
    config = json.loads((tiny / "configs" / "demo2.json").read_text())
    drv = load_module("drivers", "job_frames", tiny)

    def seeds(seed):
        d = drv.Driver(config=config, mix=mix, scene_path=str(tiny / "configs" / "demo2.yml"), device="cpu",
                       seed=seed, spans=harness.Spans())
        d.setup()
        d.window(0.2)
        d.close()
        return [f.seed for f in d.frames], d.verify()

    a, b, c = seeds(SEED), seeds(SEED), seeds(SEED + 1)
    n = min(len(a[0]), len(b[0]))
    assert a[0][:n] == b[0][:n] and a[0][0] != c[0][0]
    assert harness.frame_seed(SEED, 3) == harness.frame_seed(SEED, 3) < 2**32


def test_a_new_config_mix_and_metric_are_found_by_name(spec_all, tiny):
    """A cell, a traffic mix and a per-layer metric added as new files in a
    directory of their own, without editing any file that is there."""
    cfg = json.loads((tiny / "configs" / "demo2.json").read_text())
    cfg["name"] = "demo2_wide"
    (tiny / "configs" / "demo2_wide.json").write_text(json.dumps(cfg))
    mix = {"driver": "job_frames", "sample_root": 1, "rows_per_unit": 5, "nee": True, "keep_frames": 2,
           "pixels_per_unit": 3}
    (tiny / "mixes" / "nee_preview.json").write_text(json.dumps(mix))
    (tiny / "metrics" / "units_per_frame.py").write_text(
        "def read(run):\n    return sum(1 for _ in range(0, 12, run.mix['rows_per_unit']))\n")
    (tiny / "limits" / "demo2_wide.nee_preview.json").write_text(
        json.dumps({"max_abs_diff": 0.0, "mean_abs_diff": 0.0, "bad_frames": 0, "stray_launches": 0}))
    spec = dict(spec_all)
    spec["configs"] = spec["configs"] + [{"name": "demo2_wide", "source": "x", "file": "x", "reduced": [],
                                          "why": "x"}]
    spec["workloads"] = spec["workloads"] + [{"name": "demo2_wide.nee_preview", "config": "demo2_wide",
                                              "traffic": "nee_preview", "chips": 1, "why": "x"}]
    spec["per_layer"] = spec["per_layer"] + [{"name": "units_per_frame", "unit": "units", "better": "lower",
                                              "source": "program_counter", "layer": "job path",
                                              "moves": "setup_s", "workloads": ["demo2_wide.nee_preview"]}]
    out = run_cell(spec, "demo2_wide.nee_preview", 7, 0.2, True, device="cpu", base=tiny)
    assert out["correct"] and out["metrics"]["units_per_frame"]["value"] == 3


def test_forbidden_names_are_compared_whole():
    assert forbidden_modules(["flux_tpu_torch", "flux_tpu_torch.render", "numpy"]) == []
    assert forbidden_modules(["flux_tpu.render", "jax", "jaxlib.xla", "flax", "jaxtyping"]) == [
        "flax", "flux_tpu.render", "jax", "jaxlib.xla"]


def _modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json; print(json.dumps(sorted(sys.modules)))"],
                         cwd=REPO_DIR, capture_output=True, text=True, timeout=300, check=True)
    return {m.split(".")[0] for m in json.loads(out.stdout.splitlines()[-1])}


def test_the_harness_and_a_run_load_no_jax_nor_flux_tpu(spec_all, tmp_path):
    (tmp_path / "spec.json").write_text(json.dumps(spec_all))
    code = (f"import sys, json; sys.path.insert(0, {str(REPO_DIR / 'benchmark' / 'tests')!r})\n"
            "from pathlib import Path\nfrom conftest import make_tiny\nfrom benchmark.harness import run_cell\n"
            f"base = make_tiny(Path({str(tmp_path)!r}))\nspec = json.loads((base / 'spec.json').read_text())\n"
            "for c in ('demo2.final_16384spp', 'demo2.adaptive_0.12'):\n"
            "    assert run_cell(spec, c, 3, 0.1, True, device='cpu', base=base)['correct']\n")
    top = _modules_after(code)
    assert "flux_tpu_torch" in top and not top & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    top = _modules_after("import benchmark.reference.render, benchmark.roofline")
    assert not top & {"flux_tpu_torch", *harness.FORBIDDEN}


def test_the_command_refuses_without_a_card_and_prints_no_result(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", "demo2.final_16384spp", "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_the_command_fails_without_the_program(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark's files the
    command exits with an error and prints no result."""
    import shutil

    shutil.copy(REPO_DIR / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO_DIR / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "demo2.final_16384spp", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_check_values_stay_json():
    from benchmark.drivers.progressive import rel_gap

    assert rel_gap([float("nan")], [1.0]) == 1e300
    assert rel_gap([1.001], [1.0]) == pytest.approx(1e-3)
    assert rel_gap([0.0], [1e-9]) == pytest.approx(1e-7)


def test_kernel_config_names():
    from benchmark.harness import kernel_config

    assert kernel_config({"kernel_family": "sweep"}, {}, False) == "sweep"
    assert kernel_config({"kernel_family": "sweep"}, {}, True) == "sweep+stats"
    assert kernel_config({"kernel_family": "sweep+tri", "tri_lights": True}, {"nee": True}, False) == \
        "sweep+tri+nee+trilight"
