"""The port's bench, perf harness and MSE check (``flux_tpu_torch.bench``,
``perf``, ``mse_check``) on the CPU, and its scan against a float64
nearest-sphere hit at 257 and 1024 spheres.

Each bench cell runs at 16x12 and depth 2 through ``bench.run_cell`` and
through ``flux_tpu`` with ``bench.py``'s other parameters for that cell
(scene, seed, flags, the MIS truth's root and seed, passes of 64; one band
of the frame's height). The JAX side runs op by
op: its ``Renderer`` calls the un-jitted ``render_block_impl`` in place of
the jitted ``render_block``, as the other port tests call it, so no render
program is compiled (only the bodies of the sphere and triangle folds'
``lax.scan``, as ``lax.scan`` compiles them outside ``jit``). Frames are held
at tests/test_torch_render.py's gate, the adaptive stop to the same
samples, the MIS cell's MSE to rtol 1e-3.
"""

import functools
import json
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

from flux_tpu import checkpoint as jcp
from flux_tpu import render as jrender
from flux_tpu.meshgen import icosphere as j_icosphere
from flux_tpu.meshgen import mesh_scene as j_mesh_scene
from flux_tpu.scene import load_scene as j_load_scene
from flux_tpu_torch import artifacts, bench, genscene, mse_check, perf
from flux_tpu_torch.ops.intersect import Intersector, scan_layout
from flux_tpu_torch.render import Renderer
from flux_tpu_torch.scene import compile_scene
from flux_tpu_torch.vec import Vec3

REPO = Path(__file__).resolve().parent.parent
SIZE = (16, 12)
# Each cell's root at SIZE: the adaptive cell at root 16 with noise target
# 0.25 stops after 3 of its 4 passes of 64 (p99 0.30, 0.24 at this size).
# Two bounces, as the kernel parity tests take them: the first hit and its
# scatter, shadow and MIS weights, and the second hit (every bounce runs the
# same code). Each cell's root at SIZE: 1, and the adaptive cell's 16 with
# noise target 0.5, which it meets after 3 of its 4 passes of 64 (p99 0.61,
# then 0.48, at this size and depth).
DEPTH = 2
ROOT = {name: 16 if cell.kind == "adaptive" else 1 for name, cell in bench.CELLS.items()}
ADAPTIVE_TARGET = 0.5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Several workers share the CPU's cores under the tier-1 command; the
    renders' bits do not depend on the thread count (as in
    tests/test_torch_parallel.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _jax_scene(cell):
    if cell.scene == "mesh1280":
        sd = j_mesh_scene(*j_icosphere(3), width=800, height=600)
    else:
        sd = j_load_scene(str(REPO / "scenes" / f"{cell.scene}.yml"))
    out = sd.output_settings
    return replace(sd, output_settings=replace(out, image_width=SIZE[0], image_height=SIZE[1],
                                               pixel_size=out.pixel_size * out.image_width / SIZE[0]))


@functools.lru_cache(maxsize=None)
def jax_cell(name):
    """bench.py's cell ``name`` through flux_tpu at SIZE and ROOT[name]:
    its value and its frame."""
    cell, root = bench.CELLS[name], ROOT[name]
    sd = _jax_scene(cell)
    h = sd.output_settings.image_height
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrender, "render_block", jrender.render_block_impl)
        if cell.kind == "adaptive":
            pr = jcp.ProgressiveRenderer(sd, root, DEPTH, seed=bench.SEED)
            err = None
            while not pr.complete:
                pr.render_pass(bench.PASS_SPP)
                err = pr.max_rel_stderr()
                if err is not None and err < ADAPTIVE_TARGET:
                    break
            return {"spp_done": pr.samples_done, "p99_rel_stderr": err}, np.asarray(pr.peek())
        img = jrender.Renderer(sd, root, DEPTH, seed=bench.SEED, nee=cell.nee,
                               physical=cell.physical).render_image(rows_per_band=h)
        value = {}
        if cell.kind == "mis":
            truth = jrender.Renderer(sd, bench.TRUTH_ROOT_FACTOR * root, DEPTH, seed=bench.TRUTH_SEED,
                                     nee=True, physical=True).render_image(rows_per_band=h)
            value["mse_vs_1024spp"] = float(((img - truth) ** 2).mean())
        return value, img


@pytest.mark.parametrize("name", list(bench.CELLS))
def test_each_cell_matches_the_jax_package(name):
    cell = bench.CELLS[name]
    target = ADAPTIVE_TARGET if cell.kind == "adaptive" else None
    entry, img = bench.run_cell(name, "cpu", size=SIZE, root=ROOT[name], depth=DEPTH, reps=1, target=target)
    want_value, want = jax_cell(name)
    assert entry["gates"] == "not at the published size" and entry["launches"] == {}
    assert img.shape == want.shape == (SIZE[1], SIZE[0], 3) and np.isfinite(img).all()
    # 99% of values within float32 rounding: tests/test_torch_render.py's
    # gate, and with NEE tests/test_torch_nee.py's (XLA's FMA contraction,
    # magnified by a light cone's 1 - cos_max).
    rtol, atol = (1e-4, 1e-5) if cell.nee else (1e-5, 1e-6)
    close = np.isclose(img, want, rtol=rtol, atol=atol)
    assert close.mean() >= 0.99, f"{(~close).sum()} of {close.size} values differ"
    if cell.kind == "adaptive":
        assert 0 < entry["spp_done"] < entry["spp_max"] == ROOT[name] ** 2
        assert entry["spp_done"] == want_value["spp_done"]
        assert entry["p99_rel_stderr"] == pytest.approx(want_value["p99_rel_stderr"], rel=1e-4)
    elif cell.kind == "mis":
        assert entry["mse_vs_1024spp"] == pytest.approx(want_value["mse_vs_1024spp"], rel=1e-3)
    else:
        assert len(entry["all_runs_s"]) == 1 and entry["spp"] == ROOT[name] ** 2


def test_bench_line_and_a_failed_cell(tmp_path, monkeypatch, capsys):
    """main prints one JSON line with bench.py's fields, writes its outputs
    to --out only, and exits non-zero when a cell fails, with the others
    present and the failure in the failed cell's entry."""
    stored = {p.name: p.stat().st_mtime_ns for p in artifacts.ARTIFACTS.glob("*") if p.is_file()}

    def broken(*a, **k):
        raise RuntimeError("a cell made to fail")

    monkeypatch.setattr(bench.meshgen, "icosphere", broken)
    rc = bench.main(["--device", "cpu", "--out", str(tmp_path)], size=(8, 6), root=1, depth=1, reps=1)
    lines = capsys.readouterr().out.strip().splitlines()
    assert rc == 1 and len(lines) == 1
    line = json.loads(lines[0])
    for key in ("metric", "value", "unit", "vs_baseline", "wall_clock_s", "all_runs_s",
                "baseline_wall_clock_s", "spp", "devices", "card"):
        assert key in line, key
    assert line["metric"] == bench.HEADLINE and line["devices"] == 1 and line["card"] == "cpu"
    assert line["value"] > 0 and line["vs_baseline"] == line["value"] / bench.BASELINE_MSAMPLES_PER_S
    assert set(line["extra"]) == set(bench.CELLS) - {bench.HEADLINE}
    assert line["extra"]["mesh1280_16spp"] == {"error": "RuntimeError('a cell made to fail')"}
    assert all("error" not in e for k, e in line["extra"].items() if k != "mesh1280_16spp")
    assert json.loads((tmp_path / "bench_extra.json").read_text()) == line["extra"]
    assert (tmp_path / "demo2_16384spp.png").is_file()
    assert json.loads((tmp_path / "bench_history.jsonl").read_text())["value"] == line["value"]
    assert {p.name: p.stat().st_mtime_ns for p in artifacts.ARTIFACTS.glob("*") if p.is_file()} == stored


def test_failures_are_gates_errors_and_nothing_else():
    ok = {"gates": [artifacts.gate("g", 1, 2, True)]}
    assert bench._failures(ok) == [] and bench._failures({"gates": "not at the published size"}) == []
    assert bench._failures({"gates": [artifacts.gate("g", 3, 2, False)]}) == ["g"]
    assert bench._failures({"error": "RuntimeError()"}) == ["RuntimeError()"]


def test_default_out_is_git_ignored():
    ignored = {line.strip().rstrip("/") for line in (REPO / ".gitignore").read_text().splitlines()}
    rel = bench.DEFAULT_OUT.relative_to(REPO)
    assert rel.parts[0] in ignored and rel.parts[0] != "artifacts"


def test_published_gates_hold_the_stored_values():
    """The gates take the JAX package's stored values: the adaptive stop and
    the MIS MSE of bench_extra.json, and a frame against its own PNG."""
    extra = json.loads((artifacts.ARTIFACTS / "bench_extra.json").read_text())
    stop, mis = extra["demo2_adaptive_stop"], extra["demo3_physical_mis_16spp"]
    assert (artifacts.ADAPTIVE_SPP, artifacts.ADAPTIVE_P99) == (stop["spp_done"], stop["p99_rel_stderr"])
    assert artifacts.MIS_MSE == mis["mse_vs_1024spp"]
    assert not artifacts.failed(artifacts.adaptive_gates(768, 0.11674197))
    assert artifacts.failed(artifacts.adaptive_gates(832, 0.11674197))
    assert artifacts.failed(artifacts.mis_gates(1.03 * artifacts.MIS_MSE))
    frame = artifacts.png_levels("demo5_cornell_2304spp.png") / 255.0
    stats = artifacts.frame_vs_png(frame, "demo5_cornell_2304spp.png")
    assert stats["max_abs_levels"] == 0
    assert not artifacts.failed(artifacts.frame_gates(stats, artifacts.CORNELL_GATES, "demo5_cornell_2304spp.png"))
    assert artifacts.failed(artifacts.frame_gates({**stats, "mean_abs_levels": 3.5}, artifacts.CORNELL_GATES, "x"))


def test_perf_fields_and_refused_tpu_flags(capsys):
    argv = ["--field", "16", "--width", "8", "--height", "6", "--root", "1", "--depth", "2", "--reps", "3",
            "--device", "cpu"]
    assert perf.main(argv) == 0
    out = json.loads(capsys.readouterr().out)
    assert set(out) == {"wall_min_s", "wall_med_s", "msamples_per_s_best", "msamples_per_s_med", "times",
                        "checksum", "card"}
    assert len(out["times"]) == 3 and out["wall_min_s"] == min(out["times"]) <= out["wall_med_s"]
    assert out["card"] == "cpu" and out["checksum"] > 0
    for flag in (["--s-blk", "8"], ["--early-exit", "false"]):
        with pytest.raises(NotImplementedError, match="TPU"):
            perf.main(argv + flag)


def test_mse_check_fields_and_value(capsys, monkeypatch):
    """The MSE of demo2 against the stored frame, from rows of the frame:
    the JSON's fields, and the value of one band computed here."""
    rows = (296, 2)
    want = mse_check.mse_vs_reference(1, [0], "cpu", rows=rows)[0]
    r = Renderer(bench.scene_of(bench.CELLS[bench.HEADLINE]), 1, 5, seed=0, device="cpu")
    ref = artifacts.png_levels("demo2_16384spp.png")[296:298] / 255.0
    assert want == float(np.mean((r.render_rows(*rows).astype(np.float64) - ref) ** 2))
    monkeypatch.setattr(mse_check, "mse_vs_reference", lambda root, seeds, dev: [want * (1 + s) for s in seeds])
    assert mse_check.main(["--root", "2", "--seeds", "0", "1", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out == {"root": 2, "spp": 4, "mse_per_seed": [want, 2 * want], "mse_mean": 1.5 * want, "card": "cpu"}


def _nearest_sphere_f64(centers, radii, o, d, t_min=5e-4):
    """The sweep's sphere test (shapes.rs:176-211) in float64 over every
    sphere: the nearest t past t_min, and its sphere."""
    oc = o[None, :, :] - centers[:, None, :]
    a = (d * d).sum(-1)[None]
    b_half = (oc * d[None]).sum(-1)
    c = (oc * oc).sum(-1) - (radii ** 2)[:, None]
    disc = b_half * b_half - a * c
    e = np.sqrt(np.maximum(disc, 0.0))
    t_near = (-b_half - e) / a
    t = np.where(t_near > t_min, t_near, (-b_half + e) / a)
    t = np.where((disc >= 0.0) & (t > t_min), t, np.inf)
    return t.min(axis=0), t.argmin(axis=0)


@pytest.mark.parametrize("n, seed", [(257, 2), (1024, 3)])
def test_scan_matches_a_float64_nearest_sphere_hit(n, seed):
    """The scan (Intersector in scan mode, its plain version) on 4096 rays
    through sphere_field(n), at tests/test_scan_parity.py's gates: t within
    2e-4 where a sphere wins, and the same sphere on more than 99.9% of
    rays."""
    scene = compile_scene(genscene.sphere_field(n, seed), "cpu")
    isect = Intersector(layout=scan_layout(scene), mode="scan")
    rng = np.random.default_rng(seed + 100)
    o = rng.uniform(-30, 30, size=(4096, 3)).astype(np.float32)
    d = rng.normal(size=(4096, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    cols = lambda a: Vec3(*(torch.from_numpy(np.ascontiguousarray(a[:, k])) for k in range(3)))
    hit = isect(scene, cols(o), cols(d))
    t_ref, i_ref = _nearest_sphere_f64(scene.sphere_center.double().numpy(), scene.sphere_radius.double().numpy(),
                                       o.astype(np.float64), d.astype(np.float64))
    t_got, shape = hit.t.numpy(), hit.shape.numpy()
    check = np.isfinite(t_ref) & (shape < scene.num_spheres)
    assert check.mean() > 0.5
    np.testing.assert_allclose(t_got[check], t_ref[check], rtol=2e-4, atol=2e-4)
    assert (shape[check] == i_ref[check]).mean() > 0.999
