"""Package-level checks of the port: its import boundary, its device rules,
the kernel wrapper's CPU route, the scene loader, the CLI's output, the
entry points the documents name, and the gates on the JAX package's stored
results."""

import dataclasses
import fnmatch
import importlib
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import tomllib
import types
import torch
import yaml

from flux_tpu.image import ppm_bytes as j_ppm_bytes
from flux_tpu.scene import load_scene as j_load_scene
from flux_tpu_torch import artifacts, cli, f64_audit, genscene, oracle
from flux_tpu_torch.camera import camera_tensors
from flux_tpu_torch.ops import build, scene_kernel
from flux_tpu_torch.ops.scene_kernel import render_block_scene
from flux_tpu_torch.ops.sweep_kernel import pack_scene, render_block_sweep
from flux_tpu_torch.render import Renderer, render_block
from flux_tpu_torch.scene import MaterialData, MaterialKind, TriangleData, compile_scene, load_scene

REPO = Path(__file__).resolve().parent.parent
SCENES = sorted((REPO / "scenes").glob("*.yml"))
PORT_FILES = sorted((REPO / "flux_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
# The documents that give the port's commands.
COMMAND_DOCS = [REPO / "README.md", REPO / ".claude" / "skills" / "verify" / "SKILL.md"]
DOCUMENTED_MODULES = sorted({m for doc in COMMAND_DOCS
                             for m in re.findall(r"python3?\s+-m\s+flux_tpu_torch\.(\w+)", doc.read_text())})


def test_import_boundary_in_a_fresh_process():
    """Every module of the port, and chip_smoke.py, imports with neither JAX
    nor the JAX package loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import flux_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(flux_tpu_torch.__path__, 'flux_tpu_torch.')]\n"
        "for n in names + ['chip_smoke']:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'flux_tpu' or m.startswith('flux_tpu.'))\n"
        "assert not bad, bad\n"
        "assert len(names) >= 15, names\n"
        "new = {'flux_tpu_torch.' + m for m in ('artifacts', 'oracle', 'f64_audit')}\n"
        "assert new <= set(names), sorted(new - set(names))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_the_oracle_imports_none_of_what_it_judges():
    """flux_tpu_torch.oracle, the float64 judge, loads none of the float32
    path's modules: not the samplers, the intersection, the shading, NEE or
    the renderer (the frame-epsilon pin reads ops/brdf.py's source). Before
    it, a fresh ``import flux_tpu_torch`` loads none of its modules: each
    package-level name loads its module at first use."""
    code = (
        "import sys\n"
        "import flux_tpu_torch as ft\n"
        "loaded = sorted(m for m in sys.modules if m.startswith('flux_tpu_torch.'))\n"
        "assert not loaded, loaded\n"
        "import flux_tpu_torch.oracle\n"
        "judged = ('samplers', 'ops.intersect', 'ops.shade', 'ops.nee', 'render')\n"
        "bad = sorted(m for m in sys.modules if any(m == 'flux_tpu_torch.' + j\n"
        "             or m.startswith('flux_tpu_torch.' + j + '.') for j in judged))\n"
        "assert not bad, bad\n"
        "assert 'flux_tpu_torch.constants' in sys.modules and 'flux_tpu_torch.scene' in sys.modules\n"
        "assert ft.SceneData.__module__ == 'flux_tpu_torch.scene' and 'flux_tpu_torch.render' not in sys.modules\n"
        "assert ft.Renderer.__module__ == 'flux_tpu_torch.render'\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def _jax_package_names() -> list:
    """The names flux_tpu/__init__.py exports: what it imports from its
    modules, and the submodules its ``__getattr__`` loads lazily."""
    src = (REPO / "flux_tpu" / "__init__.py").read_text()
    names = [n.strip() for line in re.findall(r"^from \.\w* import ([\w, ]+)", src, re.M) for n in line.split(",")]
    lazy = re.search(r"if name in \(([^)]*)\)", src).group(1)
    return names + re.findall(r'"(\w+)"', lazy)


def test_package_level_names_resolve_to_their_namesakes():
    """Every name flux_tpu exports at its top level resolves on the port,
    to the port's object of the same name in the module of the same name."""
    import importlib

    import flux_tpu
    import flux_tpu_torch

    names = _jax_package_names()
    assert len(names) == 17 and sorted(flux_tpu_torch.__all__) == sorted(names)
    for name in names:
        j_obj, obj = getattr(flux_tpu, name), getattr(flux_tpu_torch, name)
        if isinstance(j_obj, types.ModuleType):
            assert obj is importlib.import_module(f"flux_tpu_torch.{name}"), name
        else:
            module = "flux_tpu_torch" + j_obj.__module__[len("flux_tpu"):]
            assert obj is getattr(importlib.import_module(module), name), name
    assert flux_tpu_torch.Renderer is Renderer and flux_tpu_torch.compile_scene is compile_scene
    with pytest.raises(AttributeError):
        flux_tpu_torch.no_such_name


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_import_in_source(path):
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flux_tpu)(\.|\s|$)", re.M)
    assert not pattern.search(path.read_text())


@pytest.mark.parametrize("path", SCENES, ids=lambda p: p.name)
def test_loader_matches_jax_package(path):
    """Every stock scene loads to the same SceneData as the JAX package's
    loader gives (PyYAML's safe_load on both sides; anchors, Mesh)."""
    assert load_scene(str(path)).to_dict() == j_load_scene(str(path)).to_dict()
    assert yaml.safe_load(path.read_text())["scene_name"] == load_scene(str(path)).scene_name


def _tiny_scene(tmp_path, w=16, h=12):
    doc = yaml.safe_load((REPO / "scenes" / "demo2.yml").read_text())
    doc["output_settings"].update(image_width=w, image_height=h, pixel_size=0.5 * 800 / w)
    path = tmp_path / "tiny.yml"
    path.write_text(yaml.safe_dump(doc))
    return path


def test_entry_points_need_the_card_by_default(tmp_path):
    """Renderer(), the CLI, the float64 oracle and the precision audit pick
    CUDA and raise when it is absent; they never carry on silently on the
    CPU, and write nothing."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    sd = load_scene(str(_tiny_scene(tmp_path)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Renderer(sd, 1, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([str(_tiny_scene(tmp_path)), "--output-dir", str(tmp_path)])
    assert not (tmp_path / "demo2.ppm").exists()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        f64_audit.main([str(_tiny_scene(tmp_path)), "--root", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        oracle.oracle_render(sd, 1, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        oracle.precision_audit(sd, 1, 2)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["tiny.yml"]


def _with_triangle(sd, kind):
    """``sd`` plus one triangle of material ``kind``."""
    tri = TriangleData(v0=(0.0, 0.1, 0.0), v1=(1.0, 0.1, 0.0), v2=(0.0, 0.1, 1.0),
                       material=MaterialData(kind=kind, color=(1.0, 1.0, 1.0), param=5.0))
    return dataclasses.replace(sd, shapes=sd.shapes + (tri,))


@pytest.mark.parametrize(
    "change, kwargs, accel",
    [
        (None, {"accel": "scan"}, "scan"),
        (MaterialKind.MATTE, {}, "sweep"),
        (MaterialKind.EMISSIVE, {"nee": True}, "sweep"),
    ],
    ids=["scan", "triangles", "triangle_lights"],
)
def test_unported_options_raise(tmp_path, change, kwargs, accel):
    """The options earlier slices of the port refused (the scan, triangle
    geometry, triangle lights) no longer raise: each renders a finite frame
    through the scene megakernel's route, and the frame shows the option at
    work (the scan equals the sweep bit for bit; a matte triangle changes
    pixels; a triangle light is in the light set and adds light)."""
    sd = load_scene(str(_tiny_scene(tmp_path)))
    base = Renderer(sd, 2, 2, device="cpu", nee=kwargs.get("nee", False)).render_image()
    if change is not None:
        sd = _with_triangle(sd, change)
    r = Renderer(sd, 2, 2, device="cpu", **kwargs)
    assert r.accel == accel and not r.uses_sweep_kernel
    img = r.render_image()
    assert img.shape == base.shape and np.isfinite(img).all()
    if change is None:
        np.testing.assert_array_equal(img, base)
    else:
        assert r.scene.num_triangles == 1 and np.abs(img - base).max() > 1e-3
    if change == MaterialKind.EMISSIVE:
        assert r.lights.has_tris and r.lights.kinds[-1] == "tri"


@pytest.mark.parametrize("case", ["20 planes", "101 spheres, accel sweep"])
def test_scenes_past_the_sweeps_caps_go_to_the_scene_kernel(case):
    """The sweep megakernel holds at most 16 planes and 64 spheres in
    constant memory; the reference has no such caps. A scene with more
    planes goes to the scene megakernel (planes from its table), a sweep over
    more spheres takes the scan, and the scene kernel's tables pack either
    without raising."""
    if case == "20 planes":
        sd = genscene.plane_ring(load_scene(str(REPO / "scenes" / "demo2.yml")), 19)
        r = Renderer(sd, 1, 2, device="cpu")
        assert r.accel == "sweep" and r.scene.num_planes == 20
    else:
        sd = genscene.sphere_field(100, seed=2)
        r = Renderer(sd, 1, 2, device="cpu", accel="sweep")
        assert r.accel == "scan" and r.scene.num_spheres == 101
    assert not r.uses_sweep_kernel
    geom, keep = scene_kernel.pack_geom(r.scene, r.isect, None, "cpu")
    assert geom.n_planes == r.scene.num_planes and geom.scan == (r.accel == "scan")
    assert bool(geom.pl_point) == (r.scene.num_planes > 16)
    rec = pack_scene(r.scene, r.cam, spheres=r.accel == "sweep", planes=r.scene.num_planes <= 16)
    assert rec.n_spheres == (r.scene.num_spheres if r.accel == "sweep" else 0)
    with pytest.raises(ValueError, match="at most"):
        pack_scene(r.scene, r.cam)


def test_package_ships_every_kernel_source_and_the_cli():
    """An installed port builds its kernels: every file that the build
    hashes (build.LIBRARIES: each source and the headers it includes) is
    package data, the CLI has its console script, and the libraries go to
    build/flux_tpu_torch/ in a checkout and to the user's cache elsewhere."""
    meta = tomllib.loads((REPO / "pyproject.toml").read_text())
    globs = meta["tool"]["setuptools"]["package-data"]["flux_tpu_torch"]
    files = {f"csrc/{name}.cu" for name in build.LIBRARIES}
    files |= {f"csrc/{h}" for headers in build.LIBRARIES.values() for h in headers}
    for f in sorted(files):
        assert (REPO / "flux_tpu_torch" / f).is_file(), f
        assert any(fnmatch.fnmatch(f, g) for g in globs), f"{f} is not package data"
    assert meta["project"]["scripts"]["flux-tpu-torch"] == "flux_tpu_torch.cli:main"
    assert meta["project"]["scripts"]["flux-tpu-torch-genscene"] == "flux_tpu_torch.genscene:main"
    assert build.BUILD_DIR == REPO / "build" / "flux_tpu_torch"


def test_wrapper_takes_the_plain_path_on_cpu():
    sd = load_scene(str(REPO / "scenes" / "demo1.yml"))
    sc = compile_scene(sd, "cpu")
    cam = camera_tensors(sd.camera_settings, sd.camera_data, sd.output_settings.pixel_size, "cpu")
    kw = dict(img_w=800, img_h=600, n_rows=1, n_samples=2, root=2, max_depth=3)
    before = render_block_sweep.launches.total()
    got = render_block_sweep(sc, cam, 300, 0, 9, **kw)
    assert render_block_sweep.launches.total() == before
    assert torch.equal(got, render_block(sc, cam, 300, 0, 9, **kw))
    with pytest.raises(ValueError):
        render_block_sweep(sc, cam, 300, 0, 9, bounce_counts=torch.zeros(800, dtype=torch.int32), **kw)
    # The scene megakernel's wrapper takes the same route on the CPU.
    r = Renderer(sd, 2, 3, device="cpu", accel="scan")
    before = render_block_scene.launches.total()
    got = render_block_scene(sc, cam, 300, 0, 9, isect=r.isect, **kw)
    assert render_block_scene.launches.total() == before
    assert torch.equal(got, render_block(sc, cam, 300, 0, 9, isect=r.isect, **kw))
    with pytest.raises(ValueError):
        render_block_scene(sc, cam, 300, 0, 9, isect=r.isect,
                           work_counts=torch.zeros((12, 800), dtype=torch.int32), **kw)


def test_cli_cpu_writes_the_jax_packages_ppm_bytes(tmp_path):
    scene_file = _tiny_scene(tmp_path)
    out = tmp_path / "out"
    assert cli.main([str(scene_file), "-r", "2", "-d", "3", "-R", "5", "--seed", "4",
                     "--device", "cpu", "--output-dir", str(out)]) == 0
    data = (out / "demo2.ppm").read_bytes()
    pixels = Renderer(load_scene(str(scene_file)), 2, 3, seed=4, device="cpu").render_image(5)
    assert data.startswith(b"P3\n16 12\n65535\n")
    assert data == j_ppm_bytes(pixels)
    assert np.isfinite(pixels).all() and pixels.max() > 0


def test_cli_run_reports_its_output_and_band_loop(tmp_path):
    """cli.run is cli.main without the exit code: it returns the PPM path,
    the band loop's seconds and the number of samples rendered."""
    out = tmp_path / "out"
    ran = cli.run([str(_tiny_scene(tmp_path)), "-r", "2", "-d", "2", "-R", "4",
                   "--device", "cpu", "--output-dir", str(out)])
    assert ran["out"] == str(out / "demo2.ppm") and (out / "demo2.ppm").exists()
    assert ran["samples"] == 16 * 12 * 4
    assert ran["band_seconds"] > 0


@pytest.mark.parametrize("name", DOCUMENTED_MODULES)
def test_documented_commands_resolve(name):
    """Every ``python -m flux_tpu_torch.<module>`` of README.md and the
    verify skill names a module of the package with a ``main`` that running
    it as a script calls."""
    module = importlib.import_module(f"flux_tpu_torch.{name}")
    assert callable(getattr(module, "main", None)), f"flux_tpu_torch.{name} has no main"
    _, guard, body = Path(module.__file__).read_text().partition('\nif __name__ == "__main__":\n')
    assert guard and re.search(r"\bmain\(\)", body), f"python -m flux_tpu_torch.{name} does not call main"


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
