"""Package-level checks of the port: its import boundary, its device rules,
the kernel wrapper's CPU route, the scene loader and the CLI's output."""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from flux_tpu.image import ppm_bytes as j_ppm_bytes
from flux_tpu.scene import load_scene as j_load_scene
from flux_tpu_torch import cli
from flux_tpu_torch.camera import camera_tensors
from flux_tpu_torch.ops.scene_kernel import render_block_scene
from flux_tpu_torch.ops.sweep_kernel import render_block_sweep
from flux_tpu_torch.render import Renderer, render_block
from flux_tpu_torch.scene import MaterialData, MaterialKind, TriangleData, compile_scene, load_scene

REPO = Path(__file__).resolve().parent.parent
SCENES = sorted((REPO / "scenes").glob("*.yml"))
PORT_FILES = sorted((REPO / "flux_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


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
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


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
    """Renderer() and the CLI pick CUDA and raise when it is absent; they
    never carry on silently on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    sd = load_scene(str(_tiny_scene(tmp_path)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Renderer(sd, 1, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([str(_tiny_scene(tmp_path)), "--output-dir", str(tmp_path)])
    assert not (tmp_path / "demo2.ppm").exists()


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
