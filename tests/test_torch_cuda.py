"""The megakernels on a CUDA card against their plain PyTorch version: the
sweep megakernel in each of its 8 instantiations (K1; K2 stats; K3 NEE; K4
physical, and MIS with NEE; each of these with stats), and the scene
megakernel in its scan (K5), triangle (K6) and triangle-light (K7)
configurations, with the skip on and off and scan against sweep bitwise.

Marked ``cuda``: each test skips without a card. This file imports neither
JAX nor ``flux_tpu``, so it also runs on a machine with the card and no JAX:
``python -m pytest tests/test_torch_cuda.py -m cuda --noconftest``.
chip_smoke.py holds the kernel to the same gates on an 8-row band of demo2
and on one of the main path's launches (a 50-row band at 16384 spp).
"""

import os

import pytest
import torch

from flux_tpu_torch.camera import camera_tensors
from flux_tpu_torch.genscene import sphere_field
from flux_tpu_torch.ops import scene_kernel
from flux_tpu_torch.ops.intersect import Intersector, scan_layout, tri_layout
from flux_tpu_torch.ops.nee import extract_lights
from flux_tpu_torch.ops.scene_kernel import render_block_scene
from flux_tpu_torch.ops.sweep_kernel import config_name, render_block_sweep
from flux_tpu_torch.render import Renderer, finalize, render_block
from flux_tpu_torch.scene import (
    CameraData,
    CameraSettings,
    MaterialData,
    MaterialKind,
    OutputSettings,
    PlaneData,
    SceneData,
    SphereData,
    compile_scene,
    load_scene,
)

SCENES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "scenes")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _scene(card, name):
    sd = load_scene(os.path.join(SCENES, f"{name}.yml"))
    cam = camera_tensors(sd.camera_settings, sd.camera_data, sd.output_settings.pixel_size, card)
    return compile_scene(sd, card), cam


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["demo1", "demo2"])
def test_kernel_matches_plain(card, name):
    """Built with --fmad=false, the kernel repeats the plain version's
    float32 operations: sums agree to float32 summation order (the kernel
    sums per thread then by a tree; rtol 1e-5) except where a borderline
    branch went the other way, which the finalized-pixel gate bounds."""
    sc, cam = _scene(card, name)
    kw = dict(img_w=800, img_h=600, n_rows=2, n_samples=9, root=3, max_depth=5)
    before = render_block_sweep.launches["sweep"]
    k = render_block_sweep(sc, cam, 299, 0, 11, **kw)
    k2 = render_block_sweep(sc, cam, 299, 0, 11, **kw)
    torch.cuda.synchronize()
    assert render_block_sweep.launches["sweep"] == before + 2
    assert torch.equal(k.view(torch.int32), k2.view(torch.int32))  # bitwise deterministic
    p = render_block(sc, cam, 299, 0, 11, **kw)
    close = torch.isclose(k, p, rtol=1e-5, atol=1e-6)
    assert close.float().mean() >= 0.99
    fd = (finalize(k, root=3) - finalize(p, root=3)).abs()
    assert fd.mean() < 1e-3 and (fd > 5e-3).float().mean() < 0.01


# (scene, nee, physical, stats): every instantiation beyond K1 (the
# progressive path adds stats to each), on the scenes whose lights and
# materials exercise it.
CONFIGS = [
    ("demo2", False, False, True),
    ("demo2", True, False, False),
    ("demo3", True, False, False),
    ("demo3", False, True, False),
    ("demo3", True, True, False),
    ("demo2", True, False, True),
    ("demo3", False, True, True),
    ("demo3", True, True, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name, nee, physical, stats", CONFIGS)
def test_kernel_configs_match_plain(card, name, nee, physical, stats):
    """K2 (stats), K3 (NEE) and K4 (physical, MIS with NEE) against the
    plain version on a full-width band: bitwise deterministic, the launch
    counted under its own instantiation, sums within float32 rounding on
    99% of values (rtol 1e-4: cos, sin, pow and rsqrt on the card differ
    from torch's by a few ulp, and 1 - cos_max of a small light magnifies
    that), the finalized gate of phase 3 of chip_smoke.py, and sample
    ranges that add up."""
    sd = load_scene(os.path.join(SCENES, f"{name}.yml"))
    sc, cam = _scene(card, name)
    lights = extract_lights(sd, card) if nee else None
    kw = dict(img_w=800, img_h=600, n_rows=4, root=4, max_depth=5, lights=lights, physical=physical,
              with_stats=stats)
    cfg = config_name(stats, nee, physical)
    before = render_block_sweep.launches[cfg]
    k = render_block_sweep(sc, cam, 300, 0, 11, n_samples=16, **kw)
    k2 = render_block_sweep(sc, cam, 300, 0, 11, n_samples=16, **kw)
    torch.cuda.synchronize()
    assert render_block_sweep.launches[cfg] == before + 2
    assert k.shape == (4, 800, 4 if stats else 3)
    assert torch.equal(k.view(torch.int32), k2.view(torch.int32))
    p = render_block(sc, cam, 300, 0, 11, n_samples=16, **kw)
    assert torch.isclose(k, p, rtol=1e-4, atol=1e-5).float().mean() >= 0.99
    fd = (finalize(k[..., :3], root=4) - finalize(p[..., :3], root=4)).abs()
    assert fd.mean() < 1e-3 and (fd > 5e-3).float().mean() < 0.01
    parts = render_block_sweep(sc, cam, 300, 0, 11, n_samples=8, **kw) + render_block_sweep(
        sc, cam, 300, 8, 11, n_samples=8, **kw)
    assert float(((parts - k).abs() / k.abs().clamp_min(1e-30)).max()) <= 1e-5


def _edge_scenes():
    """Scenes that take the kernel's other paths: no planes, no spheres,
    and a non-unit plane normal (the a = d·d quadratic)."""
    env = SphereData(center=(0.0, 0.0, 0.0), radius=100.0, invert=True,
                     material=MaterialData(kind=MaterialKind.EMISSIVE, color=(1.0, 0.97, 0.86), param=1.0))
    ball = SphereData(center=(0.0, 1.0, 0.0), radius=1.0, material=MaterialData(
        kind=MaterialKind.GLOSSY, color=(0.9, 1.0, 0.9), param=0.9, exponent=100.0))
    mirror = SphereData(center=(1.5, 0.8, 1.0), radius=0.8, material=MaterialData(
        kind=MaterialKind.REFLECTIVE, color=(0.9, 0.9, 0.9), param=1.0))

    def floor(normal):
        return PlaneData(point=(0.0, 0.0, 0.0), normal=normal, material=MaterialData(
            kind=MaterialKind.MATTE, color=(0.5, 0.5, 0.5), param=1.0))

    def scene(shapes, bg=(0.0, 0.0, 0.0)):
        return SceneData(
            scene_name="edge", background=bg, shapes=tuple(shapes),
            output_settings=OutputSettings(image_width=64, image_height=48, pixel_size=0.5 * 12.5),
            camera_settings=CameraSettings(eye=(0.0, 1.0, -9.0), look_at=(0.0, 1.0, 0.0), up=(0.0, 1.0, 0.0)),
            camera_data=CameraData(lens_radius=0.05),
        )

    return {
        "no_planes": scene([env, ball, mirror]),
        "no_spheres": scene([floor((0.0, 1.0, 0.0))], bg=(0.2, 0.4, 0.6)),
        "non_unit_plane": scene([env, ball, mirror, floor((0.0, 2.0, 0.0))]),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["no_planes", "no_spheres", "non_unit_plane"])
def test_kernel_matches_plain_edge_scenes(card, case):
    sd = _edge_scenes()[case]
    sc = compile_scene(sd, card)
    cam = camera_tensors(sd.camera_settings, sd.camera_data, sd.output_settings.pixel_size, card)
    assert sc.unit_d == (case != "non_unit_plane")
    kw = dict(img_w=64, img_h=48, n_rows=48, n_samples=16, root=4, max_depth=5)
    k = render_block_sweep(sc, cam, 0, 0, 5, **kw)
    p = render_block(sc, cam, 0, 0, 5, **kw)
    assert torch.isclose(k, p, rtol=1e-5, atol=1e-6).float().mean() >= 0.99
    fd = (finalize(k, root=4) - finalize(p, root=4)).abs()
    assert fd.mean() < 1e-3 and (fd > 5e-3).float().mean() < 0.01


# (scene, accel, nee, physical, stats): the scene megakernel's
# configurations on the stock scenes that reach them. spheres512 has 16
# emissive spheres (the any-hit scan fold), demo5 a two-triangle light.
SCENE_CONFIGS = [
    ("spheres512", "scan", False, False, False),
    ("spheres512", "scan", True, False, True),
    ("spheres512", "scan", True, True, False),
    ("mesh_ico", "sweep", False, False, False),
    ("mesh_ico", "sweep", True, True, True),
    ("demo4", "sweep", True, False, False),
    ("demo5", "sweep", False, False, True),
    ("demo5", "sweep", True, False, False),
    ("demo5", "sweep", True, True, False),
    ("demo5", "scan", True, True, True),
]


def _scene_setup(card, name, accel, nee):
    sd = load_scene(os.path.join(SCENES, f"{name}.yml"))
    sc = compile_scene(sd, card)
    cam = camera_tensors(sd.camera_settings, sd.camera_data, sd.output_settings.pixel_size, card)
    isect = Intersector(
        layout=scan_layout(sc) if accel == "scan" else None, mode=accel,
        tri_layout=tri_layout(sc) if sc.num_triangles else None,
    )
    w, h = sd.output_settings.image_width, sd.output_settings.image_height
    return sc, cam, isect, (extract_lights(sd, card) if nee else None), w, h


@pytest.mark.cuda
@pytest.mark.parametrize("name, accel, nee, physical, stats", SCENE_CONFIGS)
def test_scene_kernel_configs_match_plain(card, name, accel, nee, physical, stats):
    """K5 (scan), K6 (triangles) and K7 (triangle lights) against the plain
    version on a full-width band: bitwise deterministic, the launch counted
    under its configuration's name, the skip off and the single-level skip
    bitwise equal to the two-level one, sums within float32 rounding on 99%
    of values (rtol 1e-4, as for the sweep megakernel), the finalized gate,
    and sample ranges that add up."""
    sc, cam, isect, lights, w, h = _scene_setup(card, name, accel, nee)
    kw = dict(isect=isect, img_w=w, img_h=h, n_rows=4, root=4, max_depth=5, lights=lights,
              physical=physical, with_stats=stats)
    cfg = scene_kernel.config_name(accel, sc.num_triangles > 0, stats, nee, physical,
                                   tri_lights=nee and lights.has_tris)
    before = render_block_scene.launches[cfg]
    k = render_block_scene(sc, cam, h // 2, 0, 11, n_samples=16, **kw)
    k2 = render_block_scene(sc, cam, h // 2, 0, 11, n_samples=16, **kw)
    torch.cuda.synchronize()
    assert render_block_scene.launches[cfg] == before + 2
    assert k.shape == (4, w, 4 if stats else 3)
    assert torch.equal(k.view(torch.int32), k2.view(torch.int32))
    for off in (dict(scan_skip=False, tri_skip=False), dict(two_level=False), dict(tri_skip=True)):
        ko = render_block_scene(sc, cam, h // 2, 0, 11, n_samples=16, **kw, **off)
        assert torch.equal(k.view(torch.int32), ko.view(torch.int32)), off
    p = render_block(sc, cam, h // 2, 0, 11, n_samples=16, **kw)
    assert torch.isclose(k, p, rtol=1e-4, atol=1e-5).float().mean() >= 0.99
    fd = (finalize(k[..., :3], root=4) - finalize(p[..., :3], root=4)).abs()
    assert fd.mean() < 1e-3 and (fd > 5e-3).float().mean() < 0.01
    parts = render_block_scene(sc, cam, h // 2, 0, 11, n_samples=8, **kw) + render_block_scene(
        sc, cam, h // 2, 8, 11, n_samples=8, **kw)
    assert float(((parts - k).abs() / k.abs().clamp_min(1e-30)).max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("n", [24, 40])
@pytest.mark.parametrize("nee, physical", [(False, False), (True, True)])
def test_scene_kernel_scan_equals_sweep_kernel_bitwise(card, n, nee, physical):
    """The scan over the sphere table and the sweep megakernel give the same
    bits on whole launches (the same quadratic, invert/radius and
    color × param values; ties to the lowest index), as the JAX package
    holds its scan to its sweep."""
    sd = sphere_field(n, seed=3, width=160, height=120)
    scan = Renderer(sd, 4, 5, seed=1, device=card, accel="scan", nee=nee, physical=physical)
    sweep = Renderer(sd, 4, 5, seed=1, device=card, accel="sweep", nee=nee, physical=physical)
    assert not scan.uses_sweep_kernel and sweep.uses_sweep_kernel
    a = scan.render_rows_sum_range(0, 120, 0, 16, with_stats=True)
    b = sweep.render_rows_sum_range(0, 120, 0, 16, with_stats=True)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert torch.isfinite(a).float().mean() > 0.999


@pytest.mark.cuda
def test_scene_kernel_work_counts(card):
    """The work counters: a perfect skip needs no more blocks than the walk
    entered, the walk entered no more than it tested, and with the skip off
    every block of every fold is entered."""
    sc, cam, isect, lights, w, h = _scene_setup(card, "spheres512", "scan", True)
    kw = dict(isect=isect, img_w=w, img_h=h, n_rows=2, n_samples=4, root=2, max_depth=4, lights=lights)
    counts = torch.zeros((scene_kernel.N_COUNTS, 2 * w), dtype=torch.int32, device=card)
    render_block_scene(sc, cam, h // 2, 0, 5, work_counts=counts, **kw)
    c = dict(zip(scene_kernel.COUNT_NAMES, counts.to(torch.int64).sum(dim=1).tolist()))
    assert 0 < c["sphere_blocks_needed"] <= c["sphere_blocks_entered"] <= c["sphere_box_tests"]
    assert c["bounces"] >= 2 * w * 4 and c["shadow_folds"] > 0 and c["tri_blocks_entered"] == 0
    render_block_scene(sc, cam, h // 2, 0, 5, work_counts=counts, scan_skip=False, **kw)
    c2 = dict(zip(scene_kernel.COUNT_NAMES, counts.to(torch.int64).sum(dim=1).tolist()))
    assert c2["bounces"] == c["bounces"] and c2["sphere_box_tests"] == 0
    assert c2["sphere_blocks_entered"] >= c2["bounces"] * isect.layout.n_blocks
