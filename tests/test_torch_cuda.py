"""The megakernels on a CUDA card against their plain PyTorch version: the
sweep megakernel in each of its 8 instantiations (K1; K2 stats; K3 NEE; K4
physical, and MIS with NEE; each of these with stats), and the scene
megakernel in its scan (K5), triangle (K6) and triangle-light (K7)
configurations, with the skip on and off and scan against sweep bitwise,
and scenes past the sweep megakernel's caps (planes, spheres).

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
from flux_tpu_torch.genscene import plane_ring, sphere_field
from flux_tpu_torch.meshgen import icosphere, mesh_scene
from flux_tpu_torch.ops import scene_kernel
from flux_tpu_torch.ops.intersect import Intersector, scan_layout, tri_layout
from flux_tpu_torch.ops.nee import extract_lights
from flux_tpu_torch.ops.scene_kernel import render_block_scene
from flux_tpu_torch.ops.sweep_kernel import N_COUNTS, N_WORK, config_name, render_block_sweep
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
# emissive spheres (the any-hit scan fold), demo5 a two-triangle light;
# "demo5planes" is demo5 with a ring of 19 more planes (the plane table).
# demo5's NEE rows in sweep mode carry the shadow ray to the next bounce
# (the whole triangle table is folded); tri_skip=True folds it where it is
# drawn, in the other instantiations, with the same bits.
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
    ("demo5", "sweep", True, False, True),
    ("demo5", "sweep", True, True, True),
    ("demo5", "scan", True, True, True),
    ("demo5planes", "sweep", True, False, False),
    ("demo5planes", "sweep", True, True, False),
    ("demo5planes", "sweep", True, False, True),
    ("demo5planes", "sweep", True, True, True),
]


def _scene_setup(card, name, accel, nee):
    if name == "demo5planes":
        sd = plane_ring(load_scene(os.path.join(SCENES, "demo5.yml")), 19)
    elif name in ("mesh1280", "mesh20480"):
        sd = mesh_scene(*icosphere(3 if name == "mesh1280" else 5), name=name)
    else:
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
    """The work counters: a perfect skip needs no more tree leaves than the
    walk entered, the walk entered no more than it tested, and with the skip
    off every block of every fold is entered."""
    sc, cam, isect, lights, w, h = _scene_setup(card, "spheres512", "scan", True)
    kw = dict(isect=isect, img_w=w, img_h=h, n_rows=2, n_samples=4, root=2, max_depth=4, lights=lights)
    counts = torch.zeros((scene_kernel.N_COUNTS, 2 * w), dtype=torch.int32, device=card)
    render_block_scene(sc, cam, h // 2, 0, 5, work_counts=counts, **kw)
    c = dict(zip(scene_kernel.COUNT_NAMES, counts.to(torch.int64).sum(dim=1).tolist()))
    # The tree's units are its leaves (runs of scene_kernel.SCAN_LEAF spheres).
    assert 0 < c["sphere_leaves_needed"] <= c["sphere_blocks_entered"] <= c["sphere_box_tests"]
    assert c["sphere_tests"] == scene_kernel.SCAN_LEAF * c["sphere_blocks_entered"]
    assert c["sphere_blocks_needed"] > 0
    assert c["bounces"] >= 2 * w * 4 and c["shadow_folds"] > 0 and c["tri_blocks_entered"] == 0
    assert 0 < c["shadow_sphere_leaves_needed"] <= c["shadow_sphere_blocks_entered"] <= c["shadow_sphere_box_tests"]
    assert 0 < c["shadow_sphere_stops"] <= min(c["shadow_sphere_leaves_needed"], c["shadow_folds"])
    render_block_scene(sc, cam, h // 2, 0, 5, work_counts=counts, scan_skip=False, **kw)
    c2 = dict(zip(scene_kernel.COUNT_NAMES, counts.to(torch.int64).sum(dim=1).tolist()))
    assert c2["bounces"] == c["bounces"] and c2["sphere_box_tests"] == 0
    assert c2["sphere_blocks_entered"] >= c2["bounces"] * isect.layout.n_blocks


@pytest.mark.cuda
@pytest.mark.parametrize("physical", [False, True], ids=["K7", "K7+K4"])
def test_scene_kernel_carried_shadow_counts(card, physical):
    """The Cornell box's NEE arm: with the whole triangle table folded the
    shadow ray has no fold of its own (it rides beside the next bounce's
    ray, every triangle block entered once a bounce), with the triangle skip
    forced on it has; and the paths are the same either way, counter for
    counter, on the band where a skip that was not exact took a hit of a
    triangle's plane (rows 256-257, 8 spp, seed 5)."""
    sc, cam, isect, lights, w, h = _scene_setup(card, "demo5", "sweep", True)
    kw = dict(isect=isect, img_w=w, img_h=h, n_rows=2, n_samples=8, root=2, max_depth=5, lights=lights,
              physical=physical)
    got = {}
    for skip in (False, True):
        counts = torch.zeros((scene_kernel.N_COUNTS, 2 * w), dtype=torch.int32, device=card)
        render_block_scene(sc, cam, h // 2, 0, 5, work_counts=counts, tri_skip=skip, **kw)
        got[skip] = dict(zip(scene_kernel.COUNT_NAMES, counts.to(torch.int64).sum(dim=1).tolist()))
    carried, folded = got[False], got[True]
    paths = ("bounces", "light_samples", "shadow_rays", "reverse_densities", "glossy_lobes")
    assert {k: carried[k] for k in paths} == {k: folded[k] for k in paths}
    assert carried["shadow_folds"] == 0 and folded["shadow_folds"] > 0
    assert carried["tri_blocks_entered"] == carried["bounces"] * isect.tri_layout.n_blocks
    assert 0 < carried["shadow_rays"] < carried["light_samples"] < carried["bounces"]
    # What the operation bound charges: the shadow rays' part of the blocks
    # and triangles needed, and no padding slot (36 triangles in 48 slots).
    for c in (carried, folded):
        assert 0 < c["shadow_tri_blocks_needed"] < c["tri_blocks_needed"]
        assert 0 < c["shadow_tris_needed"] < c["tris_needed"] <= 36 * (c["bounces"] + c["light_samples"])
        assert c["tris_needed"] < scene_kernel.TRI_SCAN_BLOCK * c["tri_blocks_needed"]


@pytest.mark.cuda
@pytest.mark.parametrize("name, physical, stats", [("mesh1280", False, False), ("mesh_ico", True, False),
                                                   ("mesh_ico", True, True)], ids=["K6", "K6+K4", "K6+K4+K2"])
def test_triangle_skip_bitwise_equal_to_the_whole_fold(card, name, physical, stats):
    """The triangle fold's rows with the skip on (the tree over the blocks,
    and the triangles a ray runs nearly parallel to folded apart), off (every
    block folded) and by default: the same bits, on an 8-row full-width
    band; and the sums against the plain version at the gates of
    test_scene_kernel_configs_match_plain."""
    sc, cam, isect, _, w, h = _scene_setup(card, name, "sweep", False)
    kw = dict(isect=isect, img_w=w, img_h=h, n_rows=8, n_samples=16, root=4, max_depth=5, physical=physical,
              with_stats=stats)
    assert scene_kernel.tri_skip_engaged(isect.tri_layout.n_blocks)
    k = render_block_scene(sc, cam, h // 2 - 4, 0, 7, **kw)
    for skip in (True, False):
        other = render_block_scene(sc, cam, h // 2 - 4, 0, 7, tri_skip=skip, **kw)
        assert torch.equal(k.view(torch.int32), other.view(torch.int32)), skip
    p = render_block(sc, cam, h // 2 - 4, 0, 7, **kw)
    assert torch.isclose(k, p, rtol=1e-4, atol=1e-5).float().mean() >= 0.99
    fd = (finalize(k[..., :3], root=4) - finalize(p[..., :3], root=4)).abs()
    assert fd.mean() < 1e-3 and (fd > 5e-3).float().mean() < 0.01


@pytest.mark.cuda
def test_triangle_skip_past_the_lists_budget(card):
    """K6 on icosphere(5) (20,480 triangles, 1,280 blocks), whose direction
    lists take a grid coarser than the finest (past BIN_TESTS): the skip
    on, off and by default give the same bits on an 8-row full-width band
    (the plain version would take minutes on this table; K6's rows above
    hold it)."""
    sc, cam, isect, _, w, h = _scene_setup(card, "mesh20480", "sweep", False)
    assert scene_kernel.tri_bins(isect.tri_layout)[2] < scene_kernel.BIN_GRIDS[0]
    kw = dict(isect=isect, img_w=w, img_h=h, n_rows=8, n_samples=16, root=4, max_depth=5)
    k = render_block_scene(sc, cam, h // 2 - 4, 0, 7, **kw)
    assert torch.isfinite(k).all()
    for skip in (True, False):
        other = render_block_scene(sc, cam, h // 2 - 4, 0, 7, tri_skip=skip, **kw)
        assert torch.equal(k.view(torch.int32), other.view(torch.int32)), skip


def _scan_scene(card, name, nee):
    if name == "spheres512":
        return _scene_setup(card, name, "scan", nee)
    sd = sphere_field(1024, seed=4, width=400, height=300)
    sc = compile_scene(sd, card)
    cam = camera_tensors(sd.camera_settings, sd.camera_data, sd.output_settings.pixel_size, card)
    isect = Intersector(layout=scan_layout(sc), mode="scan")
    return sc, cam, isect, (extract_lights(sd, card) if nee else None), 400, 300


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["spheres512", "sphere_field(1024)"])
@pytest.mark.parametrize("nee, stats", [(False, False), (True, False), (False, True)], ids=["K5", "K5+K3", "K5+K2"])
def test_scan_walks_bitwise_equal(card, name, nee, stats):
    """The scan's sphere walk: the tree of boxes walked front to back, one
    level of block boxes and the fold over every block give the same bits
    on a full-width band (the fold keeps the lowest (t, index); a skipped
    node's widened box holds every widened block box below it)."""
    sc, cam, isect, lights, w, h = _scan_scene(card, name, nee)
    kw = dict(isect=isect, img_w=w, img_h=h, n_rows=8, n_samples=8, root=4, max_depth=5, lights=lights,
              with_stats=stats)
    tree = render_block_scene(sc, cam, h // 2 - 4, 0, 3, **kw)
    for off in (dict(two_level=False), dict(scan_skip=False)):
        other = render_block_scene(sc, cam, h // 2 - 4, 0, 3, **kw, **off)
        assert torch.equal(tree.view(torch.int32), other.view(torch.int32)), off
    assert torch.isfinite(tree).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["20 planes, sweep", "20 planes, scan", "101 spheres, accel sweep"])
def test_scenes_past_the_sweeps_caps(card, case):
    """Scenes that the sweep megakernel's constant memory cannot hold (more
    than 16 planes, more than 64 spheres) render on the card through the
    scene megakernel, against the plain version at the scene kernel's gate;
    a sweep asked for over 101 spheres takes the scan, bitwise equal to the
    scan asked for."""
    if case.startswith("20 planes"):
        sd = plane_ring(load_scene(os.path.join(SCENES, "demo2.yml")), 19)
        accel = case.split(", ")[1]
    else:
        sd, accel = sphere_field(100, seed=2), "sweep"
    r = Renderer(sd, 4, 5, seed=9, device=card, accel=accel)
    taken = "sweep" if case == "20 planes, sweep" else "scan"
    assert r.accel == taken and not r.uses_sweep_kernel
    before = render_block_scene.launches[taken]
    row0 = r.height // 2 - 2
    k = r.render_rows_sum_range(row0, 4, 0, 16)
    torch.cuda.synchronize()
    assert render_block_scene.launches[taken] == before + 1
    p = render_block(r.scene, r.cam, row0, 0, 9, img_w=r.width, img_h=r.height, n_rows=4, n_samples=16, root=4,
                     max_depth=5, isect=r.isect)
    assert torch.isclose(k, p, rtol=1e-4, atol=1e-5).float().mean() >= 0.99
    fd = (finalize(k, root=4) - finalize(p, root=4)).abs()
    assert fd.mean() < 1e-3 and (fd > 5e-3).float().mean() < 0.01
    if case.startswith("101"):
        scan = Renderer(sd, 4, 5, seed=9, device=card, accel="scan").render_rows_sum_range(row0, 4, 0, 16)
        assert torch.equal(k.view(torch.int32), scan.view(torch.int32))


# The NEE instantiations at their paths' launches, cut to 8 rows: (scene,
# physical, stats, n_samples, root).
NEE_LAUNCHES = [
    ("demo2", False, False, 256, 16),
    ("demo2", False, True, 32, 8),
    ("demo3", True, False, 16, 4),
    ("demo3", True, True, 64, 8),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name, physical, stats, n_samples, root", NEE_LAUNCHES)
def test_nee_kernels_bitwise_stable(card, name, physical, stats, n_samples, root):
    """The sweep megakernel carries a light sample's shadow ray to the next
    bounce and sweeps it there with that bounce's ray. Each NEE
    instantiation gives the same bits from launch to launch; the stats and
    the counting instantiations give the same radiance bits as the plain
    timed one; and the scene megakernel's scan, which sweeps each shadow
    ray where it is drawn, gives the same bits too."""
    sd = load_scene(os.path.join(SCENES, f"{name}.yml"))
    sc, cam = _scene(card, name)
    lights = extract_lights(sd, card)
    kw = dict(img_w=800, img_h=600, n_rows=8, n_samples=n_samples, root=root, max_depth=5, lights=lights,
              physical=physical)
    k = render_block_sweep(sc, cam, 296, 0, 0, with_stats=stats, **kw)
    for _ in range(3):
        again = render_block_sweep(sc, cam, 296, 0, 0, with_stats=stats, **kw)
        assert torch.equal(k.view(torch.int32), again.view(torch.int32))
    plain_timed = render_block_sweep(sc, cam, 296, 0, 0, **kw) if stats else k
    counts = torch.zeros((N_COUNTS, 8 * 800), dtype=torch.int32, device=card)
    counted = render_block_sweep(sc, cam, 296, 0, 0, bounce_counts=counts, **kw)
    torch.cuda.synchronize()
    assert torch.equal(k[..., :3].contiguous().view(torch.int32), plain_timed.view(torch.int32))
    assert torch.equal(counted.view(torch.int32), plain_timed.view(torch.int32))
    c = counts.to(torch.int64)
    assert (c[2] <= c[1]).all() and c[1].sum() > 0 and c[2].sum() > 0  # unoccluded <= light samples
    assert not ((c[0] > 0) & ((c[N_WORK:] & 0xFFFFFFFF).sum(dim=0) == 0)).any()  # clocks wherever it bounced
    isect = Intersector(layout=scan_layout(sc), mode="scan")
    scan = render_block_scene(sc, cam, 296, 0, 0, isect=isect, with_stats=stats, **kw)
    assert torch.equal(k.view(torch.int32), scan.view(torch.int32))


SINCOS_CU = r"""
#include <cstdint>
// One function a kernel, so that the compiler cannot join the cosf and the
// sinf of one argument into one sincosf of its own.
__global__ void both(const float* x, uint32_t* c, uint32_t* s, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float sv, cv;
  sincosf(x[i], &sv, &cv);
  c[i] = __float_as_uint(cv);
  s[i] = __float_as_uint(sv);
}
__global__ void cos_only(const float* x, uint32_t* c, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) c[i] = __float_as_uint(cosf(x[i]));
}
__global__ void sin_only(const float* x, uint32_t* s, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) s[i] = __float_as_uint(sinf(x[i]));
}
extern "C" int run(const float* x, uint32_t* out, int n) {
  const int b = (n + 255) / 256;
  both<<<b, 256>>>(x, out, out + n, n);
  cos_only<<<b, 256>>>(x, out + 2 * n, n);
  sin_only<<<b, 256>>>(x, out + 3 * n, n);
  return (int)cudaDeviceSynchronize();
}
"""


@pytest.mark.cuda
def test_device_sincosf_matches_cosf_and_sinf(card, tmp_path):
    """The cone sample takes its cos and sin of δ, |δ| <= π, from one
    sincosf. Built with the kernels' own flags, the card's sincosf gives
    the bits of its cosf and its sinf, each in a kernel of its own."""
    import ctypes
    import subprocess

    import numpy as np

    from flux_tpu_torch.ops import build

    src, lib = tmp_path / "sincos.cu", tmp_path / "libsincos.so"
    src.write_text(SINCOS_CU)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(src)], check=True, capture_output=True,
                   timeout=300)
    run = ctypes.CDLL(str(lib)).run
    run.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    pi = np.float32(np.pi)
    x = np.concatenate([
        np.linspace(-np.pi, np.pi, 400001).astype(np.float32),
        np.array([0.0, -0.0, 1e-30, -1e-30, 1e-38, pi, -pi, np.nextafter(pi, np.float32(0)), pi / 2, pi / 4],
                 np.float32),
    ])
    xs = torch.from_numpy(x).to(card)
    out = torch.zeros((4, len(x)), dtype=torch.int32, device=card)
    assert run(xs.data_ptr(), out.data_ptr(), len(x)) == 0
    out = out.cpu()
    assert torch.equal(out[0], out[2]) and torch.equal(out[1], out[3])


@pytest.mark.cuda
@pytest.mark.parametrize("name, nee, physical, stats", [("demo2", False, False, False), ("demo3", True, True, True)])
def test_strided_masked_launch_matches_plain(card, name, nee, physical, stats):
    """A device mesh's launch (``parallel/shard.py``): rows ``row0 + k·4``
    and a sample range cut by ``s_limit`` inside the launch, at a split the
    caller gives (its band's), against the plain version at the gates
    above; the masked samples add nothing (the launch equals the one that
    stops at the limit, bitwise, at the same split); a row shard of a
    16-row band whose own plan differs from the band's is the band's rows,
    bitwise."""
    from flux_tpu_torch.ops.sweep_kernel import launch_plan

    sd = load_scene(os.path.join(SCENES, f"{name}.yml"))
    sc, cam = _scene(card, name)
    lights = extract_lights(sd, card) if nee else None
    kw = dict(img_w=800, img_h=600, n_rows=4, root=5, max_depth=5, lights=lights, physical=physical,
              with_stats=stats)
    split = launch_plan(16 * 800, 13).split
    k = render_block_sweep(sc, cam, 281, 7, 11, n_samples=13, s_limit=17, row_stride=4, split=split, **kw)
    assert render_block_sweep.last_plan.split == split
    stop = render_block_sweep(sc, cam, 281, 7, 11, n_samples=10, row_stride=4, split=split, **kw)
    torch.cuda.synchronize()
    assert torch.equal(k.view(torch.int32), stop.view(torch.int32))
    p = render_block(sc, cam, 281, 7, 11, n_samples=13, s_limit=17, row_stride=4, **kw)
    assert torch.isclose(k, p, rtol=1e-4, atol=1e-5).float().mean() >= 0.99
    fd = (finalize(k[..., :3], root=5) - finalize(p[..., :3], root=5)).abs()
    assert fd.mean() < 1e-3 and (fd > 5e-3).float().mean() < 0.01
    # The split hazard: the band's plan, not the shard's own.
    assert launch_plan(16 * 800, 17).split != launch_plan(4 * 800, 17).split
    band = render_block_sweep(sc, cam, 280, 0, 11, **{**kw, "n_rows": 16}, n_samples=17)
    shard = render_block_sweep(sc, cam, 281, 0, 11, n_samples=17, row_stride=4,
                               split=launch_plan(16 * 800, 17).split, **kw)
    torch.cuda.synchronize()
    assert torch.equal(shard.view(torch.int32), band[1::4].contiguous().view(torch.int32))
    with pytest.raises(ValueError, match="split"):
        render_block_sweep(sc, cam, 281, 0, 11, n_samples=4, split=12, **kw)


@pytest.mark.cuda
def test_profile_dir_trace_holds_the_job_path_spans_on_the_card(card, tmp_path):
    """The CLI's ``--profile-dir`` trace of a Cornell-box job on the card:
    every span of the job path on the worker's track, one renderer build,
    one pack of each table under the job's first launch, each launch, each
    readback queued, wait and delivery under its unit, the units queued two
    deep, each launch with the configuration it was counted under; every kernel
    launch the profiler saw the worker make lies inside one of the worker's
    ``kernel.launch`` spans, on the trace's clock."""
    import collections
    import json

    from flux_tpu_torch import cli

    launched = collections.Counter(render_block_scene.launches)
    ran = cli.run([os.path.join(SCENES, "demo5.yml"), "-r", "2", "-d", "3", "--nee", "-R", "128",
                   "--output-dir", str(tmp_path), "--profile-dir", str(tmp_path / "prof")])
    assert ran["error"] is None
    with open(ran["trace"]) as f:
        events = json.load(f)["traceEvents"]
    flux = [e for e in events if e.get("cat") == "flux"]
    assert {e["name"] for e in flux} == {
        "manager.queue_wait", "manager.dispatch", "manager.finish", "worker.queue_wait", "worker.renderer_build",
        "sched.pull", "worker.unit", "kernel.launch", "kernel.pack_tables", "unit.readback", "unit.wait",
        "unit.deliver"}
    assert sum(e["name"] == "worker.renderer_build" for e in flux) == 1
    by_id = {e["args"]["span"]: e for e in flux}
    # The units are queued two deep: each but the first while the one before
    # it is in flight, and each holds its launch, its readback queued, its
    # wait and its delivery.
    units = sorted((e for e in flux if e["name"] == "worker.unit"), key=lambda e: e["ts"])
    assert [e["args"]["ahead"] for e in units] == [False, True, True, True]
    for e in flux:
        if e["name"] in ("unit.readback", "unit.wait", "unit.deliver"):
            assert by_id[e["args"]["parent"]]["name"] == "worker.unit"
    packs = [e for e in flux if e["name"] == "kernel.pack_tables"]
    assert sorted(e["args"]["table"] for e in packs) == ["lights", "triangles"]
    (first,) = {e["args"]["parent"] for e in packs}
    assert by_id[first]["name"] == "kernel.launch"
    launches = [e for e in flux if e["name"] == "kernel.launch"]
    assert all(by_id[e["args"]["parent"]]["name"] == "worker.unit" for e in launches)
    assert {e["args"]["config"] for e in launches} == {
        k for k, n in render_block_scene.launches.items() if n > launched[k]}
    (tid,) = {e["tid"] for e in flux if e["name"] == "worker.unit"}
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in launches if e["tid"] == tid]
    runtime = {e["args"].get("correlation"): e for e in events if e.get("ph") == "X"
               and e.get("cat") == "cuda_runtime"}
    kernels = [e for e in events if e.get("ph") == "X" and e.get("cat") == "kernel"
               and "scene_megakernel" in e.get("name", "")]
    assert len(kernels) == 4 == len(spans)
    for k in kernels:
        launch = runtime[k["args"]["correlation"]]
        assert any(s <= launch["ts"] and launch["ts"] + launch["dur"] <= t for s, t in spans), (launch, spans)
    assert {runtime[k["args"]["correlation"]]["tid"] for k in kernels} == {tid}


@pytest.mark.cuda
def test_a_worker_packs_the_cornell_boxs_tables_once_over_its_jobs(card):
    """Four jobs of the Cornell box through one LocalWorker on the card: one
    renderer build, then three on its kept scene state; one pack of each
    table over all four; one launch a unit, each under the configuration the
    unit's renderer counts; every frame bitwise that of a fresh Renderer."""
    import collections
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from flux_tpu_torch import metrics
    from flux_tpu_torch.job import Job, JobConfiguration, JobID
    from flux_tpu_torch.manager import RenderManager, RowsReady
    from flux_tpu_torch.workers import LocalWorker

    class Frame:
        def __init__(self):
            self.pixels = torch.full((512, 512, 3), float("nan")).numpy()

        def put(self, ev):
            if isinstance(ev, RowsReady):
                u = ev.result.work_unit
                self.pixels[u.row_start : u.row_end + 1] = ev.result.rows

    sd = load_scene(os.path.join(SCENES, "demo5.yml"))
    base = JobConfiguration(sample_root=2, max_trace_depth=3, rows_per_work_unit=128, nee=True)
    cfgs = [dataclasses.replace(base, seed=s) for s in (1, 2, 3)]
    cfgs.append(dataclasses.replace(base, sample_root=3, max_trace_depth=4, seed=4, physical=True))
    before = collections.Counter(render_block_scene.launches)
    worker = LocalWorker(device=card)
    manager = RenderManager([worker.handle()])
    frames, ids = [], []
    metrics.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for cfg in cfgs:
                frame = Frame()
                handle = manager.schedule_job(sd, cfg, frame)
                assert handle.wait(timeout=120) and handle.ok, handle.error
                frames.append(frame.pixels)
                ids.append(handle.job_id)
    finally:
        manager.stop()
        worker.stop()
    got = metrics.spans()
    builds = {s.job: s.attrs["reused"] for s in got if s.name == "worker.renderer_build"}
    assert [builds[j] for j in ids] == [False, True, True, True]
    packs = [s for s in got if s.name == "kernel.pack_tables"]
    assert sorted(s.attrs["table"] for s in packs) == ["lights", "triangles"]
    assert {s.job for s in packs} == {ids[0]}
    launched = collections.Counter(render_block_scene.launches)
    launched.subtract(before)
    want = collections.Counter()
    for cfg, pixels in zip(cfgs, frames):
        r = Renderer(sd, cfg.sample_root, cfg.max_trace_depth, seed=cfg.seed, device=card, nee=cfg.nee,
                     physical=cfg.physical)
        units = Job(JobID(0, 0), sd, cfg).work_units()
        want[r._launch_config(False)] += len(units)
        for u in units:
            band = r.render_rows(u.row_start, u.num_rows)
            assert (pixels[u.row_start : u.row_end + 1].view("int32") == band.view("int32")).all(), (cfg, u)
    assert +launched == want


@pytest.mark.cuda
@pytest.mark.parametrize("name, root, nee", [("demo5", 32, True), ("demo2", 4, False)],
                         ids=["cornell 1024 spp", "demo2 16 spp"])
def test_a_workers_units_two_deep_give_the_sequential_bits(card, tmp_path, name, root, nee):
    """Three frames through one LocalWorker on the card, 50-row units (11 of
    the Cornell box, 12 of demo2): every frame bitwise that of
    ``Renderer.render_rows`` over the same units one at a time and of the
    blocking readback of the band's sum (``finalize(...).cpu()``); ``ahead`` on
    every unit but a frame's first; the page-locked host buffers taken from
    the cache, not allocated a unit. At the Cornell cell's 1024 spp, each
    unit's launch is queued while the kernel of the unit before it still
    runs."""
    import json

    from flux_tpu_torch import metrics
    from flux_tpu_torch.job import Job, JobConfiguration, JobID
    from flux_tpu_torch.manager import RenderManager, RowsReady
    from flux_tpu_torch.workers import LocalWorker

    sd = load_scene(os.path.join(SCENES, f"{name}.yml"))
    out = sd.output_settings

    class Frame:
        def __init__(self):
            self.pixels = torch.full((out.image_height, out.image_width, 3), float("nan")).numpy()

        def put(self, ev):
            if isinstance(ev, RowsReady):
                u = ev.result.work_unit
                self.pixels[u.row_start : u.row_end + 1] = ev.result.rows

    cfgs = [JobConfiguration(sample_root=root, max_trace_depth=5, rows_per_work_unit=50, seed=s, nee=nee)
            for s in (11, 12, 13)]
    n_units = len(Job(JobID(0, 0), sd, cfgs[0]).work_units())
    worker = LocalWorker(device=card)
    manager = RenderManager([worker.handle()])
    frames = []
    # The stats are empty until the process's first page-locked allocation.
    allocs = torch.cuda.host_memory_stats().get("num_host_alloc", 0)
    try:
        with metrics.profile_trace(str(tmp_path)) as prof:
            for cfg in cfgs:
                frame = Frame()
                handle = manager.schedule_job(sd, cfg, frame)
                assert handle.wait(timeout=120) and handle.ok, handle.error
                frames.append(frame.pixels)
    finally:
        manager.stop()
        worker.stop()
    allocs = torch.cuda.host_memory_stats().get("num_host_alloc", 0) - allocs
    # A block waits, once freed, for the kernels queued before its release:
    # a few of each unit size serve every unit of the three frames.
    assert allocs <= 6 < 3 * n_units, allocs
    for cfg, pixels in zip(cfgs, frames):
        r = Renderer(sd, cfg.sample_root, cfg.max_trace_depth, seed=cfg.seed, device=card, nee=nee)
        for u in Job(JobID(0, 0), sd, cfg).work_units():
            got = pixels[u.row_start : u.row_end + 1].view("int32")
            band = r.render_rows(u.row_start, u.num_rows)
            assert (got == band.view("int32")).all(), (cfg, u)
            band = finalize(r.render_rows_sum(u.row_start, u.num_rows), root=r.root).cpu().numpy()
            assert (got == band.view("int32")).all(), (cfg, u)
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    flux = [e for e in events if e.get("cat") == "flux"]
    units = sorted((e for e in flux if e["name"] == "worker.unit"), key=lambda e: e["ts"])
    assert [e["args"]["ahead"] for e in units] == ([False] + [True] * (n_units - 1)) * 3
    if root < 32:
        return
    launches = sorted((e for e in flux if e["name"] == "kernel.launch"), key=lambda e: e["ts"])
    kernels = sorted((e for e in events if e.get("ph") == "X" and e.get("cat") == "kernel"
                      and "megakernel" in e.get("name", "")), key=lambda e: e["ts"])
    assert len(launches) == len(kernels) == 3 * n_units
    for k in range(1, len(kernels)):
        if units[k]["args"]["ahead"]:
            before = kernels[k - 1]
            assert launches[k]["ts"] + launches[k]["dur"] < before["ts"] + before["dur"], k


def _sequential(r, row0, n_rows):
    """A band's pixels rendered on the current stream and read back there."""
    return finalize(r.render_rows_sum(row0, n_rows), root=r.root).cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("name, root, nee", [("demo5", 8, True), ("demo2", 4, False)], ids=["cornell nee", "demo2"])
def test_bands_queued_on_two_launch_streams_give_the_sequential_bits(card, name, root, nee):
    """Every 50-row band of a frame queued at once through
    ``Renderer.queue_rows`` (the two launch streams in turn, a dozen kernels
    in flight), then waited on: each band bitwise its sum rendered and read
    back on the current stream; the ``kernel.launch`` spans alternate between
    the streams, and none sends the scene record the frame's first band
    sent."""
    from torch.profiler import ProfilerActivity, profile

    from flux_tpu_torch import metrics

    sd = load_scene(os.path.join(SCENES, f"{name}.yml"))
    r = Renderer(sd, root, 5, seed=21, device=card, nee=nee)
    bands = [(row0, min(50, r.height - row0)) for row0 in range(0, r.height, 50)]
    assert len(bands) >= 11
    r.render_rows(*bands[0])  # sends the scene record and packs the tables
    metrics.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        pending = [r.queue_rows(row0, n) for row0, n in bands]
        got = [r.wait_rows(p) for p in pending]
    launches = [s for s in metrics.spans() if s.name == "kernel.launch"]
    assert len(launches) == len(bands)
    streams = [s.attrs["stream"] for s in launches]
    assert all(a != b for a, b in zip(streams, streams[1:])), streams
    assert not any(s.attrs["uploaded"] for s in launches)
    for (row0, n), band in zip(bands, got):
        assert (band.view("int32") == _sequential(r, row0, n).view("int32")).all(), row0


@pytest.mark.cuda
@pytest.mark.parametrize("first, second, nee", [("demo2", "demo1", False), ("demo5", "mesh_ico", True)],
                         ids=["sweep kernel", "scene kernel"])
def test_two_scenes_in_turn_give_each_its_own_bits(card, first, second, nee):
    """The upload join. Bands of two scenes of one kernel library queued in
    turn without a wait, the first scene's at 16384 or 1024 spp, so that its
    kernel runs while the second's record is queued: each band sends its
    scene's record, which waits for the other scene's kernel, and every band
    is bitwise its scene's own band rendered alone. Then jobs of the two
    scenes and of the first again, back to back through one LocalWorker:
    each frame bitwise its scene's band loop."""
    from torch.profiler import ProfilerActivity, profile

    from flux_tpu_torch import metrics
    from flux_tpu_torch.job import Job, JobConfiguration, JobID
    from flux_tpu_torch.manager import RenderManager, RowsReady
    from flux_tpu_torch.workers import LocalWorker

    sds = [load_scene(os.path.join(SCENES, f"{n}.yml")) for n in (first, second)]
    rs = [Renderer(sds[0], 128 if first == "demo2" else 32, 5, seed=5, device=card, nee=nee),
          Renderer(sds[1], 2, 5, seed=6, device=card, nee=nee)]
    assert rs[0].uses_sweep_kernel == rs[1].uses_sweep_kernel
    order = [(rs[0], 100), (rs[1], 100), (rs[0], 150), (rs[1], 150)]
    metrics.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        pending = [r.queue_rows(row0, 50) for r, row0 in order]
        got = [Renderer.wait_rows(p) for p in pending]
    launches = [s for s in metrics.spans() if s.name == "kernel.launch"]
    # The first scene's record may be there from an earlier render.
    assert [s.attrs["uploaded"] for s in launches][1:] == [True] * 3
    for (r, row0), band in zip(order, got):
        assert (band.view("int32") == _sequential(r, row0, 50).view("int32")).all(), (r.scene_data is sds[0], row0)

    class Frame:
        def __init__(self, out):
            self.pixels = torch.full((out.image_height, out.image_width, 3), float("nan")).numpy()

        def put(self, ev):
            if isinstance(ev, RowsReady):
                u = ev.result.work_unit
                self.pixels[u.row_start : u.row_end + 1] = ev.result.rows

    jobs = [(sds[0], 1), (sds[1], 2), (sds[0], 3)]
    cfgs = [JobConfiguration(sample_root=2, max_trace_depth=5, rows_per_work_unit=64, seed=seed, nee=nee)
            for _, seed in jobs]
    worker = LocalWorker(device=card)
    manager = RenderManager([worker.handle()])
    frames = []
    try:
        for (sd, _), cfg in zip(jobs, cfgs):
            frame = Frame(sd.output_settings)
            handle = manager.schedule_job(sd, cfg, frame)
            assert handle.wait(timeout=120) and handle.ok, handle.error
            frames.append(frame.pixels)
    finally:
        manager.stop()
        worker.stop()
    for (sd, _), cfg, pixels in zip(jobs, cfgs, frames):
        r = Renderer(sd, cfg.sample_root, cfg.max_trace_depth, seed=cfg.seed, device=card, nee=nee)
        for u in Job(JobID(0, 0), sd, cfg).work_units():
            want = _sequential(r, u.row_start, u.num_rows)
            assert (pixels[u.row_start : u.row_end + 1].view("int32") == want.view("int32")).all(), (cfg, u)


@pytest.mark.cuda
def test_a_traced_job_starts_each_units_kernel_before_the_last_one_ends(card, tmp_path):
    """demo2 at 4096 spp in three units of 200 rows through the CLI's job
    path, traced: each unit's K1 starts, on the other launch stream, before
    the K1 of the unit before it has ended; the second and third units'
    ``kernel.launch`` spans are ``overlapped`` and send no scene record."""
    import json

    from flux_tpu_torch import cli

    ran = cli.run([os.path.join(SCENES, "demo2.yml"), "-r", "64", "-d", "5", "-R", "200",
                   "--output-dir", str(tmp_path), "--profile-dir", str(tmp_path / "prof")])
    assert ran["error"] is None
    with open(ran["trace"]) as f:
        events = json.load(f)["traceEvents"]
    kernels = sorted((e for e in events if e.get("ph") == "X" and e.get("cat") == "kernel"
                      and "sweep_megakernel" in e.get("name", "")), key=lambda e: e["ts"])
    assert len(kernels) == 3
    for before, k in zip(kernels, kernels[1:]):
        assert k["ts"] < before["ts"] + before["dur"], (before, k)
        assert k["tid"] != before["tid"]
    launches = sorted((e for e in events if e.get("cat") == "flux" and e["name"] == "kernel.launch"),
                      key=lambda e: e["ts"])
    assert [e["args"]["overlapped"] for e in launches] == [False, True, True]
    assert [e["args"]["uploaded"] for e in launches[1:]] == [False, False]
    assert launches[0]["args"]["stream"] != launches[1]["args"]["stream"] != launches[2]["args"]["stream"]
