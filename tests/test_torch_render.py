"""The port's plain renderer against flux_tpu's, the goldens and the oracle.

* ``render_block`` against ``flux_tpu.render.render_block_impl`` (called
  eagerly, no jit), the function tests/test_pallas.py pins the Pallas kernel
  to bit for bit, on that file's scenes and a demo2 band;
* ``Renderer(device="cpu")`` on demo1 and demo2 at 80x60 against the JAX
  package's goldens, at tests/test_golden.py's gate;
* per-sample radiance on a demo2 crop, adjudicated by the float64 NumPy
  oracle as tests/test_scan_parity.py adjudicates XLA against Pallas;
* ``Renderer`` and ``ProgressiveRenderer`` in seven configurations of
  scene, transport and kind of render against the JAX package's.
"""

import functools
import os
from dataclasses import dataclass, replace

import numpy as np
import pytest
import torch

from flux_tpu import checkpoint as jcp
from flux_tpu import render as jrender
from flux_tpu.camera import camera_arrays as j_camera_arrays
from flux_tpu.meshgen import icosphere as j_icosphere
from flux_tpu.meshgen import mesh_scene as j_mesh_scene
from flux_tpu.oracle import oracle_render
from flux_tpu.render import render_block_impl
from flux_tpu.scene import MaterialData, MaterialKind, PlaneData, SphereData
from flux_tpu.scene import compile_scene as j_compile_scene
from flux_tpu.scene import load_scene as j_load_scene
from flux_tpu_torch import meshgen
from flux_tpu_torch.camera import camera_tensors
from flux_tpu_torch.checkpoint import ProgressiveRenderer
from flux_tpu_torch.ops.scene_kernel import render_block_scene
from flux_tpu_torch.ops.sweep_kernel import render_block_sweep
from flux_tpu_torch.render import Renderer, render_block
from flux_tpu_torch.scene import SceneData, compile_scene, load_scene
from tests.test_render import env_sphere, make_scene
from tests.test_torch_ops import carry_camera, carry_scene

HERE = os.path.dirname(os.path.abspath(__file__))


def _both(sd, row0=0, s0=0, seed=3, **kw):
    """(port, JAX) radiance sums of one block on identical constants."""
    jsc = j_compile_scene(sd)
    jcam = j_camera_arrays(sd.camera_settings, sd.camera_data, sd.output_settings.pixel_size)
    want = np.asarray(render_block_impl(
        jsc, jcam, np.int32(row0), np.uint32(s0), np.uint32(seed), **kw
    ))
    got = render_block(carry_scene(jsc), carry_camera(jcam), row0, s0, seed, **kw).numpy()
    return got, want


def _demo2_small(w, h):
    """demo2 at w x h with its field of view kept."""
    sd = j_load_scene(os.path.join(HERE, "..", "scenes", "demo2.yml"))
    return replace(sd, output_settings=replace(
        sd.output_settings, image_width=w, image_height=h,
        pixel_size=sd.output_settings.pixel_size * 800 / w,
    ))


def _glossy_ball():
    return SphereData(
        center=(0.0, 1.0, 0.0), radius=1.0,
        material=MaterialData(kind=MaterialKind.GLOSSY, color=(0.9, 1.0, 0.9), param=0.9, exponent=100.0),
    )


def _floor(normal=(0.0, 1.0, 0.0)):
    return PlaneData(
        point=(0.0, 0.0, 0.0), normal=normal,
        material=MaterialData(kind=MaterialKind.MATTE, color=(0.5, 0.5, 0.5), param=1.0),
    )


# tests/test_pallas.py:40-71's scenes and a demo2 band, all at one lane
# shape so that JAX's eager dispatch compiles each op once.
BLOCK = dict(img_w=16, n_rows=4, n_samples=4, root=2, max_depth=3)
CASES = {
    "sphere_only": lambda: make_scene([env_sphere(1.0)], w=16, h=6),
    "plane_only": lambda: make_scene([_floor()], w=16, h=4, background=(0.2, 0.4, 0.6)),
    "no_planes": lambda: make_scene([env_sphere(1.0), _glossy_ball()], w=16, h=8),
    "demo2_band": lambda: _demo2_small(16, 12),
    # A non-unit plane normal: ray directions stop being unit after a mirror
    # bounce, and the sphere quadratic keeps a = d·d (unit_d False).
    "non_unit_plane": lambda: make_scene(
        [env_sphere(1.0), _glossy_ball(), _floor((0.0, 2.0, 0.0))], w=16, h=8),
}


@pytest.mark.parametrize("case", list(CASES))
def test_render_block_matches_jax(case):
    """Sums agree to float32 rounding (rtol 1e-5: XLA may contract a
    multiply-add into one FMA, and rsqrt/cos/pow differ by an ulp) on every
    pixel but those where one sample took another path at a borderline
    branch; at most 1% of values may differ more."""
    sd = CASES[case]()
    img_h = sd.output_settings.image_height
    got, want = _both(sd, row0=img_h - 4, s0=1, img_h=img_h, **BLOCK)
    assert got.shape == want.shape == (4, 16, 3)
    close = np.isclose(got, want, rtol=1e-5, atol=1e-6)
    assert close.mean() >= 0.99, f"{(~close).sum()} of {close.size} values differ"


def test_render_block_stats_channel_matches_jax():
    """``with_stats`` appends the per-pixel Σ luminance² (the adaptive-
    sampling noise signal), on the CPU, as render_block_impl does."""
    sd = CASES["demo2_band"]()
    got, want = _both(sd, row0=8, s0=0, img_h=12, with_stats=True, **BLOCK)
    assert got.shape == want.shape == (4, 16, 4)
    assert np.isclose(got, want, rtol=1e-5, atol=1e-6).mean() >= 0.99


def test_render_block_s_limit_and_row_stride():
    """Lanes at or past s_limit add nothing; row_stride renders every k-th
    row (the contract of render_block_impl)."""
    sd = SceneData.from_dict(_demo2_small(16, 12).to_dict())
    sc = compile_scene(sd, "cpu")
    cam = camera_tensors(sd.camera_settings, sd.camera_data, sd.output_settings.pixel_size, "cpu")
    kw = dict(img_w=16, img_h=12, root=2, max_depth=3)
    limited = render_block(sc, cam, 1, 0, 5, n_rows=3, n_samples=4, s_limit=2, row_stride=4, **kw)
    first_two = render_block(sc, cam, 1, 0, 5, n_rows=3, n_samples=2, row_stride=4, **kw)
    np.testing.assert_allclose(limited.numpy(), first_two.numpy(), rtol=1e-6, atol=1e-7)
    for k in range(3):
        row = render_block(sc, cam, 1 + 4 * k, 0, 5, n_rows=1, n_samples=2, **kw)
        np.testing.assert_array_equal(row.numpy()[0], first_two.numpy()[k])


def _golden_scene(name):
    sd = j_load_scene(os.path.join(HERE, "..", "scenes", f"{name}.yml"))
    sd = replace(sd, output_settings=replace(
        sd.output_settings, image_width=80, image_height=60,
        pixel_size=sd.output_settings.pixel_size * 10,
    ))
    return SceneData.from_dict(sd.to_dict())


@pytest.mark.parametrize("name", ["demo1", "demo2"])
def test_renderer_cpu_matches_golden(name):
    """tests/test_golden.py's gate: atol 5e-3 everywhere, mean within 1e-3."""
    img = Renderer(_golden_scene(name), sample_root=4, max_depth=5, seed=42, device="cpu").render_image()
    golden = np.load(os.path.join(HERE, f"golden_{name}_80x60_r4_s42.npy"))
    assert img.shape == golden.shape
    np.testing.assert_allclose(img, golden, atol=5e-3)
    assert abs(float(img.mean()) - float(golden.mean())) < 1e-3


def test_per_sample_radiance_adjudicated_by_oracle():
    """demo2 crop, root 2, depth 5. Where the port and JAX disagree on a
    sample (> 1e-5), one side must match the float64 oracle within 1e-3 (a
    borderline branch taken the other way lands on a legitimate path), and
    each side disagrees with the oracle on at most 1% of samples
    (tests/test_scan_parity.py::_oracle_adjudicate)."""
    sd = _demo2_small(16, 8)
    root, depth = 2, 5
    kw = dict(img_w=16, img_h=8, n_rows=8, n_samples=1, root=root, max_depth=depth)
    pairs = [_both(sd, row0=0, s0=s, seed=0, **kw) for s in range(root * root)]
    port = np.stack([p for p, _ in pairs])
    jax_ = np.stack([j for _, j in pairs])
    oracle = oracle_render(sd, root, depth, seed=0, raw_samples=True)
    tol = 1e-3
    bad_port = np.abs(port - oracle).max(-1) > tol
    bad_jax = np.abs(jax_ - oracle).max(-1) > tol
    flips = np.argwhere(np.abs(port - jax_).max(-1) > 1e-5)
    unadjudicated = [
        tuple(f) for f in flips
        if min(np.abs(port[tuple(f)] - oracle[tuple(f)]).max(),
               np.abs(jax_[tuple(f)] - oracle[tuple(f)]).max()) > tol
    ]
    budget = int(0.01 * bad_port.size)
    assert not unadjudicated, unadjudicated
    assert int(bad_port.sum()) <= budget and int(bad_jax.sum()) <= budget


@dataclass(frozen=True)
class Config:
    """A configuration of the renderer: ``scene`` is ``scenes/<scene>.yml``,
    or ``mesh1280`` (``meshgen.icosphere(3)`` in ``meshgen.mesh_scene``);
    ``kind`` is ``frame``, ``mis`` (a frame and its MSE against a truth of
    TRUTH_ROOT_FACTOR times the root, seed TRUTH_SEED) or ``adaptive``
    (passes of PASS_SPP until the p99 relative standard error is under
    ADAPTIVE_TARGET)."""

    scene: str
    nee: bool = False
    physical: bool = False
    kind: str = "frame"


CONFIGS = {
    "demo2": Config("demo2"),
    "demo2_nee": Config("demo2", nee=True),
    "spheres512_scan": Config("spheres512"),
    "mesh1280": Config("mesh1280"),
    "cornell_tri_light_nee": Config("demo5", nee=True),
    "demo3_physical_mis": Config("demo3", nee=True, physical=True, kind="mis"),
    "demo2_adaptive_stop": Config("demo2", kind="adaptive"),
}
CONFIG_SIZE = (16, 12)
# Two bounces, as the kernel parity tests take them: the first hit and its
# scatter, shadow and MIS weights, and the second hit (every bounce runs the
# same code). Each configuration's root at CONFIG_SIZE: 1, and the adaptive
# one's 16 with noise target 0.5, which it meets after 3 of its 4 passes of
# 64 (p99 0.61, then 0.48, at this size and depth).
CONFIG_DEPTH = 2
CONFIG_ROOT = {name: 16 if cfg.kind == "adaptive" else 1 for name, cfg in CONFIGS.items()}
ADAPTIVE_TARGET = 0.5
SEED, PASS_SPP = 0, 64
TRUTH_ROOT_FACTOR, TRUTH_SEED = 8, 7


@pytest.fixture
def two_threads():
    """Several workers share the CPU's cores under the tier-1 command; the
    renders' bits do not depend on the thread count (as in
    tests/test_torch_parallel.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _at_config_size(sd):
    out = sd.output_settings
    w, h = CONFIG_SIZE
    return replace(sd, output_settings=replace(out, image_width=w, image_height=h,
                                               pixel_size=out.pixel_size * out.image_width / w))


def _render_config(name, sd, renderer, progressive, **kw):
    """Configuration ``name`` on ``sd`` through one package's renderer
    classes, each frame one band of the frame's height: its values and its
    frame."""
    cfg, root = CONFIGS[name], CONFIG_ROOT[name]
    h = sd.output_settings.image_height
    if cfg.kind == "adaptive":
        pr = progressive(sd, root, CONFIG_DEPTH, seed=SEED, **kw)
        err = None
        while not pr.complete:
            pr.render_pass(PASS_SPP)
            err = pr.max_rel_stderr()
            if err is not None and err < ADAPTIVE_TARGET:
                break
        return {"spp_done": pr.samples_done, "spp_max": pr.spp, "p99_rel_stderr": err}, np.asarray(pr.peek())
    img = renderer(sd, root, CONFIG_DEPTH, seed=SEED, nee=cfg.nee, physical=cfg.physical,
                   **kw).render_image(rows_per_band=h)
    if cfg.kind != "mis":
        return {}, np.asarray(img)
    truth = renderer(sd, TRUTH_ROOT_FACTOR * root, CONFIG_DEPTH, seed=TRUTH_SEED, nee=True, physical=True,
                     **kw).render_image(rows_per_band=h)
    return {"mse_vs_truth": float(((img - truth) ** 2).mean())}, np.asarray(img)


@functools.lru_cache(maxsize=None)
def jax_config(name):
    """Configuration ``name`` through flux_tpu, op by op: its ``Renderer``
    calls the un-jitted ``render_block_impl`` in place of the jitted
    ``render_block``, so no render program is compiled (only the bodies of
    the sphere and triangle folds' ``lax.scan``, as ``lax.scan`` compiles
    them outside ``jit``)."""
    scene = CONFIGS[name].scene
    if scene == "mesh1280":
        sd = j_mesh_scene(*j_icosphere(3), width=800, height=600)
    else:
        sd = j_load_scene(os.path.join(HERE, "..", "scenes", f"{scene}.yml"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrender, "render_block", jrender.render_block_impl)
        return _render_config(name, _at_config_size(sd), jrender.Renderer, jcp.ProgressiveRenderer)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_configurations_match_the_jax_package(name, two_threads):
    """Frames at tests/test_torch_render.py's gate (with NEE,
    tests/test_torch_nee.py's), the adaptive stop at the same samples and
    p99, the MIS MSE to rtol 1e-3; on the CPU no kernel is launched."""
    cfg, root = CONFIGS[name], CONFIG_ROOT[name]
    if cfg.scene == "mesh1280":
        sd = meshgen.mesh_scene(*meshgen.icosphere(3), width=800, height=600)
    else:
        sd = load_scene(os.path.join(HERE, "..", "scenes", f"{cfg.scene}.yml"))
    launches = render_block_sweep.launches.total() + render_block_scene.launches.total()
    value, img = _render_config(name, _at_config_size(sd), Renderer, ProgressiveRenderer, device="cpu")
    assert render_block_sweep.launches.total() + render_block_scene.launches.total() == launches
    want_value, want = jax_config(name)
    assert img.shape == want.shape == (CONFIG_SIZE[1], CONFIG_SIZE[0], 3) and np.isfinite(img).all()
    # 99% of values within float32 rounding: test_render_block_matches_jax's
    # gate, and with NEE tests/test_torch_nee.py's (XLA's FMA contraction,
    # magnified by a light cone's 1 - cos_max).
    rtol, atol = (1e-4, 1e-5) if cfg.nee else (1e-5, 1e-6)
    close = np.isclose(img, want, rtol=rtol, atol=atol)
    assert close.mean() >= 0.99, f"{(~close).sum()} of {close.size} values differ"
    if cfg.kind == "adaptive":
        assert 0 < value["spp_done"] < value["spp_max"] == root ** 2
        assert value["spp_done"] == want_value["spp_done"]
        assert value["p99_rel_stderr"] == pytest.approx(want_value["p99_rel_stderr"], rel=1e-4)
    elif cfg.kind == "mis":
        assert value["mse_vs_truth"] == pytest.approx(want_value["mse_vs_truth"], rel=1e-3)
