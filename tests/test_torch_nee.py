"""The port's next-event estimation, physical transport and MIS against
flux_tpu's, on identical inputs made from a numpy seed.

The functions repeat the JAX package's float32 arithmetic in the same
order, but XLA's CPU code contracts multiply-adds into FMAs and takes cos,
sin, sqrt and pow from other libraries, so results differ by a few ulp; the
cone's ``1 - cos_max`` (a small light: 2e-3 for a 0.25 radius at distance
4) magnifies such an ulp in ``cos_max`` up to ~1e3 times. Hence the
relative tolerance 2e-4 of the light sampler and densities, and 1e-4 on
radiance sums, where the reference-transport tests of
tests/test_torch_render.py hold 1e-5. The f64 oracle adjudicates per-sample
radiance as it does there.
"""

import functools
import os
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux_tpu.camera import camera_arrays as j_camera_arrays
from flux_tpu.ops import nee as jnee
from flux_tpu.ops.intersect import occluded_sweep as j_occluded_sweep
from flux_tpu.oracle import oracle_render
from flux_tpu.render import render_block_impl
from flux_tpu.scene import compile_scene as j_compile_scene
from flux_tpu.scene import load_scene as j_load_scene
from flux_tpu.vec import Vec3 as JVec3
from flux_tpu_torch.ops import nee
from flux_tpu_torch.ops.intersect import intersect, occluded_sweep, sphere_t
from flux_tpu_torch.render import render_block
from flux_tpu_torch.scene import load_scene
from flux_tpu_torch.vec import Vec3
from tests.test_torch_ops import carry_camera, carry_scene

HERE = os.path.dirname(os.path.abspath(__file__))
SCENES = sorted(p for p in os.listdir(os.path.join(HERE, "..", "scenes")) if p.endswith(".yml"))
N = 4096


def _scene_path(name):
    return os.path.join(HERE, "..", "scenes", name)


@functools.lru_cache(maxsize=None)
def _jax_scene(name, w=None, h=None):
    sd = j_load_scene(_scene_path(name))
    if w is not None:
        sd = replace(sd, output_settings=replace(
            sd.output_settings, image_width=w, image_height=h,
            pixel_size=sd.output_settings.pixel_size * sd.output_settings.image_width / w,
        ))
    return sd


def carry_lights(jl):
    """The port's light set on the CPU from the JAX package's LightArrays."""
    fields = nee.LIGHT_FIELDS + (nee.TRI_LIGHT_FIELDS if jl.has_tris else ())
    return nee.lights_from_numpy({f: np.asarray(getattr(jl, f)) for f in fields}, "cpu")


def _tv(a):
    return Vec3(*(torch.from_numpy(np.ascontiguousarray(c, np.float32)) for c in a.T))


def _jv(a):
    return JVec3(*(jnp.asarray(np.asarray(c, np.float32)) for c in a.T))


def _inputs(seed=0):
    """Surface points above demo3's floor, unit normals, unit samples."""
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(N, 3)).astype(np.float32) * np.float32(2.0)
    p[:, 1] = np.abs(p[:, 1])
    nrm = rng.normal(size=(N, 3))
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(np.float32)
    u = rng.random((3, N), dtype=np.float32)
    return p, nrm, u


def _close(got, want, rtol, atol=0.0):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", SCENES)
def test_extract_lights_matches_jax(name):
    """Same light set as flux_tpu: every field bit-equal, pick and cdf
    included; a scene with an emissive triangle (demo5) also fills the
    triangle-light fields and the per-light kinds."""
    jl = jnee.extract_lights(j_load_scene(_scene_path(name)))
    sd = load_scene(_scene_path(name))
    tl = nee.extract_lights(sd, "cpu")
    if jl is None:
        assert tl is None
        return
    assert tl.has_tris == jl.has_tris and tl.kinds == jl.kinds
    for f in nee.LIGHT_FIELDS + (nee.TRI_LIGHT_FIELDS if jl.has_tris else ()):
        np.testing.assert_array_equal(getattr(tl, f).numpy(), np.asarray(getattr(jl, f)), err_msg=f)
    assert getattr(tl, "shape_idx").dtype == torch.int32


@pytest.mark.parametrize("clipped", [False, True], ids=["whole_cone", "clipped"])
def test_sample_light_dirs_matches_jax(clipped):
    jl = jnee.extract_lights(_jax_scene("demo3.yml"))
    tl = carry_lights(jl)
    p, nrm, (ux, uy, up) = _inputs(1)
    js = jnee.sample_light_dirs(jl, _jv(p), jnp.asarray(ux), jnp.asarray(uy), jnp.asarray(up),
                                normal=_jv(nrm) if clipped else None)
    ts = nee.sample_light_dirs(tl, _tv(p), torch.from_numpy(ux), torch.from_numpy(uy), torch.from_numpy(up),
                               normal=_tv(nrm) if clipped else None)
    np.testing.assert_array_equal(ts.sidx.numpy(), np.asarray(js.sidx))
    np.testing.assert_array_equal(ts.radius.numpy(), np.asarray(js.radius))
    for g, w in zip(ts.d, js.d):
        _close(g, w, rtol=0, atol=1e-5)  # unit vectors: absolute
    for g, w in zip(ts.weight, js.weight):
        _close(g, w, rtol=2e-4, atol=1e-30)
    _close(ts.pdf, js.pdf, rtol=2e-4)


@pytest.mark.parametrize("clipped", [False, True], ids=["whole_cone", "clipped"])
def test_nee_pdf_toward_matches_jax(clipped):
    """The reverse density toward each light (and 0 toward other shapes)."""
    jl = jnee.extract_lights(_jax_scene("demo3.yml"))
    tl = carry_lights(jl)
    p, nrm, (ux, uy, up) = _inputs(2)
    # Directions toward the lights: the sampler's own, so the clipped ring
    # density is taken where the BSDF walk could hit.
    js = jnee.sample_light_dirs(jl, _jv(p), jnp.asarray(ux), jnp.asarray(uy), jnp.asarray(up), normal=_jv(nrm))
    d = np.stack([np.asarray(c) for c in js.d], axis=1)
    shape = np.where(np.arange(N) % 7 == 0, 5, np.asarray(js.sidx)).astype(np.int32)  # some non-lights
    want = jnee.nee_pdf_toward(jl, _jv(p), jnp.asarray(shape), d=_jv(d), normal=_jv(nrm) if clipped else None)
    got = nee.nee_pdf_toward(tl, _tv(p), torch.from_numpy(shape), d=_tv(d), normal=_tv(nrm) if clipped else None)
    _close(got, want, rtol=2e-4)
    assert (got.numpy()[shape == 5] == 0).all()


def test_light_emission_matches_jax():
    jl = jnee.extract_lights(_jax_scene("demo3.yml"))
    shape = np.arange(-1, 12, dtype=np.int32)
    np.testing.assert_array_equal(
        nee.light_emission(carry_lights(jl), torch.from_numpy(shape)).numpy(),
        np.asarray(jnee.light_emission(jl, jnp.asarray(shape))),
    )


@pytest.mark.parametrize("name", ["demo2.yml", "demo3.yml"])
def test_occluded_sweep_matches_jax(name):
    """The any-hit shadow fold toward each picked light, from points on
    surfaces (the hit's own shape excluded as the shadow ray's origin)."""
    sd = _jax_scene(name)
    jsc = j_compile_scene(sd)
    sc = carry_scene(jsc)
    jl = jnee.extract_lights(sd)
    tl = carry_lights(jl)
    rng = np.random.default_rng(3)
    eye = np.array(sd.camera_settings.eye, np.float64)
    o = (eye + np.zeros((N, 3))).astype(np.float32)
    d = np.array(sd.camera_settings.look_at) - eye + rng.normal(size=(N, 3)) * 2.0
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    hit = intersect(sc, _tv(o), _tv(d))
    p = np.stack([c.numpy() for c in hit.point], axis=1)
    p = np.where(hit.mask.numpy()[:, None], p, o)
    origin = np.where(hit.mask.numpy(), hit.shape.numpy(), -1).astype(np.int32)
    n_ = np.stack([c.numpy() for c in hit.normal], axis=1)
    ux, uy, up = rng.random((3, N), dtype=np.float32)
    ls = nee.sample_light_dirs(tl, _tv(p), torch.from_numpy(ux), torch.from_numpy(uy), torch.from_numpy(up),
                               normal=_tv(n_))
    ld = np.stack([c.numpy() for c in ls.d], axis=1)
    t_max, _ = sphere_t(_tv(p), ls.d, None, None, *ls.center, ls.radius)
    t_max = t_max.numpy()
    got = occluded_sweep(sc, _tv(p), _tv(ld), torch.from_numpy(t_max), ls.sidx,
                         origin_idx=torch.from_numpy(origin)).numpy()
    want = np.asarray(j_occluded_sweep(jsc, _jv(p), _jv(ld), jnp.asarray(t_max), jnp.asarray(ls.sidx.numpy()),
                                       origin_idx=jnp.asarray(origin)))
    assert 0.01 < want.mean() < 0.99
    assert (got == want).mean() >= 0.999


def _both(sd, row0, s0, seed, nee_on, physical, **kw):
    """(port, JAX) radiance sums of one block, on identical constants."""
    jsc = j_compile_scene(sd)
    jcam = j_camera_arrays(sd.camera_settings, sd.camera_data, sd.output_settings.pixel_size)
    jl = jnee.extract_lights(sd) if nee_on else None
    want = np.asarray(render_block_impl(
        jsc, jcam, np.int32(row0), np.uint32(s0), np.uint32(seed), lights=jl, physical=physical, **kw))
    got = render_block(carry_scene(jsc), carry_camera(jcam), row0, s0, seed,
                       lights=None if jl is None else carry_lights(jl), physical=physical, **kw).numpy()
    return got, want


BLOCK = dict(img_w=16, img_h=12, n_rows=4, n_samples=4, root=2, max_depth=3)


@pytest.mark.parametrize("name", ["demo2.yml", "demo3.yml"])
@pytest.mark.parametrize("nee_on, physical", [(True, False), (False, True), (True, True)],
                         ids=["nee", "physical", "mis"])
def test_render_block_estimators_match_jax(name, nee_on, physical):
    """NEE, physical transport and both (MIS) through the whole block,
    against render_block_impl (eager) with stats: 99% of values within
    rtol 1e-4 (see the module docstring)."""
    sd = _jax_scene(name, 16, 12)
    got, want = _both(sd, 4, 1, 3, nee_on, physical, with_stats=True, **BLOCK)
    assert got.shape == want.shape == (4, 16, 4)
    close = np.isclose(got, want, rtol=1e-4, atol=1e-5)
    assert close.mean() >= 0.99, f"{(~close).sum()} of {close.size} values differ"
    assert want[..., :3].max() > 0


def test_per_sample_mis_radiance_adjudicated_by_oracle():
    """demo3 (three small sphere lights, an environment, mirror, glossy and
    matte spheres) at 16x8, root 2, depth 3, NEE + physical. Where the
    port and JAX disagree on a sample (> 1e-5), one side must match the
    float64 oracle within 1e-3, and each side disagrees with the oracle on
    at most 1% of samples (tests/test_torch_render.py's gate)."""
    sd = _jax_scene("demo3.yml", 16, 8)
    root, depth = 2, 3
    kw = dict(img_w=16, img_h=8, n_rows=8, n_samples=1, root=root, max_depth=depth)
    pairs = [_both(sd, 0, s, 0, True, True, **kw) for s in range(root * root)]
    port = np.stack([p for p, _ in pairs])
    jax_ = np.stack([j for _, j in pairs])
    oracle = oracle_render(sd, root, depth, seed=0, nee=True, physical=True, raw_samples=True)
    tol = 1e-3
    scale = np.maximum(1.0, np.abs(oracle).max(-1))
    bad_port = np.abs(port - oracle).max(-1) > tol * scale
    bad_jax = np.abs(jax_ - oracle).max(-1) > tol * scale
    flips = np.argwhere(np.abs(port - jax_).max(-1) > 1e-5 * scale)
    unadjudicated = [
        tuple(f) for f in flips
        if min(np.abs(port[tuple(f)] - oracle[tuple(f)]).max(),
               np.abs(jax_[tuple(f)] - oracle[tuple(f)]).max()) > tol * scale[tuple(f)]
    ]
    budget = int(0.01 * bad_port.size)
    assert not unadjudicated, unadjudicated
    assert int(bad_port.sum()) <= budget and int(bad_jax.sum()) <= budget
    assert port.max() > 1.0  # the lights are in view of some samples
