"""The port's camera and wavefront ops against flux_tpu's on identical inputs.

Scene and camera constants are carried across from the JAX package's
compiled arrays (``scene_from_numpy`` / ``camera_from_numpy``), and every
input is made from a seed with numpy, so the two packages compute on the
same float32 values. The ops are the same float32 arithmetic in the same
order, but XLA's CPU code may contract a multiply and an add into one FMA,
and rsqrt, cos and pow come from other libraries, so results agree to a few
ulp rather than bit for bit; each tolerance below says which.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux_tpu.camera import camera_arrays as j_camera_arrays
from flux_tpu.camera import primary_rays as j_primary_rays
from flux_tpu.ops.brdf import sample_directions as j_sample_directions
from flux_tpu.ops.intersect import intersect as j_intersect
from flux_tpu.ops.shade import PathState as JPathState
from flux_tpu.ops.shade import bounce as j_bounce
from flux_tpu.scene import compile_scene as j_compile_scene
from flux_tpu.scene import load_scene as j_load_scene
from flux_tpu.vec import Vec3 as JVec3
from flux_tpu_torch.camera import CAMERA_FIELDS, camera_from_numpy, camera_tensors, primary_rays
from flux_tpu_torch.ops.brdf import sample_directions
from flux_tpu_torch.ops.intersect import intersect
from flux_tpu_torch.ops.shade import PathState, bounce
from flux_tpu_torch.ops.sweep_kernel import pack_scene
from flux_tpu_torch.scene import (
    SCENE_FIELDS,
    TRI_FIELDS,
    SceneData,
    compile_scene,
    load_scene,
    scene_from_numpy,
)
from flux_tpu_torch.vec import Vec3

HERE = os.path.dirname(os.path.abspath(__file__))
SCENES = os.path.join(HERE, "..", "scenes")
EPS = float(np.spacing(np.float32(1.0)))


def carry_scene(jax_scene):
    """The port's scene on the CPU from the JAX package's SceneArrays."""
    arrays = {f: np.asarray(getattr(jax_scene, f)) for f in SCENE_FIELDS + TRI_FIELDS}
    return scene_from_numpy(arrays, jax_scene.unit_d, "cpu")


def carry_camera(jax_cam):
    return camera_from_numpy({f: np.asarray(getattr(jax_cam, f)) for f in CAMERA_FIELDS}, "cpu")


def jax_pair(name):
    """(JAX SceneData, SceneArrays, CameraArrays) of a stock scene."""
    sd = j_load_scene(os.path.join(SCENES, f"{name}.yml"))
    cam = j_camera_arrays(sd.camera_settings, sd.camera_data, sd.output_settings.pixel_size)
    return sd, j_compile_scene(sd), cam


def tv(*cols):
    return Vec3(*(torch.from_numpy(np.ascontiguousarray(c, np.float32)) for c in cols))


def jv(*cols):
    return JVec3(*(jnp.asarray(np.asarray(c, np.float32)) for c in cols))


def np_(a):
    return np.asarray(a)


def unit_dirs(rng, n):
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return d.astype(np.float32)


@pytest.mark.parametrize("name", ["demo1", "demo2"])
def test_scene_and_camera_constants_bit_equal(name):
    """compile_scene / camera_tensors build the JAX package's float32 values
    from the same SceneData (SceneData round-trips through to_dict)."""
    jsd, jsc, jcam = jax_pair(name)
    sd = SceneData.from_dict(jsd.to_dict())
    sc = compile_scene(sd, "cpu")
    assert sc.unit_d == jsc.unit_d
    for f in SCENE_FIELDS:
        np.testing.assert_array_equal(sc.host[f], np.asarray(getattr(jsc, f)), err_msg=f)
        np.testing.assert_array_equal(getattr(sc, f).numpy(), np.asarray(getattr(jsc, f)), err_msg=f)
    cam = camera_tensors(sd.camera_settings, sd.camera_data, sd.output_settings.pixel_size, "cpu")
    for f in CAMERA_FIELDS:
        np.testing.assert_array_equal(getattr(cam, f).numpy(), np.asarray(getattr(jcam, f)), err_msg=f)


@pytest.mark.parametrize("name", ["demo1", "demo2"])
def test_primary_rays_within_4_ulp(name):
    """Unit directions and world-space origins within 4 ulp of their scale
    (the rsqrt of the normalization differs between the libraries)."""
    _, _, jcam = jax_pair(name)
    cam = carry_camera(jcam)
    rng = np.random.default_rng(1)
    n = 2048
    row = rng.integers(0, 600, n).astype(np.int32)
    col = rng.integers(0, 800, n).astype(np.int32)
    sx, sy = rng.random(n, dtype=np.float32), rng.random(n, dtype=np.float32)
    lx, ly = (rng.random(n, dtype=np.float32) * 2 - 1) * 0.7, (rng.random(n, dtype=np.float32) * 2 - 1) * 0.7
    jo, jd = j_primary_rays(jcam, jnp.asarray(row), jnp.asarray(col), 800, 600, sx, sy, lx, ly)
    o, d = primary_rays(cam, torch.from_numpy(row), torch.from_numpy(col), 800, 600,
                        *(torch.from_numpy(a) for a in (sx, sy, lx, ly)))
    for got, want in zip(d, jd):
        assert np.abs(np_(got) - np_(want)).max() <= 4 * EPS
    scale = float(np.abs(np_(jcam.eye)).max())
    for got, want in zip(o, jo):
        assert np.abs(np_(got) - np_(want)).max() <= 4 * EPS * scale


def _random_rays(rng, n):
    """Origins in the stock scenes' box around the spheres, unit directions."""
    o = (rng.random((n, 3)) * [16.0, 9.0, 24.0] + [-8.0, 0.05, -6.0]).astype(np.float32)
    return o, unit_dirs(rng, n)


def _surface_rays(jsc, rng, n):
    """Rays that start ON a shape: the hit points of random rays, leaving in
    random unit directions, with ``prev`` set to the shape they start on."""
    o, d = _random_rays(rng, n)
    hit = j_intersect(jsc, jv(*o.T), jv(*d.T))
    keep = np_(hit.mask)
    p = np.stack([np_(c) for c in hit.point], 1)[keep]
    return p, unit_dirs(rng, len(p)), np_(hit.shape)[keep].astype(np.int32)


def _compare_hits(h, jh, min_agree=0.999):
    """Winner (mask, shape, kind) equal except on borderline lanes, where two
    candidates or T_MIN lie within float32 rounding of the winner; the
    winner's t, normal and albedo to 1e-5 relative wherever they agree."""
    same = (np_(h.mask) == np_(jh.mask)) & (np_(h.shape) == np_(jh.shape))
    assert same.mean() >= min_agree, f"{(~same).sum()} of {same.size} lanes disagree"
    m = same & np_(jh.mask)
    np.testing.assert_array_equal(np_(h.kind)[same], np_(jh.kind)[same])
    np.testing.assert_allclose(np_(h.t)[m], np_(jh.t)[m], rtol=1e-5)
    for got, want in zip(h.normal, jh.normal):
        np.testing.assert_allclose(np_(got)[m], np_(want)[m], rtol=1e-5, atol=1e-5)
    for got, want in zip(h.albedo, jh.albedo):
        np.testing.assert_array_equal(np_(got)[same], np_(want)[same])
    np.testing.assert_array_equal(np_(h.exponent)[same], np_(jh.exponent)[same])


@pytest.mark.parametrize("name", ["demo1", "demo2"])
def test_intersect_random_rays(name):
    _, jsc, _ = jax_pair(name)
    sc = carry_scene(jsc)
    rng = np.random.default_rng(2)
    o, d = _random_rays(rng, 4096)
    _compare_hits(intersect(sc, tv(*o.T), tv(*d.T)), j_intersect(jsc, jv(*o.T), jv(*d.T)))


@pytest.mark.parametrize("name", ["demo1", "demo2"])
def test_intersect_rays_leaving_a_surface(name):
    """Self-hit exclusion: the origin sphere takes c = 0, the origin plane
    is skipped. Hits are compared with the same ``prev`` on both sides."""
    _, jsc, _ = jax_pair(name)
    sc = carry_scene(jsc)
    o, d, prev = _surface_rays(jsc, np.random.default_rng(3), 4096)
    h = intersect(sc, tv(*o.T), tv(*d.T), prev=torch.from_numpy(prev))
    jh = j_intersect(jsc, jv(*o.T), jv(*d.T), prev=jnp.asarray(prev))
    _compare_hits(h, jh)
    # No ray leaving a plane hits that plane again.
    n_spheres = sc.num_spheres
    on_plane = prev >= n_spheres
    assert not (np_(h.mask)[on_plane] & (np_(h.shape)[on_plane] == prev[on_plane])).any()


def test_intersect_degenerate_plane_rejected():
    """A ray parallel to a plane (d·n == 0) gives t = ±inf or NaN there and
    must hit nothing, on both sides."""
    _, jsc, _ = jax_pair("demo2")
    sc = carry_scene(jsc)
    o = np.array([[0.0, 1e-3, -50.0], [3.0, 0.0, 2.0]], np.float32)  # above / in the floor
    d = np.array([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0]], np.float32)
    h = intersect(sc, tv(*o.T), tv(*d.T))
    jh = j_intersect(jsc, jv(*o.T), jv(*d.T))
    assert (np_(h.shape) != sc.num_spheres).all()
    np.testing.assert_array_equal(np_(h.shape), np_(jh.shape))


@pytest.mark.parametrize("kind", [0, 2, 3])
def test_sample_directions(kind):
    """Unit outgoing directions within the warp's tolerance (sin from cos,
    see test_torch_samplers.SQRT_TOL) plus the frame's rsqrt ulps."""
    rng = np.random.default_rng(4 + kind)
    n = 4096
    normal, d = unit_dirs(rng, n), unit_dirs(rng, n)
    d = np.where((np.sum(normal * d, 1) > 0)[:, None], -d, d)  # incoming
    exps = rng.choice(np.float32([1.0, 10.0, 100.0, 1e4, 1e5]), n).astype(np.float32)
    kinds = np.full(n, kind, np.int32)
    sx, sy = rng.random(n, dtype=np.float32), rng.random(n, dtype=np.float32)
    got = sample_directions(torch.from_numpy(kinds), torch.from_numpy(exps), tv(*normal.T), tv(*d.T),
                            torch.from_numpy(sx), torch.from_numpy(sy))
    want = j_sample_directions(jnp.asarray(kinds), jnp.asarray(exps), jv(*normal.T), jv(*d.T), sx, sy)
    tol = 16 * EPS + 2 * np.sqrt(8 * EPS)
    for g, w in zip(got, want):
        assert np.abs(np_(g) - np_(w)).max() <= tol
    norm = np.sqrt(sum(np_(g).astype(np.float64) ** 2 for g in got))
    assert np.abs(norm - 1).max() < 1e-5


def test_bounce_reference_arm():
    """One reference-transport bounce from mid-path states (rays leaving
    surfaces, random throughput and radiance, some lanes dead): alive,
    origin and radiance agree lane for lane where the hit agrees."""
    _, jsc, _ = jax_pair("demo2")
    sc = carry_scene(jsc)
    rng = np.random.default_rng(5)
    o, d, prev = _surface_rays(jsc, rng, 4096)
    n = len(o)
    tput = rng.random((n, 3), dtype=np.float32)
    rad = rng.random((n, 3), dtype=np.float32)
    alive = rng.random(n) < 0.9
    sx, sy = rng.random(n, dtype=np.float32), rng.random(n, dtype=np.float32)
    st = PathState(tv(*o.T), tv(*d.T), tv(*tput.T), tv(*rad.T), torch.from_numpy(alive),
                   torch.from_numpy(prev))
    jst = JPathState(o=jv(*o.T), d=jv(*d.T), throughput=jv(*tput.T), radiance=jv(*rad.T),
                     alive=jnp.asarray(alive), prev_shape=jnp.asarray(prev))
    out = bounce(sc, st, torch.from_numpy(sx), torch.from_numpy(sy))
    jout = j_bounce(jsc, jst, jnp.asarray(sx), jnp.asarray(sy))
    same = (np_(out.alive) == np_(jout.alive)) & (np_(out.prev_shape) == np_(jout.prev_shape))
    assert same.mean() >= 0.999
    for got, want in zip((*out.radiance, *out.throughput), (*jout.radiance, *jout.throughput)):
        np.testing.assert_allclose(np_(got)[same], np_(want)[same], rtol=1e-5)
    for got, want in zip(out.o, jout.o):
        np.testing.assert_allclose(np_(got)[same], np_(want)[same], rtol=1e-5, atol=1e-5)
    tol = 16 * EPS + 2 * np.sqrt(8 * EPS)
    for got, want in zip(out.d, jout.d):
        assert np.abs(np_(got)[same] - np_(want)[same]).max() <= tol


def test_pack_scene_layout():
    """The kernel's constant record holds the scene and camera as the plain
    version reads them: albedo = color × param in float32, the exponent
    with its two low mantissa bits clear, the kind beside it."""
    _, jsc, jcam = jax_pair("demo2")
    sc, cam = carry_scene(jsc), carry_camera(jcam)
    st = pack_scene(sc, cam)
    arr = np.ctypeslib.as_array
    ns, npl = sc.num_spheres, sc.num_planes
    assert (st.n_spheres, st.n_planes, st.unit_d) == (12, 1, 1)
    np.testing.assert_array_equal(arr(st.sph)[:ns, :3], sc.host["sphere_center"])
    np.testing.assert_array_equal(arr(st.sph)[:ns, 3], sc.host["sphere_radius"])
    np.testing.assert_array_equal(arr(st.pl_normal)[:npl, :3], sc.host["plane_normal"])
    alb = (sc.mat_color * sc.mat_param[:, None]).numpy()
    np.testing.assert_array_equal(arr(st.alb)[: ns + npl, :3], alb)
    jh = j_intersect(jsc, jv([0.0], [1.0], [-9.0]), jv([-2.0 / 5], [0.0], [np.sqrt(21) / 5]))
    k = int(jh.shape[0])
    assert arr(st.exponent)[k] == float(jh.exponent[0]) and arr(st.kind)[k] == int(jh.kind[0])
    np.testing.assert_array_equal(arr(st.u)[:3], cam.host["u"])
    assert st.vp_factor == float(cam.host["vp_factor"])
    with pytest.raises(ValueError):
        too_many = dataclasses.replace(sc, sphere_center=torch.zeros(65, 3))
        pack_scene(too_many, cam)
