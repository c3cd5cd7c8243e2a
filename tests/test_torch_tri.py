"""The port's triangle geometry (K6's plain version) and triangle lights
(K7's) against flux_tpu's, on identical inputs made from a numpy seed: the
compiled triangle arrays and the Morton-sorted triangle table bit for bit,
Möller–Trumbore, the nearest and any-hit folds in their unrolled, blocked
and carried forms, the light set, the area sampler and its reverse density,
one whole bounce with the shrunk shadow ray, the mesh generators, and
per-sample radiance against the float64 oracle.

The JAX functions run eagerly (``jax.disable_jit()`` where they use
``lax.scan``); no render program is compiled. Tolerances are those of
tests/test_torch_ops.py (hits: 1e-5 relative, 99.9% of lanes on the same
winner) and tests/test_torch_nee.py (light samples and densities: 2e-4
relative), for the reasons given there.
"""

import dataclasses
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux_tpu import meshgen as jmeshgen
from flux_tpu.ops import nee as jnee
from flux_tpu.ops.shade import PathState as JPathState
from flux_tpu.ops.shade import bounce as j_bounce
from flux_tpu.oracle import oracle_render
from flux_tpu.scene import SceneData as JSceneData
from flux_tpu.scene import compile_scene as j_compile_scene
from flux_tpu.scene import load_scene as j_load_scene
from flux_tpu_torch import meshgen
from flux_tpu_torch.ops import nee, scene_kernel
from flux_tpu_torch.ops.shade import PathState, bounce
from flux_tpu_torch.render import Renderer, render_block
from flux_tpu_torch.scene import (
    SCENE_FIELDS,
    TRI_FIELDS,
    CameraData,
    CameraSettings,
    MaterialData,
    MaterialKind,
    OutputSettings,
    PlaneData,
    SceneData,
    SphereData,
    TriangleData,
    compile_scene,
    load_scene,
)
from tests.test_torch_nee import _close, carry_lights
from tests.test_torch_ops import _compare_hits, carry_scene, jv, np_, tv, unit_dirs

# The modules, not the functions of the same name that the packages export.
ji = importlib.import_module("flux_tpu.ops.intersect")
ti = importlib.import_module("flux_tpu_torch.ops.intersect")

HERE = os.path.dirname(os.path.abspath(__file__))
SCENES = os.path.join(HERE, "..", "scenes")


def _path(name):
    return os.path.join(SCENES, f"{name}.yml")


def _ico_scene(subdiv):
    return meshgen.mesh_scene(*meshgen.icosphere(subdiv), name=f"ico{subdiv}")


def _jax(sd):
    return j_compile_scene(JSceneData.from_dict(sd.to_dict()))


def _small(sd, w, h):
    os_ = sd.output_settings
    return dataclasses.replace(sd, output_settings=dataclasses.replace(
        os_, image_width=w, image_height=h, pixel_size=os_.pixel_size * os_.image_width / w))


def _mixed_lights_scene():
    """demo5's box with one sphere light added: a light set of both kinds."""
    sd = load_scene(_path("demo5"))
    bulb = SphereData(center=(0.5, 1.0, 0.3), radius=0.15,
                      material=MaterialData(kind=MaterialKind.EMISSIVE, color=(1.0, 0.8, 0.6), param=8.0))
    return dataclasses.replace(sd, shapes=(bulb,) + sd.shapes)


def _rays_into(sd, rng, n, spread=1.5):
    eye = np.array(sd.camera_settings.eye, np.float64)
    o = (eye + np.zeros((n, 3))).astype(np.float32)
    d = np.array(sd.camera_settings.look_at) - eye + rng.normal(size=(n, 3)) * spread
    return o, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("name", ["mesh_ico", "demo4", "demo5"])
def test_compile_scene_triangle_fields_bit_equal(name):
    """v0, the edges, the unit normal and the material rows (spheres,
    planes, triangles) as flux_tpu compiles them, from the same SceneData."""
    jsc = j_compile_scene(j_load_scene(_path(name)))
    sc = compile_scene(load_scene(_path(name)), "cpu")
    assert sc.num_triangles == jsc.num_triangles > 0 and sc.unit_d == jsc.unit_d
    for f in SCENE_FIELDS + TRI_FIELDS:
        np.testing.assert_array_equal(getattr(sc, f).numpy(), np_(getattr(jsc, f)), err_msg=f)
        np.testing.assert_array_equal(sc.host[f], np_(getattr(jsc, f)), err_msg=f)
    back = carry_scene(jsc)
    assert back.num_triangles == sc.num_triangles and torch.equal(back.tri_n, sc.tri_n)


def test_degenerate_triangle_is_refused_at_compile_time():
    sd = load_scene(_path("demo5"))
    flat = TriangleData(v0=(0.0, 0.0, 0.0), v1=(1.0, 1.0, 1.0), v2=(2.0, 2.0, 2.0), material=sd.shapes[0].material)
    with pytest.raises(ValueError, match="degenerate triangle"):
        compile_scene(dataclasses.replace(sd, shapes=sd.shapes + (flat,)), "cpu")


@pytest.mark.parametrize("name", ["ico2", "demo5", "demo2"])
def test_tri_layout_bit_equal(name):
    """The Morton order over centroids and the padded triangle table, array
    for array; a triangle-free scene gives one all-pad block with a NaN
    box."""
    jsc = _jax(_ico_scene(2)) if name == "ico2" else j_compile_scene(j_load_scene(_path(name)))
    sc = carry_scene(jsc)
    jl, tl = ji.tri_layout(jsc), ti.tri_layout(sc)
    assert tl.n_blocks == jl.n_blocks == max(1, -(-sc.num_triangles // ti.TRI_SCAN_BLOCK))
    for f in ti.TRI_LAYOUT_FIELDS:
        np.testing.assert_array_equal(getattr(tl, f).numpy(), np_(getattr(jl, f)), err_msg=f)
    back = ti.tri_layout_from_numpy({f: np_(getattr(jl, f)) for f in ti.TRI_LAYOUT_FIELDS}, "cpu")
    assert all(np.array_equal(back.host[f], tl.host[f], equal_nan=True) for f in ti.TRI_LAYOUT_FIELDS)
    if sc.num_triangles == 0:
        assert np.isnan(tl.host["bmin"]).all() and (tl.host["idx"] == -1).all()


def test_meshgen_equals_jax(tmp_path):
    """The port's own copy of the mesh generators gives flux_tpu's output."""
    for k in (0, 1, 2):
        for a, b in zip(meshgen.icosphere(k), jmeshgen.icosphere(k)):
            np.testing.assert_array_equal(a, b)
    assert len(meshgen.icosphere(3)[1]) == 1280
    for a, b in zip(meshgen.box((-1, 0, -2), (1, 2, 3)), jmeshgen.box((-1, 0, -2), (1, 2, 3))):
        np.testing.assert_array_equal(a, b)
    v, f = meshgen.icosphere(1)
    kw = dict(name="m", width=64, height=48, scale=0.7, offset=(0.1, 1.2, -0.3))
    assert meshgen.mesh_scene(v, f, **kw).to_dict() == jmeshgen.mesh_scene(v, f, **kw).to_dict()
    assert meshgen.mesh_scene_yaml(v, f, scale=0.5) == jmeshgen.mesh_scene_yaml(v, f, scale=0.5)
    mat = MaterialData(kind=MaterialKind.GLOSSY, color=(0.5, 0.6, 0.7), param=0.9, exponent=50.0)
    tris = meshgen.mesh_triangles(v, f, mat, scale=2.0)
    assert len(tris) == 80 and tris[0].to_dict() == jmeshgen.mesh_triangles(v, f, mat, scale=2.0)[0].to_dict()
    obj = tmp_path / "quad.obj"
    obj.write_text("# a quad\nv 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1/1 2/2 3/3 4/4\nf -4 -3 -2\n")
    for a, b in zip(meshgen.load_obj(str(obj)), jmeshgen.load_obj(str(obj))):
        np.testing.assert_array_equal(a, b)
    out = tmp_path / "ico.yml"
    assert meshgen.main(["-k", "icosphere", "-s", "1", "--width", "32", "--height", "24", "-o", str(out)]) == 0
    assert sum(isinstance(s, TriangleData) for s in load_scene(str(out)).shapes) == 80


def test_triangle_t_matches_jax_with_a_shared_edge_and_a_degenerate_triangle():
    """Möller–Trumbore on random rays; a ray through the edge two triangles
    share hits both at one t (u + v == 1 on one, v == 0 on the other); a
    zero-area triangle is rejected by NaN and inf alone, on both sides."""
    rng = np.random.default_rng(0)
    n = 2048
    o = rng.normal(size=(n, 3)).astype(np.float32) + np.float32([0, 0, -4])
    d = (rng.normal(size=(n, 3)) * 1.2 - o).astype(np.float32)  # toward the triangle's surroundings
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    v0, e1, e2 = np.float32([-1, -1, 0]), np.float32([2, 0, 0.5]), np.float32([0, 2, -0.5])
    t, valid = ti.triangle_t(tv(*o.T), tv(*d.T), v0, e1, e2)
    jt, jvalid = ji.triangle_t(jv(*o.T), jv(*d.T), v0, e1, e2)
    same = valid.numpy() == np_(jvalid)
    assert same.mean() >= 0.999 and 0.02 < np_(jvalid).mean() < 0.9
    m = same & np_(jvalid)
    np.testing.assert_allclose(t.numpy()[m], np_(jt)[m], rtol=1e-5)
    # The unit square split along its diagonal (0,0)-(1,1); rays down the diagonal.
    s = np.linspace(0.1, 0.9, 9, dtype=np.float32)
    oo = np.stack([s, s, np.full(9, 2.0, np.float32)], 1)
    dd = np.tile(np.float32([0, 0, -1]), (9, 1))
    lower = (np.float32([0, 0, 0]), np.float32([1, 0, 0]), np.float32([1, 1, 0]))
    upper = (np.float32([0, 0, 0]), np.float32([1, 1, 0]), np.float32([0, 1, 0]))
    for tri in (lower, upper):
        t, valid = ti.triangle_t(tv(*oo.T), tv(*dd.T), *tri)
        jt, jvalid = ji.triangle_t(jv(*oo.T), jv(*dd.T), *tri)
        np.testing.assert_array_equal(valid.numpy(), np_(jvalid))
        assert valid.all() and torch.equal(t, torch.full((9,), 2.0))
    flat = (np.float32([0, 0, 0]), np.float32([1, 1, 1]), np.float32([2, 2, 2]))
    _, valid = ti.triangle_t(tv(*o.T), tv(*d.T), *flat)
    _, jvalid = ji.triangle_t(jv(*o.T), jv(*d.T), *flat)
    assert not valid.any() and not np_(jvalid).any()


@pytest.fixture(scope="module")
def box():
    """demo5 (36 triangles, a two-triangle light): JAX and port scenes, rays
    from the eye and rays leaving the surfaces they hit."""
    sd = load_scene(_path("demo5"))
    jsc = j_compile_scene(j_load_scene(_path("demo5")))
    sc = carry_scene(jsc)
    rng = np.random.default_rng(2)
    o, d = _rays_into(sd, rng, 256, spread=0.8)
    hit = ti.intersect(sc, tv(*o.T), tv(*d.T))
    keep = hit.mask.numpy()
    p = np.stack([c.numpy() for c in hit.point], 1)[keep]
    nrm = np.stack([c.numpy() for c in hit.normal], 1)[keep]
    out = unit_dirs(rng, len(p))
    out = np.where((np.sum(out * nrm, 1) < 0)[:, None], -out, out).astype(np.float32)
    return sd, jsc, sc, (o, d), (p, out, hit.shape.numpy()[keep].astype(np.int32), nrm)


@pytest.mark.parametrize("name", ["demo5", "ico1"])
def test_triangle_nearest_and_occluded_match_jax(name, box):
    """The sweep's triangle folds in both forms flux_tpu has: unrolled
    (demo5, 36 triangles) and blocked with the index tie-break (icosphere(1),
    80 triangles), with the origin triangle excluded."""
    if name == "demo5":
        _, jsc, sc, (o, d), (p, pd, prev, _) = box
    else:
        sd = _ico_scene(1)
        jsc = _jax(sd)
        sc = carry_scene(jsc)
        o, d = _rays_into(sd, np.random.default_rng(3), 128, spread=1.0)
        h0 = ti.intersect(sc, tv(*o.T), tv(*d.T))
        keep = h0.mask.numpy() & (h0.kind.numpy() != MaterialKind.EMISSIVE)
        p = np.stack([c.numpy() for c in h0.point], 1)[keep]
        pd, prev = unit_dirs(np.random.default_rng(4), len(p)), h0.shape.numpy()[keep].astype(np.int32)
    assert (sc.num_triangles > ji.TRI_UNROLL_MAX) == (name == "ico1")
    base = sc.num_spheres + sc.num_planes
    with jax.disable_jit():
        jt, jk = ji.triangle_nearest(jsc, jv(*o.T), jv(*d.T))
        jt2, jk2 = ji.triangle_nearest(jsc, jv(*p.T), jv(*pd.T), prev_tri=jnp.asarray(prev - base))
        jocc = ji.triangle_occluded(jsc, jv(*p.T), jv(*pd.T), jnp.float32(2.5), jnp.asarray(prev * 0 - 1),
                                    jv(*p.T).x < -1e30, origin_idx=jnp.asarray(prev))
    t, k = ti.triangle_nearest(sc, tv(*o.T), tv(*d.T))
    t2, k2 = ti.triangle_nearest(sc, tv(*p.T), tv(*pd.T), prev_tri=torch.from_numpy(prev - base))
    for (a, ak), (b, bk) in (((t, k), (jt, jk)), ((t2, k2), (jt2, jk2))):
        same = (ak.numpy() == np_(bk)) & (np.isfinite(a.numpy()) == np.isfinite(np_(b)))
        assert same.mean() >= 0.99, f"{(~same).sum()} of {same.size} lanes disagree"
        m = same & np.isfinite(np_(b))
        np.testing.assert_allclose(a.numpy()[m], np_(b)[m], rtol=1e-5)
    on_tri = prev >= base
    assert on_tri.sum() > 10 and not (np.isfinite(t2.numpy()) & (k2.numpy() == prev - base))[on_tri].any()
    occ = ti.triangle_occluded(sc, tv(*p.T), tv(*pd.T), torch.tensor(2.5), torch.from_numpy(prev * 0 - 1),
                               torch.zeros(len(prev), dtype=torch.bool), origin_idx=torch.from_numpy(prev))
    assert (occ.numpy() == np_(jocc)).mean() >= 0.99


def test_carried_triangle_folds_match_jax_and_the_sweep(box):
    """The functions the kernel body is made of (fold_tri_block over the
    Morton-sorted blocks, merge_tri_hit, fold_tri_occluded_block) against
    flux_tpu's, eagerly; merged into the sphere/plane hit they give the
    sweep's triangle fold bit for bit inside the port."""
    _, jsc, sc, _, (p, pd, prev, _) = box
    base = sc.num_spheres + sc.num_planes
    jl, tl = ji.tri_layout(jsc), ti.tri_layout(sc)
    jo, jd, to, td = jv(*p.T), jv(*pd.T), tv(*p.T), tv(*pd.T)
    jprev, tprev = jnp.asarray(prev), torch.from_numpy(prev)
    jc, tc = ji.tri_carry_init(jo.x), ti.tri_carry_init(to.x)
    for b in range(tl.n_blocks):
        jc = ji.fold_tri_block(jo, jd, jc, jl.v0[b], jl.e1[b], jl.e2[b], jl.n[b], jl.kind[b], jl.exp[b], jl.alb[b],
                               jl.idx[b], prev_tri=jprev - base)
        tc = ti.fold_tri_block(to, td, tc, tl.v0[b], tl.e1[b], tl.e2[b], tl.n[b], tl.kind[b], tl.exp[b], tl.alb[b],
                               tl.idx[b], prev_tri=tprev - base)
    no_tris_j = dataclasses.replace(jsc, tri_v0=jsc.tri_v0[:0], tri_e1=jsc.tri_e1[:0], tri_e2=jsc.tri_e2[:0],
                                    tri_n=jsc.tri_n[:0])
    jh = ji.merge_tri_hit(ji.intersect(no_tris_j, jo, jd, prev=jprev), jo, jd, jc, base)
    no_tris = dataclasses.replace(sc, tri_v0=sc.tri_v0[:0], tri_e1=sc.tri_e1[:0], tri_e2=sc.tri_e2[:0],
                                  tri_n=sc.tri_n[:0])
    h = ti.merge_tri_hit(ti.intersect(no_tris, to, td, prev=tprev), to, td, tc, base)
    _compare_hits(h, jh, min_agree=0.99)
    hs = ti.intersect(sc, to, td, prev=tprev)
    for a, b in zip(h[:3] + h[5:6] + h[7:] + tuple(h.point) + tuple(h.normal) + tuple(h.albedo),
                    hs[:3] + hs[5:6] + hs[7:] + tuple(hs.point) + tuple(hs.normal) + tuple(hs.albedo)):
        assert torch.equal(a, b)
    t_max, excl = np.float32(2.5), prev * 0 + base + 34  # a light triangle never blocks
    jocc, tocc = jo.x < -1e30, torch.zeros(len(prev), dtype=torch.bool)
    for b in range(tl.n_blocks):
        jocc = ji.fold_tri_occluded_block(jo, jd, jocc, jl.v0[b], jl.e1[b], jl.e2[b], jnp.float32(t_max),
                                          jnp.asarray(excl), jl.idx[b], base, origin_idx=jprev)
        tocc = ti.fold_tri_occluded_block(to, td, tocc, tl.v0[b], tl.e1[b], tl.e2[b], torch.tensor(t_max),
                                          torch.from_numpy(excl), tl.idx[b], base, origin_idx=tprev)
    assert (tocc.numpy() == np_(jocc)).mean() >= 0.99 and 0.05 < np_(jocc).mean() < 0.999
    assert torch.equal(tocc, ti.triangle_occluded(sc, to, td, torch.tensor(t_max), torch.from_numpy(excl),
                                                  torch.zeros(len(prev), dtype=torch.bool), origin_idx=tprev))


@pytest.mark.parametrize("name", ["demo5", "mixed"])
def test_triangle_lights_match_jax(name, box):
    """extract_lights with triangle lights (demo5's quad; a sphere light and
    a triangle light under one pick/cdf): every field bit-equal; the area
    sampler's direction, weight, density and ray-t, and the reverse density
    at the sampled point, within the tolerances of tests/test_torch_nee.py."""
    sd = load_scene(_path("demo5")) if name == "demo5" else _mixed_lights_scene()
    jl = jnee.extract_lights(JSceneData.from_dict(sd.to_dict()))
    tl = nee.extract_lights(sd, "cpu")
    assert tl.has_tris and tl.kinds == jl.kinds and ("sphere" in tl.kinds) == (name == "mixed")
    for f in nee.LIGHT_FIELDS + nee.TRI_LIGHT_FIELDS:
        np.testing.assert_array_equal(getattr(tl, f).numpy(), np_(getattr(jl, f)), err_msg=f)
    carried = carry_lights(jl)
    assert carried.kinds == tl.kinds and torch.equal(carried.tri_area, tl.tri_area)
    _, _, _, _, (p, _, _, nrm) = box
    n = len(p)
    ux, uy, up = np.random.default_rng(7).random((3, n), dtype=np.float32)
    js = jnee.sample_light_dirs(jl, jv(*p.T), jnp.asarray(ux), jnp.asarray(uy), jnp.asarray(up), normal=jv(*nrm.T))
    ts = nee.sample_light_dirs(tl, tv(*p.T), torch.from_numpy(ux), torch.from_numpy(uy), torch.from_numpy(up),
                               normal=tv(*nrm.T))
    np.testing.assert_array_equal(ts.sidx.numpy(), np_(js.sidx))
    np.testing.assert_array_equal(ts.tri_mask.numpy(), np_(js.tri_mask))
    assert ts.tri_mask.any() and ts.tri_mask.all() == (name == "demo5")
    for g, w in zip(ts.d, js.d):
        _close(g, w, rtol=0, atol=1e-5)
    for g, w in zip(ts.weight, js.weight):
        _close(g, w, rtol=2e-4, atol=1e-30)
    _close(ts.pdf, js.pdf, rtol=2e-4)
    _close(ts.tri_t, js.tri_t, rtol=1e-5)
    d = np.stack([np_(c) for c in js.d], 1)
    t = np_(js.tri_t)
    shape = np.where(np.arange(n) % 5 == 0, 3, np_(js.sidx)).astype(np.int32)  # some non-lights
    want = jnee.nee_pdf_toward(jl, jv(*p.T), jnp.asarray(shape), d=jv(*d.T), t=jnp.asarray(t), normal=jv(*nrm.T))
    got = nee.nee_pdf_toward(tl, tv(*p.T), torch.from_numpy(shape), d=tv(*d.T), t=torch.from_numpy(t),
                             normal=tv(*nrm.T))
    _close(got, want, rtol=2e-4)
    # On triangle lanes the reverse density is the sampler's own forward one.
    m = ts.tri_mask.numpy() & (shape != 3)
    np.testing.assert_allclose(got.numpy()[m], ts.pdf.numpy()[m], rtol=1e-5)
    with pytest.raises(ValueError, match="needs d and t"):
        nee.nee_pdf_toward(tl, tv(*p.T), torch.from_numpy(shape))


@pytest.mark.parametrize("physical", [False, True], ids=["nee", "mis"])
def test_bounce_with_triangle_lights_matches_jax(physical, box):
    """One whole bounce in demo5 with NEE over its triangle light (the
    light's ray-t from tri_t, the shadow ray shrunk by 1 - 1e-4 on triangle
    lanes): radiance, throughput and the MIS state against flux_tpu's bounce."""
    sd, jsc, sc, _, (p, pd, prev, nrm) = box
    jl = jnee.extract_lights(JSceneData.from_dict(sd.to_dict()))
    tl = carry_lights(jl)
    n = len(p)
    rng = np.random.default_rng(8)
    sx, sy, ux, uy, up = rng.random((5, n), dtype=np.float32)
    ones, zeros = np.ones(n, np.float32), np.zeros(n, np.float32)
    pdf0 = np.full(n, 0.3, np.float32)
    jstate = JPathState(
        o=jv(*p.T), d=jv(*pd.T), throughput=jv(ones, ones, ones), radiance=jv(zeros, zeros, zeros),
        alive=jnp.ones(n, bool), suppress=jnp.zeros(n, bool), prev_pdf=jnp.asarray(pdf0),
        prev_shape=jnp.asarray(prev), prev_normal=jv(*nrm.T) if physical else None)
    tstate = PathState(
        o=tv(*p.T), d=tv(*pd.T), throughput=tv(ones, ones, ones), radiance=tv(zeros, zeros, zeros),
        alive=torch.ones(n, dtype=torch.bool), prev_shape=torch.from_numpy(prev),
        suppress=torch.zeros(n, dtype=torch.bool), prev_pdf=torch.from_numpy(pdf0),
        prev_normal=tv(*nrm.T) if physical else None)
    jout = j_bounce(jsc, jstate, jnp.asarray(sx), jnp.asarray(sy), isect=ji.Intersector(mode="sweep"), lights=jl,
                    nee_samples=(jnp.asarray(ux), jnp.asarray(uy), jnp.asarray(up), True), physical=physical)
    tout = bounce(sc, tstate, torch.from_numpy(sx), torch.from_numpy(sy), lights=tl,
                  nee_samples=(torch.from_numpy(ux), torch.from_numpy(uy), torch.from_numpy(up), True),
                  physical=physical)
    same = (tout.alive.numpy() == np_(jout.alive)) & (tout.prev_shape.numpy() == np_(jout.prev_shape))
    assert same.mean() >= 0.99
    got = np.stack([c.numpy() for c in tout.radiance], 1)
    want = np.stack([np_(c) for c in jout.radiance], 1)
    close = np.isclose(got, want, rtol=2e-4, atol=1e-6).all(1)
    assert close.mean() >= 0.99, f"{(~close).sum()} of {n} lanes differ"
    assert (want > 0).any(1).mean() > 0.2  # the light is seen from many of the points
    gt = np.stack([c.numpy() for c in tout.throughput], 1)
    wt = np.stack([np_(c) for c in jout.throughput], 1)
    assert np.isclose(gt, wt, rtol=1e-4, atol=1e-6).all(1)[same].mean() >= 0.99


ORACLE_CASES = [("mesh_ico", False, False), ("demo5", True, False), ("demo5", True, True)]


@pytest.mark.parametrize("name, nee_on, physical", ORACLE_CASES, ids=["mesh_ico", "demo5-nee", "demo5-mis"])
def test_per_sample_radiance_against_the_oracle(name, nee_on, physical):
    """The slice as a whole on the CPU: per-sample radiance of a mesh scene
    (320 triangles under the sweep) and of the Cornell box with its triangle
    light, NEE alone and with MIS, against the float64 oracle at 12x9, root
    2, depth 3: at most 1% of samples off by more than 1e-3 (relative above
    1), ROADMAP.md's rule."""
    jsd = j_load_scene(_path(name))
    w, h = 12, 9
    jsd = dataclasses.replace(jsd, output_settings=dataclasses.replace(
        jsd.output_settings, image_width=w, image_height=h,
        pixel_size=jsd.output_settings.pixel_size * jsd.output_settings.image_width / w))
    r = Renderer(SceneData.from_dict(jsd.to_dict()), 2, 3, seed=0, device="cpu", nee=nee_on, physical=physical)
    assert r.accel == "sweep" and not r.uses_sweep_kernel and r.nee == nee_on
    port = np.stack([
        render_block(r.scene, r.cam, 0, s, 0, img_w=w, img_h=h, n_rows=h, n_samples=1, root=2, max_depth=3,
                     lights=r.lights, physical=physical, isect=r.isect).numpy()
        for s in range(4)
    ])
    oracle = oracle_render(jsd, 2, 3, seed=0, nee=nee_on, physical=physical, raw_samples=True)
    assert port.shape == oracle.shape == (4, h, w, 3)
    scale = np.maximum(1.0, np.abs(oracle).max(-1))
    bad = np.abs(port - oracle).max(-1) > 1e-3 * scale
    assert int(bad.sum()) <= int(0.01 * bad.size), f"{int(bad.sum())} of {bad.size} samples off"
    assert np.isfinite(port).all() and port.max() > 0.1


def test_scan_with_triangles_keeps_the_original_shape_numbering():
    """A scene whose 70 spheres pad to 96 in the scan table, a plane,
    triangles and a triangle light: under the scan the planes and triangles
    keep their numbers (spheres, planes, triangles; flux_tpu's TPU kernel
    renumbers from the padded count and remaps the lights, the port does
    not), so hit.shape, the light match and the shadow rays' exclusions
    agree with the sweep's: whole NEE + MIS renders are the same bits."""
    from flux_tpu_torch.genscene import sphere_field

    field = sphere_field(69, seed=4, width=24, height=16)
    field = dataclasses.replace(field, output_settings=dataclasses.replace(field.output_settings, pixel_size=33.0))
    mat = MaterialData(kind=MaterialKind.MATTE, color=(0.8, 0.3, 0.3), param=1.0)
    lamp = MaterialData(kind=MaterialKind.EMISSIVE, color=(1.0, 0.9, 0.8), param=12.0)
    v, f = meshgen.box((-2.0, 0.0, 4.0), (0.0, 1.5, 6.0))
    tris = meshgen.mesh_triangles(v, f, mat) + [
        TriangleData(v0=(3.0, 4.0, 2.0), v1=(3.0, 4.0, 4.0), v2=(5.0, 4.0, 2.0), material=lamp)]
    sd = dataclasses.replace(field, shapes=field.shapes + tuple(tris))
    scan = Renderer(sd, 2, 3, seed=3, device="cpu", accel="scan", nee=True, physical=True)
    sweep = Renderer(sd, 2, 3, seed=3, device="cpu", accel="sweep", nee=True, physical=True)
    assert scan.scene.num_spheres == 70 and scan.isect.layout.n_blocks == 3 and scan.isect.tri_layout.n_blocks == 1
    assert scan.lights.kinds[-1] == "tri" and int(scan.lights.shape_idx[-1]) == 70 + 1 + 12
    o, d = _rays_into(sd, np.random.default_rng(9), 512, spread=8.0)
    ha, hb = scan.isect(scan.scene, tv(*o.T), tv(*d.T)), sweep.isect(sweep.scene, tv(*o.T), tv(*d.T))
    assert torch.equal(ha.shape, hb.shape) and torch.equal(ha.t, hb.t)
    assert (ha.shape >= 71).any() and (ha.shape == 70).any()
    a = scan.render_rows_sum_range(0, 16, 0, 4, with_stats=True)
    b = sweep.render_rows_sum_range(0, 16, 0, 4, with_stats=True)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32)) and torch.isfinite(a).all()
    geom, _ = scene_kernel.pack_geom(scan.scene, scan.isect, scan.lights, "cpu")
    assert (geom.ns_base, geom.plane_row0, geom.tri_base, geom.n_tri_blocks) == (70, 0, 71, 1)
    assert geom.lights_have_tris == 1 and geom.n_lights == scan.lights.num_lights
    buf, off = scene_kernel.pack_light_table(scan.lights, 70 + 1 + 13)
    light_of = buf[off["light_of"]: off["light_of"] + 84].view(np.int32)
    assert light_of[83] == scan.lights.num_lights - 1 and (light_of >= 0).sum() == scan.lights.num_lights
    # The cached table is kept per shape count (light_of spans the shapes).
    cached = scan.lights.host[("table", "cpu", 84)]
    assert np.array_equal(cached[0].numpy().view(np.int32), buf.view(np.int32)) and cached[1] == off
    with pytest.raises(TypeError, match="three_level"):
        scene_kernel.render_block_scene(scan.scene, scan.cam, 0, 0, 0, isect=scan.isect, img_w=24, img_h=16,
                                        n_rows=1, n_samples=1, root=2, max_depth=1, three_level=True)
    assert scene_kernel.config_name("scan", True, False, True, True, tri_lights=True) == "scan+tri+nee+trilight+physical"


def _assert_lists_complete(L, offsets, cand, grid, rcap):
    """Each of 40 random bins of a layout's direction lists lists every
    triangle whose R can pass ``rcap`` for a direction of its cell (checked
    at its corners and at random directions of the cell, either sign,
    float64)."""
    n = L.host["idx"].size
    assert offsets.size == 3 * grid * grid + 1
    assert offsets[0] == 0 and offsets[-1] == len(cand) and (np.diff(offsets) >= 0).all()
    e1, e2 = (L.host[k].reshape(n, 3).astype(np.float64) for k in ("e1", "e2"))
    rng = np.random.default_rng(3)
    for f, i, j in zip(rng.integers(0, 3, 40), rng.integers(0, grid, 40), rng.integers(0, grid, 40)):
        k = (f * grid + i) * grid + j
        listed = set(cand[offsets[k]:offsets[k + 1], 3].view(np.int32).tolist())
        # Directions of the cell (the corners included), either sign.
        ab = -1 + 2 * np.stack([i + rng.random(64), j + rng.random(64)], 1) / grid
        ab[:4] = -1 + 2 * np.array([[i, j], [i + 1, j], [i, j + 1], [i + 1, j + 1]]) / grid
        one = np.ones(64)
        d = np.stack([(one, ab[:, 0], ab[:, 1]), (ab[:, 0], one, ab[:, 1]), (ab[:, 0], ab[:, 1], one)][f], axis=1)
        d *= rng.choice([-1.0, 1.0], (64, 1))
        dd = np.abs(d @ np.cross(e1, e2).T) * rcap
        scale = np.linalg.norm(d, axis=1)[:, None] * np.linalg.norm(e1, axis=1) * np.linalg.norm(e2, axis=1)
        over = (dd < scale) & (L.host["idx"].reshape(n) >= 0)  # R > rcap
        assert set(np.flatnonzero(over.any(axis=0)).tolist()) <= listed


def test_packed_triangle_table():
    """The triangle table the CUDA kernel reads: rows of four floats with
    the exponent beside the normal and the kind's bits beside the albedo,
    the tree over the blocks whose leaves are the blocks' boxes, and the
    lists of triangles by ray direction: each bin lists every triangle whose
    R can pass TRI_RCAP for a direction of its cell (checked at its center
    and at random directions of the cell, float64)."""
    r = Renderer(load_scene(_path("mesh_ico")), 1, 2, device="cpu")
    L = r.isect.tri_layout
    buf, off = scene_kernel.pack_tri_table(L)
    n = L.n_blocks * ti.TRI_SCAN_BLOCK
    assert L.n_blocks == 20 and all(o % 4 == 0 for o in off.values())
    nrm = buf[off["tri_n"]: off["tri_n"] + 4 * n].reshape(n, 4)
    np.testing.assert_array_equal(nrm[:, :3], L.host["n"].reshape(n, 3))
    np.testing.assert_array_equal(nrm[:, 3], L.host["exp"].reshape(n))
    alb = buf[off["tri_alb"]: off["tri_alb"] + 4 * n].reshape(n, 4)
    np.testing.assert_array_equal(alb[:, 3].view(np.int32), L.host["kind"].reshape(n))
    np.testing.assert_array_equal(buf[off["tri_idx"]: off["tri_idx"] + n].view(np.int32), L.host["idx"].reshape(n))
    tree = buf[off["tri_tree"]: off["tri_tree"] + 8 * 63].reshape(63, 2, 4)  # 32 leaves
    np.testing.assert_array_equal(tree[31:51, 0, :3], L.host["bmin"])
    np.testing.assert_array_equal(tree[31:51, 1, :3], L.host["bmax"])
    assert (tree[:, 0, 3] == 0).all() and np.isnan(tree[51:, :, :3]).all()  # no radius term for triangle boxes
    kids = tree[1:].reshape(31, 2, 2, 4)
    np.testing.assert_array_equal(np.fmin(kids[:, 0, 0, :3], kids[:, 1, 0, :3]), tree[:31, 0, :3])
    offsets, cand, grid, rcap = scene_kernel.tri_bins(L)
    np.testing.assert_array_equal(buf[off["tri_bin_off"]: off["tri_bin_off"] + offsets.size].view(np.int32), offsets)
    _assert_lists_complete(L, offsets, cand, grid, rcap)
    geom, keep = scene_kernel.pack_geom(r.scene, r.isect, None, "cpu", tri_skip=False)
    assert (geom.scan, geom.n_sph_blocks, geom.n_tri_blocks, geom.tri_skip, geom.plane_row0) == (0, 0, 20, 0, 2)
    assert scene_kernel.table_bytes(r.isect, None, 323) == buf.nbytes


def test_direction_lists_past_their_budget_take_a_coarser_grid():
    """icosphere(4) (5,120 triangles): at the finest grid, building its
    lists would test more (bin, triangle) pairs than BIN_TESTS, so tri_bins
    takes the next coarser grid, within the budget, and its lists there are
    complete; a built layout takes no other grid. (mesh1280, within it,
    keeps the finest grid.)"""
    sc = compile_scene(meshgen.mesh_scene(*meshgen.icosphere(4)), "cpu")
    L = ti.tri_layout(sc)
    offsets, cand, grid, rcap = scene_kernel.tri_bins(L)
    finest, coarser = scene_kernel.BIN_GRIDS[:2]
    assert 5120 * 3 * coarser ** 2 <= scene_kernel.BIN_TESTS < 5120 * 3 * finest ** 2
    assert grid == coarser
    _assert_lists_complete(L, offsets, cand, grid, rcap)
    with pytest.raises(ValueError):
        scene_kernel.tri_bins(L, grid=finest)
    assert 1280 * 3 * finest ** 2 <= scene_kernel.BIN_TESTS


def test_icosphere_converges_to_analytic_sphere():
    """The port's counterpart of tests/test_trimesh.py's: icosphere(3) (1280
    triangles, chord error ~0.25%) renders like the analytic sphere it
    approximates, same material, light, ground and seed, through the plain
    version on the CPU at the same tiny size (48x36, root 4, depth 3): mean
    |diff| under 0.02. It holds the whole triangle path (intersection,
    normals, shading) against the sphere path the goldens pin."""
    red = MaterialData(kind=MaterialKind.MATTE, color=(1.0, 0.0, 0.0))
    light = SphereData(center=(0, 6, -2), radius=2.0,
                       material=MaterialData(kind=MaterialKind.EMISSIVE, color=(1, 1, 1), param=3.0))
    ground = PlaneData(point=(0, -1.2, 0), normal=(0, 1, 0),
                       material=MaterialData(kind=MaterialKind.MATTE, color=(0.6, 0.6, 0.6)))
    mesh = meshgen.mesh_triangles(*meshgen.icosphere(3), red, scale=1.0, offset=(0.0, 0.0, 0.0))
    sphere = SphereData(center=(0, 0, 0), radius=1.0, material=red)

    def render(shapes):
        sd = SceneData(scene_name="t", output_settings=OutputSettings(image_width=48, image_height=36, pixel_size=1.0),
                       background=(0.0, 0.0, 0.0), shapes=tuple(shapes),
                       camera_settings=CameraSettings(eye=(0, 0, -5), look_at=(0, 0, 0), up=(0, 1, 0)),
                       camera_data=CameraData(zoom_factor=1.0, view_plane_distance=500.0, focal_distance=5.0,
                                              lens_radius=0.0))
        return Renderer(sd, 4, 3, seed=1, device="cpu").render_rows(0, 36)

    diff = np.abs(render([light, ground] + mesh) - render([light, ground, sphere])).mean()
    assert diff < 0.02, f"icosphere vs analytic sphere mean |diff| {diff:.4f}"
