"""The port's scan intersection (K5's plain version) against flux_tpu's, on
identical inputs made from a numpy seed: the Morton order and the block
table bit for bit, the scan and the carried folds on a few hundred rays,
the scan against the sweep inside the port bit for bit, the packed tables
the CUDA kernel reads, the golden of the 96-sphere field through
``Renderer(device="cpu")``, and per-sample radiance through the scan
against the float64 oracle.

The JAX functions run eagerly (``jax.disable_jit()`` where they use
``lax.scan``): no render program is compiled. XLA's CPU code may contract a
multiply and an add into one FMA, so t, point and normal agree to 1e-5
relative rather than bit for bit, and a borderline lane may pick another
winner (tests/test_torch_ops.py's gate: 99.9% of lanes agree).
"""

import dataclasses
import functools
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux_tpu import genscene as jgenscene
from flux_tpu.ops import aabb as jaabb
from flux_tpu.oracle import oracle_render
from flux_tpu.scene import SceneData as JSceneData
from flux_tpu.scene import compile_scene as j_compile_scene
from flux_tpu.scene import load_scene as j_load_scene
from flux_tpu_torch import cli, genscene
from flux_tpu_torch.ops import aabb, scene_kernel
from flux_tpu_torch.ops.sweep_kernel import pack_scene
from flux_tpu_torch.render import SCAN_AUTO_THRESHOLD, Renderer, finalize, render_block
from flux_tpu_torch.scene import MaterialData, MaterialKind, SphereData
from tests.test_torch_ops import _compare_hits, carry_scene, jv, np_, tv, unit_dirs

# The modules, not the functions of the same name that the packages export.
ji = importlib.import_module("flux_tpu.ops.intersect")
ti = importlib.import_module("flux_tpu_torch.ops.intersect")

HERE = os.path.dirname(os.path.abspath(__file__))
SCENES = os.path.join(HERE, "..", "scenes")


def _field96_with_twins():
    """sphere_field(96, seed=7) plus two identical matte spheres in view
    (equal t on every ray that hits them: the lower index must win)."""
    sd = genscene.sphere_field(96, seed=7)
    twin = SphereData(center=(0.5, 2.5, 6.0), radius=0.8,
                      material=MaterialData(kind=MaterialKind.MATTE, color=(0.2, 0.9, 0.4), param=1.0))
    return dataclasses.replace(sd, shapes=sd.shapes + (twin, twin))


def _jax_scene(sd):
    return j_compile_scene(JSceneData.from_dict(sd.to_dict()))


def _layout_scene(name):
    if name == "field96":
        return _jax_scene(genscene.sphere_field(96, seed=7))
    if name == "field96_twins":
        return _jax_scene(_field96_with_twins())
    return j_compile_scene(j_load_scene(os.path.join(SCENES, f"{name}.yml")))


def _carry_layout(jl):
    return ti.scan_layout_from_numpy({f: np.asarray(getattr(jl, f)) for f in ti.SCAN_FIELDS}, "cpu")


def _rays(sd, rng, n):
    """Camera-like rays into the field, and rays leaving the spheres they
    hit (``prev`` set), as float32 arrays."""
    eye = np.array(sd.camera_settings.eye, np.float64)
    o = (eye + np.zeros((n, 3))).astype(np.float32)
    d = np.array(sd.camera_settings.look_at) - eye + rng.normal(size=(n, 3)) * 6.0
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


@pytest.mark.parametrize("n, seed", [(96, 7), (24, 0), (0, 1)])
def test_genscene_sphere_field_equals_jax(n, seed):
    """The port's own copy of the generator gives flux_tpu's scene."""
    assert genscene.sphere_field(n, seed).to_dict() == jgenscene.sphere_field(n, seed).to_dict()
    kw = dict(name="f", width=64, height=48, spread=5.0, emissive_fraction=0.5)
    assert genscene.sphere_field(n, seed, **kw).to_dict() == jgenscene.sphere_field(n, seed, **kw).to_dict()


def test_genscene_main_writes_a_scene_the_loader_reads(tmp_path):
    out = tmp_path / "f.yml"
    assert genscene.main(["-n", "5", "--seed", "3", "--width", "32", "--height", "24", "-o", str(out)]) == 0
    assert j_load_scene(str(out)).to_dict() == genscene.sphere_field(5, 3, width=32, height=24).to_dict()


@pytest.mark.parametrize("name", ["field96", "spheres512", "demo5"])
def test_morton_order_and_scan_layout_bit_equal(name):
    """The same permutation and the same padded table, array for array
    (NaN padding and NaN boxes included); flux_tpu's floor of three blocks
    only adds all-pad blocks behind the port's."""
    jsc = _layout_scene(name)
    sc = carry_scene(jsc)
    np.testing.assert_array_equal(ti.morton_order(sc.host["sphere_center"]), np.asarray(ji.morton_order(jsc.sphere_center)))
    jl = ji.scan_layout(jsc)
    tl = ti.scan_layout(sc)
    nb = tl.n_blocks
    assert nb == max(1, -(-sc.num_spheres // ti.SCAN_BLOCK)) <= jl.n_blocks
    for f in ti.SCAN_FIELDS:
        want = np.asarray(getattr(jl, f))
        np.testing.assert_array_equal(getattr(tl, f).numpy(), want[:nb], err_msg=f)
        np.testing.assert_array_equal(tl.host[f], want[:nb], err_msg=f)
    assert (np.asarray(jl.idx)[nb:] == -1).all() and np.isnan(np.asarray(jl.bmin)[nb:]).all()
    assert tl.idx.dtype == tl.kind.dtype == torch.int32
    # What was handed over as numpy comes back as the same table.
    back = _carry_layout(jl)
    for f in ti.SCAN_FIELDS:
        np.testing.assert_array_equal(getattr(back, f).numpy()[:nb], getattr(tl, f).numpy(), err_msg=f)


def test_aabb_hit_equals_jax():
    """The slab test, axis-parallel rays (1/d = ±inf) included: equal masks."""
    rng = np.random.default_rng(0)
    n = 2048
    o = rng.normal(size=(n, 3)).astype(np.float32) * 3
    d = -o / np.linalg.norm(o, axis=1, keepdims=True) + unit_dirs(rng, n) * np.float32(0.6)
    d[::7, 0] = 0.0  # parallel to the x slabs
    d[::11, 1] = 0.0
    c0 = np.float32([-1.0, -0.5, -2.0])
    c1 = np.float32([1.5, 0.75, 0.25])
    got = aabb.aabb_hit(tv(*c0), tv(*c1), tv(*o.T), tv(*d.T)).numpy()
    want = np_(jaabb.aabb_hit(jv(*c0), jv(*c1), jv(*o.T), jv(*d.T)))
    np.testing.assert_array_equal(got, want)
    assert 0.05 < want.mean() < 0.95
    lo, hi = aabb.sphere_bounds((1.0, 2.0, 3.0), 0.5)
    assert tuple(lo) == (0.5, 1.5, 2.5) and tuple(hi) == (1.5, 2.5, 3.5)


@pytest.fixture(scope="module")
def field():
    """(SceneData, JAX SceneArrays, port scene, JAX layout, port layout,
    rays, rays leaving surfaces) of the 96-sphere field with twins."""
    sd = _field96_with_twins()
    jsc = _jax_scene(sd)
    sc = carry_scene(jsc)
    jl = ji.scan_layout(jsc)
    rng = np.random.default_rng(5)
    o, d = _rays(sd, rng, 256)
    hit = ti.intersect(sc, tv(*o.T), tv(*d.T))
    keep = hit.mask.numpy() & (hit.kind.numpy() != MaterialKind.EMISSIVE)
    p = np.stack([c.numpy() for c in hit.point], 1)[keep]
    leaving = (p, unit_dirs(rng, len(p)), hit.shape.numpy()[keep].astype(np.int32))
    return sd, jsc, sc, jl, _carry_layout(jl), (o, d), leaving


def test_intersect_scan_matches_jax(field):
    """The scan's hit record against flux_tpu's intersect_scan, camera rays
    and rays that start on a sphere or the plane (``prev``)."""
    _, jsc, sc, jl, tl, (o, d), (p, pd, prev) = field
    # One batch: the camera rays (prev -1: on no shape) and the leaving rays.
    o, d = np.concatenate([o, p]), np.concatenate([d, pd])
    prev = np.concatenate([np.full(256, -1, np.int32), prev])
    with jax.disable_jit():
        jh = ji.intersect_scan(jsc, jv(*o.T), jv(*d.T), layout=jl, prev=jnp.asarray(prev))
    h = ti.intersect_scan(sc, tv(*o.T), tv(*d.T), layout=tl, prev=torch.from_numpy(prev))
    _compare_hits(h, jh, min_agree=0.995)
    assert 0.3 < np_(jh.mask).mean() and len(prev) > 356
    # The twins (indices 97 and 98, equal t on every camera ray): the lower wins.
    seen = h.shape.numpy()[:256]
    assert (seen == 97).sum() > 0 and (seen == 98).sum() == 0


def test_carried_folds_match_jax(field):
    """The functions the kernel body is made of (fold_sphere_block over the
    blocks, then finish_scan_carry; fold_occluded_block) against flux_tpu's,
    eagerly, on rays leaving surfaces; the carried fold gives the scan's
    hit bit for bit inside the port."""
    _, jsc, sc, jl, tl, _, (p, pd, prev) = field
    p, pd, prev = p[:128], pd[:128], prev[:128]
    jo, jd, jprev = jv(*p.T), jv(*pd.T), jnp.asarray(prev)
    jcarry = ji.scan_carry_init(jo.x)
    for b in range(jl.n_blocks):
        jcarry = ji.fold_sphere_block(jo, jd, None, None, jcarry, jl.ctr[b], jl.rad[b], jl.inv_r[b], jl.kind[b],
                                      jl.exp[b], jl.alb[b], jl.idx[b], prev=jprev)
    jh = ji.finish_scan_carry(jsc, jo, jd, jcarry, prev=jprev)
    to, td, tprev = tv(*p.T), tv(*pd.T), torch.from_numpy(prev)
    carry = ti.scan_carry_init(to.x)
    for b in range(tl.n_blocks):
        carry = ti.fold_sphere_block(to, td, None, None, carry, tl.ctr[b], tl.rad[b], tl.inv_r[b], tl.kind[b],
                                     tl.exp[b], tl.alb[b], tl.idx[b], prev=tprev)
    h = ti.finish_scan_carry(sc, to, td, carry, prev=tprev)
    _compare_hits(h, jh, min_agree=0.99)
    hs = ti.intersect_scan(sc, to, td, layout=tl, prev=tprev)
    for a, b in zip(h[:3] + h[5:6] + h[7:] + tuple(h.point) + tuple(h.normal) + tuple(h.albedo),
                    hs[:3] + hs[5:6] + hs[7:] + tuple(hs.point) + tuple(hs.normal) + tuple(hs.albedo)):
        assert torch.equal(a, b)
    # Any-hit fold of one block toward a far point, the origin sphere given.
    t_max = np.full(128, 9.0, np.float32)
    excl = np.full(128, 0, np.int32)  # the environment sphere never blocks
    want = ji.fold_occluded_block(jo, jd, None, None, jo.x < -1e30, jl.ctr[1], jl.rad[1], jnp.asarray(t_max),
                                  jnp.asarray(excl), jl.idx[1], origin_idx=jprev)
    got = ti.fold_occluded_block(to, td, None, None, torch.zeros(128, dtype=torch.bool), tl.ctr[1], tl.rad[1],
                                 torch.from_numpy(t_max), torch.from_numpy(excl), tl.idx[1], origin_idx=tprev)
    assert (got.numpy() == np_(want)).mean() >= 0.99


def test_occluded_scan_matches_jax_and_the_sweep(field):
    """Shadow rays from surface points toward the sky and toward other
    spheres: the scan's any-hit mask against flux_tpu's occluded_scan, and
    equal to the port's own sweep."""
    _, jsc, sc, jl, tl, _, (p, pd, prev) = field
    n = len(prev)
    t_max = np.random.default_rng(6).uniform(0.5, 30.0, n).astype(np.float32)
    excl = np.full(n, 0, np.int32)
    with jax.disable_jit():
        want = np_(ji.occluded_scan(jsc, jv(*p.T), jv(*pd.T), jnp.asarray(t_max), jnp.asarray(excl), layout=jl,
                                    origin_idx=jnp.asarray(prev)))
    args = (sc, tv(*p.T), tv(*pd.T), torch.from_numpy(t_max), torch.from_numpy(excl))
    got = ti.occluded_scan(*args, layout=tl, origin_idx=torch.from_numpy(prev))
    assert (got.numpy() == want).mean() >= 0.995 and 0.02 < want.mean() < 0.98
    assert torch.equal(got, ti.occluded_sweep(*args, origin_idx=torch.from_numpy(prev)))


def test_scan_equals_sweep_bitwise_on_rays(field):
    """Inside the port the scan gives the sweep's hit record bit for bit
    (flux_tpu holds its own to the same, tests/test_scan_parity.py): t,
    shape, point, normal, kind and albedo. The exponent differs by design
    only in the two low mantissa bits the sweep clears."""
    _, _, sc, _, tl, (o, d), (p, pd, prev) = field
    for oo, dd, pv in ((o, d, None), (p, pd, torch.from_numpy(prev))):
        a = ti.intersect_scan(sc, tv(*oo.T), tv(*dd.T), layout=tl, prev=pv)
        b = ti.intersect(sc, tv(*oo.T), tv(*dd.T), prev=pv)
        for x, y in zip(a[:3] + a[5:6] + tuple(a.point) + tuple(a.normal) + tuple(a.albedo),
                        b[:3] + b[5:6] + tuple(b.point) + tuple(b.normal) + tuple(b.albedo)):
            assert torch.equal(x, y)
        assert torch.equal(a.exponent.view(torch.int32) & -4, b.exponent.view(torch.int32))
    isect = ti.Intersector(layout=tl, mode="scan")
    assert torch.equal(isect(sc, tv(*o.T), tv(*d.T)).t, a_t := ti.intersect(sc, tv(*o.T), tv(*d.T)).t) and a_t.isfinite().any()
    with pytest.raises(ValueError):
        ti.Intersector(mode="bvh")


@pytest.mark.parametrize("nee, physical", [(False, False), (True, False), (True, True)], ids=["ref", "nee", "mis"])
def test_scan_render_equals_sweep_render_bitwise(nee, physical):
    """sphere_field(24) at 32x16, root 2, depth 3: whole renders through the
    scan and through the sweep are the same bits, stats channel included."""
    sd = genscene.sphere_field(24, seed=2, width=32, height=16, emissive_fraction=0.2)
    sd = dataclasses.replace(sd, output_settings=dataclasses.replace(sd.output_settings, pixel_size=25.0))
    a = Renderer(sd, 2, 3, seed=9, device="cpu", accel="scan", nee=nee, physical=physical)
    b = Renderer(sd, 2, 3, seed=9, device="cpu", accel="sweep", nee=nee, physical=physical)
    assert not a.uses_sweep_kernel and b.uses_sweep_kernel and a.nee == b.nee == nee
    ra = a.render_rows_sum_range(0, 16, 0, 4, with_stats=True)
    rb = b.render_rows_sum_range(0, 16, 0, 4, with_stats=True)
    assert torch.equal(ra.view(torch.int32), rb.view(torch.int32))
    assert ra[..., :3].max() > 0 and torch.isfinite(ra).all()


def _per_sample(r, w, h, root, depth, seed, physical=False):
    """The port's radiance of each sample on its own, (spp, h, w, 3)."""
    return np.stack([
        render_block(r.scene, r.cam, 0, s, seed, img_w=w, img_h=h, n_rows=h, n_samples=1, root=root,
                     max_depth=depth, lights=r.lights, physical=physical, isect=r.isect).numpy()
        for s in range(root * root)
    ])


def _off_the_oracle(port, oracle):
    """Samples off the float64 oracle by more than 1e-3 (relative above 1):
    ROADMAP.md's rule allows 1% of them (paths that an ulp sends elsewhere)."""
    return np.abs(port - oracle).max(-1) > 1e-3 * np.maximum(1.0, np.abs(oracle).max(-1))


def test_golden_sphere_field_through_the_scan():
    """The JAX package's golden of the 96-sphere field (80x60, root 4, depth
    5, seed 42), rendered by the port on the CPU with the scan picked by
    itself, held to tests/test_golden.py's atol of 5e-3 on 99.5% of values,
    and every value that misses it adjudicated by the float64 oracle.

    Not all values hold the atol: among 97 small spheres some samples graze
    one, and there a difference of an ulp (XLA's fused multiply-adds and its
    rsqrt, cos and pow against PyTorch's) sends the path elsewhere; at 16 spp
    one such sample moves a pixel by up to 1/16 of a radiance. The golden
    (a jit-compiled float32 render) misses the oracle's frame in the same
    way, on 31 of 14400 values by up to 0.031; the port misses the golden on
    50 (max 0.11). That these are such flips and no fault of the scan is
    held here sample by sample: the port is off the oracle on at most 0.1%
    of the frame's 76800 samples (25; flux_tpu's own budget is 1%,
    tests/test_scan_parity.py), and every pixel that misses the golden
    either holds one of those samples or agrees with the oracle's frame
    (there the golden's own render flipped)."""
    sd = genscene.sphere_field(96, seed=7, width=80, height=60)
    sd = dataclasses.replace(sd, output_settings=dataclasses.replace(sd.output_settings, pixel_size=10.0))
    r = Renderer(sd, 4, 5, seed=42, device="cpu")
    assert r.accel == "scan" and r.scene.num_spheres == 97 > SCAN_AUTO_THRESHOLD
    # The frame from its 16 samples taken one by one (they are needed below);
    # the Renderer's own bands give the same frame.
    port = _per_sample(r, 80, 60, 4, 5, 42)
    img = finalize(torch.from_numpy(port.sum(0)), root=4).numpy()
    np.testing.assert_allclose(r.render_rows(24, 6), img[24:30], rtol=0, atol=1e-6)
    golden = np.load(os.path.join(HERE, "golden_field96_80x60_r4_s42.npy"))
    assert img.shape == golden.shape
    d = np.abs(img - golden)
    assert (d <= 5e-3).mean() >= 0.995, f"{(d > 5e-3).sum()} of {d.size} values off by more than 5e-3"
    assert d.max() <= 2.0 / 16 and np.isfinite(img).all()
    assert abs(float(img.mean()) - float(golden.mean())) < 1e-3
    oracle = oracle_render(JSceneData.from_dict(sd.to_dict()), 4, 5, seed=42, raw_samples=True)
    bad = _off_the_oracle(port, oracle)
    assert bad.sum() <= 0.001 * bad.size, f"{bad.sum()} of {bad.size} samples off the oracle"
    oracle_img = finalize(torch.from_numpy(oracle.sum(0)).float(), root=4).numpy()
    explained = bad.any(0) | (np.abs(img - oracle_img).max(-1) <= 5e-3)
    missed = d.max(-1) > 5e-3
    assert explained[missed].all(), f"{(~explained[missed]).sum()} pixels off the golden and unexplained"
    assert (np.abs(golden - oracle_img) > 5e-3).sum() >= 10  # the golden's own flips


@pytest.mark.parametrize(
    "name, nee_on, physical",
    [("field96", False, False), ("field96", True, False), ("field96", True, True), ("spheres512", False, False)],
    ids=["field96", "field96-nee", "field96-mis", "spheres512"],
)
def test_per_sample_radiance_through_the_scan_against_the_oracle(name, nee_on, physical):
    """The scan as a whole on the CPU: per-sample radiance of the 96-sphere
    field and of spheres512.yml (513 spheres, 17 blocks), reference
    transport, NEE over their sphere lights and MIS, against the float64
    oracle at 16x12 (spheres512: 12x9), root 2, depth 3: at most 1% of samples
    off by more than 1e-3 (relative above 1), ROADMAP.md's rule."""
    w, h = (16, 12) if name == "field96" else (12, 9)
    sd = genscene.sphere_field(96, seed=7) if name == "field96" else j_load_scene_port(name)
    sd = dataclasses.replace(sd, output_settings=dataclasses.replace(
        sd.output_settings, image_width=w, image_height=h,
        pixel_size=sd.output_settings.pixel_size * sd.output_settings.image_width / w))
    r = Renderer(sd, 2, 3, seed=0, device="cpu", nee=nee_on, physical=physical)
    assert r.accel == "scan" and not r.uses_sweep_kernel and r.nee == nee_on
    port = _per_sample(r, w, h, 2, 3, 0, physical)
    oracle = oracle_render(JSceneData.from_dict(sd.to_dict()), 2, 3, seed=0, nee=nee_on, physical=physical,
                           raw_samples=True)
    assert port.shape == oracle.shape == (4, h, w, 3)
    bad = _off_the_oracle(port, oracle)
    assert int(bad.sum()) <= int(0.01 * bad.size), f"{int(bad.sum())} of {bad.size} samples off"
    assert np.isfinite(port).all() and port.max() > 0.1


def test_renderer_picks_the_scan_above_64_spheres_and_cli_takes_accel(tmp_path):
    """spheres512.yml goes to the scan by itself; --accel overrides; the CLI
    writes the same frame either way on a small field."""
    import yaml

    big = Renderer(j_load_scene_port("spheres512"), 1, 2, device="cpu")
    assert big.accel == "scan" and big.isect.layout.n_blocks == 17 and big.isect.tri_layout is None
    doc = genscene.sphere_field(12, seed=1, width=16, height=12).to_dict()
    doc["output_settings"]["pixel_size"] = 50.0
    path = tmp_path / "f.yml"
    path.write_text(yaml.safe_dump(doc))
    outs = []
    for accel in ("scan", "sweep"):
        out = tmp_path / accel
        ran = cli.run([str(path), "-r", "2", "-d", "3", "--accel", accel, "--device", "cpu", "--output-dir", str(out)])
        outs.append(open(ran["out"], "rb").read())
    assert outs[0] == outs[1] and outs[0].startswith(b"P3\n16 12\n65535\n")
    with pytest.raises(SystemExit):
        cli.run([str(path), "--accel", "bvh", "--device", "cpu"])


@functools.cache
def j_load_scene_port(name):
    from flux_tpu_torch.scene import load_scene

    return load_scene(os.path.join(SCENES, f"{name}.yml"))


def test_packed_sphere_table_and_scan_scene_record():
    """What the CUDA kernel reads: sections on 16-byte bounds, the layout's
    values in place, group boxes that hold their blocks' boxes (NaN boxes
    ignored), 1/r_min beside each box; and the scan's constant record, which
    holds the planes only, their material rows from row 0, exponents as
    authored."""
    r = Renderer(j_load_scene_port("spheres512"), 1, 2, device="cpu")
    L = r.isect.layout
    buf, off = scene_kernel.pack_sphere_table(L)
    n = L.n_blocks * ti.SCAN_BLOCK
    assert buf.dtype == np.float32 and all(o % 4 == 0 for o in off.values())
    geo = buf[off["sph_geo"]: off["sph_geo"] + 4 * n].reshape(n, 4)
    np.testing.assert_array_equal(geo[:, :3], L.host["ctr"].reshape(n, 3))
    np.testing.assert_array_equal(geo[:, 3], L.host["rad"].reshape(n))
    idx = buf[off["sph_idx"]: off["sph_idx"] + n].view(np.int32)
    np.testing.assert_array_equal(idx, L.host["idx"].reshape(n))
    mat = buf[off["sph_mat"]: off["sph_mat"] + 4 * n].reshape(n, 4)
    np.testing.assert_array_equal(mat[:, 2].view(np.int32), L.host["kind"].reshape(n))
    box = buf[off["sph_box"]: off["sph_box"] + 8 * L.n_blocks].reshape(L.n_blocks, 2, 4)
    np.testing.assert_array_equal(box[:, 0, :3], L.host["bmin"])
    real = L.host["idx"] >= 0
    rmin = np.where(real, L.host["rad"], np.inf).min(axis=1)
    np.testing.assert_array_equal(box[:, 0, 3], (np.float32(1.0) / rmin).astype(np.float32))
    ng = -(-L.n_blocks // scene_kernel.SUPER)
    sbox = buf[off["sph_sbox"]: off["sph_sbox"] + 8 * ng].reshape(ng, 2, 4)
    for g in range(ng):
        kids = slice(g * scene_kernel.SUPER, (g + 1) * scene_kernel.SUPER)
        assert (sbox[g, 0, :3] <= L.host["bmin"][kids]).all() and (sbox[g, 1, :3] >= L.host["bmax"][kids]).all()
        assert sbox[g, 0, 3] == box[kids, 0, 3].max()
    lo, hi = scene_kernel.union_boxes(np.float32([[np.nan] * 3, [1, 2, 3]]), np.float32([[np.nan] * 3, [4, 5, 6]]), 2)
    assert lo.tolist() == [[1, 2, 3]] and hi.tolist() == [[4, 5, 6]]
    assert np.isnan(scene_kernel.union_boxes(np.full((3, 3), np.nan, np.float32), np.full((3, 3), np.nan, np.float32))[0]).all()
    rec = pack_scene(r.scene, r.cam, spheres=False)
    assert (rec.n_spheres, rec.n_planes) == (0, 1)
    plane_row = r.scene.num_spheres
    assert rec.kind[0] == int(r.scene.host["mat_kind"][plane_row])
    assert rec.exponent[0] == float(r.scene.host["mat_exp"][plane_row])
    with pytest.raises(ValueError, match="accel='scan'"):
        pack_scene(r.scene, r.cam)
    geom, keep = scene_kernel.pack_geom(r.scene, r.isect, None, "cpu", two_level=False)
    assert geom.scan == 1 and geom.n_sph_blocks == 17 and geom.ns_base == 513 and geom.plane_row0 == 0
    assert geom.sph_sbox is None and geom.sph_box and geom.tri_v0 is None and len(keep) == 1
    assert scene_kernel.config_name("scan", False, True, True, False) == "scan+nee+stats"
