"""The scene megakernel's fused fold, compiled for the CPU with g++: the
scatter ray and a carried shadow ray in one pass over the spheres, the
planes and every triangle slot, against the separate nearest and any-hit
folds, bit for bit.

With NEE and the whole triangle table folded (no triangle skip), the
scene megakernel carries a light sample's shadow ray to the next bounce,
whose fold takes it beside that bounce's ray from the same point
(``SceneGeom<GEO_SWEEP>::nearest_shadow`` in csrc/scene_geom.cuh). The
header compiles as host code against the ``cuda_runtime.h`` stand-in in
csrc/host/ (g++ -O2 -ffp-contract=off, float32 arithmetic op by op as on
the card); a small program loads a scene record packed by
:func:`flux_tpu_torch.ops.sweep_kernel.pack_scene` and the triangle (and
plane) tables packed by :mod:`flux_tpu_torch.ops.scene_kernel`, and for
each ray prints what ``nearest`` followed by ``occluded`` gives (with the
triangle skip off and on), and what the fused fold gives: the hit, its t
bits, its shape, the occluded flag, and the triangle blocks and triangles a
perfect skip needs, of all rays and of the shadow ray (the counters the
operation bound charges), which must be equal.

The scenes: the Cornell box (demo5, triangles only), the same with a ring
of 19 more planes (the plane table; non-unit directions), and demo4
(spheres and a plane in the constant record) with the first 52 of its
triangles, 4 blocks: the fused fold takes tables that fit its
shared-memory stage (``FLUX_TRI_STAGED`` slots). Rays
start on a triangle's surface, a sphere, a plane or off every shape;
shadow rays run toward a point sampled on a triangle light with the shrunk
far end the kernel gives them, toward a point on a triangle's edge
(grazing it), along the plane of the triangle or plane they start on, or in any
direction with the far end exactly at the nearest occluder's t or one
float beyond it. Skips where g++ is missing.
"""

import os
import shutil
import subprocess
from dataclasses import replace

import numpy as np
import pytest

from flux_tpu_torch import genscene
from flux_tpu_torch.camera import camera_tensors
from flux_tpu_torch.ops import scene_kernel
from flux_tpu_torch.ops.intersect import tri_layout
from flux_tpu_torch.ops.nee import extract_lights
from flux_tpu_torch.ops.sweep_kernel import MAX_PLANES, pack_scene
from flux_tpu_torch.scene import TriangleData, compile_scene, load_scene

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "flux_tpu_torch", "csrc")
SCENES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "scenes")
# float32(1 - 1e-4): a triangle light's shadow ray stops this hair short.
TRI_SHADOW_SHRINK = np.float32(1.0 - 1e-4)

# argv[1]: the packed scene record, argv[2]: the packed tables (float32).
# stdin: first "n_tri_blocks tri_block_leaves tri_bin_grid n_planes ns_base
# tri_base plane_row0" and the tables' offsets in floats (tri_v0 tri_e1
# tri_e2 tri_idx tri_n tri_alb tri_tree tri_bin_off tri_cand pl_point
# pl_normal pl_alb; -1: none) and the tables' R_cap; then one ray a
# line, "mode prev exclude" and the bits of o, d, ds and t_max; mode 0 no
# shadow ray, 1 the far end t_max as given, 2 the shadow direction's
# nearest hit, 3 the next float beyond it. Prints per ray, for nearest then
# occluded with the triangle skip off, the same with it on, and the fused
# fold: "hit t shape occ" and the triangle blocks and triangles needed, of
# all rays and of the shadow ray.
PROGRAM = r"""
#include <stdio.h>
#include <vector>
#include "scene_geom.cuh"

typedef Counters<true, FLUX_SCENE_N_COUNTS> Count;

static V3 v3(const unsigned* u) { return V3{__int_as_float((int)u[0]), __int_as_float((int)u[1]), __int_as_float((int)u[2])}; }

static void put(bool hit, const Hit& h, bool occ, const Count& c) {
  printf("%d %u %d %d %u %u %u %u ", (int)hit, hit ? (unsigned)__float_as_int(h.t) : 0u, hit ? h.shape : -1,
         (int)occ, c.c[CNT_TRI_NEEDED], c.c[CNT_SH_TRI_NEEDED], c.c[CNT_TRIS_NEEDED], c.c[CNT_SH_TRIS_NEEDED]);
}

int main(int argc, char** argv) {
  FILE* f = fopen(argv[1], "rb");
  if (f == nullptr || fread(&c_scene, sizeof(FluxScene), 1, f) != 1) return 2;
  fclose(f);
  f = fopen(argv[2], "rb");
  if (f == nullptr) return 2;
  fseek(f, 0, SEEK_END);
  std::vector<float> buf((size_t)ftell(f) / sizeof(float));
  fseek(f, 0, SEEK_SET);
  if (fread(buf.data(), sizeof(float), buf.size(), f) != buf.size()) return 2;
  fclose(f);
  FluxGeom g = {};
  int off[12];
  if (scanf("%d %d %d %d %d %d %d", &g.n_tri_blocks, &g.tri_block_leaves, &g.tri_bin_grid, &g.n_planes, &g.ns_base,
            &g.tri_base, &g.plane_row0) != 7) {
    return 2;
  }
  for (int k = 0; k < 12; ++k) {
    if (scanf("%d", &off[k]) != 1) return 2;
  }
  int rcap;
  if (scanf("%d", &rcap) != 1) return 2;
  g.tri_rcap = (float)rcap;
  auto at = [&](int k) { return off[k] < 0 ? nullptr : (const float4*)(buf.data() + off[k]); };
  g.tri_v0 = at(0), g.tri_e1 = at(1), g.tri_e2 = at(2), g.tri_idx = (const int*)at(3);
  g.tri_n = at(4), g.tri_alb = at(5), g.tri_tree = at(6), g.tri_bin_off = (const int*)at(7), g.tri_cand = at(8);
  g.pl_point = at(9), g.pl_normal = at(10), g.pl_alb = at(11);
  if (g.n_tri_blocks * FLUX_TRI_BLOCK > FLUX_TRI_STAGED) return 3;  // past the stage: not a GEO_SWEEP launch
  const SceneGeom<GEO_SWEEP> geo{&g, shape_rows()};
  geo.stage(0, 1);
  const float inf = __int_as_float(0x7f800000);
  int mode, prev, exclude;
  unsigned w[10];
  while (scanf("%d %d %d %u %u %u %u %u %u %u %u %u %u", &mode, &prev, &exclude, &w[0], &w[1], &w[2], &w[3], &w[4],
               &w[5], &w[6], &w[7], &w[8], &w[9]) == 13) {
    const V3 o = v3(w), d = v3(w + 3), ds = v3(w + 6);
    float a = 1.0f, inv_a = 1.0f, as = 1.0f, inv_as = 1.0f;
    if (!c_scene.unit_d) {
      a = dot3(d, d);
      inv_a = 1.0f / a;
      as = dot3(ds, ds);
      inv_as = 1.0f / as;
    }
    float t_max = __int_as_float((int)w[9]);
    if (mode >= 2) {
      Hit hs;
      Count c0;
      g.tri_skip = 0;
      const float t = geo.nearest(o, ds, as, inv_as, prev, &hs, c0) ? hs.t : inf;
      t_max = mode == 2 ? t : nextafterf(t, inf);
    }
    const bool shadow = mode != 0;
    for (int skip = 0; skip < 2; ++skip) {
      g.tri_skip = skip;
      Hit h;
      Count c;
      const bool hit = geo.nearest(o, d, a, inv_a, prev, &h, c);
      const bool occ = shadow && geo.occluded(o, ds, as, inv_as, t_max, exclude, prev, c);
      put(hit, h, occ, c);
    }
    g.tri_skip = 0;
    Hit h;
    Count c;
    bool occ = false;
    const Shadow sh{ds, t_max, shadow ? exclude : -1};
    const bool hit = geo.nearest_shadow(o, d, a, inv_a, prev, sh, &occ, &h, c);
    put(hit, h, occ, c);
    printf("\n");
  }
  return 0;
}
"""
_OFFSETS = ("tri_v0", "tri_e1", "tri_e2", "tri_idx", "tri_n", "tri_alb", "tri_tree", "tri_bin_off", "tri_cand",
            "pl_point", "pl_normal", "pl_alb")


@pytest.fixture(scope="module")
def program(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    tmp = tmp_path_factory.mktemp("tri_host")
    src = tmp / "tri.cpp"
    src.write_text(PROGRAM)
    exe = tmp / "tri"
    built = subprocess.run([gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-I", os.path.join(CSRC, "host"),
                            "-I", CSRC, "-o", str(exe), str(src)], capture_output=True, text=True, timeout=120)
    assert built.returncode == 0, built.stderr
    return exe, tmp


def _scene(name):
    if name == "demo5 + 19 planes":
        return genscene.plane_ring(load_scene(os.path.join(SCENES, "demo5.yml")), 19)
    sd = load_scene(os.path.join(SCENES, f"{name}.yml"))
    if name == "demo4":
        tris = [s for s in sd.shapes if isinstance(s, TriangleData)]
        sd = replace(sd, shapes=tuple(s for s in sd.shapes if not isinstance(s, TriangleData)) + tuple(tris[:52]))
    return sd


def _unit(v):
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _tri_light_ray(p, v0, e1, e2, rng):
    """The direction and shrunk far end of a shadow ray from p toward a
    uniform point of the triangle (v0, e1, e2), in float32 op by op as the
    kernel's triangle light sample forms them."""
    f = np.float32
    ux, uy = f(rng.random()), f(rng.random())
    flip = ux + uy > f(1.0)
    uu, vv = (f(1.0) - ux, f(1.0) - uy) if flip else (ux, uy)
    q = np.array([v0[i] + uu * e1[i] + vv * e2[i] for i in range(3)], np.float32)
    dv = (q - p).astype(np.float32)
    r2 = max(dv[0] * dv[0] + dv[1] * dv[1] + dv[2] * dv[2], f(1e-12))
    r = np.sqrt(f(r2))
    ds = (dv * (f(1.0) / r)).astype(np.float32)
    return ds, f(r * TRI_SHADOW_SHRINK)


def _rays(sc, lights, rng, n):
    """Rays from points on the scene's shapes (on prev) or off them, each
    with a shadow ray of one of the modes (see PROGRAM)."""
    h, lh = sc.host, lights.host
    ns, npl, nt = sc.num_spheres, sc.num_planes, sc.num_triangles
    tri_base = ns + npl
    v0, e1, e2 = (h[k].astype(np.float32) for k in ("tri_v0", "tri_e1", "tri_e2"))
    # The triangle lights' shape indices; where there are none (demo4's
    # lights are spheres), the scene's triangles stand in for them.
    targets = [int(lh["shape_idx"][k]) for k in range(lights.num_lights) if lights.has_tris and lh["is_tri"][k] > 0.5]
    targets = targets or list(range(tri_base, tri_base + nt))
    lo, hi = (v0.min(axis=0), v0.max(axis=0))
    lines = []
    for j in range(n):
        kind = j % 5
        prev = -1
        if kind <= 2 or (kind == 3 and ns + npl == 0):  # on a triangle's surface
            t = int(rng.integers(0, nt))
            prev = tri_base + t
            u, v = rng.random(2)
            if u + v > 1:
                u, v = 1 - u, 1 - v
            o = (v0[t] + np.float32(u) * e1[t] + np.float32(v) * e2[t]).astype(np.float32)
        elif kind == 3 and ns > 0 and rng.random() < 0.5:  # on a sphere
            s = int(rng.integers(0, ns))
            prev = s
            o = (h["sphere_center"][s] + _unit(rng.normal(size=3)) * h["sphere_radius"][s]).astype(np.float32)
        elif kind == 3:  # on a plane
            pj = int(rng.integers(0, npl))
            prev = ns + pj
            pn = _unit(h["plane_normal"][pj].astype(np.float64))
            tan = np.cross(pn, _unit(rng.normal(size=3)))
            # A hit point's rounding leaves it a hair off the plane.
            o = (h["plane_point"][pj] + tan * rng.uniform(0.0, 3.0) + pn * rng.normal() * 1e-6).astype(np.float32)
        else:  # off every shape, inside the scene's extent
            o = (lo + (hi - lo) * rng.random(3)).astype(np.float32)
        d = _unit(rng.normal(size=3))
        light = targets[int(rng.integers(0, len(targets)))]
        exclude = light if j % 7 else int(rng.integers(0, ns + npl + nt))
        mode = (1, 1, 0, 2, 3)[j % 5] if j % 3 else int(rng.integers(0, 4))
        lt = light - tri_base
        ds, t_max = _tri_light_ray(o, v0[lt], e1[lt], e2[lt], rng)
        if j % 11 == 0:  # toward a point on a triangle's edge: grazing it
            t = int(rng.integers(0, nt))
            edge = (v0[t] + np.float32(rng.random()) * (e1[t] if j % 2 else e2[t])).astype(np.float32)
            ds = _unit(edge.astype(np.float64) - o)
        elif (j % 13 == 0 and prev >= tri_base) or (j % 2 and 0 <= prev - ns < npl):
            # Along the plane of its own triangle or plane, a hair off it:
            # only the origin's exclusion keeps that shape from stopping it.
            own = h["tri_n"][prev - tri_base] if prev >= tri_base else h["plane_normal"][prev - ns]
            nrm = _unit(own.astype(np.float64))
            ds = _unit(np.cross(nrm, _unit(rng.normal(size=3))) + nrm * rng.choice([-1e-4, 1e-4]))
        elif mode != 1 and j % 2:
            ds = _unit(rng.normal(size=3))
        if not sc.unit_d:  # the a = d·d quadratic, on directions of other lengths
            d = (d * np.float32(rng.uniform(0.8, 1.25))).astype(np.float32)
        bits = np.concatenate([o, d, ds, [t_max]]).astype(np.float32).view(np.uint32)
        lines.append(" ".join(map(str, (mode, prev, exclude, *bits.tolist()))))
    return lines


@pytest.mark.parametrize("name", ["demo5", "demo5 + 19 planes", "demo4"])
def test_fused_fold_matches_nearest_then_any_hit(program, name):
    exe, tmp = program
    sd = _scene(name)
    sc = compile_scene(sd, "cpu")
    lights = extract_lights(sd, "cpu")
    layout = tri_layout(sc)
    table_planes = sc.num_planes > MAX_PLANES
    rec = pack_scene(sc, camera_tensors(sd.camera_settings, sd.camera_data, sd.output_settings.pixel_size, "cpu"),
                     spheres=True, planes=not table_planes)
    tri_buf, tri_off = scene_kernel.pack_tri_table(layout)
    bufs, offsets = [tri_buf], dict(tri_off)
    if table_planes:
        pl_buf, pl_off = scene_kernel.pack_plane_table(sc, sweep=True)
        offsets.update({k: v + tri_buf.size for k, v in pl_off.items()})
        bufs.append(pl_buf)
    tag = name.replace(" ", "_").replace("+", "p")
    (tmp / f"{tag}.rec").write_bytes(bytes(rec))
    (tmp / f"{tag}.tab").write_bytes(np.concatenate(bufs).astype(np.float32).tobytes())
    ns, npl = sc.num_spheres, sc.num_planes
    leaves = 1 << max(layout.n_blocks - 1, 0).bit_length()
    _, _, grid, rcap = scene_kernel.tri_bins(layout)
    head = [layout.n_blocks, leaves, grid, npl, ns, ns + npl, ns] + [offsets.get(k, -1) for k in _OFFSETS] + [rcap]
    lines = _rays(sc, lights, np.random.default_rng(11), 1500)
    out = subprocess.run([str(exe), str(tmp / f"{tag}.rec"), str(tmp / f"{tag}.tab")],
                         input=" ".join(map(str, head)) + "\n" + "\n".join(lines) + "\n", check=True,
                         capture_output=True, text=True, timeout=60).stdout
    got = np.array([list(map(int, ln.split())) for ln in out.splitlines()], np.int64)
    assert got.shape == (len(lines), 24)
    separate, skipped, fused = got[:, 0:8], got[:, 8:16], got[:, 16:24]
    # hit, t bits, shape, the occluded flag and what a perfect skip needs,
    # which does not depend on the walk.
    np.testing.assert_array_equal(fused, separate)
    np.testing.assert_array_equal(fused, skipped)
    modes = np.array([int(ln.split()[0]) for ln in lines])
    hit, shape, occ = fused[:, 0].astype(bool), fused[:, 2], fused[:, 3].astype(bool)
    # The cases are all there: hits and misses, triangle hits, occluded
    # shadow rays and clear ones, an occluder exactly at the far end (clear)
    # and one float before it (occluded), and no shadow ray without its flag.
    # (demo4's 52 triangles are a small part of its scene.)
    assert 0.5 < hit.mean() <= 1.0 and (shape >= ns + npl).mean() > (0.1 if name == "demo4" else 0.3)
    assert not occ[modes == 0].any()
    assert occ[modes == 1].any() and not occ[modes == 1].all()
    assert occ[modes == 3].sum() > occ[modes == 2].sum()
    # A shadow ray a triangle stopped needs that triangle; one that came
    # through, the blocks it enters; the table's padding is never needed.
    sh_blocks, sh_tris = fused[:, 5], fused[:, 7]
    assert (sh_blocks[modes == 0] == 0).all() and (sh_tris <= sh_blocks * 16).all()
    real = int((layout.host["idx"] >= 0).sum())
    assert (fused[:, 6] - sh_tris <= real).all() and (sh_tris <= real).all() and (sh_tris > 0).any()
