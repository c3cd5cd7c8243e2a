"""The scene megakernel's triangle walk with its skip, compiled for the CPU
with g++: ray by ray, the skip gives what the fold over every block gives.

With the skip on, ``SceneGeom<GEO_TABLE>`` (csrc/scene_geom.cuh) walks the
binary tree over the triangle blocks front to back (``walk_triangles``),
with boxes widened for Möller–Trumbore's own float32 error, and folds apart
the triangles a ray runs nearly parallel to, found by the ray's direction
(``scene_kernel.tri_bins``). The header compiles as host code against the
``cuda_runtime.h`` stand-in in csrc/host/ (g++ -O2 -ffp-contract=off,
float32 arithmetic op by op as on the card). A small program loads a scene
record packed by :func:`flux_tpu_torch.ops.sweep_kernel.pack_scene` and the
triangle, plane and light tables packed by
:mod:`flux_tpu_torch.ops.scene_kernel`, and

* for each ray prints the nearest hit (hit, t bits, shape), the any-hit flag
  of its shadow ray and the triangle blocks and triangles a perfect skip
  needs (the counters the operation bound charges), with the skip off and
  on, which must be equal;
* traces whole paths of a band of pixels as the kernel does (sampler rows,
  camera, bounces, NEE), its geometry answering each call as the fold over
  every block does and counting the calls where the skip would not.

The rays: from a point on a triangle's edge along the plane of the
triangle beside it (tilted out of it by 0 to 1e-3), along the line of
their common edge, from afar in a triangle's plane along it (where a hit
can be taken anywhere on the line), from outside toward a point of a
triangle's plane, and shadow rays toward a point on a triangle's edge with
the far end at the occluder's t and one float beyond.
The paths: the band of the Cornell box where the skip of the parent commit
took a hit a triangle's plane gave (demo5, rows 256-257, 8 spp, seed 5,
NEE, with reference transport and with MIS). Skips where g++ is missing.
"""

import os
import shutil
import subprocess

import numpy as np
import pytest

from flux_tpu_torch import meshgen
from flux_tpu_torch.camera import camera_tensors
from flux_tpu_torch.ops import scene_kernel
from flux_tpu_torch.ops.intersect import tri_layout
from flux_tpu_torch.ops.nee import extract_lights
from flux_tpu_torch.ops.sweep_kernel import MAX_PLANES, pack_scene
from flux_tpu_torch.scene import compile_scene, load_scene

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "flux_tpu_torch", "csrc")
SCENES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "scenes")

# argv[1]: the packed scene record, argv[2]: the packed tables (float32).
# stdin: first "n_tri_blocks tri_block_leaves tri_bin_grid n_planes ns_base
# tri_base plane_row0 n_lights lights_have_tris", the tables' R_cap and
# their offsets in floats (_OFFSETS; -1: none); then commands, one a line:
#   R mode prev exclude and the bits of o, d, ds and t_max: a ray, and a
#     shadow ray along ds (mode 0 none, 1 the far end t_max as given, 2 the
#     shadow direction's nearest hit, 3 the next float beyond it); prints,
#     with the skip off then on, "hit t shape occ" and the triangle blocks
#     and triangles needed (nearest; shadow), then the skip's box tests,
#     leaves folded, list entries read and triangles folded apart;
#   P row0 n_rows img_w img_h n_samples seed root max_depth nee physical:
#     the band's paths; prints the nearest and shadow calls, the calls where
#     the skip disagrees with the fold over every block, and the bounces.
PROGRAM = r"""
#include <stdio.h>
#include <vector>
#include "scene_geom.cuh"

typedef Counters<true, FLUX_SCENE_N_COUNTS> Count;

static FluxGeom g = {};

static V3 v3(const unsigned* u) { return V3{__int_as_float((int)u[0]), __int_as_float((int)u[1]), __int_as_float((int)u[2])}; }

static bool same_needed(const Count& a, const Count& b) {
  return a.c[CNT_TRI_NEEDED] == b.c[CNT_TRI_NEEDED] && a.c[CNT_SH_TRI_NEEDED] == b.c[CNT_SH_TRI_NEEDED] &&
         a.c[CNT_TRIS_NEEDED] == b.c[CNT_TRIS_NEEDED] && a.c[CNT_SH_TRIS_NEEDED] == b.c[CNT_SH_TRIS_NEEDED];
}

// Answers every call as the fold over every block does, and counts the calls
// where the skip gives another hit, flag or count.
struct Both : SceneGeom<GEO_TABLE> {
  mutable long n_near = 0, n_occ = 0, bad = 0;
  template <class C>
  bool nearest(V3 o, V3 d, float a, float inv_a, int prev, Hit* h, C&) const {
    Count c0, c1;
    Hit h1;
    g.tri_skip = 0;
    const bool hit = SceneGeom<GEO_TABLE>::nearest(o, d, a, inv_a, prev, h, c0);
    g.tri_skip = 1;
    const bool hit1 = SceneGeom<GEO_TABLE>::nearest(o, d, a, inv_a, prev, &h1, c1);
    n_near += 1;
    if (hit != hit1 || (hit && (__float_as_int(h->t) != __float_as_int(h1.t) || h->shape != h1.shape)) ||
        !same_needed(c0, c1)) {
      bad += 1;
    }
    return hit;
  }
  template <class C>
  bool occluded(V3 o, V3 d, float a, float inv_a, float t_max, int exclude, int origin, C&) const {
    Count c0, c1;
    g.tri_skip = 0;
    const bool occ = SceneGeom<GEO_TABLE>::occluded(o, d, a, inv_a, t_max, exclude, origin, c0);
    g.tri_skip = 1;
    const bool occ1 = SceneGeom<GEO_TABLE>::occluded(o, d, a, inv_a, t_max, exclude, origin, c1);
    n_occ += 1;
    if (occ != occ1 || !same_needed(c0, c1)) bad += 1;
    return occ;
  }
};

template <bool NEE, bool PHYSICAL>
static void paths(const Both& geo, int row0, int n_rows, int img_w, int img_h, unsigned n_samples, unsigned seed,
                  unsigned root, int max_depth) {
  std::vector<uint32_t> row(row_words(NEE, max_depth));
  Counters<true, FLUX_SCENE_N_COUNTS> cnt;
  for (int y = row0; y < row0 + n_rows; ++y) {
    for (int col = 0; col < img_w; ++col) {
      const uint32_t base = hash3(seed, (uint32_t)y, (uint32_t)col);
      const int used = ROW_DEPTH0 + row_per_depth(NEE) * max_depth;
      for (int w = 0; w < used; ++w) row[w] = sampler_word<NEE>(base, w);
      for (unsigned s = 0; s < n_samples; ++s) {
        Path ph;
        start_path(ph, row.data(), s, root, y, col, img_w, img_h);
        while (!(ph.depth > max_depth || bounce<NEE, PHYSICAL>(geo, ph, row.data(), root, max_depth, cnt))) {
        }
      }
    }
  }
  printf("%ld %ld %ld %u\n", geo.n_near, geo.n_occ, geo.bad, cnt.c[0]);
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
  if (scanf("%d %d %d %d %d %d %d %d %d", &g.n_tri_blocks, &g.tri_block_leaves, &g.tri_bin_grid, &g.n_planes,
            &g.ns_base, &g.tri_base, &g.plane_row0, &g.n_lights, &g.lights_have_tris) != 9) {
    return 2;
  }
  int rcap;
  if (scanf("%d", &rcap) != 1) return 2;
  g.tri_rcap = (float)rcap;
  int off[23];
  for (int k = 0; k < 23; ++k) {
    if (scanf("%d", &off[k]) != 1) return 2;
  }
  auto at = [&](int k) { return off[k] < 0 ? nullptr : (const float4*)(buf.data() + off[k]); };
  auto ints = [&](int k) { return (const int*)at(k); };
  auto flts = [&](int k) { return (const float*)at(k); };
  g.tri_v0 = at(0), g.tri_e1 = at(1), g.tri_e2 = at(2), g.tri_idx = ints(3), g.tri_n = at(4), g.tri_alb = at(5);
  g.tri_tree = at(6), g.tri_bin_off = ints(7), g.tri_cand = at(8);
  g.pl_point = at(9), g.pl_normal = at(10), g.pl_alb = at(11);
  g.l_center = at(12), g.l_emit = at(13), g.l_pick = flts(14), g.l_cdf = flts(15), g.l_shape = ints(16);
  g.l_is_tri = ints(17), g.l_v0 = at(18), g.l_e1 = at(19), g.l_e2 = at(20), g.l_n = at(21), g.light_of = ints(22);
  Both geo;
  geo.P = &g;
  geo.rows = shape_rows();
  geo.stage(0, 1);
  const float inf = __int_as_float(0x7f800000);
  char cmd[2];
  while (scanf("%1s", cmd) == 1) {
    if (cmd[0] == 'P') {
      int row0, n_rows, img_w, img_h, max_depth, nee, physical;
      unsigned n_samples, seed, root;
      if (scanf("%d %d %d %d %u %u %u %d %d %d", &row0, &n_rows, &img_w, &img_h, &n_samples, &seed, &root,
                &max_depth, &nee, &physical) != 10) {
        return 2;
      }
      if (nee) {
        if (physical) paths<true, true>(geo, row0, n_rows, img_w, img_h, n_samples, seed, root, max_depth);
        else paths<true, false>(geo, row0, n_rows, img_w, img_h, n_samples, seed, root, max_depth);
      } else {
        if (physical) paths<false, true>(geo, row0, n_rows, img_w, img_h, n_samples, seed, root, max_depth);
        else paths<false, false>(geo, row0, n_rows, img_w, img_h, n_samples, seed, root, max_depth);
      }
      continue;
    }
    int mode, prev, exclude;
    unsigned w[10];
    if (scanf("%d %d %d %u %u %u %u %u %u %u %u %u %u", &mode, &prev, &exclude, &w[0], &w[1], &w[2], &w[3], &w[4],
              &w[5], &w[6], &w[7], &w[8], &w[9]) != 13) {
      return 2;
    }
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
      const float t = geo.SceneGeom<GEO_TABLE>::nearest(o, ds, as, inv_as, prev, &hs, c0) ? hs.t : inf;
      t_max = mode == 2 ? t : nextafterf(t, inf);
    }
    for (int skip = 0; skip < 2; ++skip) {
      g.tri_skip = skip;
      Hit h;
      Count c;
      const bool hit = geo.SceneGeom<GEO_TABLE>::nearest(o, d, a, inv_a, prev, &h, c);
      const bool occ = mode != 0 && geo.SceneGeom<GEO_TABLE>::occluded(o, ds, as, inv_as, t_max, exclude, prev, c);
      printf("%d %u %d %d %u %u %u %u ", (int)hit, hit ? (unsigned)__float_as_int(h.t) : 0u, hit ? h.shape : -1,
             (int)occ, c.c[CNT_TRI_NEEDED], c.c[CNT_SH_TRI_NEEDED], c.c[CNT_TRIS_NEEDED], c.c[CNT_SH_TRIS_NEEDED]);
      if (skip == 1) {
        printf("%u %u %u %u\n", c.c[CNT_TRI_TESTS], c.c[CNT_TRI_ENTERED], c.c[CNT_TRI_CANDS], c.c[CNT_TRI_EXC]);
      }
    }
  }
  return 0;
}
"""
_OFFSETS = ("tri_v0", "tri_e1", "tri_e2", "tri_idx", "tri_n", "tri_alb", "tri_tree", "tri_bin_off", "tri_cand",
            "pl_point", "pl_normal", "pl_alb", "l_center", "l_emit", "l_pick", "l_cdf", "l_shape", "l_is_tri",
            "l_v0", "l_e1", "l_e2", "l_n", "light_of")


@pytest.fixture(scope="module")
def program(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    tmp = tmp_path_factory.mktemp("tri_walk_host")
    src = tmp / "walk.cpp"
    src.write_text(PROGRAM)
    exe = tmp / "walk"
    built = subprocess.run([gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-I", os.path.join(CSRC, "host"),
                            "-I", CSRC, "-o", str(exe), str(src)], capture_output=True, text=True, timeout=120)
    assert built.returncode == 0, built.stderr
    return exe, tmp


def _scene(name):
    if name == "mesh1280":
        return meshgen.mesh_scene(*meshgen.icosphere(3), name="mesh1280")
    return load_scene(os.path.join(SCENES, f"{name}.yml"))


_PACKED = {}


def _run(program, name, commands):
    """Packs the scene's record and tables (once a scene), runs the program
    on the commands; its output lines as int arrays, and the compiled scene
    and triangle layout."""
    exe, tmp = program
    if name not in _PACKED:
        _PACKED[name] = _pack(tmp, name)
    head, sc, layout = _PACKED[name]
    out = subprocess.run([str(exe), str(tmp / f"{name}.rec"), str(tmp / f"{name}.tab")],
                         input=" ".join(map(str, head)) + "\n" + "\n".join(commands) + "\n", check=True,
                         capture_output=True, text=True, timeout=60).stdout
    return [np.array(list(map(int, ln.split())), np.int64) for ln in out.splitlines()], sc, layout


def _pack(tmp, name):
    sd = _scene(name)
    sc = compile_scene(sd, "cpu")
    layout = tri_layout(sc)
    lights = extract_lights(sd, "cpu")
    table_planes = sc.num_planes > MAX_PLANES
    cam = camera_tensors(sd.camera_settings, sd.camera_data, sd.output_settings.pixel_size, "cpu")
    rec = pack_scene(sc, cam, spheres=True, planes=not table_planes)
    ns, npl, nt = sc.num_spheres, sc.num_planes, sc.num_triangles
    parts = [scene_kernel.pack_tri_table(layout), scene_kernel.pack_light_table(lights, ns + npl + nt)]
    if table_planes:
        parts.append(scene_kernel.pack_plane_table(sc, sweep=True))
    bufs, offsets, at = [], {}, 0
    for buf, off in parts:
        offsets.update({k: v + at for k, v in off.items()})
        bufs.append(buf)
        at += buf.size
    (tmp / f"{name}.rec").write_bytes(bytes(rec))
    (tmp / f"{name}.tab").write_bytes(np.concatenate(bufs).astype(np.float32).tobytes())
    leaves = 1 << max(layout.n_blocks - 1, 0).bit_length()
    _, _, grid, rcap = scene_kernel.tri_bins(layout)
    head = ([layout.n_blocks, leaves, grid, npl, ns, ns + npl, ns, lights.num_lights, int(lights.has_tris), rcap]
            + [offsets.get(k, -1) for k in _OFFSETS])
    return head, sc, layout


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _triangles(sc):
    """Float64 vertices (nt, 3, 3) and unit normals of the scene's
    triangles as the kernel holds them (float32 v0, e1, e2)."""
    h = sc.host
    v0, e1, e2 = (h[k].astype(np.float32).astype(np.float64) for k in ("tri_v0", "tri_e1", "tri_e2"))
    return np.stack([v0, v0 + e1, v0 + e2], axis=1), _unit(np.cross(e1, e2))


def _neighbours(verts, nrm):
    """Pairs (a, b, p, q) of triangles a != b and the ends p, q of an edge
    of b that a shares or whose line lies in a's plane: edges two triangles
    share, and edges of a coplanar triangle."""
    key = lambda p: tuple(np.round(p, 4))
    owner = {}
    for t, tri in enumerate(verts):
        for k in range(3):
            p, q = tri[k], tri[(k + 1) % 3]
            owner.setdefault(frozenset((key(p), key(q))), []).append((t, p, q))
    pairs = []
    for edge in owner.values():
        for a, _, _ in edge:
            pairs += [(a, b, p, q) for b, p, q in edge if b != a]
    offset = np.einsum("ij,ij->i", nrm, verts[:, 0])
    for a in range(len(verts)):
        same = np.flatnonzero((np.abs(np.abs(nrm @ nrm[a]) - 1) < 1e-6)
                              & (np.abs(np.abs(offset) - abs(offset[a])) < 1e-4))
        for b in same[same != a][:3]:
            pairs.append((a, int(b), verts[b][0], verts[b][1]))
    return pairs


def _rays(sc, rng, n):
    """Command lines of rays in and near the planes of triangles beside the
    triangle they start on, along shared edges, from the camera, with
    grazing shadow rays (see the module's docstring)."""
    verts, nrm = _triangles(sc)
    tri_base = sc.num_spheres + sc.num_planes
    pairs = _neighbours(verts, nrm)
    assert pairs
    lines = []
    for j in range(n):
        a, b, p, q = pairs[int(rng.integers(0, len(pairs)))]
        kind = j % 5
        on = p + (q - p) * rng.random()  # on b's edge
        prev = tri_base + b if j % 3 else -1
        if kind == 4:  # in a's plane, away from a, along it: its line need not cross a's box
            on = verts[a][0] + _unit(np.cross(nrm[a], rng.normal(size=3))) * rng.uniform(0.5, 4.0)
            d = _unit(np.cross(nrm[a], _unit(rng.normal(size=3)))) + nrm[a] * rng.choice([0.0, 1e-7, -1e-7])
            prev = -1
        elif kind == 0:  # along a's plane, tilted out of it by 0 .. 1e-3
            tilt = (0.0, 1e-7, -1e-7, 1e-6, -1e-5, 1e-4, -1e-3)[int(rng.integers(0, 7))]
            d = _unit(np.cross(nrm[a], _unit(rng.normal(size=3)))) + nrm[a] * tilt
        elif kind == 1:  # along the edge's line, either way
            d = (q - p) * rng.choice([-1.0, 1.0])
        elif kind == 2:  # toward a point of a, just past its edge
            d = verts[a].mean(axis=0) - on + nrm[a] * rng.normal() * 1e-4
        else:  # from outside, at a point of a's plane beyond the triangle
            far = verts[a][0] + _unit(np.cross(nrm[a], rng.normal(size=3))) * rng.uniform(0.0, 4.0)
            on = far + _unit(rng.normal(size=3)) * rng.uniform(0.5, 6.0)
            d = far - on
            prev = -1
        o = on.astype(np.float32)
        d = _unit(d).astype(np.float32)
        occluder = int(rng.integers(0, len(verts)))
        edge = verts[occluder][int(rng.integers(0, 3))] + (verts[occluder][int(rng.integers(0, 3))] -
                                                          verts[occluder][0]) * rng.random()
        ds = _unit(edge - o).astype(np.float32) if j % 2 else d
        mode = (1, 2, 3, 0)[j % 4] if j % 5 else int(rng.integers(0, 4))
        t_max = np.float32(np.linalg.norm(edge - o) * (1.0 - 1e-4))
        exclude = tri_base + occluder if j % 7 else -1
        bits = np.concatenate([o, d, ds, [t_max]]).astype(np.float32).view(np.uint32)
        lines.append("R " + " ".join(map(str, (mode, prev, exclude, *bits.tolist()))))
    return lines


@pytest.mark.parametrize("name, n_rays", [("mesh1280", 600), ("mesh_ico", 400), ("demo4", 400), ("demo5", 400)])
def test_tree_walk_equals_the_fold_over_every_block(program, name, n_rays):
    _, sc, _ = _PACKED.get(name) or (None, compile_scene(_scene(name), "cpu"), None)
    lines = _rays(sc, np.random.default_rng(8), n_rays)
    got, sc, layout = _run(program, name, lines)
    got = np.stack(got)
    assert got.shape == (n_rays, 20)
    whole, skip, work = got[:, 0:8], got[:, 8:16], got[:, 16:20]
    # hit, t bits, shape, the occluded flag, and what a perfect skip needs.
    np.testing.assert_array_equal(skip, whole)
    hit, shape, occ = whole[:, 0].astype(bool), whole[:, 2], whole[:, 3].astype(bool)
    tri_base = sc.num_spheres + sc.num_planes
    # The cases are there: triangle hits, occluded shadow rays and clear ones;
    # and the skip both left leaves out and folded triangles apart.
    assert (shape >= tri_base).mean() > 0.2 and 0.05 < occ.mean() < 0.95 and hit.mean() > 0.5
    tests, entered, cands, exc = work.T
    assert exc.sum() > 0 and cands.sum() >= exc.sum()
    if scene_kernel.tri_skip_engaged(layout.n_blocks):  # (in the closed room every ray enters every box)
        assert (entered < 2 * layout.n_blocks).mean() > 0.5


@pytest.mark.parametrize("name, band", [
    # The Cornell box with NEE where the parent commit's skip took a hit of a
    # triangle's plane (its card test: rows 256-257, 8 spp, seed 5, root 2).
    ("demo5", (256, 2, 8, 5, 2, 1, 0)),
    ("demo5", (256, 2, 8, 5, 2, 1, 1)),
])
def test_paths_take_the_whole_folds_hits(program, name, band):
    row0, n_rows, n_samples, seed, root, nee, physical = band
    sd = _scene(name)
    w, h = sd.output_settings.image_width, sd.output_settings.image_height
    cmd = f"P {row0} {n_rows} {w} {h} {n_samples} {seed} {root} 5 {nee} {physical}"
    got, _, _ = _run(program, name, [cmd])
    n_near, n_occ, bad, bounces = got[0]
    assert n_near == bounces and n_near > n_rows * w * n_samples and (n_occ > 0) == bool(nee)
    assert bad == 0
