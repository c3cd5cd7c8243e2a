"""The scan's walk over the tree of sphere blocks, compiled for the CPU with
g++: ray by ray, the tree walk gives what the fold over every block gives.

csrc/scan_walk.cuh holds the scene megakernel's sphere walk (K5): the slab
test widened by the sphere test's own error (``box_enter``), the tree walked
front to back (``walk_tree``), the one-level walk, and the nearest and
any-hit sphere folds. The header compiles as host code against the
``cuda_runtime.h`` stand-in in csrc/host/ (g++ -O2 -ffp-contract=off,
float32 arithmetic op by op as on the card). A small program loads a table
packed by :func:`flux_tpu_torch.ops.scene_kernel.pack_sphere_table` and, for
each ray, prints the nearest sphere (t bits, original index, table slot) and
the any-hit flag from the fold over every block, from one level of block
boxes and from the tree, which must be equal. The rays start at the camera,
on the spheres and beside them, graze spheres along their tangents, and
have directions whose length has drifted from 1 (the quadratic still takes
a = 1), some past the point where the walk stops skipping. Skips where g++
is missing. A numpy check holds the packed tree to its definition.
"""

import os
import shutil
import subprocess

import numpy as np
import pytest

from flux_tpu_torch.genscene import sphere_field
from flux_tpu_torch.ops.intersect import scan_layout
from flux_tpu_torch.ops.scene_kernel import SCAN_LEAF, pack_sphere_table, sphere_tree
from flux_tpu_torch.scene import compile_scene

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "flux_tpu_torch", "csrc")

# argv: the packed table, the offsets (in floats) of sph_geo, sph_idx,
# sph_box and sph_tree, the block and leaf counts, unit_d. stdin: one ray a
# line, "prev exclude" and the bits of t_max, o and d. Prints per ray, for
# the fold over every block, one level of boxes and the tree: the nearest
# hit's t bits, index and slot and the any-hit flag; then the spheres the
# one-level walk and the tree tested for the any-hit, and the box tests of
# the walk with the tree.
PROGRAM = r"""
#include <stdio.h>
#include <stdlib.h>
#include <vector>
#include "scan_walk.cuh"

static V3 v3(const unsigned* u) { return V3{__int_as_float((int)u[0]), __int_as_float((int)u[1]), __int_as_float((int)u[2])}; }

int main(int argc, char** argv) {
  if (argc != 9) return 2;
  FILE* f = fopen(argv[1], "rb");
  std::vector<float> buf;
  float x;
  while (fread(&x, sizeof x, 1, f) == 1) buf.push_back(x);
  fclose(f);
  const float* base = buf.data();
  SphereTable T{(const float4*)(base + atoi(argv[2])), (const int*)(base + atoi(argv[3])),
                (const float4*)(base + atoi(argv[4])), (const float4*)(base + atoi(argv[5])), atoi(argv[6]),
                atoi(argv[7]), 0};
  c_scene.unit_d = atoi(argv[8]);
  int prev, exclude;
  unsigned w[7];
  while (scanf("%d %d %u %u %u %u %u %u %u", &prev, &exclude, &w[0], &w[1], &w[2], &w[3], &w[4], &w[5], &w[6]) == 9) {
    const float t_max = __int_as_float((int)w[0]);
    const V3 o = v3(w + 1), d = v3(w + 4);
    float a = 1.0f, inv_a = 1.0f;
    if (!c_scene.unit_d) {
      a = dot3(d, d);
      inv_a = 1.0f / a;
    }
    const V3 inv_d = V3{1.0f / d.x, 1.0f / d.y, 1.0f / d.z};
    const RaySlack rs = ray_slack(d);
    unsigned tested[3];
    for (int walk = 0; walk < 3; ++walk) {
      T.walk = walk;
      Counters<true, FLUX_SCENE_N_COUNTS> cnt;
      float t = __int_as_float(0x7f800000);
      int i = 0, slot = -1;
      scan_nearest(T, o, d, a, inv_a, inv_d, rs, prev, t, i, slot, cnt);
      const bool occ = scan_occluded(T, o, d, a, inv_a, inv_d, rs, t_max, exclude, prev, cnt);
      tested[walk] = cnt.c[CNT_SH_SPH_SPHERES];
      printf("%u %d %d %d ", (unsigned)__float_as_int(t), i, slot, (int)occ);
      if (walk == 2) printf("%u %u %u\n", tested[1], tested[2], cnt.c[CNT_SPH_TESTS] + cnt.c[CNT_SH_SPH_TESTS]);
    }
  }
  return 0;
}
"""


def _unit(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _rays(sc, rng: np.random.Generator, n: int):
    """(prev, exclude, t_max, o, d) of ``n`` rays: a quarter each from the
    camera's side of the field, from points on a sphere (prev set), from
    points near a sphere, and along the tangent of a sphere from a point
    outside it; a fifth of the directions drifted in length by up to 2^-11,
    and every 16th by 2^-9 (past the walk's drift limit). t_max: a
    sphere's center distance, or infinity with no exclusion."""
    c = sc.host["sphere_center"].astype(np.float64)
    r = sc.host["sphere_radius"].astype(np.float64)
    ns = len(r)
    lo, hi = c.min(0), c.max(0)
    kind = np.arange(n) % 4
    k = rng.integers(0, ns, n)
    o = np.empty((n, 3))
    d = _unit(rng.normal(size=(n, 3)))
    prev = np.full(n, -1)
    cam = kind == 0
    o[cam] = (lo + hi) / 2 + np.array([0.0, 0.0, -1.0]) * (hi - lo).max() + rng.normal(size=(cam.sum(), 3))
    d[cam] = _unit((lo + (hi - lo) * rng.uniform(size=(cam.sum(), 3))) - o[cam])
    on = kind == 1
    o[on] = c[k[on]] + _unit(rng.normal(size=(on.sum(), 3))) * r[k[on], None]
    prev[on] = k[on]
    near = kind == 2
    away = rng.uniform(1.0, 3.0, (near.sum(), 1))
    o[near] = c[k[near]] + _unit(rng.normal(size=(near.sum(), 3))) * r[k[near], None] * away
    tan = kind == 3
    m = tan.sum()
    o[tan] = c[k[tan]] + _unit(rng.normal(size=(m, 3))) * r[k[tan], None] * rng.uniform(1.5, 20.0, (m, 1))
    to_c = c[k[tan]] - o[tan]
    dist = np.linalg.norm(to_c, axis=1, keepdims=True)
    w = to_c / dist
    axis = _unit(np.cross(w, rng.normal(size=(m, 3))))
    ang = np.arcsin(r[k[tan], None] / dist) * (1.0 + rng.uniform(-1e-6, 1e-6, (m, 1)))
    d[tan] = w * np.cos(ang) + np.cross(axis, w) * np.sin(ang)
    scale = np.ones(n)
    drift = rng.uniform(size=n) < 0.2
    scale[drift] = 1.0 + rng.uniform(-1.0, 1.0, drift.sum()) * 2.0 ** -11
    scale[::16] = 1.0 + 2.0 ** -9
    d = d * scale[:, None]
    light = rng.integers(0, ns, n)
    t_max = np.linalg.norm(c[light] - o, axis=1)
    exclude = light.copy()
    free = rng.uniform(size=n) < 0.25
    t_max[free], exclude[free] = np.inf, -1
    return prev, exclude, t_max.astype(np.float32), o.astype(np.float32), d.astype(np.float32)


@pytest.fixture(scope="module")
def program(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    tmp = tmp_path_factory.mktemp("scan_host")
    src = tmp / "walk.cpp"
    src.write_text(PROGRAM)
    exe = tmp / "walk"
    built = subprocess.run([gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-I", os.path.join(CSRC, "host"),
                            "-I", CSRC, "-o", str(exe), str(src)], capture_output=True, text=True, timeout=120)
    assert built.returncode == 0, built.stderr
    return exe, tmp


def _table(n: int):
    sc = compile_scene(sphere_field(n, seed=5), "cpu")
    layout = scan_layout(sc)
    return sc, layout, pack_sphere_table(layout)


@pytest.mark.parametrize("n, n_rays", [(96, 1500), (1024, 2500)])
def test_tree_walk_equals_the_fold_over_every_block(program, n, n_rays):
    exe, tmp = program
    sc, layout, (buf, off) = _table(n)
    path = tmp / f"field{n}.bin"
    path.write_bytes(buf.tobytes())
    leaves = 1 << max(layout.n_blocks - 1, 0).bit_length()
    prev, exclude, t_max, o, d = _rays(sc, np.random.default_rng(n), n_rays)
    bits = np.concatenate([t_max[:, None], o, d], axis=1).view(np.uint32)
    lines = [f"{p} {e} " + " ".join(map(str, b)) for p, e, b in zip(prev.tolist(), exclude.tolist(), bits.tolist())]
    argv = [str(exe), str(path), *(str(off[k]) for k in ("sph_geo", "sph_idx", "sph_box", "sph_tree")),
            str(layout.n_blocks), str(leaves), str(int(sc.unit_d))]
    out = subprocess.run(argv, input="\n".join(lines) + "\n", check=True, capture_output=True, text=True,
                         timeout=60).stdout
    got = np.array([list(map(int, ln.split())) for ln in out.splitlines()], np.int64)
    assert got.shape == (n_rays, 15)
    every, one_level, tree = got[:, 0:4], got[:, 4:8], got[:, 8:12]
    np.testing.assert_array_equal(one_level, every)
    np.testing.assert_array_equal(tree, every)
    # The cases are there: rays that find a sphere of the field and rays
    # that reach the environment sphere (index 0, around everything),
    # occluded shadow rays and clear ones; and the shadow rays' walk of the
    # tree, front to back, tests fewer spheres than the table-order walk of
    # one level.
    field = (every[:, 0] != 0x7F800000) & (every[:, 1] != 0)
    assert 0.2 < field.mean() < 0.95 and 0.05 < every[:, 3].mean() < 0.95
    assert got[:, 13].sum() < got[:, 12].sum()


def test_sphere_tree_nodes_hold_their_children():
    """Each internal node's box holds both children's boxes (empty ones
    aside), its lo.w is the larger of theirs, its split code names an axis;
    the leaves are the boxes of runs of SCAN_LEAF spheres in table order,
    then empty boxes up to a power of two; the nodes 32 / SCAN_LEAF leaves
    up are the blocks' boxes, bit for bit."""
    _, layout, (buf, off) = _table(1024)
    nb, h = layout.n_blocks, layout.host
    box = buf[off["sph_box"]: off["sph_box"] + 8 * nb].reshape(nb, 2, 4)
    block_leaves = 1 << max(nb - 1, 0).bit_length()
    per = 32 // SCAN_LEAF
    leaves = per * block_leaves
    tree = buf[off["sph_tree"]: off["sph_tree"] + 8 * (2 * leaves - 1)].reshape(2 * leaves - 1, 2, 4)
    real = (h["idx"] >= 0).reshape(-1, SCAN_LEAF)
    ctr, rad = h["ctr"].reshape(-1, SCAN_LEAF, 3), h["rad"].reshape(-1, SCAN_LEAF, 1)
    lo = np.where(real[..., None], ctr - rad, np.inf).min(axis=1)
    hi = np.where(real[..., None], ctr + rad, -np.inf).max(axis=1)
    has = real.any(axis=1)
    leaf = tree[leaves - 1:leaves - 1 + per * nb]
    np.testing.assert_array_equal(leaf[has, 0, :3], lo[has])
    np.testing.assert_array_equal(leaf[has, 1, :3], hi[has])
    np.testing.assert_array_equal(leaf[has, 0, 3], (1.0 / np.where(real, h["rad"].reshape(-1, SCAN_LEAF), np.inf)).max(axis=1)[has])
    assert np.isnan(leaf[~has, :, :3]).all() and np.isnan(tree[leaves - 1 + per * nb:, :, :3]).all()
    np.testing.assert_array_equal(tree[block_leaves - 1:block_leaves - 1 + nb], np.concatenate(
        [box[:, :1], np.concatenate([box[:, 1:, :3], tree[block_leaves - 1:block_leaves - 1 + nb, 1:, 3:]], -1)], 1))
    inner = np.arange(leaves - 1)
    kids = np.stack([tree[2 * inner + 1], tree[2 * inner + 2]], axis=1)
    lo, hi = tree[inner, 0, :3], tree[inner, 1, :3]
    for c in range(2):
        real = ~np.isnan(kids[:, c, 0, 0])
        assert (lo[real] <= kids[real, c, 0, :3]).all() and (hi[real] >= kids[real, c, 1, :3]).all()
    np.testing.assert_array_equal(tree[inner, 0, 3], np.nan_to_num(np.fmax(kids[:, 0, 0, 3], kids[:, 1, 0, 3])))
    assert (np.isnan(lo[:, 0]) == np.isnan(kids[:, :, 0, 0]).all(axis=1)).all()
    assert set((tree[inner, 1, 3].view(np.int32) & 3).tolist()) <= {0, 1, 2}
    np.testing.assert_array_equal(sphere_tree(leaf), tree)
