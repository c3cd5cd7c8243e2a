// The walk of the scene megakernel over its block tables, with the AABB skip,
// and the scan's sphere folds (K5; flux_tpu/ops/pallas_kernel.py:332-609).
// Apart from scene_megakernel.cu so that the walk compiles as host code too
// (csrc/host/cuda_runtime.h; tests/test_torch_scan_host.py holds the tree
// walk to the fold over every block there, ray by ray).
//
// Sphere blocks (32 Morton-sorted spheres each) sit under an implicit binary
// tree of boxes (ops/scene_kernel.py::sphere_tree) whose leaves are runs of
// FLUX_SCAN_LEAF spheres in table order, padded to a power of two with empty
// (NaN) boxes; node i's children are 2i+1 and 2i+2, and its box is the union
// of theirs. A ray walks it depth first, the child nearer along the node's
// split axis first, and prunes a node whose box it enters beyond its running
// cap: a nearest hit is usually found in the first leaves folded and the
// leaves behind it are never entered, a shadow ray meets an occluder near
// its start first, and of a block a ray folds only the runs it crosses. The
// lanes of a warp walk the tree as one (walk_tree), with no stack: one bit a
// level in a register says whether the second child of that level is still
// to be visited.
//
// Why the result cannot move: the nearest fold takes the lexicographic
// minimum of (t, original index) with an explicit compare, so it does not
// depend on the order in which blocks are folded; a node's widened box holds
// every widened box below it (box_enter is monotone in the box, its 1/r_min
// and the cap), so a skipped node holds no block that could change the
// result; an any-hit is the same boolean in any order.
//
// Triangle blocks (16 triangles) sit under the same kind of tree, one leaf a
// block (walk_triangles in scene_geom.cuh), with boxes widened for
// Möller–Trumbore's error (tri_pads below) and the triangles that error
// cannot bound (a ray nearly in their plane) found apart, by the ray's
// direction.

#pragma once

#include "flux_trace.cuh"

#define FLUX_SCAN_BLOCK 32
#define FLUX_SCAN_LEAF 16  // spheres under one leaf of the sphere tree
#define FLUX_TRI_BLOCK 16

// Work counters behind the tracer's ten (per pixel, summed over samples).
// For nearest folds: the sphere blocks a ray had to enter (its box entered
// at or before the final hit), the walk's units folded (tree leaves, or
// blocks with one level or none), its box tests; then the triangle blocks
// needed, entered and tested (nearest and shadow folds), and shadow folds
// started; the sphere three for shadow folds (needed: the blocks entered
// before t_max if the ray came through, one if a sphere stopped it); the
// tree leaves needed (the same rules at a leaf's FLUX_SCAN_LEAF spheres) and
// the spheres tested, for nearest and for shadow folds. Then clock64 cycles
// inside a bounce's CLK_NEAREST and CLK_SHADOW: sphere box tests and sphere
// folds of nearest and of shadow walks, and the counting launch's own passes
// over the boxes for the *_NEEDED counters (nearest, shadow). Then, for the
// operation bound: the triangle blocks needed by shadow rays (part of
// CNT_TRI_NEEDED), the triangles those blocks hold without their padding
// (all rays; shadow rays), and the shadow folds a sphere of the scan stopped.
// Then the triangle walk's own: the triangles the direction's list offered
// and those of them folded apart (walk_triangles), and the cycles of the
// triangle tree's box tests, of its leaves' folds and of the list.
// A triangle block is needed by a nearest fold if the ray enters its box at
// or before the final hit, by a shadow ray that came through if it enters it
// before t_max; a shadow ray a triangle stopped needs that one triangle.
#define CNT_SPH_NEEDED (FLUX_N_COUNTS + 0)
#define CNT_SPH_ENTERED (FLUX_N_COUNTS + 1)
#define CNT_SPH_TESTS (FLUX_N_COUNTS + 2)
#define CNT_TRI_NEEDED (FLUX_N_COUNTS + 3)
#define CNT_TRI_ENTERED (FLUX_N_COUNTS + 4)
#define CNT_TRI_TESTS (FLUX_N_COUNTS + 5)
#define CNT_SHADOW_FOLDS (FLUX_N_COUNTS + 6)
#define CNT_SH_SPH_NEEDED (FLUX_N_COUNTS + 7)
#define CNT_SH_SPH_ENTERED (FLUX_N_COUNTS + 8)
#define CNT_SH_SPH_TESTS (FLUX_N_COUNTS + 9)
#define CNT_SPH_LEAVES_NEEDED (FLUX_N_COUNTS + 10)
#define CNT_SH_SPH_LEAVES_NEEDED (FLUX_N_COUNTS + 11)
#define CNT_SPH_SPHERES (FLUX_N_COUNTS + 12)
#define CNT_SH_SPH_SPHERES (FLUX_N_COUNTS + 13)
#define CLK_SPH_BOX (FLUX_N_COUNTS + 14)  // + 1: CLK_SPH_FOLD
#define CLK_SH_SPH_BOX (FLUX_N_COUNTS + 16)  // + 1: its folds
#define CLK_NEEDED (FLUX_N_COUNTS + 18)  // inside CLK_NEAREST
#define CLK_SH_NEEDED (FLUX_N_COUNTS + 19)  // inside CLK_SHADOW
#define CNT_SH_TRI_NEEDED (FLUX_N_COUNTS + 20)
#define CNT_TRIS_NEEDED (FLUX_N_COUNTS + 21)
#define CNT_SH_TRIS_NEEDED (FLUX_N_COUNTS + 22)
#define CNT_SH_SPH_STOPS (FLUX_N_COUNTS + 23)
#define CNT_TRI_CANDS (FLUX_N_COUNTS + 24)
#define CNT_TRI_EXC (FLUX_N_COUNTS + 25)
#define CLK_TRI_BOX (FLUX_N_COUNTS + 26)  // + 1: CLK_TRI_FOLD
#define CLK_TRI_EXC (FLUX_N_COUNTS + 28)
#define FLUX_SCENE_N_COUNTS (FLUX_N_COUNTS + 29)
#define NO_LAPS (-1)

// What the slab test must allow for, so that a skipped block never holds a
// hit the fold would have taken: the sphere test's own error. In a scene
// with unit directions the quadratic takes a == 1, but |d| drifts from 1
// along a path (the reference's matte frame scales with the normal's
// length, and a grazing hit's normal is not quite unit); the a == 1 roots
// are then exactly those of a sphere whose squared radius is larger by
// (d·d - 1)·b², shifted along the ray by (|d| - 1)·b. Rounding of c adds a
// few ulp of |o - c|² in the same way. `drift` is |d·d - 1| (0 where the
// scene computes a); a ray that has drifted far is not skipped at all.
struct RaySlack {
  float drift;
  bool always;  // enter every box
};

#define EPS_F32 0x1p-23f
#define DRIFT_MAX 0x1p-10f

__device__ __forceinline__ RaySlack ray_slack(V3 d) {
  RaySlack rs;
  rs.drift = c_scene.unit_d ? fabsf(dot3(d, d) - 1.0f) : 0.0f;
  rs.always = !(rs.drift <= DRIFT_MAX);  // also a NaN direction
  return rs;
}

// What a triangle box must allow for: where Möller–Trumbore, in float32 op
// by op as triangle_t computes it, can put an accepted hit. With u = 2^-24,
// K = |d|·|e1|·|e2| and R = K / |det| (>= 1; 1/R is |d̂·n̂| times the sine
// of the triangle's angle at v0), each cross product, three-term dot and the
// division round as the standard model says, so |det' - det| <= 5.9u·K and
// the numerators of u, v and t are off by at most 5.9u·|s|·|d|·|e2|,
// 5.9u·|s|·|d|·|e1| and 5.9u·|s|·|e1|·|e2| (s = o - v0, itself rounded: read
// as the exact offset of an origin u·|s| away). An accepted (u', v', t') has
// u', v' in [0, 1]; the residual r = (v0 + u'e1 + v'e2) - (o + t'd) then
// satisfies r·(d × e2) = u'det - U, r·(e1 × d) = v'det - V and
// r·(e1 × e2) = t'det - T exactly, each bounded by the above (7.9u·K +
// 5.9u·|s|·|d|·|e|, and 7.9u·|t'|·K + 5.9u·|s|·|e1|·|e2|), and in the dual
// basis of (e1, e2, -d)
//   |r| <= u·R·(7.9·(|e1| + |e2| + |t'|·|d|) + 17.7·|s|).
// With D the distance from o to the far corner of a box that holds the
// triangle, |s| <= D, |e1|, |e2| <= 2D and |t'|·|d| <= D + dist, so the hit
// lies within dist <= u·D·(114.4·R + 6) of the triangle (of its box) as long
// as 7.9u·R <= 1/2. For R <= R_cap that is under 64·(R_cap + 1) EPS_F32·D
// (R_cap <= 2^13), and a box widened by that holds every hit such a triangle
// can give, at its own t: the slab test against the cap is exact for it.
// With D to the far corner of the whole table's box, one widening serves
// every box of the tree (tri_pads). Beyond R = 2^20 no box bounds a hit at
// all: a ray in a triangle's plane can be accepted anywhere along its line
// (det and the numerators are all rounding noise). The triangles with R >
// R_cap for a ray are folded apart (walk_triangles). R_cap is the wrapper's
// scene_kernel.TRI_RCAP; the bounds are worked in PERF.md.

// Slab test of one thread's ray against a box, with pruning against `cap`:
// a block whose entry t0 lies beyond the thread's current winner (or at or
// beyond a shadow ray's t_max, `strict`) cannot change its result. The box
// is widened by what the tests inside may be off by: for spheres
// (drift + 16 ulp)·D²/r_min, with D the distance to the box's farthest corner
// and 1/r_min kept in lo.w, and 32 ulp·(1 + D²) for rounding in general;
// the entry t0 is eased by the drift's shift. inv_d is ±inf on an axis the
// ray is parallel to, and 0·inf is NaN there when the origin lies on the slab
// plane: a NaN slab value counts as "enter".
__device__ __forceinline__ bool box_enter(float4 lo, float4 hi, V3 o, V3 inv_d, float cap, bool strict,
                                          RaySlack rs) {
  if (isnan(lo.x)) return false;  // an empty box
  if (rs.always) return true;
  const float dx0 = lo.x - o.x, dx1 = hi.x - o.x;
  const float dy0 = lo.y - o.y, dy1 = hi.y - o.y;
  const float dz0 = lo.z - o.z, dz1 = hi.z - o.z;
  const float far2 = fmaxf(dx0 * dx0, dx1 * dx1) + fmaxf(dy0 * dy0, dy1 * dy1) + fmaxf(dz0 * dz0, dz1 * dz1);
  const float pad = (rs.drift + 16.0f * EPS_F32) * far2 * lo.w + 32.0f * EPS_F32 * (1.0f + far2);
  const float tx0 = dx0 * inv_d.x, tx1 = dx1 * inv_d.x;
  const float ty0 = dy0 * inv_d.y, ty1 = dy1 * inv_d.y;
  const float tz0 = dz0 * inv_d.z, tz1 = dz1 * inv_d.z;
  if (isnan(tx0) || isnan(tx1) || isnan(ty0) || isnan(ty1) || isnan(tz0) || isnan(tz1)) return true;
  const float px = pad * fabsf(inv_d.x), py = pad * fabsf(inv_d.y), pz = pad * fabsf(inv_d.z);
  const float t0 = fmaxf(fminf(tx0, tx1) - px, fmaxf(fminf(ty0, ty1) - py, fminf(tz0, tz1) - pz));
  const float t1 = fminf(fmaxf(tx0, tx1) + px, fminf(fmaxf(ty0, ty1) + py, fmaxf(tz0, tz1) + pz));
  const float t0_eased = t0 * (1.0f - rs.drift) - rs.drift * (1.0f + far2);
  return t0 <= t1 && t1 > T_MIN && (strict ? t0_eased < cap : t0_eased <= cap);
}

// The slab test of a triangle box (see box_enter): with the pad of one ray,
// per axis (pad·|inv_d|), for every box of the table (tri_pads).
__device__ __forceinline__ bool tri_box_enter(float4 lo, float4 hi, V3 o, V3 inv_d, V3 pad, float cap, bool strict) {
  if (isnan(lo.x)) return false;  // an empty box
  const float tx0 = (lo.x - o.x) * inv_d.x, tx1 = (hi.x - o.x) * inv_d.x;
  const float ty0 = (lo.y - o.y) * inv_d.y, ty1 = (hi.y - o.y) * inv_d.y;
  const float tz0 = (lo.z - o.z) * inv_d.z, tz1 = (hi.z - o.z) * inv_d.z;
  if (isnan(tx0) || isnan(tx1) || isnan(ty0) || isnan(ty1) || isnan(tz0) || isnan(tz1)) return true;
  const float t0 = fmaxf(fminf(tx0, tx1) - pad.x, fmaxf(fminf(ty0, ty1) - pad.y, fminf(tz0, tz1) - pad.z));
  const float t1 = fminf(fmaxf(tx0, tx1) + pad.x, fminf(fmaxf(ty0, ty1) + pad.y, fmaxf(tz0, tz1) + pad.z));
  return t0 <= t1 && t1 > T_MIN && (strict ? t0 < cap : t0 <= cap);
}

// The pad of a ray from o for every triangle box of a table whose boxes all
// lie in `root`, per axis in t: box_enter's rounding term and the
// Möller–Trumbore term 64·(R_cap + 1) EPS_F32·D, with D² the root's far2,
// which bounds every box's.
__device__ __forceinline__ V3 tri_pads(float4 lo, float4 hi, V3 o, V3 inv_d, float rcap) {
  const float dx0 = lo.x - o.x, dx1 = hi.x - o.x;
  const float dy0 = lo.y - o.y, dy1 = hi.y - o.y;
  const float dz0 = lo.z - o.z, dz1 = hi.z - o.z;
  const float far2 = fmaxf(dx0 * dx0, dx1 * dx1) + fmaxf(dy0 * dy0, dy1 * dy1) + fmaxf(dz0 * dz0, dz1 * dz1);
  const float pad = 32.0f * EPS_F32 * (1.0f + far2) + 64.0f * (rcap + 1.0f) * EPS_F32 * sqrtf(far2);
  return V3{pad * fabsf(inv_d.x), pad * fabsf(inv_d.y), pad * fabsf(inv_d.z)};
}

// Calls fold(b) for every block whose box the ray enters (every block with
// the skip off), in table order, re-reading `cap` before each test; stops
// when fold returns true. With `clk` (not NO_LAPS) the counting
// instantiations add the cycles of box tests to counter clk and those of
// folds to clk + 1.
template <class C, class F>
__device__ __forceinline__ void walk_blocks(const float4* __restrict__ box, int n_blocks, bool skip, V3 o,
                                            V3 inv_d, RaySlack rs, const float& cap, bool strict, uint32_t& tests,
                                            uint32_t& entered, C& cnt, int clk, F fold) {
  long long t = cnt.now();
  for (int b = 0; b < n_blocks; ++b) {
    if (skip) {
      tests += 1u;
      const bool in = box_enter(__ldg(&box[2 * b]), __ldg(&box[2 * b + 1]), o, inv_d, cap, strict, rs);
      if (clk != NO_LAPS) cnt.lap(clk, t);
      if (!in) continue;
    }
    entered += 1u;
    const bool stop = fold(b);
    if (clk != NO_LAPS) cnt.lap(clk + 1, t);
    if (stop) return;
  }
}

// Whether a node's second child (2i+2) is visited first: its hi.w holds, as
// bits, the split axis (bits 0-1) and whether the second child is the lower
// one on it (bit 2); the lower child comes first for a ray going up that
// axis (inv_d carries d's sign, zeros included).
__device__ __forceinline__ int second_first(float code_bits, V3 inv_d) {
  const int code = __float_as_int(code_bits);
  const int axis = code & 3;
  const float s = axis == 0 ? inv_d.x : axis == 1 ? inv_d.y : inv_d.z;
  return ((code >> 2) & 1) ^ (signbit(s) ? 1 : 0);
}

// The lanes of a warp that start a tree walk together walk it as one: a
// node is entered if any of them enters it (each folds only the leaves its
// own ray enters), and its children are taken in the order most of them
// would take. So the warp runs one path with one load of each node for all
// its lanes, where lanes on paths of their own would each wait for their own
// loads and the warp would run every one of those paths in turn. A lane's
// result does not depend on which leaves the others bring it to.
__device__ __forceinline__ bool walk_any(unsigned group, bool p) { return __any_sync(group, p); }
__device__ __forceinline__ bool walk_all(unsigned group, bool p) { return __all_sync(group, p); }
__device__ __forceinline__ int walk_majority(unsigned group, int p) {
  return 2 * __popc(__ballot_sync(group, p)) > __popc(group) ? 1 : 0;
}

// Calls fold(leaf) for every leaf whose box, and every box above it, the ray
// enters (enter(lo, hi), which reads the cap as it stands, a box holding
// every box below it passing whenever one of those does): depth first over
// the implicit tree of `n_leaves` leaves (a power of two; 2·n_leaves - 1
// nodes of two float4 each), the nearer child first, with the lanes of the
// warp that are here together (above); a lane stops folding once its fold
// returns true, and the walk ends when every lane has. `trail` holds one bit for each level from
// the root to the current node: set while that level's other child is still
// to be visited.
template <class C, class E, class F>
__device__ __forceinline__ void walk_tree_with(const float4* __restrict__ tree, int n_leaves, V3 inv_d, E enter,
                                               uint32_t& tests, uint32_t& entered, C& cnt, int clk, F fold) {
  const unsigned group = __activemask();
  const int first_leaf = n_leaves - 1;
  long long t = cnt.now();
  uint32_t trail = 0u;
  bool done = false;
  int i = 0;
  for (;;) {
    const float4 lo = __ldg(&tree[2 * i]), hi = __ldg(&tree[2 * i + 1]);
    tests += done ? 0u : 1u;
    const bool in = !done && enter(lo, hi);
    cnt.lap(clk, t);
    if (walk_any(group, in)) {
      if (i < first_leaf) {
        i = 2 * i + 1 + walk_majority(group, second_first(hi.w, inv_d));
        trail = (trail << 1) | 1u;
        continue;
      }
      if (in) {
        entered += 1u;
        done = fold(i - first_leaf);
        cnt.lap(clk + 1, t);
      }
      if (walk_all(group, done)) return;
    }
    while ((trail & 1u) == 0u) {  // climb past levels whose children are both done
      if (trail == 0u) return;
      trail >>= 1;
      i = (i - 1) >> 1;
    }
    trail ^= 1u;
    i = ((i - 1) ^ 1) + 1;  // the other child
  }
}

// walk_tree_with with box_enter's test of the ray (o, inv_d) against the cap.
template <class C, class F>
__device__ __forceinline__ void walk_tree(const float4* __restrict__ tree, int n_leaves, V3 o, V3 inv_d,
                                          RaySlack rs, const float& cap, bool strict, uint32_t& tests,
                                          uint32_t& entered, C& cnt, int clk, F fold) {
  walk_tree_with(
      tree, n_leaves, inv_d, [&](float4 lo, float4 hi) { return box_enter(lo, hi, o, inv_d, cap, strict, rs); }, tests,
      entered, cnt, clk, fold);
}

// A sphere table in device memory (ops/scene_kernel.py::pack_sphere_table).
// The tree's leaves are runs of FLUX_SCAN_LEAF table entries, block_leaves ×
// FLUX_SCAN_BLOCK / FLUX_SCAN_LEAF of them (block_leaves: the block count up
// to a power of two), so the nodes that hold whole blocks sit
// log2(FLUX_SCAN_BLOCK / FLUX_SCAN_LEAF) levels above the leaves.
// `walk`: 0 folds every block, 1 tests each block's box, 2 walks the tree.
struct SphereTable {
  const float4* geo;  // center x, y, z, radius (NaN center on padding)
  const int* idx;  // original sphere index, -1 on padding
  const float4* box;  // per block: lo (w: 1 / least radius), hi (NaN for an all-pad block)
  const float4* tree;  // per node: lo (w: the largest 1 / least radius below), hi (w: split code)
  int n_blocks;
  int block_leaves;
  int walk;
};

#define FLUX_LEAVES_PER_BLOCK (FLUX_SCAN_BLOCK / FLUX_SCAN_LEAF)

// Calls fold(e0, n) for each run of table entries [e0, e0 + n) that the
// table's walk reaches: the tree's leaves, or whole blocks.
template <class C, class F>
__device__ __forceinline__ void walk_spheres(const SphereTable& T, V3 o, V3 inv_d, RaySlack rs, const float& cap,
                                             bool strict, uint32_t& tests, uint32_t& entered, C& cnt, int clk,
                                             F fold) {
  if (T.walk == 2) {
    walk_tree(T.tree, T.block_leaves * FLUX_LEAVES_PER_BLOCK, o, inv_d, rs, cap, strict, tests, entered, cnt, clk,
              [&](int leaf) { return fold(leaf * FLUX_SCAN_LEAF, FLUX_SCAN_LEAF); });
  } else {
    walk_blocks(T.box, T.n_blocks, T.walk != 0, o, inv_d, rs, cap, strict, tests, entered, cnt, clk,
                [&](int b) { return fold(b * FLUX_SCAN_BLOCK, FLUX_SCAN_BLOCK); });
  }
}

// The nearest sphere of the table along (o, d): updates (best_t, best_i,
// slot) with the lowest original index among equal t; slot is the winner's
// table entry. `prev` is the sphere the ray starts on.
template <class C>
__device__ __forceinline__ void scan_nearest(const SphereTable& T, V3 o, V3 d, float a, float inv_a, V3 inv_d,
                                             RaySlack rs, int prev, float& best_t, int& best_i, int& slot,
                                             C& cnt) {
  uint32_t tests = 0u, entered = 0u, spheres = 0u;  // dead unless counted
  walk_spheres(T, o, inv_d, rs, best_t, false, tests, entered, cnt, CLK_SPH_BOX, [&](int e0, int n) {
    spheres += (uint32_t)n;
    for (int k = 0; k < n; ++k) {
      const int e = e0 + k;
      const float4 s = __ldg(&T.geo[e]);
      const int idx = __ldg(&T.idx[e]);
      float t;
      if (sphere_t(o, d, a, inv_a, s.x, s.y, s.z, s.w, prev == idx, &t) &&
          (t < best_t || (t == best_t && idx < best_i))) {
        best_t = t;
        best_i = idx;
        slot = e;
      }
    }
    return false;
  });
  cnt.add(CNT_SPH_TESTS, tests);
  cnt.add(CNT_SPH_ENTERED, entered);
  cnt.add(CNT_SPH_SPHERES, spheres);
}

// Any sphere of the table but `exclude` across (o, d) at T_MIN < t < t_max?
// The ray starts on `origin` (its sphere takes c = 0). Stops at the first
// occluder.
template <class C>
__device__ __forceinline__ bool scan_occluded(const SphereTable& T, V3 o, V3 d, float a, float inv_a, V3 inv_d,
                                              RaySlack rs, float t_max, int exclude, int origin, C& cnt) {
  bool occ = false;
  uint32_t tests = 0u, entered = 0u, spheres = 0u;  // dead unless counted
  walk_spheres(T, o, inv_d, rs, t_max, true, tests, entered, cnt, CLK_SH_SPH_BOX, [&](int e0, int n) {
    spheres += (uint32_t)n;
    for (int k = 0; k < n; ++k) {
      const int e = e0 + k;
      const int idx = __ldg(&T.idx[e]);
      if (idx == exclude) continue;
      const float4 s = __ldg(&T.geo[e]);
      float t;
      if (sphere_t(o, d, a, inv_a, s.x, s.y, s.z, s.w, origin == idx, &t) && t < t_max) {
        occ = true;
        return true;
      }
    }
    return false;
  });
  cnt.add(CNT_SH_SPH_TESTS, tests);
  cnt.add(CNT_SH_SPH_ENTERED, entered);
  cnt.add(CNT_SH_SPH_SPHERES, spheres);
  return occ;
}

// Boxes of a row of `n` that the ray enters at or before `cap` (before it,
// `strict`): what a perfect skip over those boxes would still have to fold
// (the *_NEEDED counters).
__device__ __forceinline__ uint32_t boxes_needed(const float4* __restrict__ box, int n, V3 o, V3 inv_d,
                                                 RaySlack rs, float cap, bool strict = false) {
  uint32_t k = 0u;
  for (int b = 0; b < n; ++b) {
    if (box_enter(__ldg(&box[2 * b]), __ldg(&box[2 * b + 1]), o, inv_d, cap, strict, rs)) k += 1u;
  }
  return k;
}

// The counting launch's *_NEEDED counters of a sphere table: the blocks and
// the tree's leaves a nearest fold (cap: its final hit) or a shadow fold that
// came through (strict, cap: t_max) enters.
template <class C>
__device__ __forceinline__ void count_spheres_needed(const SphereTable& T, V3 o, V3 inv_d, RaySlack rs, float cap,
                                                     bool shadow, C& cnt) {
  const int leaves = T.block_leaves * FLUX_LEAVES_PER_BLOCK;
  cnt.add(shadow ? CNT_SH_SPH_NEEDED : CNT_SPH_NEEDED, boxes_needed(T.box, T.n_blocks, o, inv_d, rs, cap, shadow));
  cnt.add(shadow ? CNT_SH_SPH_LEAVES_NEEDED : CNT_SPH_LEAVES_NEEDED,
          boxes_needed(T.tree + 2 * (leaves - 1), leaves, o, inv_d, rs, cap, shadow));
}
