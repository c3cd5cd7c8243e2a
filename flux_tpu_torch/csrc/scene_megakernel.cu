// Scene megakernel: the whole render of a band of rows in one launch, for
// scenes the sweep megakernel does not take: sphere tables of any size and
// triangle meshes. For NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel flux_tpu/ops/pallas_kernel.py::_kernel in its scan
// and triangle configurations:
//   K5 scan + block skip   nearest hit and any-hit over Morton-sorted blocks
//                          of 32 spheres with per-block AABBs, a second level
//                          of boxes over 8 blocks, and front-to-back pruning
//                          against the running winner t (:332-609);
//   K6 triangle fold       Möller–Trumbore over Morton-sorted blocks of 16
//                          triangles, the winner seeded with the sphere/plane
//                          winner's t, a strictly-nearer merge, the any-hit
//                          form, the same two-level skip (:611-762);
//   K7 triangle lights     the uniform-area light sample, its density, the
//                          MIS reverse density and the shrunk shadow ray
//                          (:302-318; ops/nee.py, ops/shade.py), in
//                          flux_trace.cuh behind Lights::TRI.
// The path tracer itself (sampling, camera, shading, NEE, the per-pixel sum)
// is flux_trace.cuh, shared with sweep_megakernel.cu; this file supplies the
// geometry policy. It is a template on <STATS, NEE, PHYSICAL, COUNT> like the
// sweep kernel; sweep or scan, triangles or none, triangle lights or none,
// and each skip on or off are launch-uniform run-time choices (FluxGeom), so
// the file builds 12 kernels (8, and 4 counting ones without STATS), not 96.
// Its plain PyTorch version is
// flux_tpu_torch/render.py::render_block with an Intersector in scan mode
// and/or a scene with triangles.
//
// What bounds it on this card: float32 operations on the CUDA cores, as for
// the sweep. The tables are read again and again but are small (a sphere
// costs 52 bytes, a triangle 84; 16384 spheres are under 1 MB) and stay in
// L2 and L1, so device memory is idle; what is scarce is the work per ray,
// which without a skip grows linearly with the scene, and with it the
// coherence of a warp, whose threads walk different blocks.
//
// What the design does about that:
//   * The tables live in device memory with no cap on their size, and each
//     thread reads the entries it needs through the read-only cache. The
//     threads of a warp trace a few neighbouring pixels and their samples
//     (the launch plan of flux_trace.cuh), so they mostly walk the same
//     blocks and a load is one broadcast.
//   * The skip is a per-thread slab test: a thread folds a block only if its
//     own ray enters the block's box at or before its running winner t
//     (t0 <= cap for nearest hits, so that an equal-t candidate with a lower
//     index is still seen; t0 < t_max for shadow rays). A block a thread
//     skips cannot hold that thread's winner, so the result is bit-equal to
//     the fold over every block. For that to hold against the float32 sphere
//     test as computed, not as meant, the box is widened by that test's own
//     error (box_enter): near a tangent the quadratic takes hits a hair
//     outside the sphere, and further out once |d| has drifted from 1.
//   * The triangle skip is engaged by the table's block count (the
//     wrapper's TRI_SKIP_ENGAGE): in a closed room every ray enters every
//     box, and with 3 blocks the tests only cost.
//   * No vote, no shared-memory staging and no barrier sits inside the
//     bounce loop, so a thread whose path has died simply leaves (the TPU
//     kernel's tile-wide any() has no counterpart here). A NaN slab value
//     (0·inf on an axis-parallel ray) counts as "enter"; a NaN box (an
//     all-pad block) is empty.
//   * The winner is carried as (t, original index, table slot) in registers
//     and its material is fetched once after the walk; the TPU kernel's
//     eleven-field carry in scratch memory has no counterpart.
//   * Ties: among spheres, and among triangles, the lowest original index
//     wins equal t (an explicit compare, since the walk is in Morton order);
//     planes replace spheres, and triangles replace both, only at strictly
//     smaller t. Shapes keep their original numbering (spheres, planes,
//     triangles), so hit.shape, light_of and the shadow rays' exclusions need
//     no remapping.
//   * The __constant__ scene's per-shape rows that a hit reads with a lane's
//     own index are staged into shared memory, the sampler rows are computed
//     once per pixel, the work counters exist only in the counting
//     instantiations, and radiance is summed as in the sweep kernel: fixed
//     order, no atomics, bit-identical from run to run.

#include "flux_trace.cuh"

#define FLUX_SCAN_BLOCK 32
#define FLUX_TRI_BLOCK 16
#define FLUX_SUPER 8  // blocks under one second-level box

// Work counters behind the tracer's five (per pixel, summed over samples):
// sphere blocks a ray had to enter (its box entered at or before the final
// hit; for a shadow ray the blocks entered if it came through, one if a
// sphere stopped it), sphere blocks entered, sphere box tests made, the same
// three for triangle blocks, and shadow folds started.
#define CNT_SPH_NEEDED 5
#define CNT_SPH_ENTERED 6
#define CNT_SPH_TESTS 7
#define CNT_TRI_NEEDED 8
#define CNT_TRI_ENTERED 9
#define CNT_TRI_TESTS 10
#define CNT_SHADOW_FOLDS 11
#define FLUX_SCENE_N_COUNTS 12

// Launch parameters, passed by value; mirrored by FluxGeom in
// flux_tpu_torch/ops/scene_kernel.py. Every pointer is device memory.
struct FluxGeom {
  // Sphere table (scan): n_sph_blocks × 32 entries.
  const float4* sph_geo;  // center x, y, z, radius (NaN center on padding)
  const int* sph_idx;  // original sphere index, -1 on padding
  const float4* sph_mat;  // invert / radius, exponent, kind (as bits), 0
  const float4* sph_alb;  // color × param
  const float4* sph_box;  // per block: lo (w: 1 / least radius), hi (NaN for an all-pad block)
  const float4* sph_sbox;  // per FLUX_SUPER blocks: lo, hi; null: one level of boxes
  // Triangle table: n_tri_blocks × 16 entries.
  const float4* tri_v0;  // NaN on padding
  const float4* tri_e1;
  const float4* tri_e2;
  const int* tri_idx;  // original triangle index, -1 on padding
  const float4* tri_n;  // unit normal, exponent
  const float4* tri_alb;  // color × param, kind (as bits)
  const float4* tri_box;
  const float4* tri_sbox;
  // Lights (NEE): n_lights rows; the tri_* rows only with lights_have_tris.
  const float4* l_center;  // x, y, z, radius
  const float4* l_emit;
  const float* l_pick;
  const float* l_cdf;
  const int* l_shape;
  const int* l_is_tri;
  const float4* l_v0;
  const float4* l_e1;
  const float4* l_e2;
  const float4* l_n;  // unit normal, area
  const int* light_of;  // per shape: its light index, -1 if none
  int n_sph_blocks;
  int n_tri_blocks;
  int scan;  // spheres come from the table; else from c_scene, swept
  int ns_base;  // the scene's sphere count: planes are numbered from here
  int plane_row0;  // c_scene material row of plane 0
  int tri_base;  // triangles are numbered from here
  int sph_skip;  // the AABB skip over sphere blocks is on
  int tri_skip;
  int n_lights;
  int lights_have_tris;
};

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

// Slab test of one thread's ray against a box, with pruning against `cap`:
// a block whose entry t0 lies beyond the thread's current winner (or at or
// beyond a shadow ray's t_max, `strict`) cannot change its result. The box
// is widened by what the tests inside may be off by: for spheres
// (drift + 16 ulp)·D²/r_min, with D the distance to the box's farthest corner
// and 1/r_min kept in lo.w (0 for triangle boxes), and 32 ulp·(1 + D²) for
// rounding in general; the entry t0 is eased by the drift's shift. inv_d is
// ±inf on an axis the ray is parallel to, and 0·inf is NaN there when the
// origin lies on the slab plane: a NaN slab value counts as "enter".
__device__ __forceinline__ bool box_enter(float4 lo, float4 hi, V3 o, V3 inv_d, float cap,
                                          bool strict, RaySlack rs) {
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

// Calls fold(b) for every block whose box the ray enters (every block with
// the skip off), in table order, re-reading `cap` before each test; stops
// when fold returns true. With `sbox`, a group of FLUX_SUPER blocks is
// tested as one box first: the group's box holds its blocks' boxes and the
// cap only tightens, so a block a ray would enter lies in an entered group.
template <class F>
__device__ __forceinline__ void walk_blocks(const float4* __restrict__ box,
                                            const float4* __restrict__ sbox, int n_blocks,
                                            bool skip, V3 o, V3 inv_d, RaySlack rs,
                                            const float& cap, bool strict, uint32_t& tests,
                                            uint32_t& entered, F fold) {
  if (!skip) {
    for (int b = 0; b < n_blocks; ++b) {
      entered += 1u;
      if (fold(b)) return;
    }
    return;
  }
  const int group = sbox != nullptr ? FLUX_SUPER : n_blocks;
  for (int b0 = 0, s = 0; b0 < n_blocks; b0 += group, ++s) {
    if (sbox != nullptr) {
      tests += 1u;
      if (!box_enter(__ldg(&sbox[2 * s]), __ldg(&sbox[2 * s + 1]), o, inv_d, cap, strict, rs)) continue;
    }
    const int b1 = min(b0 + group, n_blocks);
    for (int b = b0; b < b1; ++b) {
      tests += 1u;
      if (!box_enter(__ldg(&box[2 * b]), __ldg(&box[2 * b + 1]), o, inv_d, cap, strict, rs)) continue;
      entered += 1u;
      if (fold(b)) return;
    }
  }
}

// Blocks whose box the ray enters at or before `cap`: what a perfect skip
// would still have to fold (the *_NEEDED counters).
__device__ __forceinline__ uint32_t blocks_needed(const float4* __restrict__ box, int n_blocks,
                                                  V3 o, V3 inv_d, RaySlack rs, float cap) {
  uint32_t n = 0u;
  for (int b = 0; b < n_blocks; ++b) {
    if (box_enter(__ldg(&box[2 * b]), __ldg(&box[2 * b + 1]), o, inv_d, cap, false, rs)) n += 1u;
  }
  return n;
}

__device__ __forceinline__ V3 xyz(float4 v) { return V3{v.x, v.y, v.z}; }

// The light set in device memory: sphere and triangle lights, any number.
struct TableLights {
  static constexpr bool TRI = true;
  const FluxGeom* P;
  __device__ __forceinline__ int n() const { return P->n_lights; }
  __device__ __forceinline__ float cdf(int k) const { return __ldg(&P->l_cdf[k]); }
  __device__ __forceinline__ float pick(int k) const { return __ldg(&P->l_pick[k]); }
  __device__ __forceinline__ float4 center(int k) const { return __ldg(&P->l_center[k]); }
  __device__ __forceinline__ float4 emit(int k) const { return __ldg(&P->l_emit[k]); }
  __device__ __forceinline__ int shape_idx(int k) const { return __ldg(&P->l_shape[k]); }
  __device__ __forceinline__ bool has_tris() const { return P->lights_have_tris != 0; }
  __device__ __forceinline__ bool is_tri(int k) const { return __ldg(&P->l_is_tri[k]) != 0; }
  __device__ __forceinline__ float4 tri_v0(int k) const { return __ldg(&P->l_v0[k]); }
  __device__ __forceinline__ float4 tri_e1(int k) const { return __ldg(&P->l_e1[k]); }
  __device__ __forceinline__ float4 tri_e2(int k) const { return __ldg(&P->l_e2[k]); }
  __device__ __forceinline__ float4 tri_n(int k) const { return __ldg(&P->l_n[k]); }
};

// Scan or sweep over the spheres, the planes, then the triangle fold
// (intersect.intersect_scan / intersect with triangles, and their any-hit
// forms). The counting instantiations also fill the *_NEEDED counters, by a
// second walk of the boxes.
struct SceneGeom {
  typedef TableLights Lights;
  static constexpr int N_COUNTS = FLUX_SCENE_N_COUNTS;
  const FluxGeom* P;
  ShapeRows* rows;  // c_scene's spheres (sweep mode) and planes

  __device__ __forceinline__ void stage(int tid, int n_threads) const {
    stage_shape_rows(rows, tid, n_threads);
  }
  __device__ __forceinline__ TableLights lights() const { return TableLights{P}; }
  __device__ __forceinline__ int light_of(int shape) const { return __ldg(&P->light_of[shape]); }

  template <class C>
  __device__ __forceinline__ bool nearest(V3 o, V3 d, float a, float inv_a, int prev, Hit* h,
                                          C& cnt) const {
    const FluxGeom& g = *P;
    const float inf = __int_as_float(0x7f800000);
    const V3 inv_d = V3{1.0f / d.x, 1.0f / d.y, 1.0f / d.z};
    const RaySlack rs = ray_slack(d);
    RaySlack rs_tri = rs;  // Möller–Trumbore makes no assumption about |d|
    rs_tri.drift = 0.0f;
    uint32_t tests = 0u, entered = 0u;  // dead unless counted
    // Spheres: (t, original index, slot); slot is the table entry in scan
    // mode and the index itself in sweep mode.
    float best_t = inf;
    int best_i = 0;
    int slot = -1;
    if (g.scan) {
      walk_blocks(g.sph_box, g.sph_sbox, g.n_sph_blocks, g.sph_skip != 0, o, inv_d, rs, best_t, false,
                  tests, entered, [&](int b) {
                    for (int k = 0; k < FLUX_SCAN_BLOCK; ++k) {
                      const int e = b * FLUX_SCAN_BLOCK + k;
                      const float4 s = __ldg(&g.sph_geo[e]);
                      const int idx = __ldg(&g.sph_idx[e]);
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
    } else {
      sweep_spheres_nearest(o, d, a, inv_a, prev, &best_t, &best_i);
      slot = best_i;
    }
    // Planes, in order, only at strictly smaller t.
    int pl = -1;
    for (int j = 0; j < c_scene.n_planes; ++j) {
      const float t = plane_t(o, d, j);
      if (t > T_MIN && prev != g.ns_base + j && t < best_t) {
        best_t = t;
        pl = j;
      }
    }
    // Triangles: the carry starts at the sphere/plane winner's t. A triangle
    // at exactly that t is never recorded (the tie arm needs idx < 0), so the
    // seed changes nothing but what the walk can skip.
    float tr_t = best_t;
    int tr_i = 0;
    int tr_slot = -1;
    if (g.n_tri_blocks > 0) {
      const int prev_tri = prev - g.tri_base;
      tests = 0u;
      entered = 0u;
      walk_blocks(g.tri_box, g.tri_sbox, g.n_tri_blocks, g.tri_skip != 0, o, inv_d, rs_tri, tr_t, false,
                  tests, entered, [&](int b) {
                    for (int k = 0; k < FLUX_TRI_BLOCK; ++k) {
                      const int e = b * FLUX_TRI_BLOCK + k;
                      const int idx = __ldg(&g.tri_idx[e]);
                      float t;
                      if (triangle_t(o, d, xyz(__ldg(&g.tri_v0[e])), xyz(__ldg(&g.tri_e1[e])),
                                     xyz(__ldg(&g.tri_e2[e])), &t) &&
                          (t < tr_t || (t == tr_t && idx < tr_i)) && prev_tri != idx) {
                        tr_t = t;
                        tr_i = idx;
                        tr_slot = e;
                      }
                    }
                    return false;
                  });
      cnt.add(CNT_TRI_TESTS, tests);
      cnt.add(CNT_TRI_ENTERED, entered);
    }
    const bool use_tri = tr_t < best_t;
    const float t_hit = use_tri ? tr_t : best_t;
    if constexpr (C::ON) {
      if (g.scan) cnt.add(CNT_SPH_NEEDED, blocks_needed(g.sph_box, g.n_sph_blocks, o, inv_d, rs, t_hit));
      if (g.n_tri_blocks > 0) {
        cnt.add(CNT_TRI_NEEDED, blocks_needed(g.tri_box, g.n_tri_blocks, o, inv_d, rs_tri, t_hit));
      }
    }
    if (!isfinite(t_hit)) return false;
    const V3 p = V3{o.x + t_hit * d.x, o.y + t_hit * d.y, o.z + t_hit * d.z};
    h->t = t_hit;
    h->p = p;
    if (use_tri) {
      const float4 nrm = __ldg(&g.tri_n[tr_slot]);
      const float4 alb = __ldg(&g.tri_alb[tr_slot]);
      h->shape = g.tri_base + tr_i;
      h->n = xyz(nrm);
      h->exponent = nrm.w;
      h->alb = xyz(alb);
      h->kind = __float_as_int(alb.w);
    } else if (g.scan && pl < 0) {
      const float4 s = __ldg(&g.sph_geo[slot]);
      const float4 m = __ldg(&g.sph_mat[slot]);
      h->shape = best_i;
      h->n = V3{(p.x - s.x) * m.x, (p.y - s.y) * m.x, (p.z - s.z) * m.x};
      h->exponent = m.y;
      h->kind = __float_as_int(m.z);
      h->alb = xyz(__ldg(&g.sph_alb[slot]));
    } else {
      // A plane, or a sphere of the sweep: c_scene's row plane_row0 + pl or slot.
      const int row = pl >= 0 ? g.plane_row0 + pl : slot;
      h->shape = pl >= 0 ? g.ns_base + pl : slot;
      hit_from_rows(rows, row, pl < 0, p, h);
    }
    return true;
  }

  // Any-hit shadow test: does a shape other than `exclude` cross (o, d) at
  // T_MIN < t < t_max? The ray starts on `origin` (its sphere takes c = 0,
  // its plane or triangle is skipped). Stops at the first occluder.
  template <class C>
  __device__ __forceinline__ bool occluded(V3 o, V3 d, float a, float inv_a, float t_max,
                                           int exclude, int origin, C& cnt) const {
    const FluxGeom& g = *P;
    cnt.add(CNT_SHADOW_FOLDS, 1u);
    const V3 inv_d = V3{1.0f / d.x, 1.0f / d.y, 1.0f / d.z};
    const RaySlack rs = ray_slack(d);
    RaySlack rs_tri = rs;
    rs_tri.drift = 0.0f;
    bool occ = false;
    uint32_t tests = 0u, sph_entered = 0u, tri_entered = 0u;  // dead unless counted
    if (g.scan) {
      walk_blocks(g.sph_box, g.sph_sbox, g.n_sph_blocks, g.sph_skip != 0, o, inv_d, rs, t_max, true,
                  tests, sph_entered, [&](int b) {
                    for (int k = 0; k < FLUX_SCAN_BLOCK; ++k) {
                      const int e = b * FLUX_SCAN_BLOCK + k;
                      const int idx = __ldg(&g.sph_idx[e]);
                      if (idx == exclude) continue;
                      const float4 s = __ldg(&g.sph_geo[e]);
                      float t;
                      if (sphere_t(o, d, a, inv_a, s.x, s.y, s.z, s.w, origin == idx, &t) && t < t_max) {
                        occ = true;
                        return true;
                      }
                    }
                    return false;
                  });
      cnt.add(CNT_SPH_TESTS, tests);
      cnt.add(CNT_SPH_ENTERED, sph_entered);
      if (occ) {
        cnt.add(CNT_SPH_NEEDED, 1u);
        return true;
      }
    } else if (sweep_spheres_occluded(o, d, a, inv_a, t_max, exclude, origin)) {
      return true;
    }
    for (int j = 0; j < c_scene.n_planes; ++j) {
      if (g.ns_base + j == exclude || g.ns_base + j == origin) continue;
      const float t = plane_t(o, d, j);
      if (t > T_MIN && t < t_max) return true;
    }
    if (g.n_tri_blocks > 0) {
      tests = 0u;
      walk_blocks(g.tri_box, g.tri_sbox, g.n_tri_blocks, g.tri_skip != 0, o, inv_d, rs_tri, t_max, true,
                  tests, tri_entered, [&](int b) {
                    for (int k = 0; k < FLUX_TRI_BLOCK; ++k) {
                      const int e = b * FLUX_TRI_BLOCK + k;
                      const int sidx = g.tri_base + __ldg(&g.tri_idx[e]);
                      if (sidx == exclude || sidx == origin) continue;
                      float t;
                      if (triangle_t(o, d, xyz(__ldg(&g.tri_v0[e])), xyz(__ldg(&g.tri_e1[e])),
                                     xyz(__ldg(&g.tri_e2[e])), &t) &&
                          t < t_max) {
                        occ = true;
                        return true;
                      }
                    }
                    return false;
                  });
      cnt.add(CNT_TRI_TESTS, tests);
      cnt.add(CNT_TRI_ENTERED, tri_entered);
      if (occ) {
        cnt.add(CNT_TRI_NEEDED, 1u);
        return true;
      }
    }
    // It came through: it had to look into every block it entered.
    cnt.add(CNT_SPH_NEEDED, sph_entered);
    cnt.add(CNT_TRI_NEEDED, tri_entered);
    return false;
  }
};

// ---- the kernel ----------------------------------------------------------

// Four blocks on a multiprocessor: ptxas then holds the scene kernels to 64
// registers, at the price of some spills in the NEE and physical
// instantiations; left free it takes 78-112 registers without spills, and
// only two or three blocks fit. The four blocks were the faster on an NVIDIA
// H100 80GB HBM3 at 700 W (PERF.md).
#define FLUX_SCENE_MIN_BLOCKS 4

template <bool STATS, bool NEE, bool PHYSICAL, bool COUNT>
__global__ void __launch_bounds__(FLUX_BLOCK_THREADS, FLUX_SCENE_MIN_BLOCKS)
scene_megakernel(const FluxGeom geom, float* __restrict__ out, uint32_t* __restrict__ counts,
                 int n_pix, int img_w, int img_h, int row0, int row_stride, uint32_t s0,
                 uint32_t n_samples, unsigned long long s_limit, uint32_t seed, uint32_t root,
                 int max_depth) {
  render_pixels<STATS, NEE, PHYSICAL, COUNT>(SceneGeom{&geom, shape_rows()}, out, counts, n_pix, img_w,
                                             img_h, row0, row_stride, s0, n_samples, s_limit, seed, root,
                                             max_depth);
}

typedef void (*SceneKernel)(const FluxGeom, float*, uint32_t*, int, int, int, int, int, uint32_t,
                            uint32_t, unsigned long long, uint32_t, uint32_t, int);

// The instantiation <with_stats, nee, physical, count>; the counting ones
// exist without stats only (the stats channel changes no work). Null if
// there is none.
static SceneKernel pick_kernel(int with_stats, int nee, int physical, int count) {
  const int cfg = (nee ? 2 : 0) | (physical ? 1 : 0);
  if (count) {
    if (with_stats) return nullptr;
    switch (cfg) {
      case 0: return scene_megakernel<false, false, false, true>;
      case 1: return scene_megakernel<false, false, true, true>;
      case 2: return scene_megakernel<false, true, false, true>;
      default: return scene_megakernel<false, true, true, true>;
    }
  }
  switch (cfg | (with_stats ? 4 : 0)) {
    case 0: return scene_megakernel<false, false, false, false>;
    case 1: return scene_megakernel<false, false, true, false>;
    case 2: return scene_megakernel<false, true, false, false>;
    case 3: return scene_megakernel<false, true, true, false>;
    case 4: return scene_megakernel<true, false, false, false>;
    case 5: return scene_megakernel<true, false, true, false>;
    case 6: return scene_megakernel<true, true, false, false>;
    default: return scene_megakernel<true, true, true, false>;
  }
}

// Dynamic shared memory of a launch: one sampler row per pixel of a block.
static size_t rows_bytes(int nee, int split, int max_depth) {
  return (size_t)(FLUX_BLOCK_THREADS / split) * (size_t)row_words(nee != 0, max_depth) * sizeof(uint32_t);
}

static bool plan_ok(int split, int max_depth) {
  return (split == 8 || split == 16 || split == 32) && max_depth >= 0 && max_depth <= FLUX_MAX_DEPTH;
}

// ---- plain C interface (loaded with ctypes) ------------------------------

extern "C" {

size_t flux_scene_scene_bytes(void) { return sizeof(FluxScene); }

size_t flux_scene_geom_bytes(void) { return sizeof(FluxGeom); }

int flux_scene_n_counts(void) { return FLUX_SCENE_N_COUNTS; }

int flux_scene_block_sizes(void) { return FLUX_SCAN_BLOCK * 10000 + FLUX_TRI_BLOCK * 100 + FLUX_SUPER; }

const char* flux_scene_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Blocks of the instantiation that one SM holds at once, for a launch with
// `split` threads per pixel at `max_depth`; a negative cudaError_t on failure.
int flux_scene_blocks_per_sm(int with_stats, int nee, int physical, int count, int split, int max_depth) {
  const SceneKernel k = pick_kernel(with_stats, nee, physical, count);
  if (k == nullptr || !plan_ok(split, max_depth)) return -(int)cudaErrorInvalidValue;
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, (const void*)k, FLUX_BLOCK_THREADS, rows_bytes(nee, split, max_depth));
  return err == cudaSuccess ? n : -(int)err;
}

// Uploads the scene record and launches the instantiation <with_stats, nee,
// physical, counts != null> on `stream`, in blocks of 256 / split pixels ×
// split threads. `out` is a device buffer of 3 × n_pix floats (4 × n_pix
// with stats; channel-major); `counts` is null or a device buffer of
// FLUX_SCENE_N_COUNTS × n_pix uint32 that receives each pixel's work
// counters (not with stats). Returns a cudaError_t, 0 on success.
int flux_scene_render(float* out, uint32_t* counts, const FluxScene* scene, const FluxGeom* geom,
                      int with_stats, int nee, int physical, int n_pix, int img_w, int img_h,
                      int row0, int row_stride, uint32_t s0, uint32_t n_samples,
                      unsigned long long s_limit, uint32_t seed, uint32_t root, int max_depth, int split,
                      void* stream) {
  const SceneKernel k = pick_kernel(with_stats, nee, physical, counts != nullptr);
  if (k == nullptr || !plan_ok(split, max_depth)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err =
      cudaMemcpyToSymbolAsync(c_scene, scene, sizeof(FluxScene), 0, cudaMemcpyHostToDevice, st);
  if (err != cudaSuccess) return (int)err;
  const int n_px = FLUX_BLOCK_THREADS / split;
  const dim3 block((unsigned)n_px, (unsigned)split);
  const dim3 grid((unsigned)((n_pix + n_px - 1) / n_px));
  k<<<grid, block, rows_bytes(nee, split, max_depth), st>>>(*geom, out, counts, n_pix, img_w, img_h, row0,
                                                            row_stride, s0, n_samples, s_limit, seed, root,
                                                            max_depth);
  return (int)cudaGetLastError();
}

}  // extern "C"
