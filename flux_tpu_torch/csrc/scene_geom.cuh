// The scene megakernel's launch parameters and geometry policies (see
// scene_megakernel.cu): the tables in device memory, the light set, and the
// nearest, any-hit and fused folds over spheres, planes and triangles. Apart
// from scene_megakernel.cu so that the folds compile as host code too
// (csrc/host/cuda_runtime.h; tests/test_torch_tri_host.py holds the fused
// fold of a scatter ray and a carried shadow ray to the two separate folds
// there, ray by ray, and tests/test_torch_tri_walk_host.py the triangle
// walk with its skip to the fold over every block).

#pragma once

#include "scan_walk.cuh"

// Launch parameters, passed by value; mirrored by FluxGeom in
// flux_tpu_torch/ops/scene_kernel.py. Every pointer is device memory.
struct FluxGeom {
  // Sphere table (scan): n_sph_blocks × 32 entries.
  const float4* sph_geo;  // center x, y, z, radius (NaN center on padding)
  const int* sph_idx;  // original sphere index, -1 on padding
  const float4* sph_mat;  // invert / radius, exponent, kind (as bits), 0
  const float4* sph_alb;  // color × param
  const float4* sph_box;  // per block: lo (w: 1 / least radius), hi (NaN for an all-pad block)
  const float4* sph_tree;  // per node of the tree over runs of FLUX_SCAN_LEAF spheres
  // Planes past FLUX_MAX_PLANES: n_planes rows; null: c_scene holds them.
  const float4* pl_point;
  const float4* pl_normal;  // as authored; exponent
  const float4* pl_alb;  // color × param, kind (as bits)
  // Triangle table: n_tri_blocks × 16 entries.
  const float4* tri_v0;  // NaN on padding
  const float4* tri_e1;
  const float4* tri_e2;
  const int* tri_idx;  // original triangle index, -1 on padding
  const float4* tri_n;  // unit normal, exponent
  const float4* tri_alb;  // color × param, kind (as bits)
  const float4* tri_tree;  // per node of the tree over the blocks (leaves: the blocks' boxes)
  const int* tri_bin_off;  // per direction bin (tri_bin): its run of tri_cand, and the end
  const float4* tri_cand;  // w = N·R_cap / (|e1|·|e2|), the table slot (as bits)
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
  int sph_block_leaves;  // n_sph_blocks up to a power of two
  int n_planes;
  int n_tri_blocks;
  int tri_block_leaves;  // n_tri_blocks up to a power of two
  int tri_bin_grid;  // G: the direction bins are 3·G² cells of a cube
  int scan;  // spheres come from the table; else from c_scene, swept
  int ns_base;  // the scene's sphere count: planes are numbered from here
  int plane_row0;  // c_scene material row of plane 0
  int tri_base;  // triangles are numbered from here
  int sph_walk;  // 0: fold every sphere block; 1: test each block's box; 2: walk the tree
  int tri_skip;
  int n_lights;
  int lights_have_tris;
  float tri_rcap;  // R_cap (scan_walk.cuh): the boxes hold the hits of triangles with R <= R_cap
};

// The sphere table of a launch, walked as the launch asks.
__device__ __forceinline__ SphereTable sphere_table(const FluxGeom& g) {
  return SphereTable{g.sph_geo, g.sph_idx, g.sph_box, g.sph_tree, g.n_sph_blocks, g.sph_block_leaves, g.sph_walk};
}

// Plane j: the unbounded test num / den from the __constant__ record
// (plane_t), or from the plane table in the same order.
__device__ __forceinline__ float scene_plane_t(const FluxGeom& g, V3 o, V3 d, int j) {
  if (g.pl_point == nullptr) return plane_t(o, d, j);
  const float4 p = __ldg(&g.pl_point[j]), n = __ldg(&g.pl_normal[j]);
  const float num = (p.x - o.x) * n.x + (p.y - o.y) * n.y + (p.z - o.z) * n.z;
  return num / (d.x * n.x + d.y * n.y + d.z * n.z);
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

// Plane j's numerator and denominator, from the __constant__ record (plane_t)
// or from the plane table in the same order; the numerator depends on the
// origin alone.
__device__ __forceinline__ float scene_plane_num(const FluxGeom& g, V3 o, int j) {
  if (g.pl_point == nullptr) return plane_num(o, j);
  const float4 p = __ldg(&g.pl_point[j]), n = __ldg(&g.pl_normal[j]);
  return (p.x - o.x) * n.x + (p.y - o.y) * n.y + (p.z - o.z) * n.z;
}

__device__ __forceinline__ float scene_plane_den(const FluxGeom& g, V3 d, int j) {
  if (g.pl_point == nullptr) return plane_den(d, j);
  const float4 n = __ldg(&g.pl_normal[j]);
  return d.x * n.x + d.y * n.y + d.z * n.z;
}

// The direction bin of a ray (the table's tri_bin_off): the cube face of d's
// largest component, and on it a cell of a G × G grid of (the other two
// components) / (that one). d and -d share a bin, as they share the
// triangles they run nearly parallel to. A NaN direction takes bin 0 (its
// tests fail whatever the bin).
__device__ __forceinline__ int tri_bin(V3 d, int G) {
  const float ax = fabsf(d.x), ay = fabsf(d.y), az = fabsf(d.z);
  int face;
  float m, a, b;
  if (ax >= ay && ax >= az) {
    face = 0;
    m = d.x, a = d.y, b = d.z;
  } else if (ay >= az) {
    face = 1;
    m = d.y, a = d.x, b = d.z;
  } else {
    face = 2;
    m = d.z, a = d.x, b = d.y;
  }
  const float r = 1.0f / m;  // a cell boundary misses by a few ulp: the lists' reach allows 1e-5
  a *= r;
  b *= r;
  const float half = 0.5f * (float)G;
  const int i = min(max((int)floorf((a + 1.0f) * half), 0), G - 1);
  const int j = min(max((int)floorf((b + 1.0f) * half), 0), G - 1);
  return (face * G + i) * G + j;
}

// The geometry policies of the scene kernel, its fifth template parameter,
// picked per launch from FluxGeom (flux_scene_render):
//   GEO_TABLE  spheres by the scan's walk (scan_walk.cuh) or by the sweep of
//              c_scene, a run-time choice; a shadow ray folded where it is
//              drawn. Scan launches, and NEE launches with the triangle
//              skip engaged.
//   GEO_SWEEP  spheres by the sweep of c_scene only, no scan walk compiled
//              in; a light sample's shadow ray is carried to the next bounce
//              and folded beside its ray (nearest_shadow), over the spheres,
//              the planes and every triangle of the table, staged in shared
//              memory. NEE launches in sweep mode whose triangle skip, which
//              would walk the two rays through different blocks, is off or has
//              no triangles to skip, and whose table fits the stage
//              (FLUX_TRI_STAGED slots).
//              (Launches without NEE keep GEO_TABLE: on its own the policy
//              made the triangle fold without NEE slower on an NVIDIA H100
//              80GB HBM3 at 700 W, PERF.md.)
// The two give the same bits: the nearest fold's lexicographic (t, index)
// minimum does not depend on what else the loop computes, an any-hit flag
// does not depend on the order of its tests, and a carried shadow ray's
// radiance is added first thing at the next bounce, which always comes
// (flux_trace.cuh, bounce).
#define GEO_TABLE 0
#define GEO_SWEEP 1

// Spheres, then planes, then the triangle fold (intersect.intersect_scan /
// intersect with triangles, and their any-hit forms). The counting
// instantiations also fill the *_NEEDED counters, by a second walk of the
// boxes.
// A GEO_SWEEP launch's triangle table (at most FLUX_TRI_STAGED slots) is
// staged into shared memory with the block's other rows: vertex 0 with the
// original index in w (as bits), e1, e2.
#define FLUX_TRI_STAGED 64

__device__ __forceinline__ float4* tri_stage() {
  __shared__ float4 rows[3 * FLUX_TRI_STAGED];
  return rows;
}

template <int GEO>
struct SceneGeom {
  typedef TableLights Lights;
  static constexpr int N_COUNTS = FLUX_SCENE_N_COUNTS;
  static constexpr bool SCAN = GEO == GEO_TABLE;  // the scan's walk is compiled in
  static constexpr bool DEFER_SHADOW = GEO == GEO_SWEEP;
  const FluxGeom* P;
  ShapeRows* rows;  // c_scene's spheres (sweep mode) and planes

  __device__ __forceinline__ void stage(int tid, int n_threads) const {
    stage_shape_rows(rows, tid, n_threads);
    if constexpr (GEO == GEO_SWEEP) {
      float4* st = tri_stage();
      for (int k = tid; k < P->n_tri_blocks * FLUX_TRI_BLOCK; k += n_threads) {
        float4 v = __ldg(&P->tri_v0[k]);
        v.w = __int_as_float(__ldg(&P->tri_idx[k]));
        st[k] = v;
        st[FLUX_TRI_STAGED + k] = __ldg(&P->tri_e1[k]);
        st[2 * FLUX_TRI_STAGED + k] = __ldg(&P->tri_e2[k]);
      }
    }
  }
  __device__ __forceinline__ TableLights lights() const { return TableLights{P}; }
  __device__ __forceinline__ int light_of(int shape) const { return __ldg(&P->light_of[shape]); }
  __device__ __forceinline__ bool scan() const { return SCAN && P->scan != 0; }

  // The triangle fold's walk: calls fold(e) for each table slot e of the
  // triangles a ray (o, d) may hit at or before `cap` (before it, `strict`),
  // every slot with the skip off, until fold returns true. With the skip on:
  // the leaves of the tree over the blocks whose box, widened by
  // 64·(R_cap + 1) ulp·D (tri_pads), the ray enters (the lanes of a warp as
  // one), which holds every hit of a triangle with R <= R_cap
  // (scan_walk.cuh); then the triangles with R > R_cap, found in the list of
  // the ray's direction bin: those whose w = N·R_cap / (|e1|·|e2|) has (w·d)²
  // below d·d (R > R_cap means exactly that), with 2^-7 to spare for the
  // rounding of w and of the dot products (4u·R_cap relative, R_cap <= 2^13).
  // A slot folded twice changes nothing, so the fold is the whole fold's, bit
  // for bit, in the lexicographic (t, index) minimum and in the any-hit flag
  // alike.
  template <class C, class F>
  __device__ __forceinline__ void walk_triangles(V3 o, V3 d, V3 inv_d, const float& cap, bool strict, C& cnt,
                                                 F fold) const {
    const FluxGeom& g = *P;
    uint32_t tests = 0u, entered = 0u;  // dead unless counted
    bool stopped = false;
    const auto leaf = [&](int b) {
      for (int k = 0; k < FLUX_TRI_BLOCK; ++k) {
        if (fold(b * FLUX_TRI_BLOCK + k)) {
          stopped = true;
          return true;
        }
      }
      return false;
    };
    if (g.tri_skip == 0) {
      walk_blocks(nullptr, g.n_tri_blocks, false, o, inv_d, RaySlack{}, cap, strict, tests, entered, cnt, NO_LAPS,
                  leaf);
    } else {
      const V3 pad = tri_pads(__ldg(&g.tri_tree[0]), __ldg(&g.tri_tree[1]), o, inv_d, g.tri_rcap);
      walk_tree_with(
          g.tri_tree, g.tri_block_leaves, inv_d,
          [&](float4 lo, float4 hi) { return tri_box_enter(lo, hi, o, inv_d, pad, cap, strict); }, tests, entered,
          cnt, CLK_TRI_BOX, leaf);
      if (!stopped) {
        long long t = cnt.now();
        const float lim2 = (1.0f + 0x1p-7f) * dot3(d, d);
        const int bin = tri_bin(d, g.tri_bin_grid);
        const int k0 = __ldg(&g.tri_bin_off[bin]), k1 = __ldg(&g.tri_bin_off[bin + 1]);
        uint32_t cands = 0u, exc = 0u;  // dead unless counted
        // The list 32 entries at a time: first which of them pass (loads that
        // do not wait on each other), then those folded, so that the lanes
        // of a warp, each with a list of its own, fold theirs together.
        for (int k = k0; k < k1 && !stopped; k += 32) {
          const int n = min(32, k1 - k);
          uint32_t found = 0u;
          for (int j = 0; j < n; ++j) {
            const float4 c = __ldg(&g.tri_cand[k + j]);
            const float wd = c.x * d.x + c.y * d.y + c.z * d.z;
            found |= (wd * wd < lim2 ? 1u : 0u) << j;
          }
          cands += (uint32_t)n;
          while (found != 0u && !stopped) {
            const int j = __ffs((int)found) - 1;
            found &= found - 1u;
            exc += 1u;
            stopped = fold(__float_as_int(__ldg(&g.tri_cand[k + j]).w));
          }
        }
        cnt.add(CNT_TRI_CANDS, cands);
        cnt.add(CNT_TRI_EXC, exc);
        cnt.lap(CLK_TRI_EXC, t);
      }
    }
    cnt.add(CNT_TRI_TESTS, tests);
    cnt.add(CNT_TRI_ENTERED, entered);
  }

  // The counting launch's triangle *_NEEDED counters of a fold that had to
  // see every triangle up to `cap` (a nearest fold's final hit; a shadow
  // ray's t_max, strictly, if it came through): the blocks whose box the
  // ray enters, and the triangles they hold.
  template <class C>
  __device__ __forceinline__ void count_tris_needed(V3 o, V3 d, float cap, bool shadow, C& cnt) const {
    const FluxGeom& g = *P;
    const V3 inv_d = V3{1.0f / d.x, 1.0f / d.y, 1.0f / d.z};
    RaySlack rs = ray_slack(d);
    rs.drift = 0.0f;
    const float4* box = g.tri_tree + 2 * (g.tri_block_leaves - 1);  // the leaves: each block's box
    uint32_t blocks = 0u, tris = 0u;
    for (int b = 0; b < g.n_tri_blocks; ++b) {
      if (!box_enter(__ldg(&box[2 * b]), __ldg(&box[2 * b + 1]), o, inv_d, cap, shadow, rs)) continue;
      blocks += 1u;
      for (int k = 0; k < FLUX_TRI_BLOCK; ++k) tris += __ldg(&g.tri_idx[b * FLUX_TRI_BLOCK + k]) >= 0 ? 1u : 0u;
    }
    cnt.add(CNT_TRI_NEEDED, blocks);
    cnt.add(CNT_TRIS_NEEDED, tris);
    if (shadow) {
      cnt.add(CNT_SH_TRI_NEEDED, blocks);
      cnt.add(CNT_SH_TRIS_NEEDED, tris);
    }
  }

  // The same for a shadow ray that a triangle stopped: that one triangle.
  template <class C>
  __device__ __forceinline__ void count_tri_stop(C& cnt) const {
    cnt.add(CNT_TRI_NEEDED, 1u);
    cnt.add(CNT_SH_TRI_NEEDED, 1u);
    cnt.add(CNT_TRIS_NEEDED, 1u);
    cnt.add(CNT_SH_TRIS_NEEDED, 1u);
  }

  // The hit of a nearest fold's winner: the triangle (tr_*) if it is
  // strictly nearer than the sphere/plane winner (best_t; plane pl, or the
  // sphere best_i at table entry slot), none if neither is finite. The
  // counting instantiations add what a perfect skip would have folded.
  template <class C>
  __device__ __forceinline__ bool take(V3 o, V3 d, float best_t, int best_i, int slot, int pl, float tr_t,
                                       int tr_i, int tr_slot, Hit* h, C& cnt) const {
    const FluxGeom& g = *P;
    const bool use_tri = tr_t < best_t;
    const float t_hit = use_tri ? tr_t : best_t;
    if constexpr (C::ON) {
      long long t = cnt.now();
      if (scan()) {
        const V3 inv_d = V3{1.0f / d.x, 1.0f / d.y, 1.0f / d.z};
        count_spheres_needed(sphere_table(g), o, inv_d, ray_slack(d), t_hit, false, cnt);
      }
      count_tris_needed(o, d, t_hit, false, cnt);
      cnt.lap(CLK_NEEDED, t);
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
    } else if (pl >= 0 && g.pl_point != nullptr) {
      const float4 nrm = __ldg(&g.pl_normal[pl]);
      const float4 alb = __ldg(&g.pl_alb[pl]);
      h->shape = g.ns_base + pl;
      h->n = xyz(nrm);
      h->exponent = nrm.w;
      h->alb = xyz(alb);
      h->kind = __float_as_int(alb.w);
    } else if (scan() && pl < 0) {
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

  template <class C>
  __device__ __forceinline__ bool nearest(V3 o, V3 d, float a, float inv_a, int prev, Hit* h,
                                          C& cnt) const {
    const FluxGeom& g = *P;
    const float inf = __int_as_float(0x7f800000);
    const V3 inv_d = V3{1.0f / d.x, 1.0f / d.y, 1.0f / d.z};
    const RaySlack rs = ray_slack(d);
    // Spheres: (t, original index, slot); slot is the table entry in scan
    // mode and the index itself in sweep mode.
    float best_t = inf;
    int best_i = 0;
    int slot = -1;
    if (scan()) {
      scan_nearest(sphere_table(g), o, d, a, inv_a, inv_d, rs, prev, best_t, best_i, slot, cnt);
    } else {
      sweep_spheres_nearest(o, d, a, inv_a, prev, &best_t, &best_i);
      slot = best_i;
    }
    // Planes, in order, only at strictly smaller t.
    int pl = -1;
    for (int j = 0; j < g.n_planes; ++j) {
      const float t = scene_plane_t(g, o, d, j);
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
      walk_triangles(o, d, inv_d, tr_t, false, cnt, [&](int e) {
        const int idx = __ldg(&g.tri_idx[e]);
        float t;
        if (idx >= 0 &&
            triangle_t(o, d, xyz(__ldg(&g.tri_v0[e])), xyz(__ldg(&g.tri_e1[e])), xyz(__ldg(&g.tri_e2[e])), &t) &&
            (t < tr_t || (t == tr_t && idx < tr_i)) && prev_tri != idx) {
          tr_t = t;
          tr_i = idx;
          tr_slot = e;
        }
        return false;
      });
    }
    return take(o, d, best_t, best_i, slot, pl, tr_t, tr_i, tr_slot, h, cnt);
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
    if (scan()) {
      if (scan_occluded(sphere_table(g), o, d, a, inv_a, inv_d, rs, t_max, exclude, origin, cnt)) {
        cnt.add(CNT_SH_SPH_NEEDED, 1u);
        cnt.add(CNT_SH_SPH_LEAVES_NEEDED, 1u);
        cnt.add(CNT_SH_SPH_STOPS, 1u);
        return true;
      }
    } else if (sweep_spheres_occluded(o, d, a, inv_a, t_max, exclude, origin)) {
      return true;
    }
    for (int j = 0; j < g.n_planes; ++j) {
      if (g.ns_base + j == exclude || g.ns_base + j == origin) continue;
      const float t = scene_plane_t(g, o, d, j);
      if (t > T_MIN && t < t_max) return true;
    }
    if (g.n_tri_blocks > 0) {
      bool occ = false;
      walk_triangles(o, d, inv_d, t_max, true, cnt, [&](int e) {
        const int idx = __ldg(&g.tri_idx[e]);
        const int sidx = g.tri_base + idx;
        if (idx < 0 || sidx == exclude || sidx == origin) return false;
        float t;
        if (triangle_t(o, d, xyz(__ldg(&g.tri_v0[e])), xyz(__ldg(&g.tri_e1[e])), xyz(__ldg(&g.tri_e2[e])), &t) &&
            t < t_max) {
          occ = true;
          return true;
        }
        return false;
      });
      if (occ) {
        count_tri_stop(cnt);
        return true;
      }
    }
    // It came through: it had to look into every box it enters before t_max.
    if constexpr (C::ON) {
      long long t = cnt.now();
      if (scan()) count_spheres_needed(sphere_table(g), o, inv_d, rs, t_max, true, cnt);
      count_tris_needed(o, d, t_max, true, cnt);
      cnt.lap(CLK_SH_NEEDED, t);
    }
    return false;
  }

  // The nearest hit as nearest() gives it, and in *occ whether the carried
  // shadow ray `sh` (from o on prev too; none if sh.exclude < 0) is occluded
  // as occluded() would find it: one pass over the spheres, the planes and
  // every triangle for both rays (GEO_SWEEP launches fold the whole triangle
  // table, from shared memory where stage() put it; its padding slots, whose
  // NaN vertices fail every test, are passed over). Each shape's rows are
  // loaded once, and its origin terms (a sphere's o - c and c, a plane's
  // numerator, a triangle's s, q and e2·q) computed once; the shadow ray is
  // tested no further once stopped. The counters are those of nearest(), and
  // of occluded() but for the shadow folds and blocks entered, which a
  // carried ray has none of.
  template <class C>
  __device__ __forceinline__ bool nearest_shadow(V3 o, V3 d, float a, float inv_a, int prev, const Shadow& sh,
                                                 bool* occ, Hit* h, C& cnt) const {
    static_assert(!SCAN, "a carried shadow ray is folded without the scan's walk");
    const FluxGeom& g = *P;
    const bool shadow = sh.exclude >= 0;
    float as = 1.0f, inv_as = 1.0f;
    if (!c_scene.unit_d) {
      as = dot3(sh.d, sh.d);
      inv_as = 1.0f / as;
    }
    float best_t = __int_as_float(0x7f800000);  // +inf
    int best_i = 0;
    bool oc = false;
    sweep_spheres_nearest_shadow(o, d, a, inv_a, prev, sh.d, as, inv_as, sh.t_max, sh.exclude, shadow, &best_t,
                                 &best_i, &oc);
    int pl = -1;
    for (int j = 0; j < g.n_planes; ++j) {
      const float num = scene_plane_num(g, o, j);
      const float t = num / scene_plane_den(g, d, j);
      if (t > T_MIN && prev != g.ns_base + j && t < best_t) {
        best_t = t;
        pl = j;
      }
      if (shadow && !oc && g.ns_base + j != sh.exclude && g.ns_base + j != prev) {
        const float ts = num / scene_plane_den(g, sh.d, j);
        if (ts > T_MIN && ts < sh.t_max) oc = true;
      }
    }
    float tr_t = best_t;
    int tr_i = 0;
    int tr_slot = -1;
    const bool tri_shadow = shadow && !oc;  // the shadow ray reached the triangles
    const int prev_tri = prev - g.tri_base;
    const int n_slots = g.n_tri_blocks * FLUX_TRI_BLOCK;
    const float4* st = tri_stage();
    for (int e = 0; e < n_slots; ++e) {
      const float4 ra = st[e], rb = st[FLUX_TRI_STAGED + e], rc = st[2 * FLUX_TRI_STAGED + e];
      const int idx = __float_as_int(ra.w);
      // Padding (NaN vertices) is never hit, and its determinant would take
      // the division's slow path.
      if (idx < 0) continue;
      const V3 v0 = xyz(ra), e1 = xyz(rb), e2 = xyz(rc);
      const TriOrigin to = triangle_origin(o, v0, e1, e2);
      float t;
      if (triangle_root(to, d, e1, e2, &t) && (t < tr_t || (t == tr_t && idx < tr_i)) && prev_tri != idx) {
        tr_t = t;
        tr_i = idx;
        tr_slot = e;
      }
      if (shadow && !oc && g.tri_base + idx != sh.exclude && g.tri_base + idx != prev) {
        float ts;
        if (triangle_root(to, sh.d, e1, e2, &ts) && ts < sh.t_max) oc = true;
      }
    }
    cnt.add(CNT_TRI_ENTERED, (uint32_t)g.n_tri_blocks);
    if constexpr (C::ON) {
      if (tri_shadow && oc) {
        count_tri_stop(cnt);
      } else if (tri_shadow) {
        long long t = cnt.now();
        count_tris_needed(o, sh.d, sh.t_max, true, cnt);
        cnt.lap(CLK_NEEDED, t);
      }
    }
    *occ = oc;
    return take(o, d, best_t, best_i, best_i, pl, tr_t, tr_i, tr_slot, h, cnt);
  }
};
