// Scene megakernel: the whole render of a band of rows in one launch, for
// scenes the sweep megakernel does not take: sphere tables of any size and
// triangle meshes. For NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel flux_tpu/ops/pallas_kernel.py::_kernel in its scan
// and triangle configurations:
//   K5 scan + block skip   nearest hit and any-hit over Morton-sorted blocks
//                          of 32 spheres under a binary tree of boxes down
//                          to runs of 16 spheres, walked front to back by a
//                          warp as one and pruned against the running
//                          winner t (:332-609; the walk is scan_walk.cuh);
//   K6 triangle fold       Möller–Trumbore over Morton-sorted blocks of 16
//                          triangles, the winner seeded with the sphere/plane
//                          winner's t, a strictly-nearer merge, the any-hit
//                          form, a two-level skip over groups of 8 blocks
//                          (:611-762);
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
// coherence of a warp, whose threads walk different blocks. Up to 16 planes
// ride in the __constant__ record; more are a table in device memory.
//
// What the design does about that:
//   * The tables live in device memory with no cap on their size, and each
//     thread reads the entries it needs through the read-only cache. The
//     threads of a warp trace a few neighbouring pixels and their samples
//     (the launch plan of flux_trace.cuh), so they mostly walk the same
//     blocks and a load is one broadcast.
//   * The skip is a per-thread slab test: a thread folds a run of spheres
//     (a triangle block) only if its own ray enters its box, and every box
//     above it, at or before its running winner t
//     (t0 <= cap for nearest hits, so that an equal-t candidate with a lower
//     index is still seen; t0 < t_max for shadow rays). What a thread
//     skips cannot hold that thread's winner, so the result is bit-equal to
//     the fold over every block. For that to hold against the float32 sphere
//     test as computed, not as meant, the box is widened by that test's own
//     error (box_enter): near a tangent the quadratic takes hits a hair
//     outside the sphere, and further out once |d| has drifted from 1.
//   * The triangle skip is engaged by the table's block count (the
//     wrapper's TRI_SKIP_ENGAGE): in a closed room every ray enters every
//     box, and with 3 blocks the tests only cost.
//   * No shared-memory staging and no barrier sits inside the bounce loop,
//     so a thread whose path has died simply leaves (the TPU kernel's
//     tile-wide any() has no counterpart here); the sphere walk's votes are
//     among the lanes that reach it together, so none waits for a lane that
//     has left. A NaN slab value (0·inf on an axis-parallel ray) counts as
//     "enter"; a NaN box (an all-pad block) is empty.
//   * The winner is carried as (t, original index, table slot) in registers
//     and its material is fetched once after the walk; the TPU kernel's
//     eleven-field carry in scratch memory has no counterpart.
//   * Ties: among spheres, and among triangles, the lowest original index
//     wins equal t (an explicit compare, since the walk is in Morton or
//     tree order);
//     planes replace spheres, and triangles replace both, only at strictly
//     smaller t. Shapes keep their original numbering (spheres, planes,
//     triangles), so hit.shape, light_of and the shadow rays' exclusions need
//     no remapping.
//   * The __constant__ scene's per-shape rows that a hit reads with a lane's
//     own index are staged into shared memory, the sampler rows are computed
//     once per pixel, the work counters exist only in the counting
//     instantiations, and radiance is summed as in the sweep kernel: fixed
//     order, no atomics, bit-identical from run to run.

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
  const float4* tri_box;
  const float4* tri_sbox;  // per FLUX_SUPER blocks: lo, hi; null: one level of boxes
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
  int scan;  // spheres come from the table; else from c_scene, swept
  int ns_base;  // the scene's sphere count: planes are numbered from here
  int plane_row0;  // c_scene material row of plane 0
  int tri_base;  // triangles are numbered from here
  int sph_walk;  // 0: fold every sphere block; 1: test each block's box; 2: walk the tree
  int tri_skip;
  int n_lights;
  int lights_have_tris;
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

// Scan or sweep over the spheres, the planes, then the triangle fold
// (intersect.intersect_scan / intersect with triangles, and their any-hit
// forms). The counting instantiations also fill the *_NEEDED counters, by a
// second walk of the boxes.
struct SceneGeom {
  typedef TableLights Lights;
  static constexpr int N_COUNTS = FLUX_SCENE_N_COUNTS;
  // A shadow ray is folded where it is drawn: its walk skips other blocks
  // than the scatter ray's, and stops at its first occluder.
  static constexpr bool DEFER_SHADOW = false;
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
    // Spheres: (t, original index, slot); slot is the table entry in scan
    // mode and the index itself in sweep mode.
    float best_t = inf;
    int best_i = 0;
    int slot = -1;
    if (g.scan) {
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
      uint32_t tests = 0u, entered = 0u;  // dead unless counted
      walk_blocks(g.tri_box, g.tri_sbox, g.n_tri_blocks, g.tri_skip != 0, o, inv_d, rs_tri, tr_t, false,
                  tests, entered, cnt, NO_LAPS, [&](int b) {
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
      long long t = cnt.now();
      if (g.scan) count_spheres_needed(sphere_table(g), o, inv_d, rs, t_hit, false, cnt);
      if (g.n_tri_blocks > 0) cnt.add(CNT_TRI_NEEDED, boxes_needed(g.tri_box, g.n_tri_blocks, o, inv_d, rs_tri, t_hit));
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
    uint32_t tri_entered = 0u;  // dead unless counted
    if (g.scan) {
      if (scan_occluded(sphere_table(g), o, d, a, inv_a, inv_d, rs, t_max, exclude, origin, cnt)) {
        cnt.add(CNT_SH_SPH_NEEDED, 1u);
        cnt.add(CNT_SH_SPH_LEAVES_NEEDED, 1u);
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
      uint32_t tests = 0u;
      walk_blocks(g.tri_box, g.tri_sbox, g.n_tri_blocks, g.tri_skip != 0, o, inv_d, rs_tri, t_max, true,
                  tests, tri_entered, cnt, NO_LAPS, [&](int b) {
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
    if constexpr (C::ON) {
      long long t = cnt.now();
      if (g.scan) count_spheres_needed(sphere_table(g), o, inv_d, rs, t_max, true, cnt);
      cnt.lap(CLK_SH_NEEDED, t);
    }
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

int flux_scene_scan_leaf(void) { return FLUX_SCAN_LEAF; }

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
