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
//                          form, the skip over a binary tree of the blocks'
//                          boxes walked front to back by a warp as one, and
//                          the triangles a ray runs nearly parallel to folded
//                          apart (:611-762);
//   K7 triangle lights     the uniform-area light sample, its density, the
//                          MIS reverse density and the shrunk shadow ray
//                          (:302-318; ops/nee.py, ops/shade.py), in
//                          flux_trace.cuh behind Lights::TRI.
// The path tracer itself (sampling, camera, shading, NEE, the per-pixel sum)
// is flux_trace.cuh, shared with sweep_megakernel.cu; scene_geom.cuh supplies
// the geometry policies. The kernel is a template on <STATS, NEE, PHYSICAL,
// COUNT> like the sweep kernel, and on the geometry policy: GEO_TABLE (the
// scan's walk, or the sweep of c_scene, a run-time choice) and GEO_SWEEP
// (the sweep alone, without the scan's walk compiled in; with NEE only).
// Triangles or none, triangle lights or none, and each skip on or off are
// launch-uniform run-time choices (FluxGeom), so the file builds 18 kernels
// (8 and 4 counting ones without STATS, and 6 with NEE of GEO_SWEEP), not
// 192.
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
//   * For triangles the widening is Möller–Trumbore's own error, which grows
//     as the ray turns into a triangle's plane (scan_walk.cuh, tri_pads):
//     the boxes hold every hit of a triangle the ray meets at more than a
//     hair's angle, and the few triangles it runs nearly parallel to, whose
//     hits no box holds (a ray in a triangle's plane can be accepted anywhere
//     along its line), come from a list by the ray's direction and are folded
//     whatever the boxes say. The triangle skip is engaged by the table's
//     block count (the wrapper's TRI_SKIP_ENGAGE): in a closed room every ray
//     enters every box, and with 3 blocks the tests only cost.
//   * Where the whole triangle table is folded and fits in shared memory
//     (FLUX_TRI_STAGED slots), a light sample's shadow ray has no fold of its
//     own: it is carried to the next bounce and folded beside that bounce's
//     ray from the same point (GEO_SWEEP), one pass over the spheres, planes
//     and triangle slots for both rays, each shape's rows loaded once and its
//     origin terms computed once (Möller–Trumbore's s, s × e1 and the
//     numerator of t). In the Cornell box that pass replaced a third of a
//     bounce's time, a second pass over the same 48 slots. Where the skip is
//     engaged the two rays would walk different blocks, and the shadow ray
//     keeps its fold (GEO_TABLE).
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

#include "scene_geom.cuh"

// ---- the kernel ----------------------------------------------------------

// Four blocks on a multiprocessor: ptxas then holds the scene kernels to 64
// registers, at the price of some spills in the NEE and physical
// instantiations; left free it takes 78-112 registers without spills, and
// only two or three blocks fit. The four blocks were the faster on an NVIDIA
// H100 80GB HBM3 at 700 W (PERF.md).
#define FLUX_SCENE_MIN_BLOCKS 4

template <bool STATS, bool NEE, bool PHYSICAL, bool COUNT, int GEO>
__global__ void __launch_bounds__(FLUX_BLOCK_THREADS, FLUX_SCENE_MIN_BLOCKS)
scene_megakernel(const FluxGeom geom, float* __restrict__ out, uint32_t* __restrict__ counts,
                 int n_pix, int img_w, int img_h, int row0, int row_stride, uint32_t s0,
                 uint32_t n_samples, unsigned long long s_limit, uint32_t seed, uint32_t root,
                 int max_depth) {
  render_pixels<STATS, NEE, PHYSICAL, COUNT>(SceneGeom<GEO>{&geom, shape_rows()}, out, counts, n_pix, img_w,
                                             img_h, row0, row_stride, s0, n_samples, s_limit, seed, root,
                                             max_depth);
}

typedef void (*SceneKernel)(const FluxGeom, float*, uint32_t*, int, int, int, int, int, uint32_t,
                            uint32_t, unsigned long long, uint32_t, uint32_t, int);

// The instantiation <with_stats, NEE, physical, count> of policy GEO; the
// counting ones exist without stats only (the stats channel changes no
// work). Null if there is none.
template <int GEO, bool NEE>
static SceneKernel pick_in(int with_stats, int physical, int count) {
  if (count) {
    if (with_stats) return nullptr;
    return physical ? scene_megakernel<false, NEE, true, true, GEO> : scene_megakernel<false, NEE, false, true, GEO>;
  }
  if (with_stats) {
    return physical ? scene_megakernel<true, NEE, true, false, GEO> : scene_megakernel<true, NEE, false, false, GEO>;
  }
  return physical ? scene_megakernel<false, NEE, true, false, GEO> : scene_megakernel<false, NEE, false, false, GEO>;
}

// GEO_SWEEP exists with NEE only: 18 kernels.
static SceneKernel pick_kernel(int with_stats, int nee, int physical, int count, int geo) {
  if (!nee) return pick_in<GEO_TABLE, false>(with_stats, physical, count);
  return geo == GEO_SWEEP ? pick_in<GEO_SWEEP, true>(with_stats, physical, count)
                          : pick_in<GEO_TABLE, true>(with_stats, physical, count);
}

// The geometry policy of a launch: GEO_SWEEP for NEE launches whose spheres
// come from c_scene and whose triangles (if any) are folded whole from the
// shared-memory stage.
static int launch_geo(const FluxGeom& g, int nee) {
  const bool whole = !(g.tri_skip && g.n_tri_blocks > 0) && g.n_tri_blocks * FLUX_TRI_BLOCK <= FLUX_TRI_STAGED;
  return nee && !g.scan && whole ? GEO_SWEEP : GEO_TABLE;
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

int flux_scene_block_sizes(void) { return FLUX_SCAN_BLOCK * 10000 + FLUX_TRI_BLOCK * 100; }

int flux_scene_scan_leaf(void) { return FLUX_SCAN_LEAF; }

const char* flux_scene_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Blocks that one SM holds at once of the instantiation a launch with
// `geom` takes, for `split` threads per pixel at `max_depth` (GEO_SWEEP adds
// the triangle stage to the static shared memory); a negative cudaError_t on
// failure.
int flux_scene_blocks_per_sm(const FluxGeom* geom, int with_stats, int nee, int physical, int count, int split,
                             int max_depth) {
  const SceneKernel k = pick_kernel(with_stats, nee, physical, count, launch_geo(*geom, nee));
  if (k == nullptr || !plan_ok(split, max_depth)) return -(int)cudaErrorInvalidValue;
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, (const void*)k, FLUX_BLOCK_THREADS, rows_bytes(nee, split, max_depth));
  return err == cudaSuccess ? n : -(int)err;
}

// Queues on `stream` the upload of the scene record into this library's
// __constant__ memory. A launch reads what the uploads queued before it left
// there; the caller orders an upload after the launches that may still read
// the record it overwrites. Returns a cudaError_t, 0 on success.
int flux_scene_upload(const FluxScene* scene, void* stream) {
  return (int)cudaMemcpyToSymbolAsync(c_scene, scene, sizeof(FluxScene), 0, cudaMemcpyHostToDevice,
                                      (cudaStream_t)stream);
}

// Launches the instantiation <with_stats, nee, physical, counts != null> of
// the launch's geometry policy on `stream`, in blocks of 256 / split pixels ×
// split threads, over the scene record uploaded before it (flux_scene_upload).
// `out` is a device buffer of 3 × n_pix floats (4 × n_pix
// with stats; channel-major); `counts` is null or a device buffer of
// FLUX_SCENE_N_COUNTS × n_pix uint32 that receives each pixel's work
// counters (not with stats). Returns a cudaError_t, 0 on success.
int flux_scene_render(float* out, uint32_t* counts, const FluxGeom* geom, int with_stats, int nee, int physical,
                      int n_pix, int img_w, int img_h, int row0, int row_stride, uint32_t s0, uint32_t n_samples,
                      unsigned long long s_limit, uint32_t seed, uint32_t root, int max_depth, int split,
                      void* stream) {
  const SceneKernel k = pick_kernel(with_stats, nee, physical, counts != nullptr, launch_geo(*geom, nee));
  if (k == nullptr || !plan_ok(split, max_depth)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int n_px = FLUX_BLOCK_THREADS / split;
  const dim3 block((unsigned)n_px, (unsigned)split);
  const dim3 grid((unsigned)((n_pix + n_px - 1) / n_px));
  k<<<grid, block, rows_bytes(nee, split, max_depth), st>>>(*geom, out, counts, n_pix, img_w, img_h, row0,
                                                            row_stride, s0, n_samples, s_limit, seed, root,
                                                            max_depth);
  return (int)cudaGetLastError();
}

}  // extern "C"
