// Sweep megakernel: the whole render of a band of rows in one launch, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel flux_tpu/ops/pallas_kernel.py::_kernel in its
// sweep configurations (accel="sweep", no triangles). The path tracer itself
// is flux_trace.cuh, shared with scene_megakernel.cu; this file supplies the
// sweep over the __constant__ scene as its geometry policy. It is a template on
// <STATS, NEE, PHYSICAL, COUNT>; the first three are configurations of the
// TPU kernel, COUNT adds the work counters (ops/sweep_kernel.py
// flops_lower_bound) and is built without STATS only:
//   K1 <0,0,0>  reference transport: counter-based CMJ anti-aliasing and
//               lens samples, thin-lens primary rays, max_depth bounces of
//               sphere+plane sweep intersection and reference shading with
//               BRDF direction sampling, a per-pixel radiance sum over the
//               samples [s0, s0 + n_samples) (pallas_kernel.py:135-319,
//               764-907);
//   K2 STATS    a fourth per-pixel sum, Σ luminance² of each sample's
//               radiance, the adaptive-sampling noise signal (:908-914);
//   K3 NEE      next-event estimation over sphere lights: power-
//               proportional light pick, partial-cone sampling with the
//               conservative arc, the light's exact ray-t, an any-hit
//               shadow fold, the suppress flag and the final-depth gate
//               (:764-789; ops/shade.py:186-298; ops/nee.py);
//   K4 PHYSICAL cosine-weighted matte, normalized Phong over the
//               flip-corrected lobe density, and with NEE the balance-
//               heuristic (MIS) weights on both strategies through
//               prev_pdf and prev_normal (ops/shade.py:116-184, 273-339).
// Its plain PyTorch version is flux_tpu_torch/render.py::render_block;
// every floating-point operation here follows that version's, in the same
// order.
//
// What bounds it on this card: float32 operations on the CUDA cores. It
// reads almost no bytes (a few KB of scene and light constants) and writes
// 12 or 16 bytes per pixel, so memory is idle; each sample costs a few
// hundred to a few thousand float and integer operations, all in registers.
//
// What the design does about that (flux_trace.cuh render_pixels):
//   * A block is 256 threads: 256 / split pixels × split threads per pixel,
//     a thread taking every split-th sample of its pixel. The host picks
//     the split (8, 16 or 32) from the launch's shape alone
//     (ops/sweep_kernel.py::launch_plan); a long launch takes 32, so that a
//     warp holds 8 pixels × 4 of their samples, whose rays start closer
//     together than 32 pixels' of a row, in blocks short enough that the
//     last wave leaves little of the card idle.
//   * Before its samples, the threads of a pixel write its sampler row into
//     shared memory: every hash of its sample streams that does not depend
//     on the sample index. A sample then hashes its index alone.
//   * The sweep over the shapes reads the __constant__ scene with a uniform
//     index, the constant cache's broadcast case. What a lane reads with an
//     index of its own (the hit shape's normal and material rows, a picked
//     light's rows, a shape's light) is staged into shared memory once per
//     block, where lanes on different shapes do not wait on each other.
//     Scene and lights are uploaded on the launch's stream before the
//     kernel, so two launches on one stream never see each other's scene;
//     launches of different scenes on different streams at once are not
//     supported.
//   * The path state (with NEE the suppress flag, with MIS prev_pdf and
//     prev_normal) stays in registers, and a thread leaves its bounce loop
//     when its path dies: early exit per lane, without any scratch. Light
//     samples are drawn only where they can count (matte vertices, glossy
//     ones under PHYSICAL, below the final depth), and the shadow fold
//     stops at the first occluder.
//   * The work counters exist only in the counting instantiations; a timed
//     launch carries none.
//   * Radiance (and Σ luminance²) is summed per pixel in a fixed order (each
//     thread's samples in index order, then a fixed tree over the split in
//     shared memory), with no float atomics: the result is bit-identical
//     from run to run, which exact checkpoint resume relies on.
//
// Build flags (see flux_tpu_torch/ops/build.py): no fast math, no
// flush-to-zero, IEEE division and square root, so NaN and inf reject
// degenerate planes and the sample-point divisions are correctly rounded;
// --fmad=false keeps the arithmetic op-by-op equal to the plain version.

#include "flux_trace.cuh"

#define FLUX_MAX_LIGHTS FLUX_MAX_SPHERES  // every sphere light is a sweep sphere

// The NEE light set (ops/nee.py LightTensors); mirrored by FluxLights in
// flux_tpu_torch/ops/sweep_kernel.py.
struct FluxLights {
  int n_lights;
  int pad[3];
  float center[FLUX_MAX_LIGHTS][4];  // x, y, z, radius
  float emit[FLUX_MAX_LIGHTS][4];  // color × power
  float pick[FLUX_MAX_LIGHTS];  // selection probability
  float cdf[FLUX_MAX_LIGHTS];  // exclusive prefix sum of pick
  int shape_idx[FLUX_MAX_LIGHTS];
  int light_of[FLUX_MAX_SHAPES];  // light index of each shape, -1 if none
};

__constant__ FluxLights c_lights;

// The light rows that a lane reads by its own picked light, or by the light
// of the shape it hit, staged into shared memory once per block (the pick's
// cdf walk is uniform and stays in __constant__).
struct LightRows {
  float4 center[FLUX_MAX_LIGHTS];  // x, y, z, radius
  float4 emit_pick[FLUX_MAX_LIGHTS];  // emit x, y, z, pick
  int shape_idx[FLUX_MAX_LIGHTS];
  int light_of[FLUX_MAX_SHAPES];
};

template <bool NEE>
__device__ __forceinline__ LightRows* light_rows() {
  if constexpr (NEE) {
    __shared__ LightRows rows;
    return &rows;
  } else {
    return nullptr;
  }
}

__device__ __forceinline__ void stage_light_rows(LightRows* r, int tid, int n_threads) {
  for (int k = tid; k < c_lights.n_lights; k += n_threads) {
    r->center[k] = make_float4(c_lights.center[k][0], c_lights.center[k][1], c_lights.center[k][2],
                               c_lights.center[k][3]);
    r->emit_pick[k] = make_float4(c_lights.emit[k][0], c_lights.emit[k][1], c_lights.emit[k][2], c_lights.pick[k]);
    r->shape_idx[k] = c_lights.shape_idx[k];
  }
  for (int k = tid; k < FLUX_MAX_SHAPES; k += n_threads) r->light_of[k] = c_lights.light_of[k];
}

// The sphere light set: the pick's cdf from __constant__ memory, the rows
// of a picked light from shared memory.
struct ConstLights {
  static constexpr bool TRI = false;
  const LightRows* r;
  __device__ __forceinline__ int n() const { return c_lights.n_lights; }
  __device__ __forceinline__ float cdf(int k) const { return c_lights.cdf[k]; }
  __device__ __forceinline__ float pick(int k) const { return r->emit_pick[k].w; }
  __device__ __forceinline__ float4 center(int k) const { return r->center[k]; }
  __device__ __forceinline__ float4 emit(int k) const { return r->emit_pick[k]; }
  __device__ __forceinline__ int shape_idx(int k) const { return r->shape_idx[k]; }
};

// The sweep (intersect.intersect, intersect.occluded_sweep): every sphere,
// then every plane, of the __constant__ scene record; the hit's rows from
// shared memory.
template <bool NEE>
struct SweepGeom {
  typedef ConstLights Lights;
  static constexpr int N_COUNTS = FLUX_N_COUNTS;
  ShapeRows* rows;
  LightRows* lrows;

  __device__ __forceinline__ void stage(int tid, int n_threads) const {
    stage_shape_rows(rows, tid, n_threads);
    if constexpr (NEE) stage_light_rows(lrows, tid, n_threads);
  }
  __device__ __forceinline__ ConstLights lights() const { return ConstLights{lrows}; }
  __device__ __forceinline__ int light_of(int shape) const { return lrows->light_of[shape]; }

  // Nearest hit, ties to the lowest index (strict < in order).
  template <class C>
  __device__ __forceinline__ bool nearest(V3 o, V3 d, float a, float inv_a, int prev, Hit* h, C&) const {
    const int ns = c_scene.n_spheres;
    const int npl = c_scene.n_planes;
    float best_t = __int_as_float(0x7f800000);  // +inf
    int best = 0;
    sweep_spheres_nearest(o, d, a, inv_a, prev, &best_t, &best);
    for (int j = 0; j < npl; ++j) {
      const float t = plane_t(o, d, j);
      if (t > T_MIN && prev != ns + j && t < best_t) {
        best_t = t;
        best = ns + j;
      }
    }
    if (!isfinite(best_t)) return false;
    const V3 p = V3{o.x + best_t * d.x, o.y + best_t * d.y, o.z + best_t * d.z};
    h->t = best_t;
    h->shape = best;
    h->p = p;
    hit_from_rows(rows, best, best < ns, p, h);
    return true;
  }

  // Any-hit shadow test: does a shape other than `exclude` cross (o, d) at
  // T_MIN < t < t_max? The ray starts on `origin`. Stops at the first
  // occluder.
  template <class C>
  __device__ __forceinline__ bool occluded(V3 o, V3 d, float a, float inv_a, float t_max,
                                           int exclude, int origin, C&) const {
    const int ns = c_scene.n_spheres;
    if (sweep_spheres_occluded(o, d, a, inv_a, t_max, exclude, origin)) return true;
    for (int j = 0; j < c_scene.n_planes; ++j) {
      if (ns + j == exclude || ns + j == origin) continue;
      const float t = plane_t(o, d, j);
      if (t > T_MIN && t < t_max) return true;
    }
    return false;
  }
};

// ---- the kernel ----------------------------------------------------------

template <bool STATS, bool NEE, bool PHYSICAL, bool COUNT>
__global__ void __launch_bounds__(FLUX_BLOCK_THREADS)
sweep_megakernel(float* __restrict__ out, uint32_t* __restrict__ counts, int n_pix,
                 int img_w, int img_h, int row0, int row_stride, uint32_t s0,
                 uint32_t n_samples, unsigned long long s_limit, uint32_t seed, uint32_t root,
                 int max_depth) {
  render_pixels<STATS, NEE, PHYSICAL, COUNT>(SweepGeom<NEE>{shape_rows(), light_rows<NEE>()}, out,
                                             counts, n_pix, img_w, img_h, row0, row_stride, s0,
                                             n_samples, s_limit, seed, root, max_depth);
}

typedef void (*SweepKernel)(float*, uint32_t*, int, int, int, int, int, uint32_t, uint32_t,
                            unsigned long long, uint32_t, uint32_t, int);

// The instantiation <with_stats, nee, physical, count>; the counting ones
// exist without stats only (the stats channel changes no work). Null if
// there is none.
static SweepKernel pick_kernel(int with_stats, int nee, int physical, int count) {
  const int cfg = (nee ? 2 : 0) | (physical ? 1 : 0);
  if (count) {
    if (with_stats) return nullptr;
    switch (cfg) {
      case 0: return sweep_megakernel<false, false, false, true>;
      case 1: return sweep_megakernel<false, false, true, true>;
      case 2: return sweep_megakernel<false, true, false, true>;
      default: return sweep_megakernel<false, true, true, true>;
    }
  }
  switch (cfg | (with_stats ? 4 : 0)) {
    case 0: return sweep_megakernel<false, false, false, false>;
    case 1: return sweep_megakernel<false, false, true, false>;
    case 2: return sweep_megakernel<false, true, false, false>;
    case 3: return sweep_megakernel<false, true, true, false>;
    case 4: return sweep_megakernel<true, false, false, false>;
    case 5: return sweep_megakernel<true, false, true, false>;
    case 6: return sweep_megakernel<true, true, false, false>;
    default: return sweep_megakernel<true, true, true, false>;
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

size_t flux_sweep_scene_bytes(void) { return sizeof(FluxScene); }

size_t flux_sweep_lights_bytes(void) { return sizeof(FluxLights); }

int flux_sweep_max_spheres(void) { return FLUX_MAX_SPHERES; }

int flux_sweep_max_planes(void) { return FLUX_MAX_PLANES; }

int flux_sweep_n_counts(void) { return FLUX_N_COUNTS; }

int flux_sweep_max_depth(void) { return FLUX_MAX_DEPTH; }

const char* flux_sweep_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Blocks of the instantiation that one SM holds at once, for a launch with
// `split` threads per pixel at `max_depth`; a negative cudaError_t on failure.
int flux_sweep_blocks_per_sm(int with_stats, int nee, int physical, int count, int split, int max_depth) {
  const SweepKernel k = pick_kernel(with_stats, nee, physical, count);
  if (k == nullptr || !plan_ok(split, max_depth)) return -(int)cudaErrorInvalidValue;
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, (const void*)k, FLUX_BLOCK_THREADS, rows_bytes(nee, split, max_depth));
  return err == cudaSuccess ? n : -(int)err;
}

// Uploads the scene (and, when `lights` is not null, the light set) and
// launches the instantiation <with_stats, lights != null, physical, counts
// != null> on `stream`, in blocks of 256 / split pixels × split threads.
// `out` is a device buffer of 3 × n_pix floats (4 × n_pix with stats;
// channel-major); `counts` is null or a device buffer of NCOUNT × n_pix
// uint32 that receives each pixel's work counters (NCOUNT is FLUX_N_COUNTS
// with NEE or physical, else 1: bounces only; not with stats). Returns
// a cudaError_t, 0 on success.
int flux_sweep_render(float* out, uint32_t* counts, const FluxScene* scene,
                      const FluxLights* lights, int with_stats, int physical, int n_pix,
                      int img_w, int img_h, int row0, int row_stride, uint32_t s0,
                      uint32_t n_samples, unsigned long long s_limit, uint32_t seed,
                      uint32_t root, int max_depth, int split, void* stream) {
  const int nee = lights != nullptr;
  const SweepKernel k = pick_kernel(with_stats, nee, physical, counts != nullptr);
  if (k == nullptr || !plan_ok(split, max_depth)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err =
      cudaMemcpyToSymbolAsync(c_scene, scene, sizeof(FluxScene), 0, cudaMemcpyHostToDevice, st);
  if (err != cudaSuccess) return (int)err;
  if (lights != nullptr) {
    err = cudaMemcpyToSymbolAsync(c_lights, lights, sizeof(FluxLights), 0,
                                  cudaMemcpyHostToDevice, st);
    if (err != cudaSuccess) return (int)err;
  }
  const int n_px = FLUX_BLOCK_THREADS / split;
  const dim3 block((unsigned)n_px, (unsigned)split);
  const dim3 grid((unsigned)((n_pix + n_px - 1) / n_px));
  k<<<grid, block, rows_bytes(nee, split, max_depth), st>>>(out, counts, n_pix, img_w, img_h, row0, row_stride,
                                                            s0, n_samples, s_limit, seed, root, max_depth);
  return (int)cudaGetLastError();
}

}  // extern "C"
