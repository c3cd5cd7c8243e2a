// Sweep megakernel: the whole render of a band of rows in one launch, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel flux_tpu/ops/pallas_kernel.py::_kernel in its
// sweep configurations (accel="sweep", no triangles). The path tracer itself
// is flux_trace.cuh, shared with scene_megakernel.cu; this file supplies the
// sweep over the __constant__ scene as its geometry policy. It is a template on
// <STATS, NEE, PHYSICAL>, each a configuration of the TPU kernel:
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
// order. The <0,0,0> instantiation is the K1 kernel unchanged.
//
// What bounds it on this card: float32 operations on the CUDA cores. It
// reads almost no bytes (a few KB of scene and light constants) and writes
// 12 or 16 bytes per pixel, so memory is idle; each sample costs a few
// hundred to a few thousand float and integer operations, all in registers.
//
// What the design does about that:
//   * A thread owns one pixel and every FLUX_SAMPLE_SPLIT-th sample of it,
//     so a 50-row band (40,000 pixels) still gives 320,000 threads, more
//     than the card holds at once. Neighbouring threads of a warp take
//     neighbouring pixels of the same sample index, so their rays stay
//     coherent, as the TPU tile's were.
//   * The path state (with NEE the suppress flag, with MIS prev_pdf and
//     prev_normal) stays in registers, and a thread leaves its bounce loop
//     when its path dies: early exit per lane, without any scratch. Light
//     samples are drawn only where they can count (matte vertices, glossy
//     ones under PHYSICAL, below the final depth), and the shadow fold
//     stops at the first occluder.
//   * The scene (demo2 has 13 shapes) and its light set live in __constant__
//     memory. Every thread of a warp reads the same shape at the same time,
//     the constant cache's broadcast case. Both are uploaded on the launch's
//     stream before the kernel, so two launches on one stream never see each
//     other's scene; launches of different scenes on different streams at
//     once are not supported.
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

// The light set in __constant__ memory: sphere lights only.
struct ConstLights {
  static constexpr bool TRI = false;
  __device__ __forceinline__ int n() const { return c_lights.n_lights; }
  __device__ __forceinline__ float cdf(int k) const { return c_lights.cdf[k]; }
  __device__ __forceinline__ float pick(int k) const { return c_lights.pick[k]; }
  __device__ __forceinline__ float4 center(int k) const {
    return make_float4(c_lights.center[k][0], c_lights.center[k][1], c_lights.center[k][2],
                       c_lights.center[k][3]);
  }
  __device__ __forceinline__ float4 emit(int k) const {
    return make_float4(c_lights.emit[k][0], c_lights.emit[k][1], c_lights.emit[k][2], 0.0f);
  }
  __device__ __forceinline__ int shape_idx(int k) const { return c_lights.shape_idx[k]; }
};

// The sweep (intersect.intersect, intersect.occluded_sweep): every sphere,
// then every plane, of the __constant__ scene record.
struct SweepGeom {
  typedef ConstLights Lights;
  static constexpr int N_COUNTS = FLUX_N_COUNTS;

  __device__ __forceinline__ ConstLights lights() const { return ConstLights(); }
  __device__ __forceinline__ int light_of(int shape) const { return c_lights.light_of[shape]; }

  // Nearest hit, ties to the lowest index (strict < in order).
  __device__ __forceinline__ bool nearest(V3 o, V3 d, float a, float inv_a, int prev, Hit* h,
                                          uint32_t*) const {
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
    V3 n;
    if (best < ns) {
      const float inv_r = c_scene.sph_invert[best] / c_scene.sph[best][3];
      n = V3{(p.x - c_scene.sph[best][0]) * inv_r, (p.y - c_scene.sph[best][1]) * inv_r,
             (p.z - c_scene.sph[best][2]) * inv_r};
    } else {
      const int j = best - ns;
      n = V3{c_scene.pl_normal[j][0], c_scene.pl_normal[j][1], c_scene.pl_normal[j][2]};
    }
    h->t = best_t;
    h->shape = best;
    h->p = p;
    h->n = n;
    h->kind = c_scene.kind[best];
    h->alb = V3{c_scene.alb[best][0], c_scene.alb[best][1], c_scene.alb[best][2]};
    h->exponent = c_scene.exponent[best];
    return true;
  }

  // Any-hit shadow test: does a shape other than `exclude` cross (o, d) at
  // T_MIN < t < t_max? The ray starts on `origin`. Stops at the first
  // occluder.
  __device__ __forceinline__ bool occluded(V3 o, V3 d, float a, float inv_a, float t_max,
                                           int exclude, int origin, uint32_t*) const {
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

template <bool STATS, bool NEE, bool PHYSICAL>
__global__ void __launch_bounds__(FLUX_PIXELS_PER_BLOCK * FLUX_SAMPLE_SPLIT)
sweep_megakernel(float* __restrict__ out, uint32_t* __restrict__ counts, int n_pix,
                 int img_w, int img_h, int row0, int row_stride, uint32_t s0,
                 uint32_t n_samples, unsigned long long s_limit, uint32_t seed, uint32_t root,
                 int max_depth) {
  render_pixels<STATS, NEE, PHYSICAL>(SweepGeom(), out, counts, n_pix, img_w, img_h, row0,
                                      row_stride, s0, n_samples, s_limit, seed, root, max_depth);
}

// ---- plain C interface (loaded with ctypes) ------------------------------

extern "C" {

size_t flux_sweep_scene_bytes(void) { return sizeof(FluxScene); }

size_t flux_sweep_lights_bytes(void) { return sizeof(FluxLights); }

int flux_sweep_max_spheres(void) { return FLUX_MAX_SPHERES; }

int flux_sweep_max_planes(void) { return FLUX_MAX_PLANES; }

int flux_sweep_n_counts(void) { return FLUX_N_COUNTS; }

const char* flux_sweep_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Uploads the scene (and, when `lights` is not null, the light set) and
// launches the instantiation <with_stats, lights != null, physical> on
// `stream`. `out` is a device buffer of 3 × n_pix floats (4 × n_pix with
// stats; channel-major); `counts` is null or a device buffer of
// NCOUNT × n_pix uint32 that receives each pixel's work counters (NCOUNT is
// FLUX_N_COUNTS with NEE or physical, else 1: bounces only). Returns a
// cudaError_t, 0 on success.
int flux_sweep_render(float* out, uint32_t* counts, const FluxScene* scene,
                      const FluxLights* lights, int with_stats, int physical, int n_pix,
                      int img_w, int img_h, int row0, int row_stride, uint32_t s0,
                      uint32_t n_samples, unsigned long long s_limit, uint32_t seed,
                      uint32_t root, int max_depth, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err =
      cudaMemcpyToSymbolAsync(c_scene, scene, sizeof(FluxScene), 0, cudaMemcpyHostToDevice, st);
  if (err != cudaSuccess) return (int)err;
  if (lights != nullptr) {
    err = cudaMemcpyToSymbolAsync(c_lights, lights, sizeof(FluxLights), 0,
                                  cudaMemcpyHostToDevice, st);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 block(FLUX_PIXELS_PER_BLOCK, FLUX_SAMPLE_SPLIT);
  const dim3 grid((unsigned)((n_pix + FLUX_PIXELS_PER_BLOCK - 1) / FLUX_PIXELS_PER_BLOCK));
#define FLUX_LAUNCH(S, N, P)                                                                  \
  sweep_megakernel<S, N, P><<<grid, block, 0, st>>>(out, counts, n_pix, img_w, img_h, row0, \
                                                    row_stride, s0, n_samples, s_limit, seed, \
                                                    root, max_depth)
  const int cfg = (with_stats ? 4 : 0) | (lights != nullptr ? 2 : 0) | (physical ? 1 : 0);
  switch (cfg) {
    case 0: FLUX_LAUNCH(false, false, false); break;
    case 1: FLUX_LAUNCH(false, false, true); break;
    case 2: FLUX_LAUNCH(false, true, false); break;
    case 3: FLUX_LAUNCH(false, true, true); break;
    case 4: FLUX_LAUNCH(true, false, false); break;
    case 5: FLUX_LAUNCH(true, false, true); break;
    case 6: FLUX_LAUNCH(true, true, false); break;
    default: FLUX_LAUNCH(true, true, true); break;
  }
#undef FLUX_LAUNCH
  return (int)cudaGetLastError();
}

}  // extern "C"

