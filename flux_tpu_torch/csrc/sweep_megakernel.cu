// Sweep megakernel: the whole render of a band of rows in one launch, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel flux_tpu/ops/pallas_kernel.py::_kernel in its
// sweep configurations (accel="sweep", no triangles). It is a template on
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

#include <cuda_runtime.h>
#include <stdint.h>

#define FLUX_MAX_SPHERES 64
#define FLUX_MAX_PLANES 16
#define FLUX_MAX_SHAPES (FLUX_MAX_SPHERES + FLUX_MAX_PLANES)
#define FLUX_MAX_LIGHTS FLUX_MAX_SPHERES  // every sphere light is a sweep sphere
#define FLUX_PIXELS_PER_BLOCK 32
#define FLUX_SAMPLE_SPLIT 8
// Work counters per pixel (see trace_sample): bounces, light samples,
// unoccluded shadow rays, MIS reverse densities, glossy lobe evaluations.
#define FLUX_N_COUNTS 5

#define KIND_MATTE 0
#define KIND_EMISSIVE 1
#define KIND_REFLECTIVE 2
#define KIND_GLOSSY 3

// Scene and camera constants; mirrored by flux_tpu_torch/ops/sweep_kernel.py
// (FluxScene), which checks the size at load time.
struct FluxScene {
  int n_spheres;
  int n_planes;
  int unit_d;  // every ray direction is unit: the sphere quadratic's a == 1
  int pad;
  float sph[FLUX_MAX_SPHERES][4];  // center x, y, z, radius
  float sph_invert[FLUX_MAX_SPHERES];  // +1 / -1
  float pl_point[FLUX_MAX_PLANES][4];
  float pl_normal[FLUX_MAX_PLANES][4];
  float alb[FLUX_MAX_SHAPES][4];  // material color × param (rgb)
  float exponent[FLUX_MAX_SHAPES];  // Phong exponent, low 2 mantissa bits clear
  int kind[FLUX_MAX_SHAPES];
  float bg[4];
  float eye[4];
  float u[4];
  float v[4];
  float w[4];
  float focal_distance;
  float lens_radius;
  float vp_factor;
  float adjusted_pixel_size;
};

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

__constant__ FluxScene c_scene;
__constant__ FluxLights c_lights;

// float32 constants of the plain version, exact.
#define T_MIN 0x1.0624dep-11f
#define PI_F 0x1.921fb6p+1f
#define TWO_PI 0x1.921fb6p+2f
#define QUARTER_PI 0x1.921fb6p-1f
#define INV_PI 0x1.45f306p-2f  // 1/π
#define HALF_INV_PI 0x1.45f306p-3f  // 0.5/π, also 1/(2π)
#define EPS_6 0x1.0c6f7ap-20f  // 1e-6
#define EPS_9 0x1.12e0bep-30f  // 1e-9
#define EPS_12 0x1.197998p-40f  // 1e-12
#define EPS_20 0x1.79ca1p-67f  // 1e-20
// Abramowitz–Stegun 4.4.45 arccos polynomial and its 1e-4 pad.
#define AS_0 0x1.921b48p+0f
#define AS_1 -0x1.b26908p-3f
#define AS_2 0x1.302c4ep-4f
#define AS_3 -0x1.32dc6p-6f
#define ACOS_PAD 0x1.a36e2ep-14f
// Rec. 709 luma weights (color.luminance).
#define LUM_R 0x1.b367ap-3f
#define LUM_G 0x1.6e2eb2p-1f
#define LUM_B 0x1.27bb3p-4f

#define SALT_AA 0x41415341u
#define SALT_LENS 0x4C454E53u
#define SALT_BOUNCE 0x424F554Eu
#define SALT_NEE 0x4E454531u
#define SALT_NEEPICK 0x4E454532u
#define SALT_JX 0x16A3D5C7u
#define SALT_JY 0x2C9F1B4Fu
#define SALT_PX 0x51633E2Du
#define SALT_PY 0x68BC21EBu
#define GOLDEN 0x9E3779B9u

// ---- counter-based sampling (flux_tpu_torch/samplers) --------------------

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t hc_step(uint32_t acc, uint32_t v) {
  return mix32(acc ^ (v + GOLDEN + (acc << 6) + (acc >> 2)));
}

__device__ __forceinline__ uint32_t hash2(uint32_t a, uint32_t b) {
  return hc_step(hc_step(GOLDEN, a), b);
}

__device__ __forceinline__ uint32_t hash3(uint32_t a, uint32_t b, uint32_t c) {
  return hc_step(hash2(a, b), c);
}

__device__ __forceinline__ float randfloat(uint32_t i, uint32_t p) {
  return (float)(int)(mix32(i ^ p) >> 8) * 0x1p-24f;
}

__device__ __forceinline__ uint32_t permute_pow2(uint32_t i, uint32_t l, uint32_t p) {
  const uint32_t w = l - 1u;
  i ^= p;
  i *= 0xE170893Du;
  i ^= p >> 16;
  i ^= (i & w) >> 4;
  i ^= p >> 8;
  i *= 0x0929EB3Fu;
  i ^= p >> 23;
  i ^= (i & w) >> 1;
  i *= 1u | (p >> 27);
  i *= 0x6935FA69u;
  i ^= (i & w) >> 11;
  i *= 0x74DCCA23u;
  i ^= p >> 2;
  i *= 0x9E501CC3u;
  i ^= (i & w) >> 2;
  i *= 0xC860A3DFu;
  i &= w;
  i ^= i >> 5;
  return (i + p) & w;
}

// MJ (correlated = false) or CMJ (correlated = true) sample s of root².
__device__ __forceinline__ void multi_jitter(uint32_t s, uint32_t root, uint32_t pattern,
                                             bool correlated, float* x, float* y) {
  const uint32_t i = s % root;
  const uint32_t j = s / root;
  const float rf = (float)(int)root;
  float fine_x, fine_y;
  if ((root & (root - 1u)) == 0u) {
    uint32_t px, py;
    if (correlated) {
      px = hash2(pattern, SALT_PX);
      py = hash2(pattern, SALT_PY);
    } else {
      px = hash3(pattern, SALT_PX, i);
      py = hash3(pattern, SALT_PY, j);
    }
    fine_x = (float)(int)permute_pow2(j, root, px);
    fine_y = (float)(int)permute_pow2(i, root, py);
  } else {
    fine_x = (float)(int)j;
    fine_y = (float)(int)((root - 1u) - i);
  }
  const float jx = randfloat(s, hash2(pattern, SALT_JX));
  const float jy = randfloat(s, hash2(pattern, SALT_JY));
  *x = ((float)(int)i + (fine_x + jx) / rf) / rf;
  *y = ((float)(int)j + (fine_y + jy) / rf) / rf;
}

__device__ __forceinline__ void jittered(uint32_t s, uint32_t root, uint32_t pattern,
                                         float* x, float* y) {
  const float rf = (float)(int)root;
  const float i = (float)(int)(s % root);
  const float j = (float)(int)(s / root);
  const float jx = randfloat(s, hash2(pattern, SALT_JX));
  const float jy = randfloat(s, hash2(pattern, SALT_JY));
  *x = (i + jx) / rf;
  *y = (j + jy) / rf;
}

// patterns.bounce_point: MJ at the first bounce, jittered beyond.
__device__ __forceinline__ void bounce_point(uint32_t s, uint32_t root, uint32_t pattern, int depth,
                                             float* x, float* y) {
  if (depth <= 1) {
    multi_jitter(s, root, pattern, false, x, y);
  } else {
    jittered(s, root, pattern, x, y);
  }
}

__device__ __forceinline__ float safe_div(float a, float b) {
  return a / (b == 0.0f ? 1.0f : b);
}

// Shirley-Chiu concentric square-to-disc map.
__device__ __forceinline__ void to_poisson_disc(float x, float y, float* dx, float* dy) {
  const float spx = 2.0f * x - 1.0f;
  const float spy = 2.0f * y - 1.0f;
  const bool c1 = spx > -spy;
  const bool c2 = spx > spy;
  const bool c3 = spx < spy;
  const float r = c1 ? (c2 ? spx : spy) : (c3 ? -spx : -spy);
  float phi;
  if (c1) {
    phi = c2 ? safe_div(spy, spx) : 2.0f - safe_div(spx, spy);
  } else if (c3) {
    phi = 4.0f + safe_div(spy, spx);
  } else {
    phi = spy != 0.0f ? 6.0f - safe_div(spx, spy) : 0.0f;
  }
  const float sin_sign = (phi >= 0.0f && phi < 4.0f) ? 1.0f : -1.0f;
  phi = phi * QUARTER_PI;
  const float cos_phi = cosf(phi);
  const float sin_phi = sin_sign * sqrtf(fmaxf(1.0f - cos_phi * cos_phi, 0.0f));
  *dx = r * cos_phi;
  *dy = r * sin_phi;
}

// cos^e-weighted hemisphere direction in the local frame.
__device__ __forceinline__ void to_unit_hemi(float x, float y, float e,
                                             float* hx, float* hy, float* hz) {
  const float phi = TWO_PI * x;
  const float cos_phi = cosf(phi);
  const float sin_phi = (x < 0.5f ? 1.0f : -1.0f) * sqrtf(fmaxf(1.0f - cos_phi * cos_phi, 0.0f));
  const float cos_theta = powf(fmaxf(1.0f - y, 0.0f), 1.0f / (e + 1.0f));
  const float sin_theta = sqrtf(fmaxf(1.0f - cos_theta * cos_theta, 0.0f));
  *hx = sin_theta * cos_phi;
  *hy = sin_theta * sin_phi;
  *hz = cos_theta;
}

struct V3 {
  float x, y, z;
};

// Frame-epsilon vectors (ops/brdf.py _EM, _EG) as float32.
#define EM_V3 V3{0x1.bda512p-9f, 1.0f, 0x1.d14e3cp-8f}
#define EG_V3 V3{0x1.15df66p-8f, 1.0f, 0x1.f4b1eep-8f}

__device__ __forceinline__ float dot3(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

__device__ __forceinline__ V3 cross3(V3 a, V3 b) {
  return V3{a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

__device__ __forceinline__ V3 normalize3(V3 a) {
  const float inv = rsqrtf(dot3(a, a));
  return V3{a.x * inv, a.y * inv, a.z * inv};
}

__device__ __forceinline__ float clip01(float x, float lo, float hi) { return fminf(fmaxf(x, lo), hi); }

// ---- intersection (ops/intersect.py) -------------------------------------

// The reference's ray-sphere quadratic (intersect.sphere_t): the near root,
// or the far one when the near is behind T_MIN. `on_self` marks a ray that
// starts on this sphere, whose c is then exactly 0. Writes t; returns
// whether the sphere is hit at t > T_MIN.
__device__ __forceinline__ bool sphere_t(V3 o, V3 d, float a, float inv_a, float cx, float cy,
                                         float cz, float radius, bool on_self, float* t_out) {
  const float ocx = o.x - cx, ocy = o.y - cy, ocz = o.z - cz;
  const float b_half = ocx * d.x + ocy * d.y + ocz * d.z;
  float c = ocx * ocx + ocy * ocy + ocz * ocz - radius * radius;
  if (on_self) c = 0.0f;  // exact c on the origin sphere
  float disc, t;
  if (c_scene.unit_d) {
    disc = b_half * b_half - c;
    const float e = sqrtf(fmaxf(disc, 0.0f));
    const float t_near = -b_half - e;
    t = t_near > T_MIN ? t_near : -b_half + e;
  } else {
    disc = b_half * b_half - a * c;
    const float e = sqrtf(fmaxf(disc, 0.0f));
    const float t_near = (-b_half - e) * inv_a;
    t = t_near > T_MIN ? t_near : (-b_half + e) * inv_a;
  }
  *t_out = t;
  return disc >= 0.0f && t > T_MIN;
}

// The unbounded plane test; d·n == 0 gives ±inf or NaN, rejected by the
// caller's comparisons.
__device__ __forceinline__ float plane_t(V3 o, V3 d, int j) {
  const float nx = c_scene.pl_normal[j][0], ny = c_scene.pl_normal[j][1], nz = c_scene.pl_normal[j][2];
  const float num = (c_scene.pl_point[j][0] - o.x) * nx + (c_scene.pl_point[j][1] - o.y) * ny +
                    (c_scene.pl_point[j][2] - o.z) * nz;
  const float den = d.x * nx + d.y * ny + d.z * nz;
  return num / den;
}

// Any-hit shadow test (intersect.occluded_sweep): does a shape other than
// `exclude` cross (o, d) at T_MIN < t < t_max? The ray starts on `origin`.
// Stops at the first occluder.
__device__ __forceinline__ bool occluded(V3 o, V3 d, float a, float inv_a, float t_max,
                                         int exclude, int origin) {
  const int ns = c_scene.n_spheres;
  for (int i = 0; i < ns; ++i) {
    if (i == exclude) continue;
    float t;
    if (sphere_t(o, d, a, inv_a, c_scene.sph[i][0], c_scene.sph[i][1], c_scene.sph[i][2],
                 c_scene.sph[i][3], origin == i, &t) &&
        t < t_max) {
      return true;
    }
  }
  for (int j = 0; j < c_scene.n_planes; ++j) {
    if (ns + j == exclude || ns + j == origin) continue;
    const float t = plane_t(o, d, j);
    if (t > T_MIN && t < t_max) return true;
  }
  return false;
}

// ---- next-event estimation (ops/nee.py) ----------------------------------

// arccos(x) plus a hair, never below the true value (nee._acos_conservative).
__device__ __forceinline__ float acos_conservative(float x) {
  const float ax = fabsf(x);
  const float poly = AS_0 + ax * (AS_1 + ax * (AS_2 + ax * AS_3));
  float a = sqrtf(fmaxf(1.0f - ax, 0.0f)) * poly;
  a = x < 0.0f ? PI_F - a : a;
  return clip01(a + ACOS_PAD, 0.0f, PI_F);
}

// The cone frame about w, seeded by the matte epsilon (nee._cone_frame).
__device__ __forceinline__ void cone_frame(V3 w, V3* u, V3* v) {
  *u = normalize3(cross3(EM_V3, w));
  *v = cross3(*u, w);
}

// Half-angle of the above-horizon arc of the cone ring at (cos_a, sin_a)
// for a normal with cone-frame axis part n_w and in-plane magnitude rho.
__device__ __forceinline__ float clip_arc_halfangle(float rho, float n_w, float cos_a, float sin_a) {
  const float c = -(cos_a * n_w) / fmaxf(sin_a * rho, EPS_12);
  return acos_conservative(clip01(c, -1.0f, 1.0f));
}

struct LightSample {
  V3 d;  // unit direction toward the sampled light point
  V3 weight;  // L_e / (pick · pdf)
  float pdf;  // solid-angle density of this strategy
  V3 center;  // the picked light's center and radius
  float radius;
  int sidx;  // its shape index
};

// nee.sample_light_dirs with the horizon clip about `nrm`.
__device__ __forceinline__ LightSample sample_light(V3 p, float ux, float uy, float upick, V3 nrm) {
  int li = 0;  // the last k with upick >= cdf[k]
  for (int k = 1; k < c_lights.n_lights; ++k) {
    if (upick >= c_lights.cdf[k]) li = k;
  }
  const V3 ctr = V3{c_lights.center[li][0], c_lights.center[li][1], c_lights.center[li][2]};
  const float rad = c_lights.center[li][3];
  const V3 dc = V3{ctr.x - p.x, ctr.y - p.y, ctr.z - p.z};
  const float dist2 = dot3(dc, dc);
  const float dist = sqrtf(dist2);
  const bool inside = dist2 <= rad * rad;
  const float sin2_max = clip01(rad * rad / fmaxf(dist2, EPS_12), 0.0f, 1.0f);
  const float cos_max = sqrtf(fmaxf(1.0f - sin2_max, 0.0f));
  const float inv_dist = 1.0f / fmaxf(dist, EPS_12);
  const V3 w = V3{dc.x * inv_dist, dc.y * inv_dist, dc.z * inv_dist};
  const float cos_a = 1.0f - ux * (1.0f - cos_max);
  const float sin_a = sqrtf(fmaxf(1.0f - cos_a * cos_a, 0.0f));
  V3 u, v;
  cone_frame(w, &u, &v);
  const float n_u = dot3(nrm, u), n_v = dot3(nrm, v), n_w = dot3(nrm, w);
  const float rho = sqrtf(n_u * n_u + n_v * n_v);
  const float phi_lim = clip_arc_halfangle(rho, n_w, cos_a, sin_a);
  const float arc_frac = phi_lim * INV_PI;
  const bool safe = rho > EPS_6;
  const float inv_rho = 1.0f / fmaxf(rho, EPS_12);
  const float c0 = safe ? n_u * inv_rho : 1.0f;
  const float s0 = safe ? n_v * inv_rho : 0.0f;
  const float delta = (2.0f * uy - 1.0f) * phi_lim;
  const float cd = cosf(delta), sd = sinf(delta);
  const float cp = c0 * cd - s0 * sd;
  const float sp = s0 * cd + c0 * sd;
  LightSample ls;
  ls.d = V3{sin_a * (cp * u.x + sp * v.x) + cos_a * w.x, sin_a * (cp * u.y + sp * v.y) + cos_a * w.y,
            sin_a * (cp * u.z + sp * v.z) + cos_a * w.z};
  float wgt = TWO_PI * (1.0f - cos_max) / fmaxf(c_lights.pick[li], EPS_12);
  wgt = inside ? 0.0f : wgt;
  wgt = wgt * arc_frac;
  ls.weight = V3{c_lights.emit[li][0] * wgt, c_lights.emit[li][1] * wgt, c_lights.emit[li][2] * wgt};
  ls.pdf = 1.0f / fmaxf(wgt, EPS_20);
  ls.center = ctr;
  ls.radius = rad;
  ls.sidx = c_lights.shape_idx[li];
  return ls;
}

// nee.nee_pdf_toward for light k from p along d, clipped about `nrm`: the
// MIS reverse density, rebuilt with the sampler's own frame and arc.
__device__ __forceinline__ float nee_pdf_toward(V3 p, int k, V3 d, V3 nrm) {
  const float dcx = c_lights.center[k][0] - p.x;
  const float dcy = c_lights.center[k][1] - p.y;
  const float dcz = c_lights.center[k][2] - p.z;
  const float dist2 = dcx * dcx + dcy * dcy + dcz * dcz;
  const float r = c_lights.center[k][3];
  const float sin2 = clip01(r * r / fmaxf(dist2, EPS_12), 0.0f, 1.0f);
  const float cos_max = sqrtf(fmaxf(1.0f - sin2, 0.0f));
  const float omega = TWO_PI * (1.0f - cos_max);
  float pdf = c_lights.pick[k] / fmaxf(omega, EPS_20);
  const float dist = sqrtf(fmaxf(dist2, EPS_12));
  const float inv = 1.0f / dist;
  const V3 w = V3{dcx * inv, dcy * inv, dcz * inv};
  V3 u, v;
  cone_frame(w, &u, &v);
  const float cos_a = dot3(w, d);
  const float sin_a = sqrtf(fmaxf(1.0f - cos_a * cos_a, 0.0f));
  const float n_u = dot3(nrm, u), n_v = dot3(nrm, v), n_w = dot3(nrm, w);
  const float rho = sqrtf(n_u * n_u + n_v * n_v);
  const float phi_lim = clip_arc_halfangle(rho, n_w, cos_a, sin_a);
  pdf = pdf * PI_F / fmaxf(phi_lim, EPS_9);
  return dist2 <= r * r ? 0.0f : pdf;
}

// shade.glossy_lobe: max(r·wd, 0)^e, the flip-corrected cos^e lobe density
// (e+1)/(2π)·(r·wd)^e·(1+dup), and dup = 1 where the flipped twin of wd
// lies below the horizon.
__device__ __forceinline__ void glossy_lobe(V3 mirror, V3 nrm, float e, V3 wd, float* phong,
                                            float* pdf, float* dup) {
  const float rw = fmaxf(mirror.x * wd.x + mirror.y * wd.y + mirror.z * wd.z, 0.0f);
  *phong = powf(rw, e);
  const V3 flipped = V3{2.0f * rw * mirror.x - wd.x, 2.0f * rw * mirror.y - wd.y,
                        2.0f * rw * mirror.z - wd.z};
  *dup = dot3(nrm, flipped) < 0.0f ? 1.0f : 0.0f;
  *pdf = (e + 1.0f) * HALF_INV_PI * *phong * (1.0f + *dup);
}

// ---- one sample's path ---------------------------------------------------

// Radiance of sample s of the pixel (row, col). Adds to the work counters
// cnt: [0] bounces and, with NEE or PHYSICAL, [1] light samples, [2]
// unoccluded shadow rays (each swept every other shape), [3] MIS reverse
// densities, [4] glossy lobe evaluations.
template <bool NEE, bool PHYSICAL>
__device__ __forceinline__ V3 trace_sample(uint32_t s, uint32_t pixel_base, int row, int col,
                                           int img_w, int img_h, uint32_t root, int max_depth,
                                           uint32_t* cnt) {
  float ax, ay, ux, uy, lx, ly;
  multi_jitter(s, root, hash2(pixel_base, SALT_AA), true, &ax, &ay);
  multi_jitter(s, root, hash2(pixel_base, SALT_LENS), true, &ux, &uy);
  to_poisson_disc(ux, uy, &lx, &ly);

  // Thin-lens primary ray (camera.primary_rays).
  const float half_w = (float)img_w * 0.5f;
  const float half_h = (float)img_h * 0.5f;
  const float adj = c_scene.adjusted_pixel_size;
  const float px = adj * (((float)col - half_w) + ax);
  const float py = adj * ((((float)img_h - (float)row) - half_h) + ay);
  const float lpx = lx * c_scene.lens_radius;
  const float lpy = ly * c_scene.lens_radius;
  const float dxv = px * c_scene.vp_factor - lpx;
  const float dyv = py * c_scene.vp_factor - lpy;
  const V3 fw = V3{c_scene.focal_distance * c_scene.w[0], c_scene.focal_distance * c_scene.w[1],
                   c_scene.focal_distance * c_scene.w[2]};
  V3 d = normalize3(V3{dxv * c_scene.u[0] + dyv * c_scene.v[0] - fw.x,
                       dxv * c_scene.u[1] + dyv * c_scene.v[1] - fw.y,
                       dxv * c_scene.u[2] + dyv * c_scene.v[2] - fw.z});
  V3 o = V3{c_scene.eye[0] + lpx * c_scene.u[0] + lpy * c_scene.v[0],
            c_scene.eye[1] + lpx * c_scene.u[1] + lpy * c_scene.v[1],
            c_scene.eye[2] + lpx * c_scene.u[2] + lpy * c_scene.v[2]};

  V3 tput = V3{1.0f, 1.0f, 1.0f};
  V3 rad = V3{0.0f, 0.0f, 0.0f};
  int prev = -1;  // shape the ray originates on
  const int ns = c_scene.n_spheres;
  const int npl = c_scene.n_planes;
  bool suppress = false;  // NEE: the last vertex sampled a light (hard split)
  float prev_pdf = 0.0f;  // NEE + PHYSICAL: density that sampled this ray
  V3 prev_n = V3{0.0f, 0.0f, 0.0f};  // NEE + PHYSICAL: the last vertex's normal

  for (int depth = 1; depth <= max_depth; ++depth) {
    cnt[0] += 1u;
    // Sweep: nearest hit, ties to the lowest index (strict < in order).
    float a = 1.0f, inv_a = 1.0f;
    if (!c_scene.unit_d) {
      a = d.x * d.x + d.y * d.y + d.z * d.z;
      inv_a = 1.0f / a;
    }
    float best_t = __int_as_float(0x7f800000);  // +inf
    int best = 0;
    for (int i = 0; i < ns; ++i) {
      float t;
      if (sphere_t(o, d, a, inv_a, c_scene.sph[i][0], c_scene.sph[i][1], c_scene.sph[i][2],
                   c_scene.sph[i][3], prev == i, &t) &&
          t < best_t) {
        best_t = t;
        best = i;
      }
    }
    for (int j = 0; j < npl; ++j) {
      const float t = plane_t(o, d, j);
      if (t > T_MIN && prev != ns + j && t < best_t) {
        best_t = t;
        best = ns + j;
      }
    }

    if (!isfinite(best_t)) {  // miss: background (scene.rs:168)
      rad.x = rad.x + tput.x * c_scene.bg[0];
      rad.y = rad.y + tput.y * c_scene.bg[1];
      rad.z = rad.z + tput.z * c_scene.bg[2];
      break;
    }
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
    const int kind = c_scene.kind[best];
    const V3 alb = V3{c_scene.alb[best][0], c_scene.alb[best][1], c_scene.alb[best][2]};
    if (kind == KIND_EMISSIVE) {  // emit toward rays it faces, then stop
      const bool facing = dot3(n, d) < 0.0f;
      if constexpr (NEE && PHYSICAL) {
        if (facing) {
          // MIS: a BSDF hit of an NEE light weighs pdf_b / (pdf_b + pdf_nee).
          float emit_w = 1.0f;
          const int li = c_lights.light_of[best];
          if (li >= 0 && prev_pdf > 0.0f) {
            cnt[3] += 1u;
            const float pdf_nee_prev = nee_pdf_toward(o, li, d, prev_n);
            emit_w = prev_pdf / fmaxf(prev_pdf + pdf_nee_prev, EPS_20);
          }
          rad.x = rad.x + tput.x * alb.x * emit_w;
          rad.y = rad.y + tput.y * alb.y * emit_w;
          rad.z = rad.z + tput.z * alb.z * emit_w;
        }
      } else {
        bool emit = facing;
        if constexpr (NEE) {  // hard split: the last vertex counted this light
          emit = emit && !(suppress && c_lights.light_of[best] >= 0);
        }
        if (emit) {
          rad.x = rad.x + tput.x * alb.x;
          rad.y = rad.y + tput.y * alb.y;
          rad.z = rad.z + tput.z * alb.z;
        }
      }
      break;
    }

    const float k2 = 2.0f * dot3(n, d);
    const V3 r = V3{d.x - k2 * n.x, d.y - k2 * n.y, d.z - k2 * n.z};
    const bool glossy = kind == KIND_GLOSSY;
    if constexpr (NEE) {
      // Light sample at matte vertices (and glossy ones under PHYSICAL),
      // below the final depth, whose emission the BSDF walk could still
      // have collected at the next vertex (ops/shade.py:186-298).
      const bool diffuse = kind == KIND_MATTE;
      if (depth < max_depth && (diffuse || (PHYSICAL && glossy))) {
        cnt[1] += 1u;
        float nux, nuy;
        bounce_point(s, root, hash3(pixel_base, SALT_NEE, (uint32_t)depth), depth, &nux, &nuy);
        const float upick = randfloat(s, hash3(pixel_base, SALT_NEEPICK, (uint32_t)depth));
        const LightSample ls = sample_light(p, nux, nuy, upick, n);
        const float cos_s = dot3(n, ls.d);
        float a_sh = 1.0f, inv_a_sh = 1.0f;
        if (!c_scene.unit_d) {
          a_sh = dot3(ls.d, ls.d);
          inv_a_sh = 1.0f / a_sh;
        }
        float t_l;  // the light's own ray-t, by the sweep's sphere rule
        const bool l_valid = sphere_t(p, ls.d, a_sh, inv_a_sh, ls.center.x, ls.center.y,
                                      ls.center.z, ls.radius, false, &t_l);
        if (l_valid && cos_s > 0.0f && !occluded(p, ls.d, a_sh, inv_a_sh, t_l, ls.sidx, best)) {
          cnt[2] += 1u;
          float fac;
          if constexpr (PHYSICAL) {
            // True Lambertian / normalized Phong f·cos, balance-weighted
            // against the vertex's own BSDF density.
            float pdf_b, f_fac;
            if (glossy) {
              cnt[4] += 1u;
              float phong_l, dup_l;
              glossy_lobe(r, n, c_scene.exponent[best], ls.d, &phong_l, &pdf_b, &dup_l);
              f_fac = (c_scene.exponent[best] + 2.0f) * HALF_INV_PI * phong_l;
            } else {
              pdf_b = cos_s * INV_PI;
              f_fac = INV_PI;
            }
            const float w_nee = ls.pdf / fmaxf(ls.pdf + pdf_b, EPS_20);
            fac = f_fac * cos_s * w_nee;
          } else {
            fac = HALF_INV_PI;  // the reference's cosine-free matte: Ω/(2π)
          }
          rad.x = rad.x + tput.x * alb.x * ls.weight.x * fac;
          rad.y = rad.y + tput.y * alb.y * ls.weight.y * fac;
          rad.z = rad.z + tput.z * alb.z * ls.weight.z * fac;
        }
      }
      suppress = diffuse;
    }

    // Scatter (ops/brdf.sample_directions).
    V3 wi;
    if (kind == KIND_REFLECTIVE) {
      wi = r;
    } else {
      float bx, by;
      bounce_point(s, root, hash3(pixel_base, SALT_BOUNCE, (uint32_t)depth), depth, &bx, &by);
      float hx, hy, hz;
      to_unit_hemi(bx, by, glossy ? c_scene.exponent[best] : (PHYSICAL ? 1.0f : 0.0f), &hx, &hy, &hz);
      const V3 w = glossy ? r : n;
      const V3 eps = glossy ? EG_V3 : EM_V3;
      const V3 c = normalize3(cross3(eps, w));
      const V3 c2 = cross3(c, w);
      const V3 f1 = glossy ? c : c2;
      const V3 f2 = glossy ? c2 : c;
      const V3 tan = V3{hx * f1.x + hy * f2.x, hx * f1.y + hy * f2.y, hx * f1.z + hy * f2.z};
      const V3 axial = V3{w.x * hz, w.y * hz, w.z * hz};
      const bool below =
          glossy && dot3(n, V3{tan.x + axial.x, tan.y + axial.y, tan.z + axial.z}) < 0.0f;
      const float sign = below ? -1.0f : 1.0f;
      wi = V3{tan.x * sign + axial.x, tan.y * sign + axial.y, tan.z * sign + axial.z};
    }
    if constexpr (PHYSICAL) {
      // Glossy walk weight f·cos/pdf = (e+2)/(e+1)·cos/(1+dup); matte and
      // mirror weights stay 1. With NEE, the density of wi for MIS.
      const float cos_i = fmaxf(dot3(n, wi), 0.0f);
      float tput_fac = 1.0f, pdf_gi = 0.0f;
      if (glossy) {
        cnt[4] += 1u;
        const float e = c_scene.exponent[best];
        float phong_i, dup_i;
        glossy_lobe(r, n, e, wi, &phong_i, &pdf_gi, &dup_i);
        tput_fac = (e + 2.0f) / (e + 1.0f) * cos_i / (1.0f + dup_i);
      }
      tput = V3{tput.x * alb.x * tput_fac, tput.y * alb.y * tput_fac, tput.z * alb.z * tput_fac};
      if constexpr (NEE) {
        prev_pdf = glossy ? pdf_gi : (kind == KIND_MATTE ? cos_i * INV_PI : 0.0f);
        prev_n = n;
      }
    } else {
      tput = V3{tput.x * alb.x, tput.y * alb.y, tput.z * alb.z};
    }
    o = p;
    d = wi;
    prev = best;
  }
  return rad;
}

// ---- the kernel ----------------------------------------------------------

template <bool STATS, bool NEE, bool PHYSICAL>
__global__ void __launch_bounds__(FLUX_PIXELS_PER_BLOCK * FLUX_SAMPLE_SPLIT)
sweep_megakernel(float* __restrict__ out, uint32_t* __restrict__ counts, int n_pix,
                 int img_w, int img_h, int row0, int row_stride, uint32_t s0,
                 uint32_t n_samples, unsigned long long s_limit, uint32_t seed, uint32_t root,
                 int max_depth) {
  constexpr int NCH = STATS ? 4 : 3;
  constexpr int NCOUNT = (NEE || PHYSICAL) ? FLUX_N_COUNTS : 1;
  __shared__ float part[NCH][FLUX_SAMPLE_SPLIT][FLUX_PIXELS_PER_BLOCK];
  __shared__ uint32_t part_counts[NCOUNT][FLUX_SAMPLE_SPLIT][FLUX_PIXELS_PER_BLOCK];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int pix = blockIdx.x * FLUX_PIXELS_PER_BLOCK + tx;

  V3 acc = V3{0.0f, 0.0f, 0.0f};
  float acc_lum2 = 0.0f;  // STATS: Σ luminance² of the samples
  uint32_t cnt[NCOUNT];
  for (int c = 0; c < NCOUNT; ++c) cnt[c] = 0u;
  if (pix < n_pix) {
    const int row = row0 + (pix / img_w) * row_stride;
    const int col = pix % img_w;
    const uint32_t pixel_base = hash3(seed, (uint32_t)row, (uint32_t)col);
    for (uint32_t k = (uint32_t)ty; k < n_samples; k += FLUX_SAMPLE_SPLIT) {
      const uint32_t s = s0 + k;
      if ((unsigned long long)s >= s_limit) continue;
      const V3 rad = trace_sample<NEE, PHYSICAL>(s, pixel_base, row, col, img_w, img_h, root,
                                                 max_depth, cnt);
      acc.x = acc.x + rad.x;
      acc.y = acc.y + rad.y;
      acc.z = acc.z + rad.z;
      if constexpr (STATS) {
        const float lum = LUM_R * rad.x + LUM_G * rad.y + LUM_B * rad.z;
        acc_lum2 = acc_lum2 + lum * lum;
      }
    }
  }
  part[0][ty][tx] = acc.x;
  part[1][ty][tx] = acc.y;
  part[2][ty][tx] = acc.z;
  if constexpr (STATS) part[3][ty][tx] = acc_lum2;
  for (int c = 0; c < NCOUNT; ++c) part_counts[c][ty][tx] = cnt[c];
  __syncthreads();
  // Fixed-order tree over the split: ((0+1)+(2+3)) + ((4+5)+(6+7)).
  for (int stride = 1; stride < FLUX_SAMPLE_SPLIT; stride *= 2) {
    if (ty % (2 * stride) == 0) {
      for (int ch = 0; ch < NCH; ++ch) part[ch][ty][tx] = part[ch][ty][tx] + part[ch][ty + stride][tx];
      for (int c = 0; c < NCOUNT; ++c) part_counts[c][ty][tx] += part_counts[c][ty + stride][tx];
    }
    __syncthreads();
  }
  if (ty == 0 && pix < n_pix) {
    for (int ch = 0; ch < NCH; ++ch) out[ch * n_pix + pix] = part[ch][0][tx];
    if (counts != nullptr) {
      for (int c = 0; c < NCOUNT; ++c) counts[c * n_pix + pix] = part_counts[c][0][tx];
    }
  }
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
