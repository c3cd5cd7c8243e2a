// The path tracer shared by the CUDA megakernels, for NVIDIA Hopper (sm_90a):
// counter-based sampling, the thin-lens camera, the sphere, plane and
// triangle tests, next-event estimation over sphere and triangle lights,
// shading and scattering, and the per-pixel radiance sum. It is everything
// of flux_tpu/ops/pallas_kernel.py::_kernel but the loop over the shapes,
// which each kernel supplies as a geometry policy:
//   sweep_megakernel.cu  every sphere and plane from __constant__ memory
//                        (K1-K4; at most 64 spheres, no triangles);
//   scene_megakernel.cu  Morton-sorted block tables in device memory with an
//                        AABB skip (K5 scan, K6 triangle fold, K7 triangle
//                        lights; no cap on the tables' size).
//
// A geometry policy G has
//   typename G::Lights            the light set's accessors (below);
//   G::N_COUNTS                   work counters per pixel with NEE or PHYSICAL;
//   void stage(tid, n_threads)    copies what the block reads with a per-lane
//                                 index into shared memory (before a barrier);
//   bool nearest(o, d, a, inv_a, prev, Hit*, cnt)   the nearest hit;
//   bool occluded(o, d, a, inv_a, t_max, exclude, origin, cnt)   any hit in
//                                 (T_MIN, t_max) but by `exclude`;
//   int light_of(shape)           the light index of a shape, -1 if none;
//   Lights lights().
// `cnt` is a Counters<COUNT, N>: the work counters exist only in the
// counting instantiations (COUNT), so a timed launch carries none.
// A light policy L has n(), cdf(k), pick(k), center(k) (x, y, z, radius),
// emit(k), shape_idx(k) and, where L::TRI, has_tris(), is_tri(k), tri_v0(k),
// tri_e1(k), tri_e2(k), tri_n(k) (x, y, z, area).
//
// Every floating-point operation follows the plain PyTorch version
// (flux_tpu_torch/render.py::render_block) in the same order. Build flags
// (flux_tpu_torch/ops/build.py): no fast math, no flush-to-zero, IEEE
// division and square root, so NaN and inf reject degenerate planes and
// triangles, NaN padding never tests valid, and the sample-point divisions
// are correctly rounded; --fmad=false keeps the arithmetic op-by-op equal to
// the plain version.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define FLUX_MAX_SPHERES 64
#define FLUX_MAX_PLANES 16
#define FLUX_MAX_SHAPES (FLUX_MAX_SPHERES + FLUX_MAX_PLANES)
// A block is FLUX_BLOCK_THREADS threads: (256 / split) pixels × split
// threads per pixel, split one of 8, 16, 32, chosen per launch by the host
// (ops/sweep_kernel.py::launch_plan).
#define FLUX_BLOCK_THREADS 256
// The sampler rows are sized for max_depth; the wrappers refuse a deeper one.
#define FLUX_MAX_DEPTH 32
// Work counters per pixel (see bounce): bounces, light samples,
// unoccluded shadow rays, MIS reverse densities, glossy lobe evaluations.
// A geometry policy may count more behind these.
#define FLUX_N_COUNTS 5

#define KIND_MATTE 0
#define KIND_EMISSIVE 1
#define KIND_REFLECTIVE 2
#define KIND_GLOSSY 3

// Scene and camera constants; mirrored by flux_tpu_torch/ops/sweep_kernel.py
// (FluxScene), which checks the size at load time. The scene megakernel in
// scan mode leaves the sphere arrays empty (n_spheres 0) and keeps the planes'
// material rows from row 0.
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

__constant__ FluxScene c_scene;

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
// A triangle light's shadow ray stops this hair short: float32(1 - 1e-4).
#define TRI_SHADOW_SHRINK 0x1.fff2e4p-1f
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

// A pixel's sampler row: every hash of its sample streams that does not
// depend on the sample index, computed once per pixel (render_pixels keeps
// the rows in shared memory). A pattern takes four words, its id hashed
// with SALT_PX, SALT_PY, SALT_JX and SALT_JY (patterns.py): CMJ permutes by
// the first two, uncorrelated MJ hashes the cell index into them, and both
// jitter by the last two. Words [0, 4) are the AA pattern's, [4, 8) the
// lens pattern's; then for each depth 1..max_depth the bounce pattern's
// four and, with NEE, the light-sample pattern's four and the light pick's
// stream id. The row's length is odd, so that the lanes of a warp, each on
// its own pixel's row, read distinct banks.
#define ROW_AA 0
#define ROW_LENS 4
#define ROW_DEPTH0 8
#define ROW_NEE 4  // within a depth's words
#define ROW_PICK 8

__host__ __device__ constexpr int row_per_depth(bool nee) { return nee ? 9 : 4; }

__host__ __device__ inline int row_words(bool nee, int max_depth) {
  return (ROW_DEPTH0 + row_per_depth(nee) * max_depth) | 1;
}

__device__ __forceinline__ uint32_t pattern_salt(int k) {
  return k == 0 ? SALT_PX : k == 1 ? SALT_PY : k == 2 ? SALT_JX : SALT_JY;
}

// Word w of the row of the pixel whose stream id is pixel_base.
template <bool NEE>
__device__ __forceinline__ uint32_t sampler_word(uint32_t pixel_base, int w) {
  if (w < ROW_DEPTH0) {
    return hash2(hash2(pixel_base, w < ROW_LENS ? SALT_AA : SALT_LENS), pattern_salt(w & 3));
  }
  constexpr int per = row_per_depth(NEE);
  const uint32_t depth = (uint32_t)((w - ROW_DEPTH0) / per + 1);
  const int k = (w - ROW_DEPTH0) % per;
  if (k == ROW_PICK) return hash3(pixel_base, SALT_NEEPICK, depth);
  return hash2(hash3(pixel_base, k < ROW_NEE ? SALT_BOUNCE : SALT_NEE, depth), pattern_salt(k & 3));
}

// MJ (correlated = false) or CMJ (correlated = true) sample s of root²,
// in cell (i, j), from its pattern's four row words w.
__device__ __forceinline__ void multi_jitter(uint32_t s, uint32_t i, uint32_t j, uint32_t root,
                                             const uint32_t* w, bool correlated, float* x, float* y) {
  const float rf = (float)(int)root;
  float fine_x, fine_y;
  if ((root & (root - 1u)) == 0u) {
    uint32_t px = w[0], py = w[1];
    if (!correlated) {
      px = hc_step(px, i);  // hash3(pattern, SALT_PX, i)
      py = hc_step(py, j);
    }
    fine_x = (float)(int)permute_pow2(j, root, px);
    fine_y = (float)(int)permute_pow2(i, root, py);
  } else {
    fine_x = (float)(int)j;
    fine_y = (float)(int)((root - 1u) - i);
  }
  const float jx = randfloat(s, w[2]);
  const float jy = randfloat(s, w[3]);
  *x = ((float)(int)i + (fine_x + jx) / rf) / rf;
  *y = ((float)(int)j + (fine_y + jy) / rf) / rf;
}

__device__ __forceinline__ void jittered(uint32_t s, uint32_t i, uint32_t j, uint32_t root,
                                         const uint32_t* w, float* x, float* y) {
  const float rf = (float)(int)root;
  const float jx = randfloat(s, w[2]);
  const float jy = randfloat(s, w[3]);
  *x = ((float)(int)i + jx) / rf;
  *y = ((float)(int)j + jy) / rf;
}

// patterns.bounce_point: MJ at the first bounce, jittered beyond.
__device__ __forceinline__ void bounce_point(uint32_t s, uint32_t i, uint32_t j, uint32_t root,
                                             const uint32_t* w, int depth, float* x, float* y) {
  if (depth <= 1) {
    multi_jitter(s, i, j, root, w, false, x, y);
  } else {
    jittered(s, i, j, root, w, x, y);
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

// The sweep over the spheres of the __constant__ scene record: the nearest
// hit, ties to the lowest index (strict < in order). `prev` is the sphere
// the ray starts on. Updates (best_t, best).
__device__ __forceinline__ void sweep_spheres_nearest(V3 o, V3 d, float a, float inv_a, int prev,
                                                      float* best_t, int* best) {
  const int ns = c_scene.n_spheres;
  for (int i = 0; i < ns; ++i) {
    float t;
    if (sphere_t(o, d, a, inv_a, c_scene.sph[i][0], c_scene.sph[i][1], c_scene.sph[i][2],
                 c_scene.sph[i][3], prev == i, &t) &&
        t < *best_t) {
      *best_t = t;
      *best = i;
    }
  }
}

// Its any-hit form: does a sphere other than `exclude` cross (o, d) at
// T_MIN < t < t_max? The ray starts on `origin`. Stops at the first one.
__device__ __forceinline__ bool sweep_spheres_occluded(V3 o, V3 d, float a, float inv_a,
                                                       float t_max, int exclude, int origin) {
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
  return false;
}

// Möller–Trumbore (intersect.triangle_t). No epsilon guard on the
// determinant: a degenerate one makes inv huge or ±inf and every acceptance
// fails arithmetically; a NaN v0 (padding) fails every comparison. Writes t;
// returns whether the triangle is hit at t > T_MIN.
__device__ __forceinline__ bool triangle_t(V3 o, V3 d, V3 v0, V3 e1, V3 e2, float* t_out) {
  const float px = d.y * e2.z - d.z * e2.y;
  const float py = d.z * e2.x - d.x * e2.z;
  const float pz = d.x * e2.y - d.y * e2.x;
  const float det = e1.x * px + e1.y * py + e1.z * pz;
  const float inv = 1.0f / det;
  const float sx = o.x - v0.x, sy = o.y - v0.y, sz = o.z - v0.z;
  const float u = (sx * px + sy * py + sz * pz) * inv;
  const float qx = sy * e1.z - sz * e1.y;
  const float qy = sz * e1.x - sx * e1.z;
  const float qz = sx * e1.y - sy * e1.x;
  const float v = (d.x * qx + d.y * qy + d.z * qz) * inv;
  const float t = (e2.x * qx + e2.y * qy + e2.z * qz) * inv;
  *t_out = t;
  return u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > T_MIN;
}

// The nearest hit with the winner's material (intersect.Hit).
struct Hit {
  float t;
  int shape;  // spheres, then planes, then triangles
  V3 p;  // o + t·d
  V3 n;  // unit for spheres and triangles; planes as authored
  int kind;
  V3 alb;  // color × param
  float exponent;
};

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
  V3 center;  // the picked light's center and radius (sphere lights)
  float radius;
  int sidx;  // its shape index
  bool tri;  // a triangle light was picked
  float tri_t;  // ray-t of the sampled triangle point
};

// nee.sample_light_dirs with the horizon clip about `nrm`: a sphere light by
// its cone, a triangle light by a uniform point of its area.
template <class LT>
__device__ __forceinline__ LightSample sample_light(const LT& lt, V3 p, float ux, float uy,
                                                    float upick, V3 nrm) {
  int li = 0;  // the last k with upick >= cdf[k]
  const int nl = lt.n();
  for (int k = 1; k < nl; ++k) {
    if (upick >= lt.cdf(k)) li = k;
  }
  const float4 emit = lt.emit(li);
  const float pick = lt.pick(li);
  LightSample ls;
  ls.sidx = lt.shape_idx(li);
  ls.tri = false;
  ls.tri_t = 0.0f;
  if constexpr (LT::TRI) {
    if (lt.has_tris() && lt.is_tri(li)) {
      // Uniform point on the triangle, the barycentric fold of (ux, uy);
      // density pick·r²/(A·cosθ_l), zero weight from behind.
      const float4 tv = lt.tri_v0(li), t1 = lt.tri_e1(li), t2 = lt.tri_e2(li), tn = lt.tri_n(li);
      const float area = tn.w;
      const bool flip = ux + uy > 1.0f;
      const float uu = flip ? 1.0f - ux : ux;
      const float vv = flip ? 1.0f - uy : uy;
      const float qx = tv.x + uu * t1.x + vv * t2.x;
      const float qy = tv.y + uu * t1.y + vv * t2.y;
      const float qz = tv.z + uu * t1.z + vv * t2.z;
      const float dvx = qx - p.x, dvy = qy - p.y, dvz = qz - p.z;
      const float r2 = fmaxf(dvx * dvx + dvy * dvy + dvz * dvz, EPS_12);
      const float r = sqrtf(r2);
      const float inv_r = 1.0f / r;
      ls.d = V3{dvx * inv_r, dvy * inv_r, dvz * inv_r};
      const float cos_l = -(tn.x * ls.d.x + tn.y * ls.d.y + tn.z * ls.d.z);
      const float wgt = area * fmaxf(cos_l, 0.0f) / (fmaxf(pick, EPS_12) * r2);
      ls.weight = V3{emit.x * wgt, emit.y * wgt, emit.z * wgt};
      ls.pdf = cos_l > 0.0f ? pick * r2 / fmaxf(area * cos_l, EPS_12) : 0.0f;
      ls.center = V3{0.0f, 0.0f, 0.0f};
      ls.radius = 0.0f;
      ls.tri = true;
      ls.tri_t = r;
      return ls;
    }
  }
  const float4 cr = lt.center(li);
  const V3 ctr = V3{cr.x, cr.y, cr.z};
  const float rad = cr.w;
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
  ls.d = V3{sin_a * (cp * u.x + sp * v.x) + cos_a * w.x, sin_a * (cp * u.y + sp * v.y) + cos_a * w.y,
            sin_a * (cp * u.z + sp * v.z) + cos_a * w.z};
  float wgt = TWO_PI * (1.0f - cos_max) / fmaxf(pick, EPS_12);
  wgt = inside ? 0.0f : wgt;
  wgt = wgt * arc_frac;
  ls.weight = V3{emit.x * wgt, emit.y * wgt, emit.z * wgt};
  ls.pdf = 1.0f / fmaxf(wgt, EPS_20);
  ls.center = ctr;
  ls.radius = rad;
  return ls;
}

// nee.nee_pdf_toward for light k from p along d (hit at distance t), clipped
// about `nrm`: the MIS reverse density, rebuilt with the sampler's own frame
// and arc; for a triangle light pick·t²/(A·cosθ_l), 0 from behind.
template <class LT>
__device__ __forceinline__ float nee_pdf_toward(const LT& lt, V3 p, int k, V3 d, float t, V3 nrm) {
  if constexpr (LT::TRI) {
    if (lt.has_tris() && lt.is_tri(k)) {
      const float4 tn = lt.tri_n(k);
      const float cos_l = -(tn.x * d.x + tn.y * d.y + tn.z * d.z);
      const float pdf = lt.pick(k) * t * t / fmaxf(tn.w * cos_l, EPS_12);
      return cos_l > 0.0f ? pdf : 0.0f;
    }
  }
  const float4 cr = lt.center(k);
  const float dcx = cr.x - p.x;
  const float dcy = cr.y - p.y;
  const float dcz = cr.z - p.z;
  const float dist2 = dcx * dcx + dcy * dcy + dcz * dcz;
  const float r = cr.w;
  const float sin2 = clip01(r * r / fmaxf(dist2, EPS_12), 0.0f, 1.0f);
  const float cos_max = sqrtf(fmaxf(1.0f - sin2, 0.0f));
  const float omega = TWO_PI * (1.0f - cos_max);
  float pdf = lt.pick(k) / fmaxf(omega, EPS_20);
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

// ---- per-lane rows in shared memory ---------------------------------------

// The __constant__ scene's per-shape rows that a hit reads with a per-lane
// index (the hit's shape), staged into shared memory once per block: the
// constant cache serves one address per pass, so a warp whose lanes hit
// different shapes would wait there once per distinct shape. Numbered as in
// c_scene: spheres (center, invert / radius), then planes (normal, 0).
struct ShapeRows {
  float4 geo[FLUX_MAX_SHAPES];
  float4 mat[FLUX_MAX_SHAPES];  // albedo (color × param), exponent
  int kind[FLUX_MAX_SHAPES];
};

__device__ __forceinline__ ShapeRows* shape_rows() {
  __shared__ ShapeRows rows;
  return &rows;
}

__device__ __forceinline__ void stage_shape_rows(ShapeRows* r, int tid, int n_threads) {
  const int ns = c_scene.n_spheres;
  const int n = ns + c_scene.n_planes;
  for (int k = tid; k < n; k += n_threads) {
    if (k < ns) {
      r->geo[k] = make_float4(c_scene.sph[k][0], c_scene.sph[k][1], c_scene.sph[k][2],
                              c_scene.sph_invert[k] / c_scene.sph[k][3]);
    } else {
      const int j = k - ns;
      r->geo[k] = make_float4(c_scene.pl_normal[j][0], c_scene.pl_normal[j][1], c_scene.pl_normal[j][2], 0.0f);
    }
    r->mat[k] = make_float4(c_scene.alb[k][0], c_scene.alb[k][1], c_scene.alb[k][2], c_scene.exponent[k]);
    r->kind[k] = c_scene.kind[k];
  }
}

// The normal and material of a hit on shape k of c_scene at point p: a
// sphere's normal (p - c)·invert/r, a plane's as authored.
__device__ __forceinline__ void hit_from_rows(const ShapeRows* r, int k, bool sphere, V3 p, Hit* h) {
  const float4 g = r->geo[k];
  h->n = sphere ? V3{(p.x - g.x) * g.w, (p.y - g.y) * g.w, (p.z - g.z) * g.w} : V3{g.x, g.y, g.z};
  const float4 m = r->mat[k];
  h->alb = V3{m.x, m.y, m.z};
  h->exponent = m.w;
  h->kind = r->kind[k];
}

// ---- work counters --------------------------------------------------------

// Per-thread work counters: N of them with COUNT, none at all without.
template <bool COUNT, int N>
struct Counters {
  static constexpr bool ON = true;
  uint32_t c[N];
  __device__ __forceinline__ Counters() {
    for (int k = 0; k < N; ++k) c[k] = 0u;
  }
  __device__ __forceinline__ void add(int k, uint32_t v) { c[k] += v; }
};

template <int N>
struct Counters<false, N> {
  static constexpr bool ON = false;
  __device__ __forceinline__ void add(int, uint32_t) {}
};

// ---- one sample's path -----------------------------------------------------

// The state of one sample's path between bounces.
struct Path {
  V3 o, d;  // the ray
  V3 tput;  // throughput
  V3 rad;  // radiance gathered so far
  uint32_t s;  // the sample index
  int depth;  // the next bounce, 1..max_depth
  int prev;  // shape the ray originates on
  bool suppress;  // NEE: the last vertex sampled a light (hard split)
  float prev_pdf;  // NEE + PHYSICAL: density that sampled this ray
  V3 prev_n;  // NEE + PHYSICAL: the last vertex's normal
};

// Sample s of the pixel (row y, col): its thin-lens primary ray
// (camera.primary_rays), from the CMJ anti-aliasing and lens points.
__device__ __forceinline__ void start_path(Path& ph, const uint32_t* row, uint32_t s, uint32_t root, int y,
                                           int col, int img_w, int img_h) {
  const uint32_t i = s % root, j = s / root;
  float ax, ay, ux, uy, lx, ly;
  multi_jitter(s, i, j, root, row + ROW_AA, true, &ax, &ay);
  multi_jitter(s, i, j, root, row + ROW_LENS, true, &ux, &uy);
  to_poisson_disc(ux, uy, &lx, &ly);

  const float half_w = (float)img_w * 0.5f;
  const float half_h = (float)img_h * 0.5f;
  const float adj = c_scene.adjusted_pixel_size;
  const float px = adj * (((float)col - half_w) + ax);
  const float py = adj * ((((float)img_h - (float)y) - half_h) + ay);
  const float lpx = lx * c_scene.lens_radius;
  const float lpy = ly * c_scene.lens_radius;
  const float dxv = px * c_scene.vp_factor - lpx;
  const float dyv = py * c_scene.vp_factor - lpy;
  const V3 fw = V3{c_scene.focal_distance * c_scene.w[0], c_scene.focal_distance * c_scene.w[1],
                   c_scene.focal_distance * c_scene.w[2]};
  ph.d = normalize3(V3{dxv * c_scene.u[0] + dyv * c_scene.v[0] - fw.x,
                       dxv * c_scene.u[1] + dyv * c_scene.v[1] - fw.y,
                       dxv * c_scene.u[2] + dyv * c_scene.v[2] - fw.z});
  ph.o = V3{c_scene.eye[0] + lpx * c_scene.u[0] + lpy * c_scene.v[0],
            c_scene.eye[1] + lpx * c_scene.u[1] + lpy * c_scene.v[1],
            c_scene.eye[2] + lpx * c_scene.u[2] + lpy * c_scene.v[2]};
  ph.tput = V3{1.0f, 1.0f, 1.0f};
  ph.rad = V3{0.0f, 0.0f, 0.0f};
  ph.s = s;
  ph.depth = 1;
  ph.prev = -1;
  ph.suppress = false;
  ph.prev_pdf = 0.0f;
  ph.prev_n = V3{0.0f, 0.0f, 0.0f};
}

// Bounce ph.depth of the path: its hit, emission, light sample and scatter.
// Returns whether the path has ended (a miss, an emitter, or the last
// depth). Adds to the work counters cnt: [0] bounces and, with NEE or
// PHYSICAL, [1] light samples, [2] unoccluded shadow rays (each swept every
// other shape), [3] MIS reverse densities, [4] glossy lobe evaluations. The
// geometry policy `g` finds the hits and may count its own work behind these.
template <bool NEE, bool PHYSICAL, class G, class C>
__device__ __forceinline__ bool bounce(const G& g, Path& ph, const uint32_t* row, uint32_t root, int max_depth,
                                       C& cnt) {
  const int depth = ph.depth;
  const V3 d = ph.d;
  cnt.add(0, 1u);
  float a = 1.0f, inv_a = 1.0f;
  if (!c_scene.unit_d) {
    a = d.x * d.x + d.y * d.y + d.z * d.z;
    inv_a = 1.0f / a;
  }
  Hit h;
  if (!g.nearest(ph.o, d, a, inv_a, ph.prev, &h, cnt)) {  // miss: background (scene.rs:168)
    ph.rad.x = ph.rad.x + ph.tput.x * c_scene.bg[0];
    ph.rad.y = ph.rad.y + ph.tput.y * c_scene.bg[1];
    ph.rad.z = ph.rad.z + ph.tput.z * c_scene.bg[2];
    return true;
  }
  const V3 p = h.p;
  const V3 n = h.n;
  const int best = h.shape;
  const int kind = h.kind;
  const V3 alb = h.alb;
  const V3 tput = ph.tput;
  if (kind == KIND_EMISSIVE) {  // emit toward rays it faces, then stop
    const bool facing = dot3(n, d) < 0.0f;
    if constexpr (NEE && PHYSICAL) {
      if (facing) {
        // MIS: a BSDF hit of an NEE light weighs pdf_b / (pdf_b + pdf_nee).
        float emit_w = 1.0f;
        const int li = g.light_of(best);
        if (li >= 0 && ph.prev_pdf > 0.0f) {
          cnt.add(3, 1u);
          const float pdf_nee_prev = nee_pdf_toward(g.lights(), ph.o, li, d, h.t, ph.prev_n);
          emit_w = ph.prev_pdf / fmaxf(ph.prev_pdf + pdf_nee_prev, EPS_20);
        }
        ph.rad.x = ph.rad.x + tput.x * alb.x * emit_w;
        ph.rad.y = ph.rad.y + tput.y * alb.y * emit_w;
        ph.rad.z = ph.rad.z + tput.z * alb.z * emit_w;
      }
    } else {
      bool emit = facing;
      if constexpr (NEE) {  // hard split: the last vertex counted this light
        emit = emit && !(ph.suppress && g.light_of(best) >= 0);
      }
      if (emit) {
        ph.rad.x = ph.rad.x + tput.x * alb.x;
        ph.rad.y = ph.rad.y + tput.y * alb.y;
        ph.rad.z = ph.rad.z + tput.z * alb.z;
      }
    }
    return true;
  }

  const uint32_t s = ph.s;
  const uint32_t i = s % root, j = s / root;
  const uint32_t* w = row + ROW_DEPTH0 + (depth - 1) * row_per_depth(NEE);  // this depth's words
  const float k2 = 2.0f * dot3(n, d);
  const V3 r = V3{d.x - k2 * n.x, d.y - k2 * n.y, d.z - k2 * n.z};
  const bool glossy = kind == KIND_GLOSSY;
  if constexpr (NEE) {
    // Light sample at matte vertices (and glossy ones under PHYSICAL),
    // below the final depth, whose emission the BSDF walk could still
    // have collected at the next vertex (ops/shade.py:186-298).
    const bool diffuse = kind == KIND_MATTE;
    if (depth < max_depth && (diffuse || (PHYSICAL && glossy))) {
      cnt.add(1, 1u);
      float nux, nuy;
      bounce_point(s, i, j, root, w + ROW_NEE, depth, &nux, &nuy);
      const float upick = randfloat(s, w[ROW_PICK]);
      const LightSample ls = sample_light(g.lights(), p, nux, nuy, upick, n);
      const float cos_s = dot3(n, ls.d);
      float a_sh = 1.0f, inv_a_sh = 1.0f;
      if (!c_scene.unit_d) {
        a_sh = dot3(ls.d, ls.d);
        inv_a_sh = 1.0f / a_sh;
      }
      float t_l;  // the light's own ray-t, by the sweep's sphere rule
      bool l_valid = sphere_t(p, ls.d, a_sh, inv_a_sh, ls.center.x, ls.center.y,
                              ls.center.z, ls.radius, false, &t_l);
      float t_sh = t_l;  // the shadow ray's far end
      if constexpr (G::Lights::TRI) {
        if (ls.tri) {  // the sampled point's own t, shrunk on triangle lanes only
          t_l = ls.tri_t;
          l_valid = t_l > T_MIN;
          t_sh = t_l * TRI_SHADOW_SHRINK;
        }
      }
      if (l_valid && cos_s > 0.0f && !g.occluded(p, ls.d, a_sh, inv_a_sh, t_sh, ls.sidx, best, cnt)) {
        cnt.add(2, 1u);
        float fac;
        if constexpr (PHYSICAL) {
          // True Lambertian / normalized Phong f·cos, balance-weighted
          // against the vertex's own BSDF density.
          float pdf_b, f_fac;
          if (glossy) {
            cnt.add(4, 1u);
            float phong_l, dup_l;
            glossy_lobe(r, n, h.exponent, ls.d, &phong_l, &pdf_b, &dup_l);
            f_fac = (h.exponent + 2.0f) * HALF_INV_PI * phong_l;
          } else {
            pdf_b = cos_s * INV_PI;
            f_fac = INV_PI;
          }
          const float w_nee = ls.pdf / fmaxf(ls.pdf + pdf_b, EPS_20);
          fac = f_fac * cos_s * w_nee;
        } else {
          fac = HALF_INV_PI;  // the reference's cosine-free matte: Ω/(2π)
        }
        ph.rad.x = ph.rad.x + tput.x * alb.x * ls.weight.x * fac;
        ph.rad.y = ph.rad.y + tput.y * alb.y * ls.weight.y * fac;
        ph.rad.z = ph.rad.z + tput.z * alb.z * ls.weight.z * fac;
      }
    }
    ph.suppress = diffuse;
  }

  // Scatter (ops/brdf.sample_directions).
  V3 wi;
  if (kind == KIND_REFLECTIVE) {
    wi = r;
  } else {
    float bx, by;
    bounce_point(s, i, j, root, w, depth, &bx, &by);
    float hx, hy, hz;
    to_unit_hemi(bx, by, glossy ? h.exponent : (PHYSICAL ? 1.0f : 0.0f), &hx, &hy, &hz);
    const V3 wv = glossy ? r : n;
    const V3 eps = glossy ? EG_V3 : EM_V3;
    const V3 c = normalize3(cross3(eps, wv));
    const V3 c2 = cross3(c, wv);
    const V3 f1 = glossy ? c : c2;
    const V3 f2 = glossy ? c2 : c;
    const V3 tan = V3{hx * f1.x + hy * f2.x, hx * f1.y + hy * f2.y, hx * f1.z + hy * f2.z};
    const V3 axial = V3{wv.x * hz, wv.y * hz, wv.z * hz};
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
      cnt.add(4, 1u);
      const float e = h.exponent;
      float phong_i, dup_i;
      glossy_lobe(r, n, e, wi, &phong_i, &pdf_gi, &dup_i);
      tput_fac = (e + 2.0f) / (e + 1.0f) * cos_i / (1.0f + dup_i);
    }
    ph.tput = V3{tput.x * alb.x * tput_fac, tput.y * alb.y * tput_fac, tput.z * alb.z * tput_fac};
    if constexpr (NEE) {
      ph.prev_pdf = glossy ? pdf_gi : (kind == KIND_MATTE ? cos_i * INV_PI : 0.0f);
      ph.prev_n = n;
    }
  } else {
    ph.tput = V3{tput.x * alb.x, tput.y * alb.y, tput.z * alb.z};
  }
  ph.o = p;
  ph.d = wi;
  ph.prev = best;
  ph.depth = depth + 1;
  return depth >= max_depth;
}

// ---- a band's radiance sums ---------------------------------------------

// The body of a megakernel: a block of FLUX_BLOCK_THREADS threads,
// blockDim (256 / split, split), one block per 256 / split pixels of the
// band. The `split` threads of a pixel first write its sampler row into
// dynamic shared memory, the geometry policy stages its per-lane rows, and
// one barrier follows. A thread then traces every split-th sample of its
// pixel in index order, each until its path ends (a lane whose path dies
// leaves the bounce loop; regenerating paths in its place measured twice as
// slow on an NVIDIA H100 80GB HBM3 at 700 W: its warps then run the primary
// ray and a bounce in every iteration). Radiance (and Σ luminance²) is summed per pixel in a fixed
// order (each thread's samples in index order, then a fixed tree over the
// split in shared memory), with no float atomics, so the result is
// bit-identical from run to run for a given split. Nothing between the two
// barriers synchronises, so every thread reaches the second.
template <bool STATS, bool NEE, bool PHYSICAL, bool COUNT, class G>
__device__ __forceinline__ void render_pixels(const G& g, float* __restrict__ out,
                                              uint32_t* __restrict__ counts, int n_pix, int img_w,
                                              int img_h, int row0, int row_stride, uint32_t s0,
                                              uint32_t n_samples, unsigned long long s_limit,
                                              uint32_t seed, uint32_t root, int max_depth) {
  constexpr int NCH = STATS ? 4 : 3;
  // Bounces only for K1 and K2; a policy with counters of its own keeps all.
  constexpr int NCOUNT = (NEE || PHYSICAL || G::N_COUNTS > FLUX_N_COUNTS) ? G::N_COUNTS : 1;
  extern __shared__ uint32_t flux_rows[];  // a sampler row per pixel of the block
  __shared__ float part[NCH][FLUX_BLOCK_THREADS];
  const int n_px = blockDim.x;  // pixels of the block
  const int split = blockDim.y;  // threads per pixel
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * n_px + tx;
  const int pix = blockIdx.x * n_px + tx;
  const int words = row_words(NEE, max_depth);
  uint32_t* row = flux_rows + tx * words;

  int y = 0, col = 0;
  if (pix < n_pix) {
    y = row0 + (pix / img_w) * row_stride;
    col = pix % img_w;
    const uint32_t pixel_base = hash3(seed, (uint32_t)y, (uint32_t)col);
    const int used = ROW_DEPTH0 + row_per_depth(NEE) * max_depth;
    for (int w = ty; w < used; w += split) row[w] = sampler_word<NEE>(pixel_base, w);
  }
  g.stage(tid, FLUX_BLOCK_THREADS);
  __syncthreads();

  V3 acc = V3{0.0f, 0.0f, 0.0f};
  float acc_lum2 = 0.0f;  // STATS: Σ luminance² of the samples
  Counters<COUNT, NCOUNT> cnt;
  if (pix < n_pix) {
    for (uint32_t k = (uint32_t)ty; k < n_samples; k += (uint32_t)split) {
      const uint32_t s = s0 + k;
      if ((unsigned long long)s >= s_limit) continue;
      Path ph;
      start_path(ph, row, s, root, y, col, img_w, img_h);
      while (!(ph.depth > max_depth || bounce<NEE, PHYSICAL>(g, ph, row, root, max_depth, cnt))) {
      }
      acc.x = acc.x + ph.rad.x;
      acc.y = acc.y + ph.rad.y;
      acc.z = acc.z + ph.rad.z;
      if constexpr (STATS) {
        const float lum = LUM_R * ph.rad.x + LUM_G * ph.rad.y + LUM_B * ph.rad.z;
        acc_lum2 = acc_lum2 + lum * lum;
      }
    }
  }
  part[0][tid] = acc.x;
  part[1][tid] = acc.y;
  part[2][tid] = acc.z;
  if constexpr (STATS) part[3][tid] = acc_lum2;
  __syncthreads();
  // Fixed-order tree over the split: ((0+1)+(2+3)) + ((4+5)+(6+7)) for 8.
  for (int stride = 1; stride < split; stride *= 2) {
    if (ty % (2 * stride) == 0) {
      for (int ch = 0; ch < NCH; ++ch) part[ch][tid] = part[ch][tid] + part[ch][tid + stride * n_px];
    }
    __syncthreads();
  }
  if (ty == 0 && pix < n_pix) {
    for (int ch = 0; ch < NCH; ++ch) out[ch * n_pix + pix] = part[ch][tx];
  }
  if constexpr (COUNT) {
    // The counters' own tree, NCH at a time in the same shared memory.
    uint32_t* pc = reinterpret_cast<uint32_t*>(&part[0][0]);
#pragma unroll
    for (int c = 0; c < NCOUNT; c += NCH) {
      __syncthreads();
#pragma unroll
      for (int ch = 0; ch < NCH && c + ch < NCOUNT; ++ch) pc[ch * FLUX_BLOCK_THREADS + tid] = cnt.c[c + ch];
      __syncthreads();
      for (int stride = 1; stride < split; stride *= 2) {
        if (ty % (2 * stride) == 0) {
#pragma unroll
          for (int ch = 0; ch < NCH && c + ch < NCOUNT; ++ch) {
            pc[ch * FLUX_BLOCK_THREADS + tid] += pc[ch * FLUX_BLOCK_THREADS + tid + stride * n_px];
          }
        }
        __syncthreads();
      }
      if (ty == 0 && pix < n_pix && counts != nullptr) {
        for (int ch = 0; ch < NCH && c + ch < NCOUNT; ++ch) counts[(c + ch) * n_pix + pix] = pc[ch * FLUX_BLOCK_THREADS + tx];
      }
    }
  }
}
