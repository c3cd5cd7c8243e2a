// A stand-in for <cuda_runtime.h> that lets a C++ compiler without CUDA
// compile flux_trace.cuh's device functions as host code:
//   g++ -std=c++17 -O2 -ffp-contract=off -I flux_tpu_torch/csrc/host ...
// tests/test_torch_trace_host.py checks the sampler path with it,
// tests/test_torch_nee_host.py the sweep of a scatter and a shadow ray,
// tests/test_torch_scan_host.py the walk of scan_walk.cuh, and
// tests/test_torch_tri_host.py and tests/test_torch_tri_walk_host.py the
// triangle folds of scene_geom.cuh. It defines only what the headers use;
// nothing here runs on a card.
#pragma once

#include <stdint.h>
#include <string.h>

#include <algorithm>
#include <cmath>

using std::isfinite;
using std::isnan;
using std::max;
using std::min;
using std::signbit;

#define __host__
#define __device__
#define __global__
#define __forceinline__ inline
#define __constant__
#define __shared__ thread_local
#define __launch_bounds__(...)

struct float4 {
  float x, y, z, w;
};

inline float4 make_float4(float x, float y, float z, float w) { return float4{x, y, z, w}; }

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};

inline thread_local dim3 threadIdx, blockIdx, blockDim;

inline void __syncthreads() {}

inline float __int_as_float(int i) {
  float f;
  memcpy(&f, &i, sizeof f);
  return f;
}

inline int __float_as_int(float f) {
  int i;
  memcpy(&i, &f, sizeof i);
  return i;
}

template <class T>
inline T __ldg(const T* p) {
  return *p;
}

inline float rsqrtf(float x) { return 1.0f / sqrtf(x); }

inline long long clock64() { return 0; }

// A warp of one lane.
inline unsigned __activemask() { return 1u; }
inline bool __any_sync(unsigned, bool p) { return p; }
inline bool __all_sync(unsigned, bool p) { return p; }
inline unsigned __ballot_sync(unsigned, bool p) { return p ? 1u : 0u; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(int x) { return __builtin_ffs(x); }
