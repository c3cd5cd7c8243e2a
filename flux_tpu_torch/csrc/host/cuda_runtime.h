// A stand-in for <cuda_runtime.h> that lets a C++ compiler without CUDA
// compile flux_trace.cuh's device functions as host code:
//   g++ -std=c++17 -O2 -ffp-contract=off -I flux_tpu_torch/csrc/host ...
// tests/test_torch_trace_host.py checks the sampler path with it. It
// defines only what the header uses; nothing here runs on a card.
#pragma once

#include <stdint.h>
#include <string.h>

#include <cmath>

using std::isfinite;
using std::isnan;

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
