// Shared helpers for the colorvideovdp_tpu_torch Hopper kernels.
//
// Every entry point has a plain C interface (bound with ctypes), launches on
// the stream it is given, allocates nothing and returns cudaGetLastError().
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define CVVDP_API extern "C" __attribute__((visibility("default")))

// Piecewise-linear castleCSF LUT on a uniform grid: ``ind`` is the clamped
// fractional knot index in [0, nk-1]. The last knot returns its value exactly.
__device__ __forceinline__ float lut_lerp(const float* __restrict__ v, int nk,
                                          float ind) {
  const float f0 = floorf(ind);
  const int i0 = (int)f0;
  if (i0 >= nk - 1) return v[nk - 1];
  const float v0 = v[i0];
  const float v1 = v[i0 + 1];
  return v0 + (ind - f0) * (v1 - v0);
}

__device__ __forceinline__ float lut_index(float logL, float x0, float scale,
                                           int nk) {
  return fminf(fmaxf((logL - x0) * scale, 0.0f), (float)(nk - 1));
}

// x ** p for a run-time exponent that is usually a small constant: the same
// multiply chains as ops/masking.py:_pow_static (a transcendental pow biases
// large pooled sums).
__device__ __forceinline__ float pow_static(float x, float p) {
  if (p == 1.0f) return x;
  if (p == 2.0f) return x * x;
  if (p == 3.0f) return x * x * x;
  if (p == 4.0f) {
    const float x2 = x * x;
    return x2 * x2;
  }
  if (p == 0.5f) return sqrtf(x);
  if (p == 0.25f) return sqrtf(sqrtf(x));
  return powf(x, p);
}

static inline unsigned int ceil_div_u(long long a, long long b) {
  return (unsigned int)((a + b - 1) / b);
}
