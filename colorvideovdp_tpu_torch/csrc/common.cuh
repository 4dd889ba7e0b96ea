// Shared helpers for the colorvideovdp_tpu_torch Hopper kernels.
//
// Every entry point has a plain C interface (bound with ctypes), launches on
// the stream it is given, allocates nothing and returns cudaGetLastError().
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define CVVDP_API extern "C" __attribute__((visibility("default")))

// The kernels round every step as their plain PyTorch versions do, one
// operation at a time (no fused multiply-add), so that a kernel and its plain
// version give the same bits: the loss path's non-smooth steps (the min of
// |T| and |R|, the clips) then take the same branch on both, and their
// gradients agree (chip_smoke.py phase 5).
__device__ __forceinline__ float mul_add_rn(float acc, float a, float b) {
  return __fadd_rn(acc, __fmul_rn(a, b));
}

// Piecewise-linear castleCSF LUT on a uniform grid: ``ind`` is the clamped
// fractional knot index in [0, nk-1]. The last knot returns its value exactly.
__device__ __forceinline__ float lut_lerp(const float* __restrict__ v, int nk,
                                          float ind) {
  const float f0 = floorf(ind);
  const int i0 = (int)f0;
  if (i0 >= nk - 1) return v[nk - 1];
  const float v0 = v[i0];
  const float v1 = v[i0 + 1];
  return mul_add_rn(v0, ind - f0, v1 - v0);
}

// 10 ** v as torch.pow(10.0, v) computes it on the card (powf).
__device__ __forceinline__ float pow10_lut(float v) { return powf(10.0f, v); }

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

// Edge-excluded reflect of ops/blur.py (-1 -> 1, n -> n - 2). It reflects
// once, so it is exact for |overhang| < n; the clamp only keeps a wild index
// inside the plane.
__device__ __forceinline__ int reflect_clamp(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * n - 2 - i;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// The shared-memory tile blur of csrc/blur.cu and stage B of
// csrc/band_masking.cu, so the two blurs cannot drift apart. A block owns the
// TH x TW output tile whose corner is (y0, x0) in an h x w plane.
// tile_blur_vertical loads the tile plus its r-halo, (TH + 2r) x (TW + 2r),
// into `sm` through the reflect, then sums the 2r + 1 vertical taps, in tap
// order, into `tmp` (TH x (TW + 2r)). Every thread of the block must call it;
// it ends with __syncthreads(). tile_blur_vpass is its second half, for a
// caller that has filled `sm` itself. tile_blur_horizontal then sums the
// horizontal taps for tile pixel (y, x). `taps` lies in shared memory.
// With v_reflect false (a halo'd row slab, whose rows above and below the
// owned rows are real neighbour rows) rows are not reflected, only clamped
// into the plane.
template <int TH, int TW>
__device__ __forceinline__ void tile_blur_vpass(int r, const float* taps, const float* sm,
                                                float* tmp) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthr = blockDim.x * blockDim.y;
  const int SW = TW + 2 * r;
  const int ntap = 2 * r + 1;
  for (int idx = tid; idx < TH * SW; idx += nthr) {
    const int y = idx / SW, x = idx % SW;
    float acc = 0.0f;
    for (int k = 0; k < ntap; ++k) acc = mul_add_rn(acc, taps[k], sm[(y + k) * SW + x]);
    tmp[idx] = acc;
  }
  __syncthreads();
}

template <int TH, int TW>
__device__ __forceinline__ void tile_blur_vertical(const float* __restrict__ plane, int h,
                                                   int w, int y0, int x0, int r,
                                                   const float* taps, float* sm,
                                                   float* tmp, bool v_reflect = true) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthr = blockDim.x * blockDim.y;
  const int SW = TW + 2 * r, SH = TH + 2 * r;
  for (int idx = tid; idx < SH * SW; idx += nthr) {
    const int yy = idx / SW, xx = idx % SW;
    const int gy = v_reflect ? reflect_clamp(y0 - r + yy, h) : min(max(y0 - r + yy, 0), h - 1);
    const int gx = reflect_clamp(x0 - r + xx, w);
    sm[idx] = plane[(long long)gy * w + gx];
  }
  __syncthreads();
  tile_blur_vpass<TH, TW>(r, taps, sm, tmp);
}

template <int TW>
__device__ __forceinline__ float tile_blur_horizontal(const float* tmp, int r,
                                                      const float* taps, int y, int x) {
  const int SW = TW + 2 * r;
  float acc = 0.0f;
  for (int j = 0; j < 2 * r + 1; ++j) acc = mul_add_rn(acc, taps[j], tmp[y * SW + x + j]);
  return acc;
}

// Asynchronous global -> shared copies (Ampere's cp.async, on Hopper too):
// 16 bytes (both addresses 16-byte aligned) or 4 bytes, one commit group per
// cp_async_commit; cp_async_wait<N> waits until at most N of the calling
// thread's groups are pending (a __syncthreads() then makes every thread's
// copies visible).
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

static inline unsigned int ceil_div_u(long long a, long long b) {
  return (unsigned int)((a + b - 1) / b);
}
