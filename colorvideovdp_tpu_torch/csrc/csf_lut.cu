// castleCSF LUT lookup S_c = 10 ** lerp(lut_c, logL) for up to four
// channels, and its derivative.
//
// Replaces colorvideovdp_tpu/ops/kernels/csf_lut.py `_make_lookup`: the
// forward (`_fwd_kernel`) in both its routes, the natural (H, W) tiling of a
// band's full log-luminance field (`_forward_natural`) and the padded 2-D
// slab of any shape; and the backward (`_bwd_kernel`), the analytic
// dlogL = sum_c g_c 10^v_c ln10 slope_c dind, where slope_c is the
// segment's rise (0 at the last knot) and dind the grid scale strictly
// inside the table's range, 0 elsewhere.
//
// Bound on the H100: memory. The forward reads 4 bytes and writes 4*C per
// element, the backward reads 4*(1 + C) and writes 4; the arithmetic (one
// index, C lerps and C powf, ~30 instructions a channel) is below the
// card's instruction rate at those bytes. Both round as
// ops/kernels/csf_lut.py's plain versions do (common.cuh). The TPU evaluated
// the table as a select/relu chain because it has no per-lane gather; here
// each thread reads its two knots from the table, which a block stages in
// shared memory once. A thread takes 4 consecutive elements: one 16-byte
// load of logL, the index once an element, then per channel the 4 outputs
// (forward) or the 4 gradients g_c (backward) as one 16-byte access where
// that channel's plane is 16-byte aligned, 4 scalar ones where it is not
// (n % 4 != 0 puts planes 1.. off alignment). The last n % 4 elements, and
// every element where logL (or the backward's output) is off 16-byte
// alignment, take a scalar loop. A grid of a few blocks an SM strides over
// the groups.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;
constexpr int MAX_TABLE = 48 * 1024 / (int)sizeof(float);  // C * nk floats

__device__ __forceinline__ void stage_table(float* s, const float* __restrict__ luts, int m) {
  for (int i = threadIdx.x; i < m; i += blockDim.x) s[i] = luts[i];
  __syncthreads();
}

__device__ __forceinline__ bool aligned16(const float* p) {
  return ((uintptr_t)p & 15) == 0;
}

__device__ __forceinline__ float4 load4(const float* p, bool vec) {
  if (vec) return *reinterpret_cast<const float4*>(p);
  return make_float4(p[0], p[1], p[2], p[3]);
}

__device__ __forceinline__ void store4(float* p, float4 v, bool vec) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = v;
  } else {
    p[0] = v.x;
    p[1] = v.y;
    p[2] = v.z;
    p[3] = v.w;
  }
}

// vec: logL (and the output of the backward) 16-byte aligned; then groups
// 0 .. n / 4 - 1 take the vector body and elements 4 (n / 4) .. n - 1 the
// scalar loop, else every element takes the scalar loop.
template <int C>
__global__ void __launch_bounds__(THREADS)
    csf_lut_kernel(const float* __restrict__ logL, float* __restrict__ out, long long n,
                   int nk, const float* __restrict__ luts, float x0, float scale, int vec) {
  extern __shared__ float s_lut[];
  stage_table(s_lut, luts, C * nk);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n4 = vec ? n / 4 : 0;
  bool vec_out[C];
#pragma unroll
  for (int c = 0; c < C; ++c) vec_out[c] = aligned16(out + c * n);
  for (long long q = tid; q < n4; q += stride) {
    const float4 l = *reinterpret_cast<const float4*>(logL + 4 * q);
    const float ind[4] = {lut_index(l.x, x0, scale, nk), lut_index(l.y, x0, scale, nk),
                          lut_index(l.z, x0, scale, nk), lut_index(l.w, x0, scale, nk)};
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float* v = s_lut + c * nk;
      store4(out + c * n + 4 * q,
             make_float4(pow10_lut(lut_lerp(v, nk, ind[0])), pow10_lut(lut_lerp(v, nk, ind[1])),
                         pow10_lut(lut_lerp(v, nk, ind[2])), pow10_lut(lut_lerp(v, nk, ind[3]))),
             vec_out[c]);
    }
  }
  for (long long i = 4 * n4 + tid; i < n; i += stride) {
    const float ind = lut_index(logL[i], x0, scale, nk);
#pragma unroll
    for (int c = 0; c < C; ++c) out[c * n + i] = pow10_lut(lut_lerp(s_lut + c * nk, nk, ind));
  }
}

// One element's gradient: the C channels summed in channel order.
template <int C>
__device__ __forceinline__ float lut_grad(float logL, const float (&g)[C], const float* s_lut,
                                          int nk, float x0, float scale) {
  const float ln10 = 2.302585092994046f;
  const float raw = (logL - x0) * scale;
  const float ind = fminf(fmaxf(raw, 0.0f), (float)(nk - 1));
  const float dind = (raw > 0.0f && raw < (float)(nk - 1)) ? scale : 0.0f;
  const int i0 = (int)floorf(ind);
  float acc = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float* v = s_lut + c * nk;
    const float slope = i0 >= nk - 1 ? 0.0f : v[i0 + 1] - v[i0];
    const float S = pow10_lut(lut_lerp(v, nk, ind));
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(__fmul_rn(__fmul_rn(g[c], S), ln10), slope), dind));
  }
  return acc;
}

template <int C>
__global__ void __launch_bounds__(THREADS)
    csf_lut_bwd_kernel(const float* __restrict__ logL, const float* __restrict__ g,
                       float* __restrict__ out, long long n, int nk,
                       const float* __restrict__ luts, float x0, float scale, int vec) {
  extern __shared__ float s_lut[];
  stage_table(s_lut, luts, C * nk);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n4 = vec ? n / 4 : 0;
  bool vec_g[C];
#pragma unroll
  for (int c = 0; c < C; ++c) vec_g[c] = aligned16(g + c * n);
  for (long long q = tid; q < n4; q += stride) {
    const float4 l = *reinterpret_cast<const float4*>(logL + 4 * q);
    float ge[4][C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float4 gc = load4(g + c * n + 4 * q, vec_g[c]);
      ge[0][c] = gc.x;
      ge[1][c] = gc.y;
      ge[2][c] = gc.z;
      ge[3][c] = gc.w;
    }
    *reinterpret_cast<float4*>(out + 4 * q) =
        make_float4(lut_grad<C>(l.x, ge[0], s_lut, nk, x0, scale),
                    lut_grad<C>(l.y, ge[1], s_lut, nk, x0, scale),
                    lut_grad<C>(l.z, ge[2], s_lut, nk, x0, scale),
                    lut_grad<C>(l.w, ge[3], s_lut, nk, x0, scale));
  }
  for (long long i = 4 * n4 + tid; i < n; i += stride) {
    float gi[C];
#pragma unroll
    for (int c = 0; c < C; ++c) gi[c] = g[c * n + i];
    out[i] = lut_grad<C>(logL[i], gi, s_lut, nk, x0, scale);
  }
}

// Blocks for n elements (groups of 4 where vec): enough for one step of every
// thread, at most BLOCKS_PER_SM an SM.
int lut_blocks(long long n, bool vec, int* blocks) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const long long work = vec ? n / 4 + n % 4 : n;
  const long long want = (work + THREADS - 1) / THREADS;
  *blocks = (int)(want < (long long)sms * BLOCKS_PER_SM ? want : (long long)sms * BLOCKS_PER_SM);
  return 0;
}

}  // namespace

// logL: n floats; luts: (C, nk) floats on the device; out: (C, n).
CVVDP_API int cvvdp_csf_lut(const float* logL, float* out, long long n, int C,
                            int nk, const float* luts, float x0, float scale,
                            void* stream) {
  if (n <= 0) return 0;
  if (C < 1 || C > 4 || nk < 2 || C * nk > MAX_TABLE) return (int)cudaErrorInvalidValue;
  const int vec = ((uintptr_t)logL % 16 == 0) ? 1 : 0;
  int blocks = 0;
  const int rc = lut_blocks(n, vec, &blocks);
  if (rc != 0) return rc;
  const size_t smem = (size_t)C * nk * sizeof(float);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
#define CVVDP_LUT_CASE(CC)                                                                  \
  case CC:                                                                                  \
    csf_lut_kernel<CC><<<blocks, THREADS, smem, s>>>(logL, out, n, nk, luts, x0, scale, vec); \
    break;
    CVVDP_LUT_CASE(1) CVVDP_LUT_CASE(2) CVVDP_LUT_CASE(3) CVVDP_LUT_CASE(4)
#undef CVVDP_LUT_CASE
  }
  return (int)cudaGetLastError();
}

// logL: n floats; g: (C, n) gradient of S; luts: (C, nk) on the device;
// out: n floats, the gradient of logL.
CVVDP_API int cvvdp_csf_lut_bwd(const float* logL, const float* g, float* out,
                                long long n, int C, int nk, const float* luts,
                                float x0, float scale, void* stream) {
  if (n <= 0) return 0;
  if (C < 1 || C > 4 || nk < 2 || C * nk > MAX_TABLE) return (int)cudaErrorInvalidValue;
  const int vec = ((uintptr_t)logL % 16 == 0 && (uintptr_t)out % 16 == 0) ? 1 : 0;
  int blocks = 0;
  const int rc = lut_blocks(n, vec, &blocks);
  if (rc != 0) return rc;
  const size_t smem = (size_t)C * nk * sizeof(float);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
#define CVVDP_LUT_CASE(CC)                                                  \
  case CC:                                                                  \
    csf_lut_bwd_kernel<CC><<<blocks, THREADS, smem, s>>>(logL, g, out, n, nk, luts, x0, \
                                                         scale, vec);       \
    break;
    CVVDP_LUT_CASE(1) CVVDP_LUT_CASE(2) CVVDP_LUT_CASE(3) CVVDP_LUT_CASE(4)
#undef CVVDP_LUT_CASE
  }
  return (int)cudaGetLastError();
}
