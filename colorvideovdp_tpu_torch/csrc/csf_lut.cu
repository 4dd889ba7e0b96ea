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
// index, C lerps and C powf) is far below the card's compute rate. Both
// round as ops/kernels/csf_lut.py's plain versions do (common.cuh). The TPU evaluated the table as a
// select/relu chain because it has no per-lane gather; here each thread reads
// its two knots straight from the table, which sits in L1 after the first
// warp touches it. Grid-stride loop, one element per thread per step,
// neighbouring threads on neighbouring addresses.

#include "common.cuh"

__global__ void csf_lut_kernel(const float* __restrict__ logL,
                               float* __restrict__ out, long long n, int C,
                               int nk, const float* __restrict__ luts, float x0,
                               float scale) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float ind = lut_index(logL[i], x0, scale, nk);
    for (int c = 0; c < C; ++c) {
      out[(long long)c * n + i] = pow10_lut(lut_lerp(luts + c * nk, nk, ind));
    }
  }
}

// logL: n floats; luts: (C, nk) floats on the device; out: (C, n).
CVVDP_API int cvvdp_csf_lut(const float* logL, float* out, long long n, int C,
                            int nk, const float* luts, float x0, float scale,
                            void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 65535LL * 16) blocks = 65535LL * 16;
  csf_lut_kernel<<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(
      logL, out, n, C, nk, luts, x0, scale);
  return (int)cudaGetLastError();
}

// Same grid-stride layout as the forward; one thread sums the C channels of
// its element in channel order.
__global__ void csf_lut_bwd_kernel(const float* __restrict__ logL,
                                   const float* __restrict__ g,
                                   float* __restrict__ out, long long n, int C,
                                   int nk, const float* __restrict__ luts,
                                   float x0, float scale) {
  const float ln10 = 2.302585092994046f;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float raw = (logL[i] - x0) * scale;
    const float ind = fminf(fmaxf(raw, 0.0f), (float)(nk - 1));
    const float dind = (raw > 0.0f && raw < (float)(nk - 1)) ? scale : 0.0f;
    const int i0 = (int)floorf(ind);
    float acc = 0.0f;
    for (int c = 0; c < C; ++c) {
      const float* v = luts + c * nk;
      const float slope = i0 >= nk - 1 ? 0.0f : v[i0 + 1] - v[i0];
      const float S = pow10_lut(lut_lerp(v, nk, ind));
      acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(__fmul_rn(__fmul_rn(
                               g[(long long)c * n + i], S), ln10), slope), dind));
    }
    out[i] = acc;
  }
}

// logL: n floats; g: (C, n) gradient of S; luts: (C, nk) on the device;
// out: n floats, the gradient of logL.
CVVDP_API int cvvdp_csf_lut_bwd(const float* logL, const float* g, float* out,
                                long long n, int C, int nk, const float* luts,
                                float x0, float scale, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 65535LL * 16) blocks = 65535LL * 16;
  csf_lut_bwd_kernel<<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(
      logL, g, out, n, C, nk, luts, x0, scale);
  return (int)cudaGetLastError();
}
