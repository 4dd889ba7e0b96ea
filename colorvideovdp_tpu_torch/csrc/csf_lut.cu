// castleCSF LUT lookup: S_c = 10 ** lerp(lut_c, logL) for up to four channels.
//
// Replaces colorvideovdp_tpu/ops/kernels/csf_lut.py `_make_lookup.forward`
// (padded 2-D route, `_fwd_kernel`), forward only.
//
// Bound on the H100: memory. Per element it reads 4 bytes and writes 4*C
// bytes; the arithmetic (one log-domain index, C lerps and C exp10f) is far
// below the card's compute rate. The TPU evaluated the table as a
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
      out[(long long)c * n + i] = exp10f(lut_lerp(luts + c * nk, nk, ind));
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
