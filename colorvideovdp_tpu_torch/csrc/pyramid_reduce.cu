// One Gaussian-pyramid level: (P, H, W) -> (P, ceil(H/2), ceil(W/2)).
//
// Replaces colorvideovdp_tpu/ops/kernels/pyramid_reduce.py `reduce_tpu`
// (`_reduce_kernel`). Semantics are those of ops/pyramid.py `_xla_reduce`:
// separable 5-tap K5 at stride 2 over a zero-padded input, plus the
// reference's first/last-sample edge corrections. The last-sample branch of
// BOTH passes is chosen by the parity of H (the row count), a reference quirk
// replicated on purpose (trap 1 of memory/cvvdp-parity-traps.md).
//
// Both passes sum each tap and correction in the order and rounding of the
// plain version (ops/pyramid.py `_reduce_1d`: the zero-padded taps summed
// one by one, then x[0] * K1 + x[1] * K0 at the first output and the
// last-sample terms at the last), so the kernel gives the plain version's
// bits.
//
// Bound on the H100: memory. It reads P*H*W*4 bytes and writes a quarter of
// that. A block owns a TOH x TOW output tile: it loads the (2 TOH + 3) x
// (2 TOW + 3) input window once into shared memory (coalesced, zero outside
// the plane), runs the vertical pass once per (output row, input column)
// into a second shared buffer, then the horizontal pass per output, so every
// input is read from device memory about 1.1 times and every vertical sum is
// formed once.

#include "common.cuh"

struct ReduceK {
  float k[5];
};

// One pass at output index i of an axis of n samples (n_out outputs), from
// the window s[a] = x[2i - 2 + a] (0 outside the axis).
__device__ __forceinline__ float reduce_pass(const float s[5], int i, int n, int n_out,
                                             bool h_odd, const ReduceK& K) {
  float y = __fmul_rn(K.k[0], s[0]);
#pragma unroll
  for (int a = 1; a < 5; ++a) y = mul_add_rn(y, K.k[a], s[a]);
  if (i == 0)  // + x[0] * K1 + x[1] * K0
    y = mul_add_rn(mul_add_rn(y, s[2], K.k[1]), s[3], K.k[0]);
  if (i == n_out - 1) {
    const int a = n + 1 - 2 * i;  // window slot of x[n-1]
    if (h_odd)                    // + x[n-1] * K3 + x[n-2] * K4
      y = mul_add_rn(mul_add_rn(y, s[a], K.k[3]), s[a - 1], K.k[4]);
    else                          // + x[n-1] * K4
      y = mul_add_rn(y, s[a], K.k[4]);
  }
  return y;
}

constexpr int TOH = 16, TOW = 64;               // output tile
constexpr int SIH = 2 * TOH + 3, SIW = 2 * TOW + 3;  // its input window
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
pyramid_reduce_kernel(const float* __restrict__ x, float* __restrict__ y, int H,
                      int W, ReduceK K) {
  __shared__ float s_in[SIH * SIW];
  __shared__ float s_v[TOH * SIW];
  const int Ho = (H + 1) / 2;
  const int Wo = (W + 1) / 2;
  const int i0 = blockIdx.y * TOH, j0 = blockIdx.x * TOW;
  const int row0 = 2 * i0 - 2, col0 = 2 * j0 - 2;
  const bool h_odd = (H % 2) == 1;
  const float* xp = x + (long long)blockIdx.z * H * W;
  for (int idx = threadIdx.x; idx < SIH * SIW; idx += THREADS) {
    const int row = row0 + idx / SIW, col = col0 + idx % SIW;
    s_in[idx] = (row >= 0 && row < H && col >= 0 && col < W)
                    ? xp[(long long)row * W + col]
                    : 0.0f;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < TOH * SIW; idx += THREADS) {
    const int ii = idx / SIW, c = idx % SIW;
    const int col = col0 + c;
    float v = 0.0f;  // the vertical pass's output is zero-padded too
    if (i0 + ii < Ho && col >= 0 && col < W) {
      float s[5];
#pragma unroll
      for (int a = 0; a < 5; ++a) s[a] = s_in[(2 * ii + a) * SIW + c];
      v = reduce_pass(s, i0 + ii, H, Ho, h_odd, K);
    }
    s_v[idx] = v;
  }
  __syncthreads();
  float* yp = y + (long long)blockIdx.z * Ho * Wo;
  for (int idx = threadIdx.x; idx < TOH * TOW; idx += THREADS) {
    const int ii = idx / TOW, jj = idx % TOW;
    const int i = i0 + ii, j = j0 + jj;
    if (i >= Ho || j >= Wo) continue;
    float v[5];
#pragma unroll
    for (int b = 0; b < 5; ++b) v[b] = s_v[ii * SIW + 2 * jj + b];
    // NOTE: the horizontal pass keys its correction on the ROW parity (trap 1).
    yp[(long long)i * Wo + j] = reduce_pass(v, j, W, Wo, h_odd, K);
  }
}

// x: (P, H, W) float32, y: (P, ceil(H/2), ceil(W/2)); H, W >= 3.
CVVDP_API int cvvdp_pyramid_reduce(const float* x, float* y, int P, int H,
                                   int W, const float* k5, void* stream) {
  if (P <= 0) return 0;
  ReduceK K;
  for (int t = 0; t < 5; ++t) K.k[t] = k5[t];
  const int Ho = (H + 1) / 2;
  const int Wo = (W + 1) / 2;
  dim3 grid(ceil_div_u(Wo, TOW), ceil_div_u(Ho, TOH), (unsigned int)P);
  pyramid_reduce_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(x, y, H, W, K);
  return (int)cudaGetLastError();
}
