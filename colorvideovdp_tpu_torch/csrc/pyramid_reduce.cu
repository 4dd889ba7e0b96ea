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
// The slab mode (cvvdp_pyramid_reduce_slab) replaces
// colorvideovdp_tpu/ops/kernels/pyramid_reduce.py `reduce_slab_tpu` (:238,
// the kernel's halo=True branches): one rank's row slab of a level sharded
// over image rows, (P, H_loc + 16, W) with 8 real neighbour rows above and
// below (zeros at the global edges), -> (P, H_loc / 2, ceil(W / 2)). Buffer
// row b holds slab row b - 8, so output row i reads buffer rows 2i + 6 ..
// 2i + 10; the vertical edge corrections are off (the caller adds them at
// the global edges only), and the horizontal last-column branch is keyed on
// the GLOBAL row parity `rows_odd` (trap 1), not on the slab's. It gives
// ops/pyramid.py `reduce_slab_plain`'s bits.
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
// the window s[a] = x[2i - 2 + a] (0 outside the axis); `fix` adds the edge
// corrections.
__device__ __forceinline__ float reduce_pass(const float s[5], int i, int n, int n_out,
                                             bool h_odd, const ReduceK& K, bool fix = true) {
  float y = __fmul_rn(K.k[0], s[0]);
#pragma unroll
  for (int a = 1; a < 5; ++a) y = mul_add_rn(y, K.k[a], s[a]);
  if (!fix) return y;
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

// Plain mode: Hin = H rows, Ho = ceil(H / 2), row_off = 0, vfix = 1,
// h_odd = H % 2. Slab mode: Hin = H_loc + 16 buffer rows, Ho = H_loc / 2,
// row_off = 8, vfix = 0, h_odd = the global row parity.
__global__ void __launch_bounds__(THREADS)
pyramid_reduce_kernel(const float* __restrict__ x, float* __restrict__ y, int Hin,
                      int Ho, int W, int row_off, bool vfix, bool h_odd, ReduceK K) {
  __shared__ float s_in[SIH * SIW];
  __shared__ float s_v[TOH * SIW];
  const int Wo = (W + 1) / 2;
  const int i0 = blockIdx.y * TOH, j0 = blockIdx.x * TOW;
  const int row0 = 2 * i0 - 2 + row_off, col0 = 2 * j0 - 2;
  const float* xp = x + (long long)blockIdx.z * Hin * W;
  for (int idx = threadIdx.x; idx < SIH * SIW; idx += THREADS) {
    const int row = row0 + idx / SIW, col = col0 + idx % SIW;
    s_in[idx] = (row >= 0 && row < Hin && col >= 0 && col < W)
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
      v = reduce_pass(s, i0 + ii, Hin, Ho, h_odd, K, vfix);
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

static int launch_reduce(const float* x, float* y, int P, int Hin, int Ho, int W,
                         int row_off, bool vfix, bool h_odd, const float* k5, void* stream) {
  if (P <= 0) return 0;
  ReduceK K;
  for (int t = 0; t < 5; ++t) K.k[t] = k5[t];
  const int Wo = (W + 1) / 2;
  dim3 grid(ceil_div_u(Wo, TOW), ceil_div_u(Ho, TOH), (unsigned int)P);
  pyramid_reduce_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(x, y, Hin, Ho, W, row_off,
                                                                   vfix, h_odd, K);
  return (int)cudaGetLastError();
}

// x: (P, H, W) float32, y: (P, ceil(H/2), ceil(W/2)); H, W >= 3.
CVVDP_API int cvvdp_pyramid_reduce(const float* x, float* y, int P, int H,
                                   int W, const float* k5, void* stream) {
  return launch_reduce(x, y, P, H, (H + 1) / 2, W, 0, true, (H % 2) == 1, k5, stream);
}

// The slab mode. x: (P, H_loc + 16, W) float32, y: (P, H_loc / 2, ceil(W/2));
// H_loc even and >= 2, W >= 3; rows_odd: the parity of the level's global
// row count.
CVVDP_API int cvvdp_pyramid_reduce_slab(const float* x, float* y, int P, int H_loc, int W,
                                        int rows_odd, const float* k5, void* stream) {
  if (H_loc < 2 || (H_loc % 2) != 0 || W < 3) return (int)cudaErrorInvalidValue;
  return launch_reduce(x, y, P, H_loc + 16, H_loc / 2, W, 8, false, rows_odd != 0, k5, stream);
}
