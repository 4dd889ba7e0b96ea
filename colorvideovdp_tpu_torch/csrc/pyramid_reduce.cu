// One Gaussian-pyramid level: (P, H, W) -> (P, ceil(H/2), ceil(W/2)).
//
// Replaces colorvideovdp_tpu/ops/kernels/pyramid_reduce.py `reduce_tpu`
// (`_reduce_kernel`). Semantics are those of ops/pyramid.py `_xla_reduce`:
// separable 5-tap K5 at stride 2 over a zero-padded input, plus the
// reference's first/last-sample edge corrections. The last-sample branch of
// BOTH passes is chosen by the parity of H (the row count), a reference quirk
// replicated on purpose (trap 1 of memory/cvvdp-parity-traps.md).
//
// The corrections are linear, so each output index folds them into five
// effective weights per axis; an output is then a 5x5 weighted gather,
// evaluated vertical-first (the JAX pass order).
//
// Bound on the H100: memory. It reads P*H*W*4 bytes and writes a quarter of
// that. One thread per output; a warp covers 32 neighbouring output columns,
// so its loads span 64+4 neighbouring input columns and the 5x5 window
// overlap between neighbours is served from L1 instead of device memory.

#include "common.cuh"

struct ReduceK {
  float k[5];
};

// Effective tap weights for output index i of an axis of n samples.
__device__ __forceinline__ void axis_weights(int i, int n, int n_out,
                                             bool h_odd, const ReduceK& K,
                                             float w[5]) {
#pragma unroll
  for (int a = 0; a < 5; ++a) {
    const int p = 2 * i - 2 + a;
    w[a] = (p >= 0 && p < n) ? K.k[a] : 0.0f;
  }
  if (i == 0) {  // x[0] * K1 + x[1] * K0
    w[2] += K.k[1];
    w[3] += K.k[0];
  }
  if (i == n_out - 1) {
    const int a_last = n - 1 - 2 * i + 2;  // tap slot of x[n-1]
    if (h_odd) {                           // x[n-1] * K3 + x[n-2] * K4
      w[a_last] += K.k[3];
      w[a_last - 1] += K.k[4];
    } else {                               // x[n-1] * K4
      w[a_last] += K.k[4];
    }
  }
}

__global__ void pyramid_reduce_kernel(const float* __restrict__ x,
                                      float* __restrict__ y, int P, int H,
                                      int W, ReduceK K) {
  const int Ho = (H + 1) / 2;
  const int Wo = (W + 1) / 2;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int p = blockIdx.z;
  if (j >= Wo || i >= Ho || p >= P) return;
  const bool h_odd = (H % 2) == 1;
  float wv[5], wh[5];
  axis_weights(i, H, Ho, h_odd, K, wv);
  axis_weights(j, W, Wo, h_odd, K, wh);
  const float* xp = x + (long long)p * H * W;
  float acc = 0.0f;
#pragma unroll
  for (int b = 0; b < 5; ++b) {
    const int col = 2 * j - 2 + b;
    if (col < 0 || col >= W) continue;
    float v = 0.0f;
#pragma unroll
    for (int a = 0; a < 5; ++a) {
      const int row = 2 * i - 2 + a;
      if (row < 0 || row >= H) continue;
      v += wv[a] * __ldg(xp + (long long)row * W + col);
    }
    acc += wh[b] * v;
  }
  y[((long long)p * Ho + i) * Wo + j] = acc;
}

// x: (P, H, W) float32, y: (P, ceil(H/2), ceil(W/2)); H, W >= 3.
CVVDP_API int cvvdp_pyramid_reduce(const float* x, float* y, int P, int H,
                                   int W, const float* k5, void* stream) {
  if (P <= 0) return 0;
  ReduceK K;
  for (int t = 0; t < 5; ++t) K.k[t] = k5[t];
  const int Ho = (H + 1) / 2;
  const int Wo = (W + 1) / 2;
  dim3 block(32, 8);
  dim3 grid(ceil_div_u(Wo, 32), ceil_div_u(Ho, 8), (unsigned int)P);
  pyramid_reduce_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(x, y, P, H,
                                                                   W, K);
  return (int)cudaGetLastError();
}
