// Separable blur of (P, H, W) float32 planes with an odd kernel of radius
// <= 16 and the edge-excluded reflect padding of ops/blur.py, vertical pass
// first, taps summed in order.
//
// Replaces colorvideovdp_tpu/ops/kernels/blur_halo.py `blur_tpu`
// (`_blur_kernel`, `apply_blur_tile`): the standalone phase-uncertainty blur
// (13 taps at the calibrated pu_dilate = 3) that the masking model's gradient
// recompute and the non-default masking models run, and the 33-tap texture
// blur (sigma 8) of the *-transducer-texture models. The TPU kernel stops at
// radius 8 (`can_blur_tpu`); this one takes radius 16 in the same tile code.
//
// Design: the TPU kernel DMAs 8-row-aligned halo slabs into VMEM and patches
// the reflect as masked corrections. Here one block owns a 32x32 output tile
// of one plane: the tile plus its r-halo is loaded once into shared memory,
// with the reflect done in the load's indexing; the vertical taps run into a
// second shared buffer, the horizontal taps from there, and each output is
// written once. The tile code is common.cuh's, shared with stage B of
// band_masking.cu. Threads are (32, 8): each owns one column and four rows.
//
// Bound on the H100: memory. Per element it must read 4 bytes and write 4
// (the halo, (44 x 44) / (32 x 32) = 1.9 reads per element at r = 6 and
// (64 x 64) / (32 x 32) = 4 at r = 16, comes mostly from L2); the 2 x 13
// multiply-adds per element at r = 6 are about 6.5 operations per byte and
// the 2 x 33 at r = 16 about 16.5, below the card's ~20 float32 operations
// per byte of HBM bandwidth.

#include "common.cuh"

#define BL_TH 32
#define BL_TW 32
#define BL_MAX_TAPS 33
#define BL_R_MAX ((BL_MAX_TAPS - 1) / 2)
#define BL_THREADS_X 32
#define BL_THREADS_Y 8
#define BL_ROWS_PER_THREAD (BL_TH / BL_THREADS_Y)

struct BlurTaps {
  float t[BL_MAX_TAPS];
  int n;
};

__global__ void __launch_bounds__(BL_THREADS_X* BL_THREADS_Y)
    blur_kernel(const float* __restrict__ x, float* __restrict__ y, int H, int W,
                int tiles_x, int tiles_per_plane, BlurTaps T) {
  __shared__ float sm[(BL_TH + 2 * BL_R_MAX) * (BL_TW + 2 * BL_R_MAX)];
  __shared__ float tmp[BL_TH * (BL_TW + 2 * BL_R_MAX)];
  __shared__ float s_taps[BL_MAX_TAPS];

  const long long p = blockIdx.x / tiles_per_plane;
  const int tt = (int)(blockIdx.x % tiles_per_plane);
  const int y0 = (tt / tiles_x) * BL_TH;
  const int x0 = (tt % tiles_x) * BL_TW;
  const int r = (T.n - 1) / 2;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  if (tid < BL_MAX_TAPS) s_taps[tid] = tid < T.n ? T.t[tid] : 0.0f;
  __syncthreads();

  const long long hw = (long long)H * W;
  tile_blur_vertical<BL_TH, BL_TW>(x + p * hw, H, W, y0, x0, r, s_taps, sm, tmp);
#pragma unroll
  for (int k = 0; k < BL_ROWS_PER_THREAD; ++k) {
    const int ty = threadIdx.y + k * BL_THREADS_Y;
    const int gy = y0 + ty, gx = x0 + threadIdx.x;
    if (gy < H && gx < W)
      y[p * hw + (long long)gy * W + gx] =
          tile_blur_horizontal<BL_TW>(tmp, r, s_taps, ty, threadIdx.x);
  }
}

// x, y: (P, H, W) device arrays; taps: ntaps host floats (odd, <= 33), and
// H, W must exceed the radius (one reflection).
CVVDP_API int cvvdp_blur(const float* x, float* y, int P, int H, int W,
                         const float* taps, int ntaps, void* stream) {
  if (ntaps < 1 || ntaps > BL_MAX_TAPS || (ntaps % 2) != 1 || P < 1 ||
      H <= (ntaps - 1) / 2 || W <= (ntaps - 1) / 2)
    return (int)cudaErrorInvalidValue;
  BlurTaps T;
  for (int k = 0; k < BL_MAX_TAPS; ++k) T.t[k] = k < ntaps ? taps[k] : 0.0f;
  T.n = ntaps;
  const int tiles_x = (W + BL_TW - 1) / BL_TW;
  const int tiles_y = (H + BL_TH - 1) / BL_TH;
  const long long blocks = (long long)P * tiles_x * tiles_y;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  blur_kernel<<<(unsigned int)blocks, dim3(BL_THREADS_X, BL_THREADS_Y), 0,
                (cudaStream_t)stream>>>(x, y, H, W, tiles_x, tiles_x * tiles_y, T);
  return (int)cudaGetLastError();
}
