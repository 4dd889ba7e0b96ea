// Per-band CSF + contrast masking for the calibrated default (weber_g1 raw
// pairs, mult-mutual masking, cross-channel mix, soft clamp): pooled scores,
// or the per-pixel distortion map D for the heatmap.
//
// Replaces four TPU kernels of colorvideovdp_tpu/ops/kernels/:
//   masking_fused.py `fused_csf_contrast_raw` (`_kernel_a_raw`),
//   masking_fused.py `fused_blur_transducer` (`_blur_b_kernel`), pooled and
//     in its D-output mode (`pool_beta=None`),
//   masking_fused.py `fused_masking_transducer` (`_kernel_b`, the transducer
//     on a band whose blur is skipped: here the same stage B with a unit
//     tap), and
//   band_stack.py `make_band_stack` (`_stack_kernel`, all narrow bands).
// One launch handles a list of up to BM_MAX_BANDS bands of any sizes (per-band
// LUT rows, sizes and gains come from the band table, so one build serves
// every band); ops/kernels/masking_fused.py `band_groups` picks the lists.
//
// Inputs per band: gi (B, 2C, F, h, w), the Gaussian level with test/
// reference channels interleaved, and E, the expanded next level, same shape.
//  Stage A (elementwise, one thread per pixel, all C channels):
//    lb = max(E_Y, 0.01); T/R = min((gi - E) / lb, 1000) * 10^lut(log10 lb_R)
//    * gain_c * band_mul; M_pre = min(|T|, |R|); diff = |T - R|.
//  Stage B (one block per 32x32 output tile): for each channel, the M_pre
//    tile plus its blur halo goes to shared memory through the exclude-edge
//    reflect padding of ops/blur.py; vertical then horizontal taps (the tile
//    blur of common.cuh, shared with csrc/blur.cu); x 10^mask_c;
//    safe_pow(q_c); the 4x4 cross-channel mix accumulates in registers. Then
//    D = soft_clamp(safe_pow(diff, p) / (1 + mix)). Pooled mode sums
//    safe_pow(D, beta) over the tile's valid pixels into one partial sum per
//    channel; D mode writes D, (B, C, F, h, w) per band, and stops there.
//    Bands whose blur phase_uncertainty skips (h or w <= pu_padsize) use a
//    single unit tap, an exact identity.
//  Stage C (pooled mode only; one block per (band, image plane)): the tile
//    partials of the plane are summed in a fixed order. No float atomics, so
//    the result is deterministic.
//
// Bound on the H100: memory. Stage A reads 16 floats per pixel (C = 4) and
// writes 8; stage B reads the 8 again (halo re-reads of M_pre hit L2) and
// writes C floats per tile, or C per pixel in D mode. The blur is 2 * 13
// multiply-adds per channel and pixel out of shared memory. In pooled mode D
// never reaches device memory.

#include "common.cuh"

#define BM_MAX_BANDS 8
#define BM_MAX_C 4
#define BM_MAX_TAPS 17
#define BM_TH 32
#define BM_TW 32
#define BM_R_MAX ((BM_MAX_TAPS - 1) / 2)
#define BM_THREADS_X 32
#define BM_THREADS_Y 8
#define BM_ROWS_PER_THREAD (BM_TH / BM_THREADS_Y)
#define BM_EPS 1e-5f

struct BandDesc {
  const float* gi;
  const float* E;
  float* mpre;
  float* diff;
  float* D;  // D mode: (B, C, F, h, w) output
  int h, w;
  float mul;
  int blur;
  long long blk_off;    // first stage-A block of the band
  long long tile_off;   // first tile of the band
  long long plane_off;  // first (b, f) plane of the band
  int tiles_x, tiles_y;
};

struct BandParams {
  int n_bands, B, C, F, nk;
  BandDesc band[BM_MAX_BANDS];
  const float* luts;  // (n_bands, C, nk)
  float x0, lut_scale;
  float gains[BM_MAX_C];  // channel gain x sensitivity correction
  int ref_only;
  float qs[BM_MAX_C];
  float p;
  float xcm[BM_MAX_C * BM_MAX_C];  // 2^xcm_weights, [c][d]
  float max_v, blur_scale, beta;
  float taps[BM_MAX_TAPS];
  int ntaps;
};

__device__ __forceinline__ int band_of(const BandParams& P, long long idx,
                                       int which) {
  int b = 0;
  for (int k = 1; k < P.n_bands; ++k) {
    const long long off = which == 0   ? P.band[k].blk_off
                          : which == 1 ? P.band[k].tile_off
                                       : P.band[k].plane_off;
    if (idx >= off) b = k;
  }
  return b;
}

__device__ __forceinline__ float min1000(float x) { return x > 1000.0f ? 1000.0f : x; }

__global__ void band_stage_a(BandParams P) {
  const int bi = band_of(P, blockIdx.x, 0);
  const BandDesc& d = P.band[bi];
  const long long hw = (long long)d.h * d.w;
  const long long i = (blockIdx.x - d.blk_off) * (long long)blockDim.x + threadIdx.x;
  if (i >= (long long)P.B * P.F * hw) return;
  const int C = P.C, F = P.F;
  const long long pix = i % hw;
  const long long bf = i / hw;
  const int f = (int)(bf % F);
  const int b = (int)(bf / F);
  const long long in0 = ((long long)b * 2 * C * F + f) * hw + pix;  // channel 0
  const long long cstride = (long long)F * hw;

  const float lb_r = fmaxf(d.E[in0 + cstride], 0.01f);
  const float lb_t = P.ref_only ? lb_r : fmaxf(d.E[in0], 0.01f);
  const float ind = lut_index(log10f(lb_r), P.x0, P.lut_scale, P.nk);
  const float* lut = P.luts + (long long)bi * C * P.nk;
  const long long out0 = ((long long)b * C * F + f) * hw + pix;
  for (int c = 0; c < C; ++c) {
    const float S = pow10_lut(lut_lerp(lut + c * P.nk, P.nk, ind)) * (P.gains[c] * d.mul);
    const long long it = in0 + (2 * c) * cstride;
    const long long ir = it + cstride;
    const float T = min1000((d.gi[it] - d.E[it]) / lb_t) * S;
    const float R = min1000((d.gi[ir] - d.E[ir]) / lb_r) * S;
    d.mpre[out0 + c * cstride] = fminf(fabsf(T), fabsf(R));
    d.diff[out0 + c * cstride] = fabsf(T - R);
  }
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int nwarps = (blockDim.x * blockDim.y) >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.0f;
  if (tid == 0)
    for (int k = 0; k < nwarps; ++k) s += red[k];
  return s;  // valid in thread 0
}

template <bool D_OUT>
__global__ void __launch_bounds__(BM_THREADS_X* BM_THREADS_Y)
    band_stage_b(BandParams P, float* __restrict__ partials) {
  __shared__ float sm[(BM_TH + 2 * BM_R_MAX) * (BM_TW + 2 * BM_R_MAX)];
  __shared__ float tmp[BM_TH * (BM_TW + 2 * BM_R_MAX)];
  __shared__ float s_taps[BM_MAX_TAPS];
  __shared__ float red[32];

  const int bi = band_of(P, blockIdx.x, 1);
  const BandDesc& d = P.band[bi];
  const int C = P.C, F = P.F;
  const int h = d.h, w = d.w;
  const long long hw = (long long)h * w;
  const long long t = blockIdx.x - d.tile_off;
  const int tpp = d.tiles_x * d.tiles_y;
  const long long l = t / tpp;  // image plane b * F + f
  const int tt = (int)(t % tpp);
  const int y0 = (tt / d.tiles_x) * BM_TH;
  const int x0 = (tt % d.tiles_x) * BM_TW;
  const int b = (int)(l / F), f = (int)(l % F);

  const int r = d.blur ? (P.ntaps - 1) / 2 : 0;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  if (tid < BM_MAX_TAPS) s_taps[tid] = d.blur ? P.taps[tid] : (tid == 0 ? 1.0f : 0.0f);

  float mix[BM_ROWS_PER_THREAD][BM_MAX_C];
#pragma unroll
  for (int k = 0; k < BM_ROWS_PER_THREAD; ++k)
#pragma unroll
    for (int dd = 0; dd < BM_MAX_C; ++dd) mix[k][dd] = 0.0f;

  for (int c = 0; c < C; ++c) {
    const float* m = d.mpre + (((long long)b * C + c) * F + f) * hw;
    __syncthreads();  // previous channel done with sm/tmp; taps visible
    tile_blur_vertical<BM_TH, BM_TW>(m, h, w, y0, x0, r, s_taps, sm, tmp);
    const float q = P.qs[c];
    const float eps_q = powf(BM_EPS, q);
#pragma unroll
    for (int k = 0; k < BM_ROWS_PER_THREAD; ++k) {
      const int y = threadIdx.y + k * BM_THREADS_Y;
      const float mb =
          tile_blur_horizontal<BM_TW>(tmp, r, s_taps, y, threadIdx.x) * P.blur_scale;
      const float mq = powf(fabsf(mb) + BM_EPS, q) - eps_q;
#pragma unroll
      for (int dd = 0; dd < BM_MAX_C; ++dd)
        if (dd < C) mix[k][dd] += P.xcm[c * BM_MAX_C + dd] * mq;
    }
  }

  const float eps_p = powf(BM_EPS, P.p);
  if (D_OUT) {
#pragma unroll
    for (int k = 0; k < BM_ROWS_PER_THREAD; ++k) {
      const int gy = y0 + threadIdx.y + k * BM_THREADS_Y;
      const int gx = x0 + threadIdx.x;
      if (gy >= h || gx >= w) continue;
#pragma unroll
      for (int dd = 0; dd < BM_MAX_C; ++dd) {
        if (dd >= C) continue;
        const long long o = (((long long)b * C + dd) * F + f) * hw + (long long)gy * w + gx;
        const float du = (powf(d.diff[o] + BM_EPS, P.p) - eps_p) / (1.0f + mix[k][dd]);
        d.D[o] = P.max_v * du / (P.max_v + du);
      }
    }
    return;
  }
  const float eps_b = pow_static(BM_EPS, P.beta);
  float part[BM_MAX_C];
#pragma unroll
  for (int dd = 0; dd < BM_MAX_C; ++dd) part[dd] = 0.0f;
#pragma unroll
  for (int k = 0; k < BM_ROWS_PER_THREAD; ++k) {
    const int gy = y0 + threadIdx.y + k * BM_THREADS_Y;
    const int gx = x0 + threadIdx.x;
    if (gy >= h || gx >= w) continue;
#pragma unroll
    for (int dd = 0; dd < BM_MAX_C; ++dd) {
      if (dd >= C) continue;
      const float df = d.diff[(((long long)b * C + dd) * F + f) * hw + (long long)gy * w + gx];
      const float du = (powf(df + BM_EPS, P.p) - eps_p) / (1.0f + mix[k][dd]);
      const float D = P.max_v * du / (P.max_v + du);
      part[dd] += pow_static(D + BM_EPS, P.beta) - eps_b;
    }
  }
  const long long tile = blockIdx.x;
  for (int dd = 0; dd < C; ++dd) {
    const float s = block_sum(part[dd], red);
    if (tid == 0) partials[tile * C + dd] = s;
  }
}

// One block per (band, plane): out[band][b][c][f] = sum of the plane's tiles.
__global__ void band_stage_c(BandParams P, const float* __restrict__ partials,
                             float* __restrict__ out) {
  __shared__ float red[32];
  const int bi = band_of(P, blockIdx.x, 2);
  const BandDesc& d = P.band[bi];
  const int C = P.C, F = P.F;
  const long long l = blockIdx.x - d.plane_off;
  const int tpp = d.tiles_x * d.tiles_y;
  const long long first = d.tile_off + l * tpp;
  const int b = (int)(l / F), f = (int)(l % F);
  for (int dd = 0; dd < C; ++dd) {
    float s = 0.0f;
    for (int k = threadIdx.x; k < tpp; k += blockDim.x) s += partials[(first + k) * C + dd];
    s = block_sum(s, red);
    if (threadIdx.x == 0)
      out[(((long long)bi * P.B + b) * C + dd) * F + f] = s;
  }
}

static void layout(BandParams& P, const int* dims, long long* n_blocks_a,
                   long long* n_tiles, long long* n_planes) {
  long long blk = 0, tiles = 0, planes = 0;
  for (int k = 0; k < P.n_bands; ++k) {
    BandDesc& d = P.band[k];
    d.h = dims[2 * k];
    d.w = dims[2 * k + 1];
    d.tiles_x = (d.w + BM_TW - 1) / BM_TW;
    d.tiles_y = (d.h + BM_TH - 1) / BM_TH;
    d.blk_off = blk;
    d.tile_off = tiles;
    d.plane_off = planes;
    const long long n_pix = (long long)P.B * P.F * d.h * d.w;
    blk += (n_pix + 255) / 256;
    tiles += (long long)P.B * P.F * d.tiles_x * d.tiles_y;
    planes += (long long)P.B * P.F;
  }
  *n_blocks_a = blk;
  *n_tiles = tiles;
  *n_planes = planes;
}

// Number of stage-B tiles (the length of the partials buffer / C).
CVVDP_API long long cvvdp_band_masking_tiles(int n_bands, int B, int F,
                                             const int* dims) {
  BandParams P;
  P.n_bands = n_bands;
  P.B = B;
  P.F = F;
  long long a, t, p;
  layout(P, dims, &a, &t, &p);
  return t;
}

// ptrs: n_bands x {gi, E, mpre, diff, D} device pointers (D unused in pooled
// mode); dims: n_bands x {h, w}; muls, blur: per band; luts: device
// (n_bands, C, nk); gains, qs: C floats; xcm: C x C floats; taps: ntaps
// floats. d_out = 0: partials is (tiles, C) scratch and out receives the
// (n_bands, B, C, F) pooled sums of safe_pow(D, beta). d_out = 1: each band's
// D is written to its D pointer; partials and out are not touched.
CVVDP_API int cvvdp_band_masking(
    int n_bands, int B, int C, int F, int nk, const long long* ptrs,
    const int* dims, const float* muls, const int* blur, const float* luts,
    float x0, float lut_scale, const float* gains, int ref_only,
    const float* qs, float p, const float* xcm, float max_v, float blur_scale,
    const float* taps, int ntaps, float beta, int d_out, float* partials,
    float* out, void* stream) {
  if (n_bands < 1 || n_bands > BM_MAX_BANDS || C < 1 || C > BM_MAX_C ||
      ntaps < 1 || ntaps > BM_MAX_TAPS || (ntaps % 2) != 1)
    return (int)cudaErrorInvalidValue;
  BandParams P;
  P.n_bands = n_bands;
  P.B = B;
  P.C = C;
  P.F = F;
  P.nk = nk;
  for (int k = 0; k < n_bands; ++k) {
    BandDesc& d = P.band[k];
    d.gi = (const float*)ptrs[5 * k];
    d.E = (const float*)ptrs[5 * k + 1];
    d.mpre = (float*)ptrs[5 * k + 2];
    d.diff = (float*)ptrs[5 * k + 3];
    d.D = (float*)ptrs[5 * k + 4];
    d.mul = muls[k];
    d.blur = blur[k];
  }
  long long n_a, n_t, n_p;
  layout(P, dims, &n_a, &n_t, &n_p);
  P.luts = luts;
  P.x0 = x0;
  P.lut_scale = lut_scale;
  P.ref_only = ref_only;
  for (int c = 0; c < BM_MAX_C; ++c) {
    P.gains[c] = c < C ? gains[c] : 0.0f;
    P.qs[c] = c < C ? qs[c] : 1.0f;
    for (int e = 0; e < BM_MAX_C; ++e)
      P.xcm[c * BM_MAX_C + e] = (c < C && e < C) ? xcm[c * C + e] : 0.0f;
  }
  P.p = p;
  P.max_v = max_v;
  P.blur_scale = blur_scale;
  P.beta = beta;
  for (int k = 0; k < BM_MAX_TAPS; ++k) P.taps[k] = k < ntaps ? taps[k] : 0.0f;
  P.ntaps = ntaps;
  if (n_a > 0x7fffffffLL || n_t > 0x7fffffffLL || n_p > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;

  cudaStream_t st = (cudaStream_t)stream;
  band_stage_a<<<(unsigned int)n_a, 256, 0, st>>>(P);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 threads_b(BM_THREADS_X, BM_THREADS_Y);
  if (d_out) {
    band_stage_b<true><<<(unsigned int)n_t, threads_b, 0, st>>>(P, nullptr);
    return (int)cudaGetLastError();
  }
  band_stage_b<false><<<(unsigned int)n_t, threads_b, 0, st>>>(P, partials);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  band_stage_c<<<(unsigned int)n_p, 256, 0, st>>>(P, partials, out);
  return (int)cudaGetLastError();
}
