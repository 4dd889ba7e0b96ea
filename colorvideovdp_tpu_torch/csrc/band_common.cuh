// The band kernels' shared arithmetic: stage A on raw pairs and on contrast
// bands, the expand tap,
// the stage-B transducer and its epilogue, the block sums and stage C, of
// csrc/band_pooled.cu (the one-pass band kernel, pooled, D and halo).
#pragma once

#include "common.cuh"

#define BM_MAX_BANDS 8
#define BM_MAX_C 4
#define BM_MAX_TAPS 17
#define BM_TH 32  // partial tile: one pooled sum per 32 x 32 tile and channel
#define BM_TW 32
#define BM_EPS 1e-5f

__device__ __forceinline__ float min1000(float x) { return x > 1000.0f ? 1000.0f : x; }

// Stage A on raw pairs at one pixel; every product and quotient is rounded
// on its own. S_c = 10^lut_c(ind) * (gain_c * band_mul);
// T/R = min((gi - E) / lb, 1000) * S_c; M_pre = min(|T|, |R|); diff = |T - R|.
__device__ __forceinline__ float raw_sensitivity(const float* lut, int nk, float ind,
                                                 float gain, float mul) {
  return __fmul_rn(pow10_lut(lut_lerp(lut, nk, ind)), __fmul_rn(gain, mul));
}

__device__ __forceinline__ void raw_pair(float g_t, float e_t, float g_r, float e_r, float lb_t,
                                         float lb_r, float S, float& mpre, float& diff) {
  const float T = __fmul_rn(min1000(__fdiv_rn(__fsub_rn(g_t, e_t), lb_t)), S);
  const float R = __fmul_rn(min1000(__fdiv_rn(__fsub_rn(g_r, e_r), lb_r)), S);
  mpre = fminf(fabsf(T), fabsf(R));
  diff = fabsf(__fsub_rn(T, R));
}

// Stage A on a pair of pre-formed contrast-band samples (at full band
// gain): T = band_t * S * g, R likewise, each product rounded as
// masking.apply_masking_model rounds it (S = 10^lut_c(logL) * sens_corr).
__device__ __forceinline__ void contrast_pair(float b_t, float b_r, float S, float g,
                                              float& mpre, float& diff) {
  const float T = __fmul_rn(__fmul_rn(b_t, S), g);
  const float R = __fmul_rn(__fmul_rn(b_r, S), g);
  mpre = fminf(fabsf(T), fabsf(R));
  diff = fabsf(__fsub_rn(T, R));
}

// One sample of E = gausspyr_expand(gn) along one axis, rounded as
// ops/pyramid.py `_expand_1d` rounds it: even ((k0 a + k2 b) + k4 c), odd
// (k1 a + k3 b), over the edge-clamped samples of gn (the 1-sample replicate
// pad); an odd band size ends on an even sample. Output index y of a band
// of n gn samples; s holds gn samples from index `base` on, `stride` apart.
__device__ __forceinline__ float expand_tap(const float* ek, const float* s, int stride, int y,
                                            int n, int base) {
  const int m = y >> 1;
  if ((y & 1) == 0) {
    const float a = s[(max(m - 1, 0) - base) * stride];
    const float b = s[(m - base) * stride];
    const float c = s[(min(m + 1, n - 1) - base) * stride];
    return __fadd_rn(__fadd_rn(__fmul_rn(ek[0], a), __fmul_rn(ek[2], b)), __fmul_rn(ek[4], c));
  }
  const float a = s[(m - base) * stride];
  const float b = s[(min(m + 1, n - 1) - base) * stride];
  return __fadd_rn(__fmul_rn(ek[1], a), __fmul_rn(ek[3], b));
}

// expand_tap without the branch on y's parity (neighbouring threads take
// samples of both parities): the three gn samples around y >> 1 are read
// and both sums formed, with the roundings of expand_tap, so the result is
// its bits.
__device__ __forceinline__ float expand_tap_sel(const float* ek, const float* s, int y, int n,
                                                int base) {
  const int m = y >> 1;
  const float a = s[max(m - 1, 0) - base];
  const float b = s[m - base];
  const float c = s[min(m + 1, n - 1) - base];
  const float even =
      __fadd_rn(__fadd_rn(__fmul_rn(ek[0], a), __fmul_rn(ek[2], b)), __fmul_rn(ek[4], c));
  const float odd = __fadd_rn(__fmul_rn(ek[1], b), __fmul_rn(ek[3], c));
  return (y & 1) ? odd : even;
}

// Stage B's transducer of one blurred sample mb (already x 10^mask_c) of
// channel q: safe_pow(|mb|, q). The caller adds xcm[c][d] * mq into mix_d.
__device__ __forceinline__ float masking_mq(float mb, float q, float eps_q) {
  return powf(fabsf(mb) + BM_EPS, q) - eps_q;
}

// D = soft_clamp(safe_pow(diff, p) / (1 + mix)).
__device__ __forceinline__ float masked_D(float df, float mix, float p, float eps_p,
                                          float max_v) {
  const float du = (powf(df + BM_EPS, p) - eps_p) / (1.0f + mix);
  return max_v * du / (max_v + du);
}

// One pixel's term of the pooled sum: safe_pow(D, beta).
__device__ __forceinline__ float pooled_term(float D, float beta, float eps_b) {
  return pow_static(D + BM_EPS, beta) - eps_b;
}

// The warp's tree sum, valid in lane 0.
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// The block's sum: each warp's tree sum, then the warps in order in thread 0.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
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

// Stage C of one (band, image plane), run by a block of BM_STAGE_C_THREADS:
// the plane's tpp tile partials (C floats each, from tile `first` on) summed
// in a fixed order into out[dd * out_stride], dd < C. No float atomics, so
// the result is deterministic.
#define BM_STAGE_C_THREADS 256
__device__ __forceinline__ void plane_sums(const float* __restrict__ partials, long long first,
                                           int tpp, int C, float* out, long long out_stride,
                                           float* red) {
  for (int dd = 0; dd < C; ++dd) {
    float s = 0.0f;
    for (int k = threadIdx.x; k < tpp; k += blockDim.x) s += partials[(first + k) * C + dd];
    s = block_sum(s, red);
    if (threadIdx.x == 0) out[dd * out_stride] = s;
  }
}
