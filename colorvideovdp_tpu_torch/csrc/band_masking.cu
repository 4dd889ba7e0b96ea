// Per-band CSF + contrast masking for the band-kernel configuration
// (mult-mutual masking, cross-channel mix, soft clamp): pooled scores, or the
// per-pixel distortion map D for the heatmap.
//
// Replaces five TPU kernels of colorvideovdp_tpu/ops/kernels/:
//   masking_fused.py `fused_csf_contrast_raw` (`_kernel_a_raw`, stage A on
//     raw pairs, weber_g1 / weber_g1_ref),
//   masking_fused.py `fused_csf_contrast` (`_kernel_a`, stage A on
//     pre-formed contrast bands: weber_g0_ref, log, or any contrast off the
//     raw-pair route),
//   masking_fused.py `fused_blur_transducer` (`_blur_b_kernel`), pooled and
//     in its D-output mode (`pool_beta=None`),
//   masking_fused.py `fused_masking_transducer` (`_kernel_b`, the transducer
//     on a band whose blur is skipped: here the same stage B with a unit
//     tap), and
//   band_stack.py `make_band_stack` (`_stack_kernel`, all narrow bands), and
//   band_fused.py `band_fused_tpu` (:320, `_band_kernel`, the band
//     mega-kernel: expand + contrast + CSF + masking + pooling or D in one
//     pass): the fused mode below.
// One launch handles a list of up to BM_MAX_BANDS bands of any sizes (per-band
// LUT rows, sizes and gains come from the band table, so one build serves
// every band); ops/kernels/masking_fused.py `band_groups` picks the lists.
//
// Two input modes for stage A (BandParams.contrast):
//  raw pairs (contrast = 0): per band gi (B, 2C, F, h, w), the Gaussian level
//    with test/reference channels interleaved, and E, the expanded next
//    level, same shape.
//    lb = max(E_Y, 0.01); T/R = min((gi - E) / lb, 1000) * 10^lut(log10 lb_R)
//    * gain_c * band_mul.
//  contrast bands (contrast = 1): per band the contrast band (B, 2C, F, h, w)
//    as the non-raw decomposition gives it, test/reference interleaved and
//    already at full band gain, and logL (B, 1, F, h, w), the CSF's
//    adaptation field, in the slots of gi and E.
//    S_c = 10^lut_c(logL) * sens_corr; T_p = T * S_c * g_c, R_p likewise,
//    each product rounded as the plain chain (masking.apply_masking_model)
//    rounds it, so that stage A gives the plain version's bits.
//  Both: M_pre = min(|T|, |R|); diff = |T - R|, one thread per pixel, all C
//  channels.
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
// The fused mode (expand = 1; ops/kernels/band_fused.py): raw pairs with the
//   next Gaussian level gn in place of E. Stage A does not run; each stage-B
//   block expands gn over its tile's window (the 32 x 32 tile plus the blur
//   halo, clipped to the band) in shared memory, rows then columns, rounded
//   as ops/pyramid.py `_expand_1d` rounds each sample, forms stage A's M_pre
//   for the window into the blur's input and diff for its own pixels in
//   registers (raw_pair, shared with stage A), then runs stage B and, pooled,
//   stage C. Neither E, M_pre nor diff reaches device memory, and the result
//   is the raw-pair route's fed the plain expand, bit for bit.
//   Bound on the H100: memory. Per pixel it reads the 2C planes of gi and
//   the 2C quarter planes of gn (40 B at C = 4) and writes C floats per tile
//   pooled, or C floats per pixel in D mode (56 B). The halo makes each block
//   recompute E and M_pre on (32 + 2r)^2 / 32^2 of its pixels, 2.25 times at
//   r = 8 (the default 13 taps, r = 6: 1.89 times), out of about 74 KB of
//   shared memory a block.
//
// The halo mode (pooled, raw pairs or contrast bands; per band row_off > 0)
//   replaces `fused_blur_transducer`'s halo'd shard mode (`row_off` /
//   `h_valid`, masking_fused.py:219-227, :313-316, :333-343): the band is one
//   rank's row slab of a band sharded over image rows, h = h_valid + 2 row_off
//   buffer rows, the owned rows [row_off, row_off + h_valid) with row_off real
//   neighbour rows above and below (at a global edge the exclude-edge
//   reflection, x[-s] = x[s], built by the caller). Stage A runs on every
//   buffer row (it is elementwise); stage B's tiles cover the owned rows only
//   and read the halo rows as they are, without the vertical reflection
//   (row_off >= the blur radius), so that a slab's blurred rows are those of
//   the whole band; only owned rows feed the tile sums. The caller sums the
//   ranks' pooled sums. Bound as stage A + B + C: memory.
//
// Bound on the H100: memory. Stage A reads 16 floats per pixel (C = 4) and
// writes 8 (raw pairs; contrast bands read 9); stage B reads the 8 again
// (halo re-reads of M_pre hit L2) and writes C floats per tile, or C per
// pixel in D mode. The blur is 2 * 13 multiply-adds per channel and pixel out
// of shared memory. In pooled mode D never reaches device memory.

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
  const float* E;  // expand mode: gn, (B, 2C, F, ceil(h/2), ceil(w/2))
  float* mpre;
  float* diff;
  float* D;  // D mode: (B, C, F, h, w) output
  int h, w;
  int row_off, h_valid;  // halo mode: owned rows [row_off, row_off + h_valid)
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
  float ch_gain[BM_MAX_C];  // channel gain
  float sens_corr;          // sensitivity correction
  float gains[BM_MAX_C];    // raw pairs: ch_gain x sens_corr, rounded once
  int ref_only;
  int contrast;             // stage A input: 0 raw pairs, 1 contrast bands
  int expand;               // 1: raw pairs with gn in E's slot (fused mode)
  float ek[5];              // expand taps, 2 * K5
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

// Stage A on raw pairs at one pixel, shared by stage A and the fused mode so
// that the two give the same bits; every product and quotient is rounded on
// its own. S_c = 10^lut_c(ind) * (gain_c * band_mul);
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
  const float* lut = P.luts + (long long)bi * C * P.nk;
  const long long out0 = ((long long)b * C * F + f) * hw + pix;

  if (P.contrast) {
    // gi holds the contrast band, E the (B, 1, F, h, w) adaptation field.
    const float ind = lut_index(d.E[i], P.x0, P.lut_scale, P.nk);
    for (int c = 0; c < C; ++c) {
      const float S = __fmul_rn(pow10_lut(lut_lerp(lut + c * P.nk, P.nk, ind)), P.sens_corr);
      const long long it = in0 + (2 * c) * cstride;
      const float T = __fmul_rn(__fmul_rn(d.gi[it], S), P.ch_gain[c]);
      const float R = __fmul_rn(__fmul_rn(d.gi[it + cstride], S), P.ch_gain[c]);
      d.mpre[out0 + c * cstride] = fminf(fabsf(T), fabsf(R));
      d.diff[out0 + c * cstride] = fabsf(__fsub_rn(T, R));
    }
    return;
  }
  const float lb_r = fmaxf(d.E[in0 + cstride], 0.01f);
  const float lb_t = P.ref_only ? lb_r : fmaxf(d.E[in0], 0.01f);
  const float ind = lut_index(log10f(lb_r), P.x0, P.lut_scale, P.nk);
  for (int c = 0; c < C; ++c) {
    const float S = raw_sensitivity(lut + c * P.nk, P.nk, ind, P.gains[c], d.mul);
    const long long it = in0 + (2 * c) * cstride;
    const long long ir = it + cstride;
    raw_pair(d.gi[it], d.E[it], d.gi[ir], d.E[ir], lb_t, lb_r, S, d.mpre[out0 + c * cstride],
             d.diff[out0 + c * cstride]);
  }
}

// The fused mode's expand: E = gausspyr_expand(gn) of one plane over the
// window of band rows [wy0, wy0 + eh) and columns [wx0, wx0 + ew), into
// Ew (eh x BF_EW). Rows first, then columns, each output sample rounded as
// ops/pyramid.py `_expand_1d` rounds it: even ((k0 a + k2 b) + k4 c), odd
// (k1 a + k3 b), over the edge-clamped samples of gn (the 1-sample
// replicate pad); an odd band size ends on an even sample. gnw and rexp are
// shared scratch. Every thread of the block must call it; it ends with
// __syncthreads().
#define BF_EW (BM_TH + 2 * BM_R_MAX)  // window side
#define BF_GW (BF_EW / 2 + 4)         // gn window side (at most BF_EW / 2 + 3)

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

__device__ void expand_window(const float* __restrict__ gn, int hn, int wn, int wy0, int eh,
                              int wx0, int ew, const float* ek, float* gnw, float* rexp,
                              float* Ew) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthr = blockDim.x * blockDim.y;
  const int gr0 = max((wy0 >> 1) - 1, 0), gr1 = min(((wy0 + eh - 1) >> 1) + 1, hn - 1);
  const int gc0 = max((wx0 >> 1) - 1, 0), gc1 = min(((wx0 + ew - 1) >> 1) + 1, wn - 1);
  const int gh = gr1 - gr0 + 1, gw = gc1 - gc0 + 1;
  __syncthreads();  // the previous plane's readers are done with the scratch
  for (int idx = tid; idx < gh * gw; idx += nthr) {
    const int i = idx / gw, j = idx % gw;
    gnw[i * BF_GW + j] = gn[(long long)(gr0 + i) * wn + gc0 + j];
  }
  __syncthreads();
  for (int idx = tid; idx < eh * gw; idx += nthr) {
    const int yy = idx / gw, j = idx % gw;
    rexp[yy * BF_GW + j] = expand_tap(ek, gnw + j, BF_GW, wy0 + yy, hn, gr0);
  }
  __syncthreads();
  for (int idx = tid; idx < eh * ew; idx += nthr) {
    const int yy = idx / ew, xx = idx % ew;
    Ew[yy * BF_EW + xx] = expand_tap(ek, rexp + yy * BF_GW, 1, wx0 + xx, wn, gc0);
  }
  __syncthreads();
}

// Dynamic shared memory of the fused mode: E of the Y pair and of the
// current channel's pair over the window, the LUT index over the window,
// the expand scratch and the tile's diff of the current channel.
#define BF_SMEM_FLOATS \
  (5 * BF_EW * BF_EW + BF_GW * BF_GW + BF_EW * BF_GW + BM_TH * BM_TW)

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

// FUSED: the fused mode (stages A and B in one pass). The block expands gn
// over its tile's window in shared memory, forms the LUT index of the window
// once, then per channel M_pre for the tile and its blur halo into `sm` (the
// samples stage B would read from M_pre) and the tile's diff, through the
// same raw_pair as stage A; the blur, transducer and epilogue are stage B's
// code. Registers are capped for two blocks per SM.
template <bool D_OUT, bool FUSED>
__global__ void __launch_bounds__(BM_THREADS_X* BM_THREADS_Y, FUSED ? 2 : 1)
    band_stage_b(BandParams P, float* __restrict__ partials) {
  __shared__ float sm[(BM_TH + 2 * BM_R_MAX) * (BM_TW + 2 * BM_R_MAX)];
  __shared__ float tmp[BM_TH * (BM_TW + 2 * BM_R_MAX)];
  __shared__ float s_taps[BM_MAX_TAPS];
  __shared__ float red[32];
  extern __shared__ float dyn[];  // FUSED: BF_SMEM_FLOATS

  const int bi = band_of(P, blockIdx.x, 1);
  const BandDesc& d = P.band[bi];
  const int C = P.C, F = P.F;
  const int h = d.h, w = d.w;
  const long long hw = (long long)h * w;
  const long long t = blockIdx.x - d.tile_off;
  const int tpp = d.tiles_x * d.tiles_y;
  const long long l = t / tpp;  // image plane b * F + f
  const int tt = (int)(t % tpp);
  const int y0 = d.row_off + (tt / d.tiles_x) * BM_TH;
  const int y_end = d.row_off + d.h_valid;  // end of the rows the tile sums take
  const int x0 = (tt % d.tiles_x) * BM_TW;
  const int b = (int)(l / F), f = (int)(l % F);

  const int r = d.blur ? (P.ntaps - 1) / 2 : 0;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  if (tid < BM_MAX_TAPS) s_taps[tid] = d.blur ? P.taps[tid] : (tid == 0 ? 1.0f : 0.0f);

  float mix[BM_ROWS_PER_THREAD][BM_MAX_C];
  float dreg[BM_ROWS_PER_THREAD][BM_MAX_C];  // FUSED: diff of own pixels
#pragma unroll
  for (int k = 0; k < BM_ROWS_PER_THREAD; ++k)
#pragma unroll
    for (int dd = 0; dd < BM_MAX_C; ++dd) mix[k][dd] = dreg[k][dd] = 0.0f;

  // FUSED: the window of band pixels the tile and its halo read.
  const int wy0 = max(y0 - r, 0), wy1 = min(y0 + BM_TH + r, h);
  const int wx0 = max(x0 - r, 0), wx1 = min(x0 + BM_TW + r, w);
  const int hn = (h + 1) / 2, wn = (w + 1) / 2;
  float* EY0 = dyn;
  float* EY1 = EY0 + BF_EW * BF_EW;
  float* EC0 = EY1 + BF_EW * BF_EW;
  float* EC1 = EC0 + BF_EW * BF_EW;
  float* IND = EC1 + BF_EW * BF_EW;
  float* gnw = IND + BF_EW * BF_EW;
  float* rexp = gnw + BF_GW * BF_GW;
  float* sdiff = rexp + BF_EW * BF_GW;
  auto gi_plane = [&](int k) {
    return d.gi + (((long long)b * 2 * C + k) * F + f) * hw;
  };
  auto expand = [&](int k, float* Ew) {
    const long long hwn = (long long)hn * wn;
    expand_window(d.E + (((long long)b * 2 * C + k) * F + f) * hwn, hn, wn, wy0, wy1 - wy0,
                  wx0, wx1 - wx0, P.ek, gnw, rexp, Ew);
  };
  if (FUSED) {
    expand(0, EY0);
    expand(1, EY1);
    const int ew = wx1 - wx0;
    for (int idx = tid; idx < (wy1 - wy0) * ew; idx += BM_THREADS_X * BM_THREADS_Y) {
      const int e = (idx / ew) * BF_EW + idx % ew;
      IND[e] = lut_index(log10f(fmaxf(EY1[e], 0.01f)), P.x0, P.lut_scale, P.nk);
    }
  }

  for (int c = 0; c < C; ++c) {
    if (FUSED) {
      if (c > 0) {
        expand(2 * c, EC0);
        expand(2 * c + 1, EC1);
      }
      const float* Et = c == 0 ? EY0 : EC0;
      const float* Er = c == 0 ? EY1 : EC1;
      const float* g_t = gi_plane(2 * c);
      const float* g_r = gi_plane(2 * c + 1);
      const float* lut = P.luts + ((long long)bi * C + c) * P.nk;
      __syncthreads();  // previous channel done with sm/tmp/sdiff; taps visible
      const int SW = BM_TW + 2 * r, SH = BM_TH + 2 * r;
      for (int idx = tid; idx < SH * SW; idx += BM_THREADS_X * BM_THREADS_Y) {
        const int yy = idx / SW, xx = idx % SW;
        // The reflected sample stage B reads; clamped into the window, which
        // moves only samples that feed rows or columns past the band's edge.
        const int gy = min(max(reflect_clamp(y0 - r + yy, h), wy0), wy1 - 1);
        const int gx = min(max(reflect_clamp(x0 - r + xx, w), wx0), wx1 - 1);
        const int e = (gy - wy0) * BF_EW + (gx - wx0);
        const float lb_r = fmaxf(EY1[e], 0.01f);
        const float lb_t = P.ref_only ? lb_r : fmaxf(EY0[e], 0.01f);
        const float S = raw_sensitivity(lut, P.nk, IND[e], P.gains[c], d.mul);
        const long long o = (long long)gy * w + gx;
        float mp, df;
        raw_pair(g_t[o], Et[e], g_r[o], Er[e], lb_t, lb_r, S, mp, df);
        sm[idx] = mp;
        // Tile pixels inside the band sit unreflected at (yy - r, xx - r).
        const int ty = yy - r, tx = xx - r;
        if (ty >= 0 && ty < BM_TH && tx >= 0 && tx < BM_TW) sdiff[ty * BM_TW + tx] = df;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < BM_ROWS_PER_THREAD; ++k) {
        const float df = sdiff[(threadIdx.y + k * BM_THREADS_Y) * BM_TW + threadIdx.x];
#pragma unroll
        for (int dd = 0; dd < BM_MAX_C; ++dd)
          if (dd == c) dreg[k][dd] = df;
      }
      tile_blur_vpass<BM_TH, BM_TW>(r, s_taps, sm, tmp);
    } else {
      const float* m = d.mpre + (((long long)b * C + c) * F + f) * hw;
      __syncthreads();  // previous channel done with sm/tmp; taps visible
      tile_blur_vertical<BM_TH, BM_TW>(m, h, w, y0, x0, r, s_taps, sm, tmp, d.row_off == 0);
    }
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
        const float df = FUSED ? dreg[k][dd] : d.diff[o];
        const float du = (powf(df + BM_EPS, P.p) - eps_p) / (1.0f + mix[k][dd]);
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
    if (gy >= y_end || gx >= w) continue;
#pragma unroll
    for (int dd = 0; dd < BM_MAX_C; ++dd) {
      if (dd >= C) continue;
      const float df = FUSED ? dreg[k][dd]
                             : d.diff[(((long long)b * C + dd) * F + f) * hw +
                                      (long long)gy * w + gx];
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

// halo: n_bands x {row_off, h_valid}; {0, h} outside the halo mode.
static void layout(BandParams& P, const int* dims, const int* halo, long long* n_blocks_a,
                   long long* n_tiles, long long* n_planes) {
  long long blk = 0, tiles = 0, planes = 0;
  for (int k = 0; k < P.n_bands; ++k) {
    BandDesc& d = P.band[k];
    d.h = dims[2 * k];
    d.w = dims[2 * k + 1];
    d.row_off = halo[2 * k];
    d.h_valid = halo[2 * k + 1];
    d.tiles_x = (d.w + BM_TW - 1) / BM_TW;
    d.tiles_y = (d.h_valid + BM_TH - 1) / BM_TH;
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
                                             const int* dims, const int* halo) {
  BandParams P;
  P.n_bands = n_bands;
  P.B = B;
  P.F = F;
  long long a, t, p;
  layout(P, dims, halo, &a, &t, &p);
  return t;
}

// ptrs: n_bands x {gi, E, mpre, diff, D} device pointers (D unused in pooled
// mode; with contrast = 1 gi is the contrast band and E the logL field; with
// expand = 1, the fused mode, E is gn, the next Gaussian level
// (B, 2C, F, ceil(h/2), ceil(w/2)), ek its 5 expand taps, and mpre/diff are
// unused);
// dims: n_bands x {h, w}; halo: n_bands x {row_off, h_valid} ({0, h} for a
// whole band; row_off > 0, the halo mode, pooled only, not with expand = 1,
// and row_off >= the blur radius); muls, blur: per band (muls unused with
// contrast = 1); luts: device (n_bands, C, nk); ch_gain, qs: C floats; xcm: C x C
// floats; taps: ntaps floats. d_out = 0: partials is (tiles, C) scratch and
// out receives the (n_bands, B, C, F) pooled sums of safe_pow(D, beta).
// d_out = 1: each band's D is written to its D pointer; partials and out are
// not touched.
CVVDP_API int cvvdp_band_masking(
    int n_bands, int B, int C, int F, int nk, const long long* ptrs,
    const int* dims, const int* halo, const float* muls, const int* blur, const float* luts,
    float x0, float lut_scale, const float* ch_gain, float sens_corr, int ref_only,
    int contrast, int expand, const float* ek, const float* qs, float p, const float* xcm,
    float max_v, float blur_scale, const float* taps, int ntaps, float beta, int d_out,
    float* partials, float* out, void* stream) {
  if (n_bands < 1 || n_bands > BM_MAX_BANDS || C < 1 || C > BM_MAX_C ||
      ntaps < 1 || ntaps > BM_MAX_TAPS || (ntaps % 2) != 1 || (expand && contrast))
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
  layout(P, dims, halo, &n_a, &n_t, &n_p);
  for (int k = 0; k < n_bands; ++k) {
    const BandDesc& d = P.band[k];
    const int r = d.blur ? (ntaps - 1) / 2 : 0;
    if (d.row_off < 0 || d.h_valid < 1 || d.h != d.h_valid + 2 * d.row_off ||
        (d.row_off > 0 && (d_out || expand || d.row_off < r)))
      return (int)cudaErrorInvalidValue;
  }
  P.luts = luts;
  P.x0 = x0;
  P.lut_scale = lut_scale;
  P.ref_only = ref_only;
  P.contrast = contrast;
  P.expand = expand;
  for (int k = 0; k < 5; ++k) P.ek[k] = expand ? ek[k] : 0.0f;
  P.sens_corr = sens_corr;
  for (int c = 0; c < BM_MAX_C; ++c) {
    P.ch_gain[c] = c < C ? ch_gain[c] : 0.0f;
    P.gains[c] = P.ch_gain[c] * sens_corr;
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
  const dim3 threads_b(BM_THREADS_X, BM_THREADS_Y);
  cudaError_t e;
  if (expand) {
    // Above the 48 KB default with the static arrays: opt in.
    const int smem = BF_SMEM_FLOATS * (int)sizeof(float);
    auto kern = d_out ? band_stage_b<true, true> : band_stage_b<false, true>;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<(unsigned int)n_t, threads_b, smem, st>>>(P, d_out ? nullptr : partials);
    e = cudaGetLastError();
    if (d_out || e != cudaSuccess) return (int)e;
  } else {
    band_stage_a<<<(unsigned int)n_a, 256, 0, st>>>(P);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    if (d_out) {
      band_stage_b<true, false><<<(unsigned int)n_t, threads_b, 0, st>>>(P, nullptr);
      return (int)cudaGetLastError();
    }
    band_stage_b<false, false><<<(unsigned int)n_t, threads_b, 0, st>>>(P, partials);
    e = cudaGetLastError();
  }
  if (e != cudaSuccess) return (int)e;
  band_stage_c<<<(unsigned int)n_p, 256, 0, st>>>(P, partials, out);
  return (int)cudaGetLastError();
}
