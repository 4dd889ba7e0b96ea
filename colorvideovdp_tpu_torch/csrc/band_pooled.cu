// One-pass band masking of raw bands: expand, Weber contrast, CSF, masking
// blur, transducer and pooling, from each band's Gaussian level gi and the
// next level gn. It gives the bits of the raw-pair route of
// csrc/band_masking.cu (stages A, B and C, or its D mode) fed
// E = gausspyr_expand(gn), with E, M_pre and diff kept out of device memory.
// Two modes of one kernel (the D_OUT template flag): pooled, where D never
// reaches memory either, and D, which also stores each pixel's D for the
// heatmap.
//
// Replaces, for the pooled raw-pair route of ops/kernels/band_pooled.py:
//   colorvideovdp_tpu/ops/kernels/masking_fused.py `fused_csf_contrast_raw`
//     (:440, stage A on raw pairs) + `fused_blur_transducer` (:352, pooled),
//   colorvideovdp_tpu/ops/kernels/band_stack.py `make_band_stack` (:253, the
//     narrow bands in one launch), and
//   colorvideovdp_tpu/ops/kernels/band_fused.py `band_fused_tpu` (:320, the
//     band mega-kernel, pooled and D).
// and, in the D mode (ops/kernels/band_pooled.py band_pooled_d), the D
// output of `fused_blur_transducer` (:352, pool_beta=None) on bands that take
// the masking blur and `fused_masking_transducer` (:463) on bands whose blur
// is skipped (the unit tap, r = 0).
// The contrast-band codings (PooledParams.coding weber_g0_ref, log) replace
// `fused_csf_contrast` (:403) + `fused_blur_transducer` (:352), pooled and
// D, fed the bands and logL that the JAX package's decomposition writes
// (colorvideovdp_tpu/ops/pyramid.py:488-579): here the contrast band, its
// band gain and its adaptation field are formed per sample, rounded as the
// pre-formed band route of csrc/band_masking.cu rounds them.
// The halo mode (per band geometry, pooled only) replaces the halo'd shard
// mode of `fused_blur_transducer` (`row_off`/`h_valid`, :219-227, :540-602):
// gi is one rank's row slab with row_off neighbour rows on each side (the
// exclude-edge reflection past a global edge), gn the rows of the next
// level the slab's expand reads; the expand is taken at each buffer row's
// reflected global row, stage B reads the halo rows as they are, and only
// the owned rows are pooled. The caller sums the ranks' sums.
// The JAX package expands gn in XLA before its band kernels
// (colorvideovdp_tpu/metrics/cvvdp.py:1400-1410); here the expand is inside.
//
// Inputs per band (up to BM_MAX_BANDS in one launch, any sizes): gi
// (B, 2C, F, h, w), test/reference channels interleaved, and gn
// (B, 2C, F, ceil(h/2), ceil(w/2)). Output: one partial sum of safe_pow(D,
// beta) per 32x32 tile and channel, in the slots and in the in-tile order of
// band_masking.cu's stage B, then the same stage C (band_common.cuh
// plane_sums): the (n_bands, B, C, F) pooled sums, deterministic, no float
// atomics. The D mode also writes D (B, C, F, h, w) per band, each row of a
// tile by one warp (coalesced), from the registers the pooled term is formed
// from, so its sums are the pooled mode's and the heatmap's JOD is the
// pooled-only JOD.
//
// Bound on the H100: per pixel the 2C planes of gi and the 2C quarter planes
// of gn are read once (40 B at C = 4; 9.6 GB, 2.9 ms at 3.35 TB/s, for band
// 0 of a 29-frame 4K block) and C floats per 32x32 tile are written; the D
// mode adds C floats a pixel (4 B x C a pixel written; at band 0 of an
// 8-frame 4K block 1.06 GB, 0.32 ms). The
// arithmetic is about 115 float32 operations per pixel and channel counting
// each transcendental (powf, log10f) and each IEEE division as one; they
// take many dependent instructions each, so the kernel is bound by their
// latency well above its byte bound: its time follows the warps an SM holds
// (PERF.md), and the design cuts instructions and stalls:
//   * Block tiles of 32 x 32 pixels, the partial tiles themselves, at three
//     256-thread blocks an SM (85 registers a thread, about 68 KB of dynamic
//     shared memory a block at r <= 6). The stage-A work on the blur halo is
//     (32 + 2r)^2 / 1024 = 1.89x at the default 13 taps (r = 6); 32 x 64
//     tiles cut it to 1.63x but fit two blocks an SM and were measured
//     slower on the H100 (PERF.md): the warps an SM holds count, not the
//     halo.
//   * Per job (tile, channel pair) the block copies the gi window
//     ((32 + 2r) x (32 + 2r), clipped to the band) and the gn window it
//     expands from into shared memory with cp.async: 16-byte copies where
//     the rows are 16-byte aligned (w % 4 == 0), 4-byte ones otherwise (the
//     narrow bands of 30 or 15 columns; TMA's 16-byte pitch rule excludes
//     them too). The next job's windows are issued as soon as the current
//     job has formed M_pre, so they are in flight while the current channel
//     is blurred and transduced (the staging buffer and the M_pre buffer
//     alternate, a double buffer without a second staging copy).
//   * The expand runs as one vertical pass of both planes of the pair into
//     shared memory, every thread busy, and the horizontal taps are taken
//     where M_pre is formed. The Y pair's expand gives the adaptation
//     luminances and the LUT index of every window pixel once per tile; the
//     other channel pairs read them.
//   * A persistent grid of as many blocks as fit walks the tiles in a fixed
//     order; a block loads a band's LUT rows and blur taps into shared
//     memory once, when it enters the band.
//   * The tile's own pixels are computed by the threads that pool them, so
//     diff stays in registers; the halo ring is computed by all threads. A
//     tile whose window the band does not clip skips the reflection.
//   * No tensor cores: TF32 or bf16 would break the float32 parity with the
//     plain chain (every product and quotient is rounded as there).

#include "band_common.cuh"

#define BP_TH BM_TH  // block tile = partial tile, 32 x 32
#define BP_TW BM_TW
#define BP_THREADS 256
#define BP_MIN_BLOCKS 3  // blocks an SM the registers are capped for
#define BP_WARPS (BP_THREADS / 32)
#define BP_ROWS (BP_TH / BP_WARPS)  // rows a thread pools
#define BP_MAX_NK 64

// Contrast codings (PooledParams.coding): the raw codings adapt to the
// expanded Y, and S folds the band gain in (raw_sensitivity); the
// contrast-band codings round as the pre-formed band route does: the band
// (x band gain), then band * S, then x the channel gain.
#define BP_WEBER_G1 0      // each side to its own E_Y
#define BP_WEBER_G1_REF 1  // both to the reference's E_Y
#define BP_WEBER_G0_REF 2  // both to the reference's Y of gi itself
#define BP_LOG 3           // gi - E, no division; LUT input a (E_Y,ref - b)

struct PooledBand {
  const float* gi;
  const float* gn;
  float* D;  // the D mode: (B, C, F, h, w)
  // gi holds h rows; the halo mode: a rank's row slab of a band of h_glob
  // rows, row_off neighbour rows on each side of its owned rows, buffer
  // row 0 at global row g_off (rows past a global edge hold the
  // exclude-edge reflection). Whole bands: row_off = g_off = 0, h_glob = h.
  int h, w, hn, wn;
  int row_off, y_end;  // tiles cover buffer rows [row_off, y_end)
  int g_off, h_glob;
  int gn_row0, hn_buf;  // gn holds hn_buf rows from global row gn_row0 on
  float mul;
  int r;                 // blur radius; 0 (a unit tap) where the blur is skipped
  int vec_gi, vec_gn;    // 16-byte rows: 16-byte copies
  int tiles_x, tiles_y;  // 32x32 tiles
  long long tile_off;    // first tile of the band
  long long plane_off;   // first (b, f) plane of the band (stage C)
};

struct PooledParams {
  int n_bands, B, C, F, nk;
  PooledBand band[BM_MAX_BANDS];
  const float* luts;  // (n_bands, C, nk)
  float x0, lut_scale;
  float gains[BM_MAX_C];  // raw codings: channel gain x sensitivity correction
  float ch_gain[BM_MAX_C], sens_corr;  // contrast-band codings: apart
  int coding;
  float log_a, log_b;  // the log coding's LUT input a (E_Y - b)
  float ek[5];  // expand taps, 2 * K5
  float qs[BM_MAX_C];
  float p;
  float xcm[BM_MAX_C * BM_MAX_C];  // 2^xcm_weights, [c][d]
  float max_v, blur_scale, beta;
  float taps[BM_MAX_TAPS];
  int ntaps;
  long long n_tiles;  // tiles of all bands
  // Dynamic shared memory, in floats, sized for the launch's largest radius.
  int y_plane, rexp_plane, giw_plane, gnw_plane;
  int o_y, o_mpre, o_rexp, o_giw, o_gnw, o_lut;
};

// Row pitches (floats) of the staged gi window and of the gn window and its
// vertical expand, for blur radius r: the window is at most 32 + 2r columns
// (19 + r of gn), plus up to 3 on each side for 16-byte alignment.
__host__ __device__ __forceinline__ int gi_pitch(int r) { return (BP_TW + 2 * r + 9) & ~3; }
__host__ __device__ __forceinline__ int gn_pitch(int r) { return (BP_TW / 2 + r + 12) & ~3; }
__host__ __device__ __forceinline__ int gn_rows(int r) { return BP_TH / 2 + r + 3; }

// Dynamic shared memory of a launch whose largest blur radius is r_max, in
// floats, each segment 16-byte aligned; fills P's offsets when given.
static int pooled_smem_floats(int r_max, int C, int nk, PooledParams* P) {
  auto up4 = [](int n) { return (n + 3) & ~3; };
  const int WH = BP_TH + 2 * r_max, SW = BP_TW + 2 * r_max;
  PooledParams Q;
  PooledParams& R = P ? *P : Q;
  R.y_plane = up4(WH * SW);
  R.rexp_plane = up4(WH * gn_pitch(r_max));
  R.giw_plane = up4(WH * gi_pitch(r_max));
  R.gnw_plane = up4(gn_rows(r_max) * gn_pitch(r_max));
  R.o_y = 0;
  R.o_mpre = R.o_y + 3 * R.y_plane;
  R.o_rexp = R.o_mpre + up4(WH * SW);
  R.o_giw = R.o_rexp + 2 * R.rexp_plane;
  R.o_gnw = R.o_giw + 2 * R.giw_plane;
  R.o_lut = R.o_gnw + 2 * R.gnw_plane;
  return R.o_lut + up4(C * nk);
}

// The global row a buffer row stands for: the exclude-edge reflection (-k
// -> k, h - 1 + k -> h - 1 - k) past a global edge, as halo_rows builds
// the halo; the identity inside the band.
__host__ __device__ __forceinline__ int reflect_row(int g, int h) {
  return g < 0 ? -g : (g >= h ? 2 * (h - 1) - g : g);
}

// The rows of gn that the expand of buffer rows [y0, y1] reads, in global
// gn rows: the expand of global row y reads gn rows y/2 - 1 .. y/2 + 1,
// clamped at the edges, and the buffer rows stand for their reflected
// rows. [y0, y1] meets the band's rows; its reflected rows span [lo, hi].
__host__ __device__ __forceinline__ void gn_rows_of(int y0, int y1, int g_off, int h, int hn,
                                                    int* gr0, int* gr1) {
  const int G0 = g_off + y0, G1 = g_off + y1;
  const int r1 = reflect_row(G1, h), r0 = reflect_row(G0, h);
  const int lo = G0 < 0 ? 0 : (G0 < r1 ? G0 : r1);
  const int hi = G1 > h - 1 ? h - 1 : (G1 > r0 ? G1 : r0);
  *gr0 = (lo >> 1) - 1 > 0 ? (lo >> 1) - 1 : 0;
  *gr1 = (hi >> 1) + 1 < hn - 1 ? (hi >> 1) + 1 : hn - 1;
}

// floor(i / n) for 0 <= i < 2^22 through fl(1 / n): the product's relative
// error (2^-23) stays below the 0.5 / n margin of i + 0.5.
__device__ __forceinline__ int div_small(int i, float inv_n) {
  return __float2int_rz(__fmul_rn((float)i + 0.5f, inv_n));
}

// One tile of one band: its 32 x 32 pixels at (y0, x0) of plane
// (b, f), the window of band pixels its blur halo reads, [wy0, wy1) x
// [wx0, wx1), the staged gi columns [sx0, sx1), and the gn rows [gr0, gr1]
// and the columns the window's expand reads, staged from [sgc0, sgc1).
struct Job {
  int bi, b, f, ty, tx, y0, x0, r;
  int wy0, wy1, wx0, wx1, sx0, sx1, gr0, gr1, sgc0, sgc1;
};

__device__ __forceinline__ Job make_job(const PooledParams& P, long long bt) {
  Job J;
  J.bi = 0;
  for (int k = 1; k < P.n_bands; ++k)
    if (bt >= P.band[k].tile_off) J.bi = k;
  const PooledBand& d = P.band[J.bi];
  const long long local = bt - d.tile_off;
  const long long per_plane = (long long)d.tiles_y * d.tiles_x;
  const long long l = local / per_plane;
  const int rem = (int)(local - l * per_plane);
  J.ty = rem / d.tiles_x;
  J.tx = rem - J.ty * d.tiles_x;
  J.b = (int)(l / P.F);
  J.f = (int)(l - (long long)J.b * P.F);
  J.y0 = d.row_off + J.ty * BP_TH;
  J.x0 = J.tx * BP_TW;
  J.r = d.r;
  J.wy0 = max(J.y0 - J.r, 0);
  J.wy1 = min(J.y0 + BP_TH + J.r, d.h);
  J.wx0 = max(J.x0 - J.r, 0);
  J.wx1 = min(J.x0 + BP_TW + J.r, d.w);
  J.sx0 = d.vec_gi ? (J.wx0 & ~3) : J.wx0;
  J.sx1 = d.vec_gi ? min((J.wx1 + 3) & ~3, d.w) : J.wx1;
  gn_rows_of(J.wy0, J.wy1 - 1, d.g_off, d.h_glob, d.hn, &J.gr0, &J.gr1);
  const int gc0 = max((J.wx0 >> 1) - 1, 0);
  const int gc1 = min(((J.wx1 - 1) >> 1) + 1, d.wn - 1);
  J.sgc0 = d.vec_gn ? (gc0 & ~3) : gc0;
  J.sgc1 = d.vec_gn ? min((gc1 + 4) & ~3, d.wn) : gc1 + 1;
  return J;
}

// Issue the copies of channel pair c's gi and gn windows (one commit group).
__device__ __forceinline__ void issue_loads(const PooledParams& P, const Job& J, int c,
                                            float* giw, float* gnw) {
  const PooledBand& d = P.band[J.bi];
  const int tid = threadIdx.x;
  const long long hw = (long long)d.h * d.w, hwn = (long long)d.hn_buf * d.wn;
  const long long pl = ((long long)J.b * 2 * P.C + 2 * c) * P.F + J.f;  // plane 2c
  const int WH = J.wy1 - J.wy0;
  {
    const float* src0 = d.gi + pl * hw + (long long)J.wy0 * d.w + J.sx0;
    const long long pstride = (long long)P.F * hw;
    const int GIP = gi_pitch(J.r);
    const int step = d.vec_gi ? 4 : 1;
    const int nch = (J.sx1 - J.sx0) / step;
    const float inv = 1.0f / (float)nch;
    for (int idx = tid; idx < 2 * WH * nch; idx += BP_THREADS) {
      const int pr = div_small(idx, inv);  // p * WH + row
      const int col = (idx - pr * nch) * step;
      const int p = pr >= WH;
      const int row = pr - p * WH;
      float* dst = giw + p * P.giw_plane + row * GIP + col;
      const float* src = src0 + p * pstride + (long long)row * d.w + col;
      if (d.vec_gi)
        cp_async16(dst, src);
      else
        cp_async4(dst, src);
    }
  }
  {
    const int GH = J.gr1 - J.gr0 + 1;
    const float* src0 = d.gn + pl * hwn + (long long)(J.gr0 - d.gn_row0) * d.wn + J.sgc0;
    const long long pstride = (long long)P.F * hwn;
    const int GNP = gn_pitch(J.r);
    const int step = d.vec_gn ? 4 : 1;
    const int nch = (J.sgc1 - J.sgc0) / step;
    const float inv = 1.0f / (float)nch;
    for (int idx = tid; idx < 2 * GH * nch; idx += BP_THREADS) {
      const int pr = div_small(idx, inv);
      const int col = (idx - pr * nch) * step;
      const int p = pr >= GH;
      const int row = pr - p * GH;
      float* dst = gnw + p * P.gnw_plane + row * GNP + col;
      const float* src = src0 + p * pstride + (long long)row * d.wn + col;
      if (d.vec_gn)
        cp_async16(dst, src);
      else
        cp_async4(dst, src);
    }
  }
  cp_async_commit();
}

// KIND: the coding's code path, BP_WEBER_G1 (both raw codings, told apart
// by P.coding), BP_WEBER_G0_REF or BP_LOG; a template argument, so that
// each coding's kernel holds only its own arithmetic.
template <bool D_OUT, int KIND>
__global__ void __launch_bounds__(BP_THREADS, BP_MIN_BLOCKS)
    band_pooled_kernel(const __grid_constant__ PooledParams P, float* __restrict__ partials) {
  extern __shared__ __align__(16) float dyn[];
  __shared__ float s_taps[BM_MAX_TAPS];
  __shared__ float red[BM_MAX_C * BP_WARPS];

  long long bt = blockIdx.x;
  if (bt >= P.n_tiles) return;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = P.C, nk = P.nk;
  float* Yt = dyn + P.o_y;  // per window pixel: lb_t, lb_r, LUT index
  float* Yr = Yt + P.y_plane;
  float* YI = Yr + P.y_plane;
  float* mpre = dyn + P.o_mpre;  // M_pre on the blur's sample grid
  float* rexp = dyn + P.o_rexp;  // the gn pair expanded vertically; then the
  float* tmp = rexp;             // vertical blur's output
  float* giw = dyn + P.o_giw;
  float* gnw = dyn + P.o_gnw;
  float* s_lut = dyn + P.o_lut;
  float ek[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) ek[k] = P.ek[k];

  float mix[BP_ROWS][BM_MAX_C];
  float dreg[BP_ROWS][BM_MAX_C];  // diff of the thread's own pixels
  Job J = make_job(P, bt);
  int c = 0, cur_band = -1;
  issue_loads(P, J, 0, giw, gnw);
  while (true) {
    cp_async_wait<0>();
    __syncthreads();  // the windows have landed; the previous job is done
    const PooledBand& d = P.band[J.bi];
    const int r = J.r, h = d.h, w = d.w;
    const int WH = J.wy1 - J.wy0;
    const int SW = BP_TW + 2 * r, SH = BP_TH + 2 * r;  // sample grid, = Y pitch
    const int GIP = gi_pitch(r), GNP = gn_pitch(r);
    if (c == 0) {
#pragma unroll
      for (int k = 0; k < BP_ROWS; ++k)
#pragma unroll
        for (int dd = 0; dd < BM_MAX_C; ++dd) mix[k][dd] = dreg[k][dd] = 0.0f;
      if (J.bi != cur_band) {
        for (int i = tid; i < C * nk; i += BP_THREADS)
          s_lut[i] = P.luts[(long long)J.bi * C * nk + i];
        if (tid < BM_MAX_TAPS) s_taps[tid] = r ? P.taps[tid] : (tid == 0 ? 1.0f : 0.0f);
        cur_band = J.bi;
      }
    }

    // The gn pair expanded along rows: rexp[p][ey][j], window row ey, staged
    // gn column j.
    {
      const int ncol = J.sgc1 - J.sgc0;
      const float inv = 1.0f / (float)ncol;
      for (int idx = tid; idx < 2 * WH * ncol; idx += BP_THREADS) {
        const int pr = div_small(idx, inv);
        const int j = idx - pr * ncol;
        const int p = pr >= WH;
        const int ey = pr - p * WH;
        rexp[p * P.rexp_plane + ey * GNP + j] =
            expand_tap(ek, gnw + p * P.gnw_plane + j, GNP,
                       reflect_row(d.g_off + J.wy0 + ey, d.h_glob), d.hn, J.gr0);
      }
    }
    __syncthreads();

    // M_pre at every sample of the blur's grid (SH x SW, the tile at
    // (r, r)): the reflected sample stage B reads, clamped into the window,
    // which moves only samples that feed rows or columns past the band's
    // edge. The tile's pixels go to the threads that pool them, diff with
    // them; the halo ring is shared out over all threads.
    const float* lut = s_lut + c * nk;
    const float gain = P.gains[c], chg = P.ch_gain[c];
    // A tile whose window the band does not clip reads no reflected sample.
    const bool interior = J.wy0 == J.y0 - r && J.wy1 == J.y0 + BP_TH + r &&
                          J.wx0 == J.x0 - r && J.wx1 == J.x0 + BP_TW + r;
    auto sample = [&](int yy, int xx, float& mp, float& df) {
      const int gy = interior ? J.y0 - r + yy
                              : min(max(reflect_clamp(J.y0 - r + yy, h), J.wy0), J.wy1 - 1);
      const int gx = interior ? J.x0 - r + xx
                              : min(max(reflect_clamp(J.x0 - r + xx, w), J.wx0), J.wx1 - 1);
      const int ey = gy - J.wy0;
      const float* rt = rexp + ey * GNP;
      const float E_t = expand_tap_sel(ek, rt, gx, d.wn, J.sgc0);
      const float E_r = expand_tap_sel(ek, rt + P.rexp_plane, gx, d.wn, J.sgc0);
      const int e = ey * SW + (gx - J.wx0);
      const int o = ey * GIP + (gx - J.sx0);
      const float g_t = giw[o], g_r = giw[P.giw_plane + o];
      float lb_t, lb_r, ind;
      if (c == 0) {
        if constexpr (KIND == BP_LOG) {
          lb_t = lb_r = 1.0f;  // no division
          ind = lut_index(__fmul_rn(P.log_a, __fsub_rn(E_r, P.log_b)), P.x0, P.lut_scale, nk);
        } else {
          // The Y pair: weber_g0_ref adapts to the reference Y of gi itself.
          lb_r = fmaxf(KIND == BP_WEBER_G0_REF ? g_r : E_r, 0.01f);
          lb_t = KIND == BP_WEBER_G1 && P.coding == BP_WEBER_G1 ? fmaxf(E_t, 0.01f) : lb_r;
          ind = lut_index(log10f(lb_r), P.x0, P.lut_scale, nk);
        }
        Yt[e] = lb_t;
        Yr[e] = lb_r;
        YI[e] = ind;
      } else {
        lb_t = Yt[e];
        lb_r = Yr[e];
        ind = YI[e];
      }
      if constexpr (KIND == BP_WEBER_G1) {
        const float S = raw_sensitivity(lut, nk, ind, gain, d.mul);
        raw_pair(g_t, E_t, g_r, E_r, lb_t, lb_r, S, mp, df);
      } else {
        const float S = __fmul_rn(pow10_lut(lut_lerp(lut, nk, ind)), P.sens_corr);
        float ct = __fsub_rn(g_t, E_t), cr = __fsub_rn(g_r, E_r);
        if constexpr (KIND == BP_WEBER_G0_REF) {
          ct = min1000(__fdiv_rn(ct, lb_t));
          cr = min1000(__fdiv_rn(cr, lb_r));
        }
        contrast_pair(__fmul_rn(ct, d.mul), __fmul_rn(cr, d.mul), S, chg, mp, df);
      }
    };
#pragma unroll
    for (int k = 0; k < BP_ROWS; ++k) {
      const int yy = r + warp + k * BP_WARPS, xx = r + lane;
      float mp, df;
      sample(yy, xx, mp, df);
      mpre[yy * SW + xx] = mp;
#pragma unroll
      for (int dd = 0; dd < BM_MAX_C; ++dd)
        if (dd == c) dreg[k][dd] = df;
    }
    if (r > 0) {
      const int top = r * SW;
      const float inv_sw = 1.0f / (float)SW, inv_2r = 1.0f / (float)(2 * r);
      for (int idx = tid; idx < SH * SW - BP_TH * BP_TW; idx += BP_THREADS) {
        int yy, xx;
        if (idx < 2 * top) {  // the r rows above the tile, then the r below
          const int i = idx < top ? idx : idx - top;
          const int q = div_small(i, inv_sw);
          yy = q + (idx < top ? 0 : BP_TH + r);
          xx = i - q * SW;
        } else {  // the r columns left and right of each tile row
          const int i = idx - 2 * top;
          const int q = div_small(i, inv_2r);
          const int cc = i - q * 2 * r;
          yy = r + q;
          xx = cc < r ? cc : BP_TW + cc;
        }
        float mp, df;
        sample(yy, xx, mp, df);
        mpre[yy * SW + xx] = mp;
      }
    }
    __syncthreads();  // M_pre complete; the staged windows are free

    // The next job's windows, in flight while this channel is blurred.
    Job N = J;
    int nc = c + 1;
    long long nbt = bt;
    bool more = true;
    if (nc == C) {
      nc = 0;
      nbt = bt + gridDim.x;
      more = nbt < P.n_tiles;
      if (more) N = make_job(P, nbt);
    }
    if (more) issue_loads(P, N, nc, giw, gnw);

    // Stage B: the vertical taps over the grid's columns (rows in tap
    // order, as common.cuh tile_blur_vpass), then per own pixel the
    // horizontal taps, x 10^mask_c, the transducer and the channel mix.
    {
      const int ntap = 2 * r + 1;
      const float inv_sw = 1.0f / (float)SW;
      for (int idx = tid; idx < BP_TH * SW; idx += BP_THREADS) {
        const int yy = div_small(idx, inv_sw);
        const int xx = idx - yy * SW;
        float acc = 0.0f;
        for (int k = 0; k < ntap; ++k) acc = mul_add_rn(acc, s_taps[k], mpre[(yy + k) * SW + xx]);
        tmp[idx] = acc;
      }
    }
    __syncthreads();
    {
      const float q = P.qs[c];
      const float eps_q = powf(BM_EPS, q);
      const int ntap = 2 * r + 1;
#pragma unroll
      for (int k = 0; k < BP_ROWS; ++k) {
        const float* row = tmp + (warp + k * BP_WARPS) * SW + lane;
        float acc = 0.0f;
        for (int t = 0; t < ntap; ++t) acc = mul_add_rn(acc, s_taps[t], row[t]);
        const float mq = masking_mq(acc * P.blur_scale, q, eps_q);
#pragma unroll
        for (int dd = 0; dd < BM_MAX_C; ++dd)
          if (dd < C) mix[k][dd] += P.xcm[c * BM_MAX_C + dd] * mq;
      }
    }

    if (c == C - 1) {
      // The epilogue of stage B: the thread's rows in order, the warp's tree
      // sum, the warps in order (band_common.cuh block_sum), into the tile's
      // slot; the D mode stores each own pixel's D on the way.
      const float eps_p = powf(BM_EPS, P.p);
      const float eps_b = pow_static(BM_EPS, P.beta);
      float part[BM_MAX_C];
#pragma unroll
      for (int dd = 0; dd < BM_MAX_C; ++dd) part[dd] = 0.0f;
#pragma unroll
      for (int k = 0; k < BP_ROWS; ++k) {
        const int gy = J.y0 + warp + k * BP_WARPS, gx = J.x0 + lane;
        if (gy >= d.y_end || gx >= w) continue;
#pragma unroll
        for (int dd = 0; dd < BM_MAX_C; ++dd) {
          if (dd >= C) continue;
          const float Dv = band_D(dreg[k][dd], mix[k][dd], P.p, eps_p, P.max_v);
          if (D_OUT)
            d.D[(((long long)J.b * C + dd) * P.F + J.f) * h * (long long)w +
                (long long)gy * w + gx] = Dv;
          part[dd] += pooled_term(Dv, P.beta, eps_b);
        }
      }
#pragma unroll
      for (int dd = 0; dd < BM_MAX_C; ++dd) {
        if (dd >= C) continue;
        const float v = warp_sum(part[dd]);
        if (lane == 0) red[dd * BP_WARPS + warp] = v;
      }
      __syncthreads();
      if (tid < C) {
        float s = 0.0f;
        for (int k = 0; k < BP_WARPS; ++k) s += red[tid * BP_WARPS + k];
        const long long l = (long long)J.b * P.F + J.f;
        const long long tile =
            d.tile_off + l * d.tiles_x * d.tiles_y + (long long)J.ty * d.tiles_x + J.tx;
        partials[tile * C + tid] = s;
      }
    }
    if (!more) break;
    J = N;
    c = nc;
    bt = nbt;
  }
}

// One block per (band, plane): out[band][b][c][f] = sum of the plane's tiles.
__global__ void pooled_stage_c(const __grid_constant__ PooledParams P,
                               const float* __restrict__ partials, float* __restrict__ out) {
  __shared__ float red[32];
  int bi = 0;
  for (int k = 1; k < P.n_bands; ++k)
    if ((long long)blockIdx.x >= P.band[k].plane_off) bi = k;
  const PooledBand& d = P.band[bi];
  const int C = P.C, F = P.F;
  const long long l = blockIdx.x - d.plane_off;
  const int tpp = d.tiles_x * d.tiles_y;
  const int b = (int)(l / F), f = (int)(l % F);
  plane_sums(partials, d.tile_off + l * tpp, tpp, C,
             out + (((long long)bi * P.B + b) * C) * F + f, F, red);
}

// Opt a mode's kernel into `smem` bytes of dynamic shared memory; returns
// its blocks per SM through per_sm.
template <bool D_OUT, int KIND>
static cudaError_t configure(int smem, int* per_sm) {
  cudaError_t e = cudaFuncSetAttribute(band_pooled_kernel<D_OUT, KIND>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(band_pooled_kernel<D_OUT, KIND>,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, band_pooled_kernel<D_OUT, KIND>,
                                                       BP_THREADS, smem);
}

template <bool D_OUT, int KIND>
static cudaError_t launch_tiles(const PooledParams& P, int smem, cudaStream_t st,
                                float* partials) {
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaError_t e = configure<D_OUT, KIND>(smem, &per_sm);
  if (e != cudaSuccess) return e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long fit = (long long)per_sm * n_sm;
  const long long grid = P.n_tiles < fit ? P.n_tiles : fit;
  band_pooled_kernel<D_OUT, KIND><<<(unsigned int)grid, BP_THREADS, smem, st>>>(P, partials);
  return cudaGetLastError();
}

template <bool D_OUT>
static cudaError_t launch_coding(const PooledParams& P, int smem, cudaStream_t st,
                                 float* partials) {
  if (P.coding == BP_WEBER_G0_REF)
    return launch_tiles<D_OUT, BP_WEBER_G0_REF>(P, smem, st, partials);
  if (P.coding == BP_LOG) return launch_tiles<D_OUT, BP_LOG>(P, smem, st, partials);
  return launch_tiles<D_OUT, BP_WEBER_G1>(P, smem, st, partials);
}

// ptrs: n_bands x {gi, gn} device pointers, gi (B, 2C, F, h, w) and gn
// (B, 2C, F, ceil(h/2), ceil(w/2)); dptrs: null (the pooled mode) or, for
// the D mode, n_bands device pointers to each band's D (B, C, F, h, w);
// dims: n_bands x {h, w}; geo: null (whole bands) or, for the halo mode
// (pooled only), n_bands x {row_off, y0, h_glob, gn_row0, hn_buf}: gi is a
// row slab of h = h_valid + 2 row_off rows whose owned rows start at global
// row y0 of a band of h_glob rows, and gn holds hn_buf rows of the next
// level from global row gn_row0 on; muls, blur: per band; luts: device
// (n_bands, C, nk); coding: BP_WEBER_G1 .. BP_LOG, log_a and log_b the log
// coding's; ch_gain, qs: C floats; xcm: C x C floats; ek: the 5 expand
// taps; taps: ntaps floats. partials: (tiles, C) scratch, one per 32x32
// tile of each (b, f) plane of each band in order (the owned rows' tiles in
// the halo mode); out receives the (n_bands, B, C, F) pooled sums of
// safe_pow(D, beta) in both modes.
CVVDP_API int cvvdp_band_pooled(int n_bands, int B, int C, int F, int nk, const long long* ptrs,
                                const long long* dptrs, const int* dims, const int* geo,
                                const float* muls, const int* blur, const float* luts, float x0,
                                float lut_scale, const float* ch_gain, float sens_corr,
                                int coding, float log_a, float log_b, const float* ek,
                                const float* qs, float p, const float* xcm, float max_v,
                                float blur_scale, const float* taps, int ntaps, float beta,
                                float* partials, float* out, void* stream) {
  if (n_bands < 1 || n_bands > BM_MAX_BANDS || C < 1 || C > BM_MAX_C || B < 1 || F < 1 ||
      nk < 2 || nk > BP_MAX_NK || ntaps < 1 || ntaps > BM_MAX_TAPS || (ntaps % 2) != 1 ||
      coding < BP_WEBER_G1 || coding > BP_LOG || (geo && dptrs))
    return (int)cudaErrorInvalidValue;
  PooledParams P;
  P.n_bands = n_bands;
  P.B = B;
  P.C = C;
  P.F = F;
  P.nk = nk;
  long long tiles = 0, planes = 0;
  int r_max = 0;
  for (int k = 0; k < n_bands; ++k) {
    PooledBand& d = P.band[k];
    d.gi = (const float*)ptrs[2 * k];
    d.gn = (const float*)ptrs[2 * k + 1];
    d.D = dptrs ? (float*)dptrs[k] : nullptr;
    d.h = dims[2 * k];
    d.w = dims[2 * k + 1];
    if (d.h < 1 || d.w < 1) return (int)cudaErrorInvalidValue;
    d.r = blur[k] ? (ntaps - 1) / 2 : 0;
    r_max = d.r > r_max ? d.r : r_max;
    d.row_off = geo ? geo[5 * k] : 0;
    const int y0 = geo ? geo[5 * k + 1] : 0;
    d.h_glob = geo ? geo[5 * k + 2] : d.h;
    d.hn = (d.h_glob + 1) / 2;
    d.wn = (d.w + 1) / 2;
    d.gn_row0 = geo ? geo[5 * k + 3] : 0;
    d.hn_buf = geo ? geo[5 * k + 4] : d.hn;
    d.g_off = y0 - d.row_off;
    const int h_valid = d.h - 2 * d.row_off;
    d.y_end = d.row_off + h_valid;
    // The halo mode: the halo covers the blur, the owned rows lie in the
    // band, the buffer's rows reflect once at most, and gn's rows cover
    // what the expand of the buffer reads.
    if (geo) {
      int gr0, gr1;
      if (d.row_off < d.r || h_valid < 1 || y0 < 0 || y0 + h_valid > d.h_glob ||
          d.g_off < -(d.h_glob - 1) || d.g_off + d.h - 1 > 2 * (d.h_glob - 1))
        return (int)cudaErrorInvalidValue;
      gn_rows_of(0, d.h - 1, d.g_off, d.h_glob, d.hn, &gr0, &gr1);
      if (gr0 < d.gn_row0 || gr1 >= d.gn_row0 + d.hn_buf) return (int)cudaErrorInvalidValue;
    }
    d.mul = muls[k];
    d.vec_gi = (d.w % 4 == 0) && ((uintptr_t)d.gi % 16 == 0);
    d.vec_gn = (d.wn % 4 == 0) && ((uintptr_t)d.gn % 16 == 0);
    d.tiles_x = (d.w + BM_TW - 1) / BM_TW;
    d.tiles_y = (h_valid + BM_TH - 1) / BM_TH;
    d.tile_off = tiles;
    d.plane_off = planes;
    tiles += (long long)B * F * d.tiles_x * d.tiles_y;
    planes += (long long)B * F;
  }
  if (planes > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  P.n_tiles = tiles;
  P.luts = luts;
  P.x0 = x0;
  P.lut_scale = lut_scale;
  P.coding = coding;
  P.log_a = log_a;
  P.log_b = log_b;
  P.sens_corr = sens_corr;
  for (int k = 0; k < 5; ++k) P.ek[k] = ek[k];
  for (int c = 0; c < BM_MAX_C; ++c) {
    const float g = c < C ? ch_gain[c] : 0.0f;
    P.ch_gain[c] = g;
    P.gains[c] = g * sens_corr;
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

  const int smem = pooled_smem_floats(r_max, C, nk, &P) * (int)sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = dptrs ? launch_coding<true>(P, smem, st, partials)
                        : launch_coding<false>(P, smem, st, partials);
  if (e != cudaSuccess) return (int)e;
  pooled_stage_c<<<(unsigned int)planes, BM_STAGE_C_THREADS, 0, st>>>(P, partials, out);
  return (int)cudaGetLastError();
}

// Blocks per SM the pooled mode gets for a launch whose largest blur radius
// is r_max with C channels and nk knots (for the record; 0 if it does not
// fit).
CVVDP_API int cvvdp_band_pooled_occupancy(int r_max, int C, int nk) {
  const int smem = pooled_smem_floats(r_max, C, nk, nullptr) * (int)sizeof(float);
  int per_sm = 0;
  return configure<false, BP_WEBER_G1>(smem, &per_sm) == cudaSuccess ? per_sm : 0;
}
