// Video front end: raw frames -> float -> display EOTF -> DKL (or log-LMS
// DKL) -> temporal FIR.
//
// Replaces colorvideovdp_tpu/ops/kernels/ingest.py `make_ingest_fn`
// (`_ingest_kernel`) in its three modes. The blk new frames come in as raw
// planes (uint8, uint16 bits, float16 or float32; 3 colour channels, or 1
// luminance channel broadcast to all three DKL channels); the fl-1 slots
// before them (the temporal padding) come, by mode:
//   tail       the fl-1 DKL frames carried from the previous block;
//   replicate  the first new frame, converted once and reused (the first
//              block with replicate padding);
//   head       fl-1 raw head frames in the source dtype, converted as the new
//              frames are (the first block with symmetric padding).
// Any batch size: blockIdx.z is the batch item; blockIdx.y the source (0 =
// test, 1 = reference).
//
// A thread walks the fl-1+blk buffer slots of its pixels in time order and
// converts each slot to the metric colour space exactly once: tail slots are
// read from the tail, raw slots go through the dtype ladder (true division by
// 255 / 65535: the PQ curve amplifies a last-ulp error about 6x), the EOTF
// with black level, reflection and exposure, and the fused RGB->DKL 3x3; or,
// for the log contrast's metric colour space logLMS_DKLd65, the RGB->LMS2006
// 3x3, log10 of each cone response (taken in float64 and rounded once, as
// ops/colorspace.py:log10_rn does) and the LMS->DKL 3x3. Once a slot
// completes a window, the four FIR channels of that output frame are summed
// in tap order and written to out[:, 2*c_out + src, fo] (c_out = 3 re-filters
// Y). Slots blk.. fl-2+blk are also written out as the next tail.
//
// All math is float32 with the plain version's roundings: every product and
// sum that the plain PyTorch chain rounds separately is rounded separately
// here (__fmul_rn / __fadd_rn keep nvcc from contracting them into FMAs).
// That matters for PQ: near the display peak the curve amplifies a last-ulp
// difference in C2 - C3 * im_t about 500x, so its two powers are also taken
// in float64 and rounded once, as the plain version does. A replicated or
// head slot goes through the same conversion as a new frame, so the first
// block's modes give the bits of tail mode fed the plain version's tails.
//
// Bound on the H100: memory. Per pixel and block it reads 2*3*blk source
// bytes (uint8; twice that for uint16), plus 2*3*(fl-1)*4 tail bytes (tail
// mode) or 2*3*(fl-1) head bytes (head mode), and writes (8*blk + 6*(fl-1))*4
// bytes, 94% of the traffic at blk = 29, fl = 9. The design keeps the
// arithmetic under that traffic:
//   * Code-value tables. For uint8, uint16 and float16 sources in DKLd65 a
//     small kernel first runs the per-channel EOTF (sRGB, PQ, linear, gamma;
//     for HLG the per-channel s(v) of the inverse OETF) on every code value,
//     256 or 65,536 of them, through the same device code as the per-sample
//     path. The ingest kernel then looks each sample up, from shared memory
//     for uint8 and through __ldg for the 65,536-entry tables, so its output
//     is the per-sample path's bit for bit; PQ's two float64 pows per sample
//     (about 2.9e9 per 4K block at blk = 29) are gone. HLG's Y_s and powf stay
//     per pixel. Float32 sources and the log-LMS colour space keep the
//     per-sample path.
//   * The FIR without per-slot modulo. For the filter lengths the metric
//     gives at 24, 25/30 and 60 fps (fl = 7, 9, 17) fl is a template
//     parameter: the window of the last fl DKL triplets is a register array
//     and the slot loop is unrolled by fl, so every ring index is a
//     compile-time constant and the taps are constant-bank operands. Other
//     lengths keep the window in shared memory with a ring index advanced by
//     compare-and-reset. Either way the sum runs in tap order, so the bits do
//     not change.
//   * One pixel a thread: a warp moves 32 contiguous source samples and 128
//     output bytes per instruction. A register window of 2 or 4 pixels a
//     thread (vector loads and float4 stores) was measured slower on the
//     H100, 12.8 and 22.6 ms against 9.8 ms at (1, 29, 3, 2160, 3840) uint8
//     and fl = 9 (PERF.md): it multiplies the window's registers, and at 4
//     pixels the kernel holds 255 registers a thread and 8 warps an SM.

#include <cuda_fp16.h>

#include "common.cuh"

#define INGEST_MAX_FL 64
#define INGEST_THREADS 128

enum Eotf { EOTF_SRGB = 0, EOTF_PQ = 1, EOTF_LINEAR = 2, EOTF_HLG = 3, EOTF_GAMMA = 4 };
enum SrcType { SRC_U8 = 0, SRC_U16 = 1, SRC_F16 = 2, SRC_F32 = 3 };
enum PadMode { MODE_TAIL = 0, MODE_REPLICATE = 1, MODE_HEAD = 2 };

struct IngestParams {
  int eotf, channels;
  // Display constants, each rounded once from the host's double value:
  // Y_peak - Y_black, Y_black, Y_refl, exposure, Y_peak, max(0.005, Y_black),
  // gamma, hlg_gamma - 1, HLG b, HLG c.
  float span, Y_black, Y_refl, exposure, Y_peak, lin_floor, gamma, hlg_g1, hlg_b, hlg_c;
  float M[9];                      // RGB -> DKLd65 (RGB -> LMS2006 with log_lms)
  float M2[9];                     // log_lms: LMS2006 -> DKLd65
  int log_lms;
  float filt[4 * INGEST_MAX_FL];   // time-reversed taps, (4, fl)
  int fl, blk, mode;
  long long hw;
};

// A source sample as the kernels hold it: its bits (float16 as its 16-bit
// pattern, the table index).
template <int SRC> struct Src;
template <> struct Src<SRC_U8> { using bits = uint8_t; };
template <> struct Src<SRC_U16> { using bits = uint16_t; };
template <> struct Src<SRC_F16> { using bits = uint16_t; };
template <> struct Src<SRC_F32> { using bits = float; };

// The dtype ladder of ops/kernels/ingest.py:raw_to_float.
template <int SRC>
__device__ __forceinline__ float to_float(typename Src<SRC>::bits v) {
  if constexpr (SRC == SRC_U8) return __fdiv_rn((float)v, 255.0f);
  else if constexpr (SRC == SRC_U16) return __fdiv_rn((float)v, 65535.0f);
  else if constexpr (SRC == SRC_F16) return __half2float(__ushort_as_half(v));
  else return v;
}

__device__ __forceinline__ float clamp01(float v) { return fminf(fmaxf(v, 0.0f), 1.0f); }

// float32 x ** y taken in float64 and rounded once (ops/colorspace.py:_pow_rn).
__device__ __forceinline__ float pow_rn(float x, float y) {
  return (float)pow((double)x, (double)y);
}

// (Y_peak - Y_black) * lin + Y_black + Y_refl, rounded step by step.
__device__ __forceinline__ float gog(const IngestParams& P, float lin) {
  return __fadd_rn(__fadd_rn(__fmul_rn(P.span, lin), P.Y_black), P.Y_refl);
}

__device__ __forceinline__ float expose01(const IngestParams& P, float lin) {
  return P.exposure != 1.0f ? clamp01(__fmul_rn(lin, P.exposure)) : lin;
}

// HLG's per-channel inverse OETF s(v) (ops/colorspace.py:hlg_s).
__device__ __forceinline__ float hlg_s(const IngestParams& P, float V) {
  const float a = 0.17883277f;
  const float v = clamp01(V);
  return v <= 0.5f ? __fdiv_rn(__fmul_rn(v, v), 3.0f)
                   : __fdiv_rn(__fadd_rn(expf(__fdiv_rn(__fsub_rn(v, P.hlg_c), a)), P.hlg_b),
                               12.0f);
}

// HLG's per-pixel rest: Y_s = the weighted sum of the n channels' s (one
// luminance channel weighs three times, as the plain version's broadcast
// does), the OOTF power, exposure and the display's GOG.
__device__ __forceinline__ void hlg_pixel(const IngestParams& P, const float* s, float* L,
                                          int n) {
  const float s1 = n == 3 ? s[1] : s[0], s2 = n == 3 ? s[2] : s[0];
  const float Ys = __fadd_rn(__fadd_rn(__fmul_rn(s[0], 0.2627f), __fmul_rn(s1, 0.6780f)),
                             __fmul_rn(s2, 0.0593f));
  const float oo = powf(Ys, P.hlg_g1);
  for (int k = 0; k < n; ++k) L[k] = gog(P, expose01(P, __fmul_rn(oo, s[k])));
}

// The per-channel EOTF of the other displays (display.vvdp_display_photo_eotf
// .forward).
__device__ __forceinline__ float eotf_channel(const IngestParams& P, float v) {
  if (P.eotf == EOTF_SRGB) {
    const float u = clamp01(v);
    const float lin = u > 0.04045f ? powf(__fdiv_rn(__fadd_rn(u, 0.055f), 1.055f), 2.4f)
                                   : __fdiv_rn(u, 12.92f);
    return gog(P, expose01(P, lin));
  }
  if (P.eotf == EOTF_PQ) {
    // ops/colorspace.py:pq2lin: float32 as the JAX package computes it,
    // with both powers correctly rounded (pow_rn).
    const float im_t = pow_rn(clamp01(v), (float)(1.0 / 78.84375));
    const float num = fmaxf(__fsub_rn(im_t, 0.8359375f), 0.0f);
    const float den = __fsub_rn(18.8515625f, __fmul_rn(18.6875f, im_t));
    const float lin = __fmul_rn(10000.0f, pow_rn(__fdiv_rn(num, den),
                                                 (float)(1.0 / 0.1593017578125)));
    return __fadd_rn(__fadd_rn(fminf(fmaxf(__fmul_rn(lin, P.exposure), 0.005f), P.Y_peak),
                               P.Y_black), P.Y_refl);
  }
  if (P.eotf == EOTF_LINEAR)
    return __fadd_rn(fminf(fmaxf(__fmul_rn(v, P.exposure), P.lin_floor), P.Y_peak), P.Y_refl);
  // numeric gamma
  return gog(P, clamp01(__fmul_rn(powf(clamp01(v), P.gamma), P.exposure)));
}

// What a code value's table entry holds: the channel's luminance, or HLG's s.
__device__ __forceinline__ float table_entry(const IngestParams& P, float v) {
  return P.eotf == EOTF_HLG ? hlg_s(P, v) : eotf_channel(P, v);
}

// y = M x with the plain version's order: (x0 m0 + x1 m1) + x2 m2 per row.
__device__ __forceinline__ void mat3(const float* M, const float* x, float* y) {
  for (int c = 0; c < 3; ++c)
    y[c] = __fadd_rn(__fadd_rn(__fmul_rn(x[0], M[3 * c]), __fmul_rn(x[1], M[3 * c + 1])),
                     __fmul_rn(x[2], M[3 * c + 2]));
}

// The per-sample path of one channel sample: the table entry its code would
// have. Not inlined: the template kernels unroll the slot loop, and the
// float64 pows would multiply the code.
__device__ __noinline__ float sample_entry(const IngestParams& P, float v) {
  return table_entry(P, v);
}

// logLMS_DKLd65: log10 of each cone response, taken in float64 and rounded
// once, then the LMS->DKL 3x3 (not inlined, as above).
__device__ __noinline__ void log_lms_to_dkl(const IngestParams& P, float* lms) {
  float lg[3];
  for (int c = 0; c < 3; ++c) lg[c] = (float)log10((double)lms[c]);
  mat3(P.M2, lg, lms);
}

// One pixel's n (1 or 3) raw samples -> its metric colour-space triplet.
// `tab`: the code-value table (uint8, uint16, float16 in DKLd65), else null:
// the per-sample path, which computes the same entries.
template <int SRC>
__device__ __forceinline__ void pixel_to_metric(const IngestParams& P, const float* tab,
                                                const typename Src<SRC>::bits* code,
                                                float* dkl) {
  const int nc = P.channels;
  float s[3], L[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    if (c >= nc) continue;
    if (SRC != SRC_F32 && tab) {
      const int i = (int)code[c];
      s[c] = SRC == SRC_U8 ? tab[i] : __ldg(tab + i);
    } else {
      s[c] = sample_entry(P, to_float<SRC>(code[c]));
    }
  }
  if (P.eotf == EOTF_HLG) {
    hlg_pixel(P, s, L, nc);
  } else {
#pragma unroll
    for (int c = 0; c < 3; ++c) L[c] = s[c];
  }
  if (nc == 3) {
    mat3(P.M, L, dkl);
    if (P.log_lms) log_lms_to_dkl(P, dkl);
  } else {  // luminance-only content bypasses the colour transform
    for (int c = 0; c < 3; ++c) dkl[c] = L[0];
  }
}

template <int SRC>
__global__ void eotf_table_kernel(const __grid_constant__ IngestParams P,
                                  float* __restrict__ table, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  typename Src<SRC>::bits code = (typename Src<SRC>::bits)i;
  table[i] = table_entry(P, to_float<SRC>(code));
}

// The slots' sources, shared by both kernels. pad_t / pad_r: the DKL tails
// (float, (B, 3, fl-1, hw)) in tail mode, the raw head frames (B, fl-1,
// channels, hw) in head mode, unused in replicate mode.
template <int SRC>
struct Slots {
  using U = typename Src<SRC>::bits;
  const IngestParams& P;
  const float* tab;
  const U* raw;    // this source's (blk, channels, hw) new frames
  const void* pad;
  long long pix, b;

  // Frame fr of a (frames, channels, hw) raw plane set -> the pixel's triplet.
  __device__ __forceinline__ void convert(const U* frames, int fr, float (&dkl)[3]) const {
    const int nc = P.channels;
    U code[3];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      code[c] = c < nc ? frames[((long long)fr * nc + c) * P.hw + pix] : (U)0;
    pixel_to_metric<SRC>(P, tab, code, dkl);
  }

  // Slot s (s < fl - 1: the padding) -> the pixel's triplet; `first` holds
  // frame 0 in replicate mode.
  __device__ __forceinline__ void get(int s, const float (&first)[3], float (&dkl)[3]) const {
    const int fl = P.fl;
    if (P.mode == MODE_REPLICATE && s <= fl - 1) {
#pragma unroll
      for (int c = 0; c < 3; ++c) dkl[c] = first[c];
    } else if (s >= fl - 1 || P.mode == MODE_HEAD) {
      const bool is_new = s >= fl - 1;
      convert(is_new ? raw : (const U*)pad + b * (fl - 1) * P.channels * P.hw,
              is_new ? s - (fl - 1) : s, dkl);
    } else {
      const float* tail = (const float*)pad + b * 3 * (fl - 1) * P.hw;
#pragma unroll
      for (int c = 0; c < 3; ++c) dkl[c] = tail[((long long)c * (fl - 1) + s) * P.hw + pix];
    }
  }
};

// fl = FL, one pixel a thread, the window in registers.
template <int SRC, int FL>
__global__ void __launch_bounds__(INGEST_THREADS)
    ingest_window(const void* __restrict__ pad_t, const void* __restrict__ pad_r,
                  const void* __restrict__ raw_t, const void* __restrict__ raw_r,
                  float* __restrict__ out, float* __restrict__ ntail_t,
                  float* __restrict__ ntail_r, const float* __restrict__ table,
                  const __grid_constant__ IngestParams P) {
  using U = typename Src<SRC>::bits;
  __shared__ float s_tab[256];
  const float* tab = table;
  if (SRC == SRC_U8 && table) {
    for (int i = threadIdx.x; i < 256; i += blockDim.x) s_tab[i] = table[i];
    __syncthreads();
    tab = s_tab;
  }
  const long long hw = P.hw;
  const long long pix = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= hw) return;
  const int src = blockIdx.y, blk = P.blk;
  const long long b = blockIdx.z;
  const Slots<SRC> slots{P, tab, (const U*)(src == 0 ? raw_t : raw_r) + b * blk * P.channels * hw,
                         src == 0 ? pad_t : pad_r, pix, b};
  float* ntail = (src == 0 ? ntail_t : ntail_r) + b * 3 * (FL - 1) * hw;
  float* outb = out + b * 8 * blk * hw;

  float first[3];  // replicate: frame 0's triplet, converted once
  if (P.mode == MODE_REPLICATE) slots.convert(slots.raw, 0, first);

  float win[FL][3];  // slot s sits at win[s % FL]
  const int nslot = FL - 1 + blk;
  for (int s0 = 0; s0 < nslot; s0 += FL) {
#pragma unroll
    for (int j = 0; j < FL; ++j) {
      const int s = s0 + j;
      if (s < nslot) {
        slots.get(s, first, win[j]);
        if (s >= blk) {
#pragma unroll
          for (int c = 0; c < 3; ++c)
            ntail[((long long)c * (FL - 1) + (s - blk)) * hw + pix] = win[j][c];
        }
        if (s >= FL - 1) {
          const int fo = s - (FL - 1);
#pragma unroll
          for (int co = 0; co < 4; ++co) {
            const int ci = co < 3 ? co : 0;
            float acc = 0.0f;
#pragma unroll
            for (int t = 0; t < FL; ++t)  // slot fo + t sits at win[(j + 1 + t) % FL]
              acc = __fadd_rn(acc, __fmul_rn(win[(j + 1 + t) % FL][ci], P.filt[co * FL + t]));
            outb[((long long)(2 * co + src) * blk + fo) * hw + pix] = acc;
          }
        }
      }
    }
  }
}

// Any fl (<= INGEST_MAX_FL), one pixel a thread, the window in a per-thread
// ring in shared memory whose index is advanced by compare-and-reset.
template <int SRC>
__global__ void __launch_bounds__(INGEST_THREADS)
    ingest_ring(const void* __restrict__ pad_t, const void* __restrict__ pad_r,
                const void* __restrict__ raw_t, const void* __restrict__ raw_r,
                float* __restrict__ out, float* __restrict__ ntail_t,
                float* __restrict__ ntail_r, const float* __restrict__ table,
                const __grid_constant__ IngestParams P) {
  using U = typename Src<SRC>::bits;
  extern __shared__ float ring[];  // [fl][3][blockDim.x]
  __shared__ float s_filt[4 * INGEST_MAX_FL];
  __shared__ float s_tab[256];
  const int fl = P.fl, blk = P.blk;
  for (int k = threadIdx.x; k < 4 * fl; k += blockDim.x) s_filt[k] = P.filt[k];
  const float* tab = table;
  if (SRC == SRC_U8 && table) {
    for (int i = threadIdx.x; i < 256; i += blockDim.x) s_tab[i] = table[i];
    tab = s_tab;
  }
  __syncthreads();

  const long long hw = P.hw;
  const long long pix = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= hw) return;
  const int src = blockIdx.y;
  const long long b = blockIdx.z;
  const Slots<SRC> slots{P, tab, (const U*)(src == 0 ? raw_t : raw_r) + b * blk * P.channels * hw,
                         src == 0 ? pad_t : pad_r, pix, b};
  float* ntail = (src == 0 ? ntail_t : ntail_r) + b * 3 * (fl - 1) * hw;
  float* outb = out + b * 8 * blk * hw;
  const int bd = blockDim.x, tid = threadIdx.x;

  float first[3];
  if (P.mode == MODE_REPLICATE) slots.convert(slots.raw, 0, first);

  int slot = 0;  // s % fl
  for (int s = 0; s < fl - 1 + blk; ++s) {
    float dkl[3];
    slots.get(s, first, dkl);
    for (int c = 0; c < 3; ++c) ring[(slot * 3 + c) * bd + tid] = dkl[c];
    if (s >= blk) {
      for (int c = 0; c < 3; ++c)
        ntail[((long long)c * (fl - 1) + (s - blk)) * hw + pix] = dkl[c];
    }
    if (++slot == fl) slot = 0;  // now (s + 1) % fl: slot fo of the window
    if (s >= fl - 1) {
      const int fo = s - (fl - 1);
      for (int co = 0; co < 4; ++co) {
        const int ci = co < 3 ? co : 0;
        float acc = 0.0f;
        int q = slot;
        for (int t = 0; t < fl; ++t) {
          acc = __fadd_rn(acc, __fmul_rn(ring[(q * 3 + ci) * bd + tid], s_filt[co * fl + t]));
          if (++q == fl) q = 0;
        }
        outb[((long long)(2 * co + src) * blk + fo) * hw + pix] = acc;
      }
    }
  }
}

template <int SRC>
static cudaError_t launch(dim3 threads, long long hw, int batch, int fl, cudaStream_t st,
                          const void* pad_t, const void* pad_r, const void* raw_t,
                          const void* raw_r, float* out, float* ntail_t, float* ntail_r,
                          const float* table, const IngestParams& P) {
  const dim3 grid(ceil_div_u(hw, INGEST_THREADS), 2, batch);
#define CVVDP_INGEST_WINDOW(L)                                                         \
  ingest_window<SRC, L><<<grid, threads, 0, st>>>(pad_t, pad_r, raw_t, raw_r, out, \
                                                  ntail_t, ntail_r, table, P)
  if (fl == 7) {
    CVVDP_INGEST_WINDOW(7);
  } else if (fl == 9) {
    CVVDP_INGEST_WINDOW(9);
  } else if (fl == 17) {
    CVVDP_INGEST_WINDOW(17);
  } else {
    const size_t smem = (size_t)fl * 3 * INGEST_THREADS * sizeof(float);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          ingest_ring<SRC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
    }
    ingest_ring<SRC><<<grid, threads, smem, st>>>(pad_t, pad_r, raw_t, raw_r, out, ntail_t,
                                                  ntail_r, table, P);
  }
#undef CVVDP_INGEST_WINDOW
  return cudaGetLastError();
}

// mode: PadMode. pad_t / pad_r: tails (B, 3, fl-1, H, W) float32 in tail
// mode, raw heads (B, fl-1, channels, H, W) of src_type in head mode, null in
// replicate mode; raws: (B, blk, channels, H, W) of src_type (SrcType); out:
// (B, 8, blk, H, W); new tails: (B, 3, fl-1, H, W). consts: the 10 display
// constants of IngestParams in order; M: 9 floats; log_lms: 0 for DKLd65 (M
// is RGB -> DKL), 1 for logLMS_DKLd65 (M is RGB -> LMS2006 and M2, 9 floats,
// LMS2006 -> DKL); filt: (4, fl) floats. table: null (the per-sample path),
// or, for a uint8, uint16 or float16 source in DKLd65, device scratch of
// 256 (uint8) or 65,536 floats that the code-value table is built into.
CVVDP_API int cvvdp_ingest(int mode, const void* pad_t, const void* pad_r,
                           const void* raw_t, const void* raw_r, float* out,
                           float* ntail_t, float* ntail_r, int batch, int blk, int channels,
                           int fl, long long hw, int src_type, int eotf_code,
                           const float* consts, const float* M, int log_lms,
                           const float* M2, const float* filt, float* table, void* stream) {
  if (fl < 2 || fl > INGEST_MAX_FL || blk < 1 || batch < 1 || batch > 65535 ||
      (channels != 1 && channels != 3) || eotf_code < EOTF_SRGB || eotf_code > EOTF_GAMMA ||
      mode < MODE_TAIL || mode > MODE_HEAD || (mode != MODE_REPLICATE && (!pad_t || !pad_r)) ||
      src_type < SRC_U8 || src_type > SRC_F32 ||
      (table && (src_type == SRC_F32 || log_lms)))
    return (int)cudaErrorInvalidValue;
  IngestParams P;
  P.eotf = eotf_code;
  P.channels = channels;
  float* dst[10] = {&P.span, &P.Y_black, &P.Y_refl, &P.exposure, &P.Y_peak,
                    &P.lin_floor, &P.gamma, &P.hlg_g1, &P.hlg_b, &P.hlg_c};
  for (int k = 0; k < 10; ++k) *dst[k] = consts[k];
  for (int k = 0; k < 9; ++k) P.M[k] = M[k];
  P.log_lms = log_lms;
  for (int k = 0; k < 9; ++k) P.M2[k] = log_lms ? M2[k] : 0.0f;
  for (int k = 0; k < 4 * INGEST_MAX_FL; ++k) P.filt[k] = k < 4 * fl ? filt[k] : 0.0f;
  P.fl = fl;
  P.blk = blk;
  P.mode = mode;
  P.hw = hw;
  cudaStream_t st = (cudaStream_t)stream;
  if (table) {
    const int n = src_type == SRC_U8 ? 256 : 65536;
    const unsigned int g = ceil_div_u(n, 256);
    switch (src_type) {
      case SRC_U8: eotf_table_kernel<SRC_U8><<<g, 256, 0, st>>>(P, table, n); break;
      case SRC_U16: eotf_table_kernel<SRC_U16><<<g, 256, 0, st>>>(P, table, n); break;
      default: eotf_table_kernel<SRC_F16><<<g, 256, 0, st>>>(P, table, n); break;
    }
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 threads(INGEST_THREADS);
  cudaError_t e;
  switch (src_type) {
    case SRC_U8:
      e = launch<SRC_U8>(threads, hw, batch, fl, st, pad_t, pad_r, raw_t, raw_r, out,
                         ntail_t, ntail_r, table, P);
      break;
    case SRC_U16:
      e = launch<SRC_U16>(threads, hw, batch, fl, st, pad_t, pad_r, raw_t, raw_r, out,
                          ntail_t, ntail_r, table, P);
      break;
    case SRC_F16:
      e = launch<SRC_F16>(threads, hw, batch, fl, st, pad_t, pad_r, raw_t, raw_r, out,
                          ntail_t, ntail_r, table, P);
      break;
    default:
      e = launch<SRC_F32>(threads, hw, batch, fl, st, pad_t, pad_r, raw_t, raw_r, out,
                          ntail_t, ntail_r, table, P);
      break;
  }
  return (int)e;
}
