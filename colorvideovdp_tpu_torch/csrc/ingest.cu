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
// Any batch size: blockIdx.z is the batch item.
//
// One thread per pixel and source (blockIdx.y: 0 = test, 1 = reference).
// The thread walks the fl-1+blk buffer slots in time order and converts each
// slot to DKL exactly once: tail slots are read from the tail, raw slots go
// through the dtype ladder (true division by 255 / 65535: the PQ curve
// amplifies a last-ulp error about 6x), the EOTF with black level,
// reflection and exposure, and the fused RGB->DKL 3x3; or, for the log
// contrast's metric colour space logLMS_DKLd65, the RGB->LMS2006 3x3, log10
// of each cone response (taken in float64 and rounded once, as
// ops/colorspace.py:log10_rn does) and the LMS->DKL 3x3. The last fl DKL
// triplets sit in a per-thread ring in shared memory; once a slot completes a
// window, the four FIR channels of that output frame are summed in tap order
// and written to out[:, 2*c_out + src, fo] (c_out = 3 re-filters Y). Slots
// blk.. fl-2+blk are also written out as the next tail.
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
// bytes; every read and write is coalesced across the warp and nothing is
// read twice. The EOTF's pow/exp per converted sample is the only heavy
// arithmetic and is hidden behind the traffic.

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

// The dtype ladder of ops/kernels/ingest.py:raw_to_float.
__device__ __forceinline__ float to_float(uint8_t v) { return __fdiv_rn((float)v, 255.0f); }
__device__ __forceinline__ float to_float(uint16_t v) { return __fdiv_rn((float)v, 65535.0f); }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }

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

// Mirrors display.vvdp_display_photo_eotf.forward for the n (1 or 3)
// channels of one pixel.
__device__ void eotf(const IngestParams& P, const float* V, float* L, int n) {
  if (P.eotf == EOTF_HLG) {
    const float a = 0.17883277f;
    float s[3];
    for (int k = 0; k < n; ++k) {
      const float v = clamp01(V[k]);
      s[k] = v <= 0.5f ? __fdiv_rn(__fmul_rn(v, v), 3.0f)
                       : __fdiv_rn(__fadd_rn(expf(__fdiv_rn(__fsub_rn(v, P.hlg_c), a)), P.hlg_b),
                                   12.0f);
    }
    // Y_s = sum of the weighted channels; luminance content weighs its one
    // channel three times, as the plain version's broadcast does.
    const float s1 = n == 3 ? s[1] : s[0], s2 = n == 3 ? s[2] : s[0];
    const float Ys = __fadd_rn(__fadd_rn(__fmul_rn(s[0], 0.2627f), __fmul_rn(s1, 0.6780f)),
                               __fmul_rn(s2, 0.0593f));
    const float oo = powf(Ys, P.hlg_g1);
    for (int k = 0; k < n; ++k) L[k] = gog(P, expose01(P, __fmul_rn(oo, s[k])));
    return;
  }
  for (int k = 0; k < n; ++k) {
    const float v = V[k];
    if (P.eotf == EOTF_SRGB) {
      const float u = clamp01(v);
      const float lin = u > 0.04045f ? powf(__fdiv_rn(__fadd_rn(u, 0.055f), 1.055f), 2.4f)
                                     : __fdiv_rn(u, 12.92f);
      L[k] = gog(P, expose01(P, lin));
    } else if (P.eotf == EOTF_PQ) {
      // ops/colorspace.py:pq2lin: float32 as the JAX package computes it,
      // with both powers correctly rounded (pow_rn).
      const float im_t = pow_rn(clamp01(v), (float)(1.0 / 78.84375));
      const float num = fmaxf(__fsub_rn(im_t, 0.8359375f), 0.0f);
      const float den = __fsub_rn(18.8515625f, __fmul_rn(18.6875f, im_t));
      const float lin = __fmul_rn(10000.0f, pow_rn(__fdiv_rn(num, den),
                                                   (float)(1.0 / 0.1593017578125)));
      L[k] = __fadd_rn(__fadd_rn(fminf(fmaxf(__fmul_rn(lin, P.exposure), 0.005f), P.Y_peak),
                                 P.Y_black), P.Y_refl);
    } else if (P.eotf == EOTF_LINEAR) {
      L[k] = __fadd_rn(fminf(fmaxf(__fmul_rn(v, P.exposure), P.lin_floor), P.Y_peak), P.Y_refl);
    } else {  // numeric gamma
      L[k] = gog(P, clamp01(__fmul_rn(powf(clamp01(v), P.gamma), P.exposure)));
    }
  }
}

// y = M x with the plain version's order: (x0 m0 + x1 m1) + x2 m2 per row.
__device__ __forceinline__ void mat3(const float* M, const float* x, float* y) {
  for (int c = 0; c < 3; ++c)
    y[c] = __fadd_rn(__fadd_rn(__fmul_rn(x[0], M[3 * c]), __fmul_rn(x[1], M[3 * c + 1])),
                     __fmul_rn(x[2], M[3 * c + 2]));
}

// One raw frame's pixel (frame fr of a (blk|fl-1, channels, hw) plane set)
// -> its metric colour-space triplet.
template <typename T>
__device__ __forceinline__ void convert(const IngestParams& P, const T* __restrict__ raw,
                                        long long fr, long long pix, float* dkl) {
  const int nc = P.channels;
  const long long hw = P.hw;
  float V[3], L[3];
  for (int c = 0; c < nc; ++c) V[c] = to_float(raw[(fr * nc + c) * hw + pix]);
  eotf(P, V, L, nc);
  if (nc == 3) {
    mat3(P.M, L, dkl);
    if (P.log_lms) {
      float lg[3];
      for (int c = 0; c < 3; ++c) lg[c] = (float)log10((double)dkl[c]);
      mat3(P.M2, lg, dkl);
    }
  } else {  // luminance-only content bypasses the colour transform
    for (int c = 0; c < 3; ++c) dkl[c] = L[0];
  }
}

// pad_t / pad_r: the DKL tails (float, (B, 3, fl-1, hw)) in tail mode, the
// raw head frames (T, (B, fl-1, channels, hw)) in head mode, unused in
// replicate mode.
template <typename T>
__global__ void ingest_kernel(const void* __restrict__ pad_t,
                              const void* __restrict__ pad_r,
                              const T* __restrict__ raw_t,
                              const T* __restrict__ raw_r,
                              float* __restrict__ out,
                              float* __restrict__ ntail_t,
                              float* __restrict__ ntail_r, IngestParams P) {
  extern __shared__ float ring[];  // [fl][3][blockDim.x]
  __shared__ float s_filt[4 * INGEST_MAX_FL];
  const int fl = P.fl, blk = P.blk, nc = P.channels, mode = P.mode;
  for (int k = threadIdx.x; k < 4 * fl; k += blockDim.x) s_filt[k] = P.filt[k];
  __syncthreads();

  const long long hw = P.hw;
  const long long pix = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= hw) return;
  const int src = blockIdx.y;
  const long long b = blockIdx.z;
  const long long tail_off = b * 3 * (fl - 1) * hw;
  const void* pad = src == 0 ? pad_t : pad_r;
  const T* raw = (src == 0 ? raw_t : raw_r) + b * blk * nc * hw;
  float* ntail = (src == 0 ? ntail_t : ntail_r) + tail_off;
  float* outb = out + b * 8 * blk * hw;
  const int bd = blockDim.x, tid = threadIdx.x;

  float first[3];  // replicate: frame 0's triplet, converted once
  if (mode == MODE_REPLICATE) convert(P, raw, 0, pix, first);

  for (int s = 0; s < fl - 1 + blk; ++s) {
    float dkl[3];
    if (mode == MODE_REPLICATE && s <= fl - 1) {
      for (int c = 0; c < 3; ++c) dkl[c] = first[c];
    } else if (s >= fl - 1) {
      convert(P, raw, s - (fl - 1), pix, dkl);
    } else if (mode == MODE_HEAD) {
      convert(P, (const T*)pad + b * (fl - 1) * nc * hw, s, pix, dkl);
    } else {
      const float* tail = (const float*)pad + tail_off;
      for (int c = 0; c < 3; ++c) dkl[c] = tail[((long long)c * (fl - 1) + s) * hw + pix];
    }
    const int slot = s % fl;
    for (int c = 0; c < 3; ++c) ring[(slot * 3 + c) * bd + tid] = dkl[c];
    if (s >= blk) {
      for (int c = 0; c < 3; ++c)
        ntail[((long long)c * (fl - 1) + (s - blk)) * hw + pix] = dkl[c];
    }
    if (s >= fl - 1) {
      const int fo = s - (fl - 1);
      for (int co = 0; co < 4; ++co) {
        const int ci = co < 3 ? co : 0;
        float acc = 0.0f;
        for (int t = 0; t < fl; ++t)
          acc = __fadd_rn(acc, __fmul_rn(ring[(((fo + t) % fl) * 3 + ci) * bd + tid],
                                         s_filt[co * fl + t]));
        outb[((long long)(2 * co + src) * blk + fo) * hw + pix] = acc;
      }
    }
  }
}

template <typename T>
static void launch(dim3 grid, size_t smem, cudaStream_t st, const void* pad_t,
                   const void* pad_r, const void* raw_t, const void* raw_r, float* out,
                   float* ntail_t, float* ntail_r, const IngestParams& P) {
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(ingest_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  ingest_kernel<T><<<grid, INGEST_THREADS, smem, st>>>(
      pad_t, pad_r, (const T*)raw_t, (const T*)raw_r, out, ntail_t, ntail_r, P);
}

// mode: PadMode. pad_t / pad_r: tails (B, 3, fl-1, H, W) float32 in tail
// mode, raw heads (B, fl-1, channels, H, W) of src_type in head mode, null in
// replicate mode; raws: (B, blk, channels, H, W) of src_type (SrcType); out:
// (B, 8, blk, H, W); new tails: (B, 3, fl-1, H, W). consts: the 10 display
// constants of IngestParams in order; M: 9 floats; log_lms: 0 for DKLd65 (M
// is RGB -> DKL), 1 for logLMS_DKLd65 (M is RGB -> LMS2006 and M2, 9 floats,
// LMS2006 -> DKL); filt: (4, fl) floats.
CVVDP_API int cvvdp_ingest(int mode, const void* pad_t, const void* pad_r,
                           const void* raw_t, const void* raw_r, float* out,
                           float* ntail_t, float* ntail_r, int batch, int blk, int channels,
                           int fl, long long hw, int src_type, int eotf_code,
                           const float* consts, const float* M, int log_lms,
                           const float* M2, const float* filt, void* stream) {
  if (fl < 2 || fl > INGEST_MAX_FL || blk < 1 || batch < 1 || batch > 65535 ||
      (channels != 1 && channels != 3) || eotf_code < EOTF_SRGB || eotf_code > EOTF_GAMMA ||
      mode < MODE_TAIL || mode > MODE_HEAD || (mode != MODE_REPLICATE && (!pad_t || !pad_r)))
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
  for (int k = 0; k < 4 * fl; ++k) P.filt[k] = filt[k];
  P.fl = fl;
  P.blk = blk;
  P.mode = mode;
  P.hw = hw;
  const size_t smem = (size_t)fl * 3 * INGEST_THREADS * sizeof(float);
  dim3 grid(ceil_div_u(hw, INGEST_THREADS), 2, batch);
  cudaStream_t st = (cudaStream_t)stream;
  switch (src_type) {
    case SRC_U8:
      launch<uint8_t>(grid, smem, st, pad_t, pad_r, raw_t, raw_r, out, ntail_t, ntail_r, P);
      break;
    case SRC_U16:
      launch<uint16_t>(grid, smem, st, pad_t, pad_r, raw_t, raw_r, out, ntail_t, ntail_r, P);
      break;
    case SRC_F16:
      launch<__half>(grid, smem, st, pad_t, pad_r, raw_t, raw_r, out, ntail_t, ntail_r, P);
      break;
    case SRC_F32:
      launch<float>(grid, smem, st, pad_t, pad_r, raw_t, raw_r, out, ntail_t, ntail_r, P);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
