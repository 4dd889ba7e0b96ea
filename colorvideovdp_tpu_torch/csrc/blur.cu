// Separable blur of (P, H, W) float32 planes with an odd kernel of radius
// R <= 16 and the edge-excluded reflect padding of ops/blur.py, vertical pass
// first, taps summed in order; and its adjoint.
//
// Replaces colorvideovdp_tpu/ops/kernels/blur_halo.py `blur_tpu`
// (`_blur_kernel`, `apply_blur_tile`): the standalone phase-uncertainty blur
// (13 taps at the calibrated pu_dilate = 3) that the masking model's gradient
// recompute and the non-default masking models run, and the 33-tap texture
// blur (sigma 8) of the *-transducer-texture models; and the VJP of
// `blur_tpu` (the JAX package takes XLA's transpose of its plain blur). The
// TPU kernel stops at radius 8 (`can_blur_tpu`); this one takes radius 16.
//
// Forward: y = H(V(x)), V and H each reflect (index -j reads j, n - 1 + j
// reads n - 1 - j) and correlate with the taps t_0 .. t_2R. Adjoint (mode
// ADJ): x_bar = H^T(V^T(g)) = V^T(H^T(g)) (the two passes act on different
// axes); each transposed pass correlates g with the reversed taps over the
// axis extended by R zeros on each side, then folds the R extended samples
// beyond each edge back onto their reflections (index -j adds to j, index
// n - 1 + j adds to n - 1 - j; the left fold first). ops/blur.py
// `blur_adjoint_plain` does the same steps in the same order, so the two
// give the same bits; autograd of `blur_plain` sums the fold in another
// order (within rounding).
//
// Bound on the H100: bytes at 13 taps, the float32 pipe at 33. Per element
// the kernel must read 4 bytes and write 4, and issue 2 (2R + 1) multiplies
// and 4R adds (the kernels round each step, no FMA): 50 instructions at
// R = 6, 130 at R = 16, against the card's 33.5 T instructions and 3.35 TB/s
// a second (8 bytes take the time of ~80 instructions). The design keeps
// everything else off those two pipes:
//   * A block of BT = 256 threads owns a strip of SW = 256 - 2 HALO output
//     columns of one plane (HALO = R rounded up to 4) and walks down a run
//     of 16 to 128 output rows (chosen at launch from the grid's size).
//     Input rows of the strip plus HALO columns a side
//     stream through a ring of RING = AHEAD * CM + 2R rows in shared memory
//     by cp.async (16-byte copies where the staged columns lie inside a
//     plane with W % 4 == 0 and an aligned base, 4-byte copies through the
//     column reflect, computed once a block, otherwise); rows are reflected
//     (zeroed in ADJ) as they are fetched. The vertical halo, 2R rows, is
//     paid once a run.
//   * Stage 1 (vertical): thread u owns staged column u and forms CM output
//     rows at a time in registers from the CM + 2R ring rows of their window,
//     one shared load a ring row: a ring row feeds up to CM sums, each in tap
//     order. The taps are a kernel parameter read with static indices (no
//     shared loads), because R is a template argument and every tap loop
//     unrolls. The CM rows of sums go to a shared buffer.
//   * Stage 2 (horizontal): a thread takes 4 adjacent outputs of one row,
//     reads their 4 + 2 HALO sums with 16-byte shared loads (adjacent threads
//     on adjacent addresses: no bank conflicts), sums the taps in order and
//     stores the 4 outputs once, as a float4 where aligned.
//   * While stage 2 of chunk c runs, the rows of chunks c + 1 .. c + AHEAD
//     are in flight. A 1-D grid over (plane, run, strip), strips fastest.

#include "common.cuh"

namespace {

constexpr int MAX_R = 16;
// Threads a block (= staged columns a ring row), output rows a chunk, chunks
// whose rows are in flight: the fastest of the layouts timed on the H100
// (PERF.md; 8-row chunks, one or three chunks in flight, 128- or 512-thread
// blocks, 32-row chunks were slower).
constexpr int BT = 256;
constexpr int CM = 16;
constexpr int AHEAD = 2;

struct BlurTaps {
  float t[2 * MAX_R + 1];
};

struct BlurArgs {
  const float* x;
  float* y;
  int H, W, n_strips, n_runs, run, vec_in, vec_out;
  BlurTaps T;
};

// The rows a block walks (BlurArgs::run) are a multiple of CM chosen at
// launch.
template <int R>
struct BlurGeo {
  static constexpr int HALO = (R + 3) / 4 * 4;  // staged columns beyond the strip, a side
  static constexpr int SW = BT - 2 * HALO;      // output columns a strip
  static constexpr int G = SW / 4;              // stage-2 groups of 4 outputs a row
  static constexpr int WIN = 4 + 2 * HALO;      // stage-2 window of sums
  // Live ring rows when chunk c + AHEAD's rows are issued: chunk c + 1's
  // window start up to chunk c + AHEAD's last row.
  static constexpr int RING = AHEAD * CM + 2 * R;
  static constexpr int SMEM = (RING + CM) * BT * (int)sizeof(float);
  static_assert(SW % 4 == 0 && SW > 0, "strip");
};

// The folds of the adjoint (ADJ). Each transposed pass leaves u_m at the
// zero-extended positions m in [-R, -1] and [n, n - 1 + R] of an axis of n
// samples s; the fold adds u_{-j} onto j (1 <= j <= R), then u_{2n-2-j} onto
// j (n - 1 - R <= j <= n - 2), each summed over its in-axis samples in tap
// order (the zero samples add nothing):
//   u_{-j}     = sum_{q = 0}^{R - j}         t_{R-j-q} s(q)
//   u_{2n-2-j} = sum_{k = 0}^{j + R + 1 - n} t_{2R-k}  s(2n - 2 - j - R + k)

// Stage 1 (rows; block-uniform, the first and last chunks of a plane): s(q)
// is plane row q in ring slot (q - i0 + R) % RING (the top fold's rows never
// wrap). The loads are unrolled to R and predicated, so they issue together.
template <int R, int RING>
__device__ __forceinline__ float fold_rows(float acc, int j, int n, int i0,
                                           const float* taps, const float* col) {
  if (j >= 1 && j <= R) {
    float f = 0.0f;
#pragma unroll
    for (int q = 0; q < R; ++q)
      if (q <= R - j) {
        const float term = __fmul_rn(taps[R - j - q], col[(q - i0 + R) * BT]);
        f = q == 0 ? term : __fadd_rn(f, term);
      }
    acc = __fadd_rn(acc, f);
  }
  if (j >= n - 1 - R && j <= n - 2) {
    int slot = (2 * n - 2 - j - i0) % RING;
    float f = 0.0f;
#pragma unroll
    for (int k = 0; k < R; ++k)
      if (k <= j + R + 1 - n) {
        const float term = __fmul_rn(taps[2 * R - k], col[slot * BT]);
        f = k == 0 ? term : __fadd_rn(f, term);
        slot = slot + 1 == RING ? 0 : slot + 1;
      }
    acc = __fadd_rn(acc, f);
  }
  return acc;
}

// Stage 2 (columns): a task's window win[i] holds column cb - HALO + i of its
// row of sums, so the folds of its outputs cb + E (E = 0..3) read registers at
// indices fixed by CB = cb (left fold, cb <= R) or by D = W - 1 - cb (right
// fold, 1 <= D <= R + 3): one unrolled case for each, taps at static indices.
template <int R, int HALO, int CB, int E>
__device__ __forceinline__ void fold_left_one(float& o, const float* win, const BlurTaps& T) {
  constexpr int cc = CB + E;
  if constexpr (cc >= 1 && cc <= R) {
    float f = __fmul_rn(T.t[R - cc], win[HALO - CB]);
#pragma unroll
    for (int q = 1; q <= R - cc; ++q) f = mul_add_rn(f, T.t[R - cc - q], win[q - CB + HALO]);
    o = __fadd_rn(o, f);
  }
}

template <int R, int HALO, int D, int E>
__device__ __forceinline__ void fold_right_one(float& o, const float* win, const BlurTaps& T) {
  if constexpr (E >= D - R && E <= D - 1) {
    constexpr int i0 = 2 * D - E - R + HALO;  // window index of s(2n - 2 - cc - R)
    float f = __fmul_rn(T.t[2 * R], win[i0]);
#pragma unroll
    for (int k = 1; k <= E + R - D; ++k) f = mul_add_rn(f, T.t[2 * R - k], win[i0 + k]);
    o = __fadd_rn(o, f);
  }
}

template <int R, int HALO, int CB = 0>
__device__ __forceinline__ void fold_left(int cb, float (&o)[4], const float* win,
                                          const BlurTaps& T) {
  if constexpr (CB <= R) {
    if (cb == CB) {
      fold_left_one<R, HALO, CB, 0>(o[0], win, T);
      fold_left_one<R, HALO, CB, 1>(o[1], win, T);
      fold_left_one<R, HALO, CB, 2>(o[2], win, T);
      fold_left_one<R, HALO, CB, 3>(o[3], win, T);
    } else {
      fold_left<R, HALO, CB + 4>(cb, o, win, T);
    }
  }
}

template <int R, int HALO, int D = 1>
__device__ __forceinline__ void fold_right(int d, float (&o)[4], const float* win,
                                           const BlurTaps& T) {
  if constexpr (D <= R + 3) {
    if (d == D) {
      fold_right_one<R, HALO, D, 0>(o[0], win, T);
      fold_right_one<R, HALO, D, 1>(o[1], win, T);
      fold_right_one<R, HALO, D, 2>(o[2], win, T);
      fold_right_one<R, HALO, D, 3>(o[3], win, T);
    } else {
      fold_right<R, HALO, D + 1>(d, o, win, T);
    }
  }
}

template <int R, bool ADJ>
__global__ void __launch_bounds__(BT) blur_kernel(const __grid_constant__ BlurArgs A) {
  using Gm = BlurGeo<R>;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                // RING rows of BT staged columns
  float* vs = smem + Gm::RING * BT;  // CM rows of stage-1 sums
  __shared__ float s_taps[2 * R + 1];  // the taps, for the folds' run-time indices

  const int u = threadIdx.x;
  long long blk = blockIdx.x;
  const int strip = (int)(blk % A.n_strips);
  blk /= A.n_strips;
  const int run = (int)(blk % A.n_runs);
  const long long p = blk / A.n_runs;
  const int H = A.H, W = A.W;
  const int c0 = strip * Gm::SW, i0 = run * A.run;
  const int n_rows = min(A.run, H - i0);
  const int n_chunks = (n_rows + CM - 1) / CM;
  const float* xp = A.x + p * H * (long long)W;
  float* yp = A.y + p * H * (long long)W;
  if (u <= 2 * R) s_taps[u] = A.T.t[u];

  // This thread's staged column and its source column: the reflect (forward)
  // or -1 outside the plane (ADJ: zero).
  const int col = c0 - Gm::HALO + u;
  const int src_col = ADJ ? ((col >= 0 && col < W) ? col : -1) : reflect_clamp(col, W);
  const bool vec = A.vec_in && c0 - Gm::HALO >= 0 && c0 - Gm::HALO + BT <= W;

  // Ring row t holds plane row i0 - R + t, in slot t % RING. Group g: the
  // rows chunk g reads first (its whole window for g = 0, then CM rows);
  // one commit group each, empty past the run.
  auto load_group = [&](int g) {
    if (g < n_chunks) {
      const int t_lo = g == 0 ? 0 : g * CM + 2 * R;
      const int t_hi = min(g == 0 ? CM + 2 * R : t_lo + CM, n_rows + 2 * R);
      if (vec) {
        const int ch = u & (BT / 4 - 1);
        for (int t = t_lo + u / (BT / 4); t < t_hi; t += 4) {
          const int q = i0 - R + t;
          float* dst = ring + (t % Gm::RING) * BT + 4 * ch;
          if (ADJ && (q < 0 || q >= H))
            *reinterpret_cast<float4*>(dst) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          else
            cp_async16(dst, xp + (long long)reflect_clamp(q, H) * W + (c0 - Gm::HALO + 4 * ch));
        }
      } else {
        for (int t = t_lo; t < t_hi; ++t) {
          const int q = i0 - R + t;
          float* dst = ring + (t % Gm::RING) * BT + u;
          if (ADJ && (q < 0 || q >= H || src_col < 0))
            *dst = 0.0f;
          else
            cp_async4(dst, xp + (long long)reflect_clamp(q, H) * W + src_col);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int g = 0; g < AHEAD; ++g) load_group(g);

  int base = 0;  // ring slot of chunk c's first window row, t = c * CM
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<AHEAD - 1>();
    __syncthreads();  // chunk c's rows have landed; the previous stage 2 is done
    // Stage 1: output rows j = i0 + c CM + m at staged column u; tap k of
    // row m reads window row m + k.
    float acc[CM];
#pragma unroll
    for (int w = 0; w < CM + 2 * R; ++w) {
      int s = base + w;
      if (s >= Gm::RING) s -= Gm::RING;
      const float v = ring[s * BT + u];
#pragma unroll
      for (int m = 0; m < CM; ++m) {
        const int k = w - m;
        if (k >= 0 && k <= 2 * R) {
          const float tk = A.T.t[ADJ ? 2 * R - k : k];
          acc[m] = k == 0 ? __fmul_rn(tk, v) : mul_add_rn(acc[m], tk, v);
        }
      }
    }
    if (ADJ && R > 0) {
      const int j0 = i0 + c * CM;
      if (j0 <= R || j0 + CM - 1 >= H - 1 - R) {  // block-uniform
#pragma unroll
        for (int m = 0; m < CM; ++m)
          acc[m] = fold_rows<R, Gm::RING>(acc[m], j0 + m, H, i0, s_taps, ring + u);
      }
    }
#pragma unroll
    for (int m = 0; m < CM; ++m) vs[m * BT + u] = acc[m];
    __syncthreads();  // the sums are visible; chunk c's first CM ring rows are free
    load_group(c + AHEAD);
    base += CM;
    if (base >= Gm::RING) base -= Gm::RING;

    // Stage 2: outputs cb .. cb + 3 of row j; staged index of column x is
    // x - c0 + HALO, so tap k of output e reads window e + HALO - R + k.
    for (int task = u; task < CM * Gm::G; task += BT) {
      const int m = task / Gm::G, gq = task % Gm::G;
      const int cb = c0 + 4 * gq;
      if (c * CM + m >= n_rows || cb >= W) continue;
      const float* vrow = vs + m * BT;
      float win[Gm::WIN];
#pragma unroll
      for (int a = 0; a < Gm::WIN / 4; ++a) {
        const float4 f = *reinterpret_cast<const float4*>(vrow + 4 * gq + 4 * a);
        win[4 * a] = f.x;
        win[4 * a + 1] = f.y;
        win[4 * a + 2] = f.z;
        win[4 * a + 3] = f.w;
      }
      float o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float a = __fmul_rn(A.T.t[ADJ ? 2 * R : 0], win[e + Gm::HALO - R]);
#pragma unroll
        for (int k = 1; k <= 2 * R; ++k)
          a = mul_add_rn(a, A.T.t[ADJ ? 2 * R - k : k], win[e + Gm::HALO - R + k]);
        o[e] = a;
      }
      if (ADJ && R > 0) {
        if (cb <= R) fold_left<R, Gm::HALO>(cb, o, win, A.T);
        const int d = W - 1 - cb;
        if (d >= 1 && d <= R + 3) fold_right<R, Gm::HALO>(d, o, win, A.T);
      }
      const int j = i0 + c * CM + m;
      float* dst = yp + (long long)j * W + cb;
      if (A.vec_out && cb + 3 < W) {
        *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (cb + e < W) dst[e] = o[e];
      }
    }
  }
  cp_async_wait<0>();
}

// The run: the longest of 128, 64 or 32 rows that still gives the grid
// MIN_BLOCKS blocks, else CM rows: few or short planes take short runs so that
// every SM gets blocks, large ones long runs to pay the vertical halo rarely.
// The threshold splits the layouts measured fastest on the H100 (PERF.md):
// 32-row runs for (3, 1080, 1920) at 33 taps (918 blocks), 64 for
// (12, 1080, 1920) at 13 (1632; 128 rows give 864), 128 for the 4K band 0.
constexpr long long MIN_BLOCKS = 900;

template <int R, bool ADJ>
int launch_blur(const float* x, float* y, int P, int H, int W, const BlurTaps& T,
                cudaStream_t stream) {
  using Gm = BlurGeo<R>;
  const long long strips = (W + Gm::SW - 1) / Gm::SW;
  int run = CM;
  for (int cand = 128; cand > CM; cand /= 2)
    if ((long long)P * strips * ((H + cand - 1) / cand) >= MIN_BLOCKS) {
      run = cand;
      break;
    }
  BlurArgs A;
  A.x = x;
  A.y = y;
  A.H = H;
  A.W = W;
  A.run = run;
  A.n_strips = (int)strips;
  A.n_runs = (H + run - 1) / run;
  A.vec_in = (W % 4 == 0) && ((uintptr_t)x % 16 == 0);
  A.vec_out = (W % 4 == 0) && ((uintptr_t)y % 16 == 0);
  A.T = T;
  const long long blocks = (long long)P * A.n_strips * A.n_runs;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto kernel = blur_kernel<R, ADJ>;
  if (Gm::SMEM > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Gm::SMEM);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<(unsigned int)blocks, BT, Gm::SMEM, stream>>>(A);
  return (int)cudaGetLastError();
}

template <bool ADJ>
int dispatch_blur(int r, const float* x, float* y, int P, int H, int W, const BlurTaps& T,
                  cudaStream_t s) {
  switch (r) {
#define CVVDP_BLUR_CASE(RR) \
  case RR:                  \
    return launch_blur<RR, ADJ>(x, y, P, H, W, T, s);
    CVVDP_BLUR_CASE(0) CVVDP_BLUR_CASE(1) CVVDP_BLUR_CASE(2) CVVDP_BLUR_CASE(3)
    CVVDP_BLUR_CASE(4) CVVDP_BLUR_CASE(5) CVVDP_BLUR_CASE(6) CVVDP_BLUR_CASE(7)
    CVVDP_BLUR_CASE(8) CVVDP_BLUR_CASE(9) CVVDP_BLUR_CASE(10) CVVDP_BLUR_CASE(11)
    CVVDP_BLUR_CASE(12) CVVDP_BLUR_CASE(13) CVVDP_BLUR_CASE(14) CVVDP_BLUR_CASE(15)
    CVVDP_BLUR_CASE(16)
#undef CVVDP_BLUR_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x, y: (P, H, W) device arrays; taps: ntaps host floats (odd, <= 33), and
// H, W must exceed the radius (one reflection). adjoint != 0 computes the
// adjoint of the blur with these taps (x: the gradient of y).
CVVDP_API int cvvdp_blur(const float* x, float* y, int P, int H, int W, const float* taps,
                         int ntaps, int adjoint, void* stream) {
  const int r = (ntaps - 1) / 2;
  if (ntaps < 1 || ntaps > 2 * MAX_R + 1 || (ntaps % 2) != 1 || P < 1 || H <= r || W <= r)
    return (int)cudaErrorInvalidValue;
  BlurTaps T;
  for (int k = 0; k < 2 * MAX_R + 1; ++k) T.t[k] = k < ntaps ? taps[k] : 0.0f;
  const cudaStream_t s = (cudaStream_t)stream;
  return adjoint ? dispatch_blur<true>(r, x, y, P, H, W, T, s)
                 : dispatch_blur<false>(r, x, y, P, H, W, T, s);
}
