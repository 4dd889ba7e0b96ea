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
// that, and does 7.5 float32 operations per input pixel, far below the
// card's rate. The design streams rows so that each input byte crosses HBM
// about once, with enough of them in flight:
//   * A block of RT = 128 threads owns a strip of 256 output columns (512
//     input columns plus 4 on each side: the horizontal halo is 8/512, and
//     the staged window starts 16-byte aligned) and a run of up to 32
//     output rows, which it walks down. The vertical halo (3 input rows)
//     is paid once per run.
//   * Input rows go through a ring of RING = 8 rows in shared memory by
//     cp.async: 16-byte copies where W % 4 == 0 (4K: 3840 down to 60),
//     4-byte copies otherwise. While output row k is computed, the input
//     rows of rows k + 1 and k + 2 (two rows each) are in flight.
//   * These sizes were measured fastest on the H100 (PERF.md): strips
//     of 128 outputs or 64-thread blocks cost 5%, more rows in flight or a
//     16-row ring cost registers and 8-15%, one row in flight 18%; one
//     barrier a row (double-buffered edge sums) and edge sums formed by
//     every thread lost too.
//   * Thread u forms the vertical sums of input columns 4u .. 4u + 3 in
//     registers from one 16-byte shared load per ring row (no bank
//     conflicts), then the two adjacent outputs 2u and 2u + 1. The three
//     sums it needs from its neighbours go through three small shared
//     arrays indexed by thread (consecutive, so conflict-free); three
//     threads form the strip's edge sums. Outputs leave as float2 where Wo
//     is even.
//   * A 1-D grid over (plane, run, strip), strips fastest so that
//     neighbouring blocks share their halo columns in L2; P is not capped.
//     No integer division per element, only per block.

#include "common.cuh"

struct ReduceK {
  float k[5];
};

// One pass at output index i of an axis of n samples (n_out outputs), from
// the window s[a] = x[2i - 2 + a] (0 outside the axis); `fix` adds the edge
// corrections, the last-sample branch chosen by h_odd (trap 1). x[n - 1]
// sits at slot 2 (n odd) or 3 (n even) of the last output's window.
__device__ __forceinline__ float reduce_pass(const float s[5], int i, int n, int n_out,
                                             bool h_odd, const ReduceK& K, bool fix) {
  float y = __fmul_rn(K.k[0], s[0]);
#pragma unroll
  for (int a = 1; a < 5; ++a) y = mul_add_rn(y, K.k[a], s[a]);
  if (!fix) return y;
  if (i == 0)  // + x[0] * K1 + x[1] * K0
    y = mul_add_rn(mul_add_rn(y, s[2], K.k[1]), s[3], K.k[0]);
  if (i == n_out - 1) {
    const bool n_odd = (n & 1) != 0;
    const float last = n_odd ? s[2] : s[3], prev = n_odd ? s[1] : s[2];
    if (h_odd)  // + x[n-1] * K3 + x[n-2] * K4
      y = mul_add_rn(mul_add_rn(y, last, K.k[3]), prev, K.k[4]);
    else        // + x[n-1] * K4
      y = mul_add_rn(y, last, K.k[4]);
  }
  return y;
}

constexpr int RT = 128;                // threads a block, two outputs each
constexpr int RS_OUT = 2 * RT;         // output columns a strip
constexpr int RS_IN = 2 * RS_OUT + 8;  // staged input columns, from 2 j0 - 4
constexpr int RING = 8;                // input rows in the ring
constexpr int AHEAD = 2;               // output rows whose input rows are in flight
constexpr int RUN_MAX = 32;            // output rows a block walks at most
// The ring holds the five rows of the current output row and the rows in
// flight: 2 * AHEAD + 3 <= RING.
static_assert(2 * AHEAD + 3 <= RING && (RING & (RING - 1)) == 0, "ring too small");

// Plain mode: Hin = H rows, Ho = ceil(H / 2), row_off = 0, vfix = 1,
// h_odd = H % 2. Slab mode: Hin = H_loc + 16 buffer rows, Ho = H_loc / 2,
// row_off = 8, vfix = 0, h_odd = the global row parity.
struct ReduceArgs {
  const float* x;
  float* y;
  int Hin, Ho, W, Wo, row_off;
  int vfix, h_odd, vec_in, vec_out;
  int n_strips, n_runs, run_len;
  ReduceK K;
};

__global__ void __launch_bounds__(RT)
    pyramid_reduce_kernel(const __grid_constant__ ReduceArgs A) {
  __shared__ __align__(16) float ring[RING][RS_IN];
  // Thread u reads v(4u - 2) = l2[u], v(4u - 1) = l1[u], v(4u + 4) = r0[u + 1].
  __shared__ float l2[RT + 1], l1[RT + 1], r0[RT + 1];
  const int u = threadIdx.x;
  long long blk = blockIdx.x;
  const int strip = (int)(blk % A.n_strips);
  blk /= A.n_strips;
  const int run = (int)(blk % A.n_runs);
  const long long p = blk / A.n_runs;
  const int j0 = strip * RS_OUT, i0 = run * A.run_len;
  const int n_rows = min(A.run_len, A.Ho - i0);
  const int X0 = 2 * j0 - 4;                // input column of ring column 0
  const int q0 = 2 * i0 - 2 + A.row_off;    // input row of ring row q = 0
  const float* xp = A.x + p * A.Hin * (long long)A.W;
  float* yp = A.y + p * A.Ho * (long long)A.Wo;
  const bool vfix = A.vfix != 0, h_odd = A.h_odd != 0;

  // Ring row q holds input row q0 + q, in slot q % RING; rows and columns
  // outside the plane are not copied (the passes read them as zeros).
  auto load_row = [&](int q) {
    const int row = q0 + q;
    if (row < 0 || row >= A.Hin) return;
    float* dst = ring[q & (RING - 1)];
    const float* src = xp + (long long)row * A.W;
    if (A.vec_in) {
      for (int c = 4 * u; c < RS_IN; c += 4 * RT) {
        const int col = X0 + c;
        if (col >= 0 && col < A.W) cp_async16(dst + c, src + col);
      }
    } else {
      for (int c = u; c < RS_IN; c += RT) {
        const int col = X0 + c;
        if (col >= 0 && col < A.W) cp_async4(dst + c, src + col);
      }
    }
  };
  // Group g: the input rows output row g reads first (rows 0..4 for g = 0,
  // then 2g + 3 and 2g + 4); one commit group each, empty past the run.
  auto load_group = [&](int g) {
    if (g == 0) {
      for (int q = 0; q < 5; ++q) load_row(q);
    } else if (g < n_rows) {
      load_row(2 * g + 3);
      load_row(2 * g + 4);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int g = 0; g < AHEAD; ++g) load_group(g);

  // The vertical pass of output row k at input columns 4u .. 4u + 3 (zero
  // outside the plane: the vertical pass's output is zero-padded too), and
  // the neighbours' sums into l2, l1 and r0.
  auto vertical = [&](int k, float v[4]) {
    const int i = i0 + k;
    const float* rows[5];
    bool ok[5];
#pragma unroll
    for (int a = 0; a < 5; ++a) {
      const int row = q0 + 2 * k + a;
      ok[a] = row >= 0 && row < A.Hin;
      rows[a] = ring[(2 * k + a) & (RING - 1)];
    }
    float4 w[5];
#pragma unroll
    for (int a = 0; a < 5; ++a)
      w[a] = ok[a] ? *reinterpret_cast<const float4*>(rows[a] + 4 + 4 * u)
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    {
      float s[5];
#pragma unroll
      for (int a = 0; a < 5; ++a) s[a] = w[a].x;
      v[0] = reduce_pass(s, i, A.Hin, A.Ho, h_odd, A.K, vfix);
#pragma unroll
      for (int a = 0; a < 5; ++a) s[a] = w[a].y;
      v[1] = reduce_pass(s, i, A.Hin, A.Ho, h_odd, A.K, vfix);
#pragma unroll
      for (int a = 0; a < 5; ++a) s[a] = w[a].z;
      v[2] = reduce_pass(s, i, A.Hin, A.Ho, h_odd, A.K, vfix);
#pragma unroll
      for (int a = 0; a < 5; ++a) s[a] = w[a].w;
      v[3] = reduce_pass(s, i, A.Hin, A.Ho, h_odd, A.K, vfix);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (2 * j0 + 4 * u + e >= A.W) v[e] = 0.0f;
    l2[u + 1] = v[2];
    l1[u + 1] = v[3];
    r0[u] = v[0];
    if (u < 3) {  // the strip's edge columns: 2 j0 - 2, 2 j0 - 1, 2 j0 + 4 RT
      const int c = u < 2 ? 2 + u : RS_IN - 4;
      const int col = X0 + c;
      float s[5];
#pragma unroll
      for (int a = 0; a < 5; ++a) s[a] = ok[a] ? rows[a][c] : 0.0f;
      const float e = (col >= 0 && col < A.W) ? reduce_pass(s, i, A.Hin, A.Ho, h_odd, A.K, vfix)
                                              : 0.0f;
      if (u == 0) l2[0] = e;
      else if (u == 1) l1[0] = e;
      else r0[RT] = e;
    }
  };
  // The horizontal pass of output row i: outputs j and j + 1 from input
  // columns 2j - 2 .. 2j + 4 (the correction keyed on the ROW parity, trap 1).
  auto horizontal = [&](int i, const float v[4]) {
    const int j = j0 + 2 * u;
    if (j >= A.Wo) return;
    float s[5] = {l2[u], l1[u], v[0], v[1], v[2]};
    const float o0 = reduce_pass(s, j, A.W, A.Wo, h_odd, A.K, true);
    float* dst = yp + (long long)i * A.Wo + j;
    if (j + 1 < A.Wo) {
      const float t[5] = {v[0], v[1], v[2], v[3], r0[u + 1]};
      const float o1 = reduce_pass(t, j + 1, A.W, A.Wo, h_odd, A.K, true);
      if (A.vec_out) {
        *reinterpret_cast<float2*>(dst) = make_float2(o0, o1);
      } else {
        dst[0] = o0;
        dst[1] = o1;
      }
    } else {
      dst[0] = o0;
    }
  };

  for (int k = 0; k < n_rows; ++k) {
    cp_async_wait<AHEAD - 1>();
    __syncthreads();  // group k has landed; the previous row's readers are done
    float v[4];
    vertical(k, v);
    __syncthreads();  // the neighbours' sums are visible; ring rows 2k, 2k + 1 are free
    load_group(k + AHEAD);
    horizontal(i0 + k, v);
  }
  cp_async_wait<0>();
}

static int launch_reduce(const float* x, float* y, int P, int Hin, int Ho, int W,
                         int row_off, bool vfix, bool h_odd, const float* k5, void* stream) {
  if (P <= 0) return 0;
  ReduceArgs A;
  A.x = x;
  A.y = y;
  A.Hin = Hin;
  A.Ho = Ho;
  A.W = W;
  A.Wo = (W + 1) / 2;
  A.row_off = row_off;
  A.vfix = vfix;
  A.h_odd = h_odd;
  A.vec_in = (W % 4 == 0) && ((uintptr_t)x % 16 == 0);
  A.vec_out = (A.Wo % 2 == 0) && ((uintptr_t)y % 8 == 0);
  A.n_strips = (A.Wo + RS_OUT - 1) / RS_OUT;
  A.n_runs = (Ho + RUN_MAX - 1) / RUN_MAX;
  A.run_len = (Ho + A.n_runs - 1) / A.n_runs;  // runs of even length
  for (int t = 0; t < 5; ++t) A.K.k[t] = k5[t];
  const long long blocks = (long long)P * A.n_runs * A.n_strips;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  pyramid_reduce_kernel<<<(unsigned int)blocks, RT, 0, (cudaStream_t)stream>>>(A);
  return (int)cudaGetLastError();
}

// x: (P, H, W) float32, y: (P, ceil(H/2), ceil(W/2)); H, W >= 3.
CVVDP_API int cvvdp_pyramid_reduce(const float* x, float* y, int P, int H,
                                   int W, const float* k5, void* stream) {
  if (H < 3 || W < 3) return (int)cudaErrorInvalidValue;
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
