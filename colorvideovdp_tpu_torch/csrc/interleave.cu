// Lane interleave, its inverse and the concat copy floor, float32.
//
// Replaces the three Pallas micro-kernels of tools/interleave_bench.py
// (`pallas_interleave` :50, `pallas_concat` :77, `pallas_deinterleave` :109),
// with which the JAX package measured what an in-kernel polyphase expand
// would pay for merging its two phases along W:
//   interleave:   ev, od (P, H, W/2) -> out (P, H, W), out[..., 2j] = ev[..., j],
//                 out[..., 2j + 1] = od[..., j];
//   concat:       ev, od (P, H, W/2) -> out (P, H, W) = [ev | od] along W, the
//                 same bytes with no shuffle (the copy floor);
//   deinterleave: the inverse of interleave.
// Interleave and deinterleave act on the flat arrays (out[2i] = ev[i],
// out[2i + 1] = od[i] over all P H W/2 elements), so their rows need no
// alignment; concat keeps the row structure.
//
// Bound on the H100: memory, 8 bytes read and 8 written per output pair; no
// arithmetic. Every access is a 16-byte float4 where the sizes allow (the
// flat length, or W/2 for concat, a multiple of 4; PyTorch allocations are
// 16-byte aligned): an interleave thread reads one float4 of each input and
// writes the two float4 they make, a deinterleave thread the reverse, and a
// concat thread copies one output float4. Otherwise one thread per element
// (pair).

#include "common.cuh"

#define IL_THREADS 256

__global__ void interleave_v4(const float4* __restrict__ ev, const float4* __restrict__ od,
                              float4* __restrict__ out, long long n4) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    const float4 a = ev[i], b = od[i];
    out[2 * i] = make_float4(a.x, b.x, a.y, b.y);
    out[2 * i + 1] = make_float4(a.z, b.z, a.w, b.w);
  }
}

__global__ void interleave_1(const float* __restrict__ ev, const float* __restrict__ od,
                             float* __restrict__ out, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    out[2 * i] = ev[i];
    out[2 * i + 1] = od[i];
  }
}

__global__ void deinterleave_v4(const float4* __restrict__ x, float4* __restrict__ ev,
                                float4* __restrict__ od, long long n4) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    const float4 a = x[2 * i], b = x[2 * i + 1];
    ev[i] = make_float4(a.x, a.z, b.x, b.z);
    od[i] = make_float4(a.y, a.w, b.y, b.w);
  }
}

__global__ void deinterleave_1(const float* __restrict__ x, float* __restrict__ ev,
                               float* __restrict__ od, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    ev[i] = x[2 * i];
    od[i] = x[2 * i + 1];
  }
}

// One thread per output element (vector when T = float4): rows of 2 wh.
template <typename T>
__global__ void concat_rows(const T* __restrict__ ev, const T* __restrict__ od,
                            T* __restrict__ out, long long rows, int wh) {
  const long long n = rows * 2 * wh;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / (2 * wh);
    const int c = (int)(i % (2 * wh));
    out[i] = c < wh ? ev[r * wh + c] : od[r * wh + c - wh];
  }
}

static unsigned int il_blocks(long long n) {
  const long long b = (n + IL_THREADS - 1) / IL_THREADS;
  return (unsigned int)(b < 1 ? 1 : (b > 0x7fffffffLL ? 0x7fffffffLL : b));
}

static bool aligned16(const void* a, const void* b, const void* c) {
  return ((uintptr_t)a | (uintptr_t)b | (uintptr_t)c) % 16 == 0;
}

// n: elements of each half (ev, od); out has 2 n.
CVVDP_API int cvvdp_interleave(const float* ev, const float* od, float* out, long long n,
                               void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (n % 4 == 0 && aligned16(ev, od, out))
    interleave_v4<<<il_blocks(n / 4), IL_THREADS, 0, st>>>(
        (const float4*)ev, (const float4*)od, (float4*)out, n / 4);
  else
    interleave_1<<<il_blocks(n), IL_THREADS, 0, st>>>(ev, od, out, n);
  return (int)cudaGetLastError();
}

CVVDP_API int cvvdp_deinterleave(const float* x, float* ev, float* od, long long n,
                                 void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (n % 4 == 0 && aligned16(x, ev, od))
    deinterleave_v4<<<il_blocks(n / 4), IL_THREADS, 0, st>>>(
        (const float4*)x, (float4*)ev, (float4*)od, n / 4);
  else
    deinterleave_1<<<il_blocks(n), IL_THREADS, 0, st>>>(x, ev, od, n);
  return (int)cudaGetLastError();
}

// rows: P H; wh: W/2 (elements per input row).
CVVDP_API int cvvdp_concat(const float* ev, const float* od, float* out, long long rows,
                           int wh, void* stream) {
  if (rows < 1 || wh < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (wh % 4 == 0 && aligned16(ev, od, out))
    concat_rows<float4><<<il_blocks(rows * wh / 2), IL_THREADS, 0, st>>>(
        (const float4*)ev, (const float4*)od, (float4*)out, rows, wh / 4);
  else
    concat_rows<float><<<il_blocks(rows * 2 * wh), IL_THREADS, 0, st>>>(ev, od, out, rows, wh);
  return (int)cudaGetLastError();
}
