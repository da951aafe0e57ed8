// Jacquard weight-streaming GEMV for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/jacquard_gemv/kernel.py
// (_gemv_kernel, launched by jacquard_gemv_raw).  Same function:
// out = x (M, K) @ w (K, N) for a skinny x (M <= 16 here), x and w of one
// dtype (float32 or bfloat16), the sum in float32, the output in x's dtype.
// The TPU grid walks w's (K, N) tiles once with x resident in VMEM and a
// float32 accumulator per N tile.
//
// What bounds it.  The bytes of w, each read once: at M = 1, K = 1280,
// N = 8192 in float32 (the LSTM1 model's output FC) 42 MB, 12.5 us at
// 3.35 TB/s, for 21 MFLOP.  Reaching that rate takes tens of KB of w in
// flight on every SM, all the time.
//
// Design.  A block of 256 threads owns a slab of N (grid: one block a slab)
// and streams all of K.  8 lanes run across the slab, each V adjacent
// columns (V = 16 bytes / element: 4 float32 or 8 bf16, one 16-byte load a
// row where N is a multiple of V and w is 16-byte aligned, else V scalar
// loads), so the 8 lanes read one 128-byte run of a w row; the other factor,
// KG = 32 groups of lanes, splits the rows.  x is staged in shared memory
// once, before the stream (all M rows, as float32, read as a broadcast; in
// chunks of 32 KB where M x K is larger); from then on there is no barrier
// until the stream ends.  A thread keeps two batches of U = 8 rows of w in
// registers: it issues the next batch's loads before the FMAs of the current
// one, so 16 loads (256 bytes) a thread, 64 KB a block, are in flight.  Each
// thread keeps M x V float32 partial sums; at the end the 32 groups' partials
// are summed in shared memory in group order and written: no atomics, the
// same bits from run to run.  K is not split across blocks: at the shapes
// where the slabs are fewer than the SMs (bf16 at N = 8192, 640 -> 4096),
// splitting it inside a thread-block cluster read the same time as one block
// a slab on the H100 (PERF.md).  Ragged N and K are masked, nothing is
// padded; M is a template bound (1, 2, 4, 8 or 16 rows of sums).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;          // threads per block
constexpr int LANES = 8;         // lanes across N
constexpr int KG = NT / LANES;   // groups along K
constexpr int U = 8;             // rows of w a batch, per thread
constexpr int XS_BYTES = 32768;  // the most shared memory x may take

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int V = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int V = 8; };

// 16 bytes of w, streamed past L1
__device__ __forceinline__ uint4 ld_stream(const void* p) {
  uint4 r;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "l"(p));
  return r;
}

// V values of w's row k from column n as raw bytes (0 past N or K)
template <typename T, bool VEC>
__device__ __forceinline__ uint4 load_row(const T* __restrict__ w, int64_t k,
                                          bool in, int n, int N) {
  constexpr int V = Vec<T>::V;
  const T* p = w + k * N + n;
  if (VEC) return in && n < N ? ld_stream(p) : make_uint4(0, 0, 0, 0);
  uint4 raw = make_uint4(0, 0, 0, 0);
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int v = 0; v < V; ++v)
    if (in && n + v < N) e[v] = p[v];
  return raw;
}

// grid: one block a slab of N
template <typename T, int MT, bool VEC>
__global__ void __launch_bounds__(NT)
jacquard_gemv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     T* __restrict__ out, int M, int N, int K) {
  constexpr int V = Vec<T>::V;
  constexpr int SLAB = LANES * V;
  constexpr int XR = XS_BYTES / (4 * MT);    // rows of x a chunk holds
  extern __shared__ float xs[];     // MT x min(K, XR)
  __shared__ float red[KG][SLAB];
  const int lane = threadIdx.x % LANES, g = threadIdx.x / LANES;
  const int n = blockIdx.x * SLAB + lane * V;
  const int xr = min(K, XR);

  float acc[MT][V];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[m][v] = 0.f;

  // K in chunks of x (one chunk unless M x K is large)
  for (int c0 = 0; c0 < K; c0 += xr) {
    const int cn = min(xr, K - c0);
    const T* wc = w + (int64_t)c0 * N;
    // rows g, g + KG, ... of the chunk, U a batch; batch b + 1 in flight
    // while batch b is summed.  The first batch is asked for before x is
    // staged, so its latency hides the staging's.
    uint4 cur[U], nxt[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      cur[u] = load_row<T, VEC>(wc, g + u * KG, g + u * KG < cn, n, N);
    if (c0 > 0) __syncthreads();    // the last chunk of x is consumed
    for (int i = threadIdx.x; i < MT * xr; i += NT) {
      const int m = i / xr, kk = i % xr;
      xs[i] = (m < M && kk < cn) ? to_f(x[(int64_t)m * K + c0 + kk]) : 0.f;
    }
    __syncthreads();
    for (int kb = g; kb < cn; kb += U * KG) {
      const int kn = kb + U * KG;
#pragma unroll
      for (int u = 0; u < U; ++u)
        nxt[u] = load_row<T, VEC>(wc, kn + u * KG, kn + u * KG < cn, n, N);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const T* e = reinterpret_cast<const T*>(&cur[u]);
        const int kk = min(kb + u * KG, xr - 1);   // x is 0 past cn
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float xv = xs[m * xr + kk];
#pragma unroll
          for (int v = 0; v < V; ++v)
            acc[m][v] = fmaf(xv, to_f(e[v]), acc[m][v]);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) cur[u] = nxt[u];
    }
  }

  // the KG groups' partial sums, one output row at a time, in group order
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m >= M) break;
    __syncthreads();
#pragma unroll
    for (int v = 0; v < V; ++v) red[g][lane * V + v] = acc[m][v];
    __syncthreads();
    for (int c = threadIdx.x; c < SLAB; c += NT) {
      const int col = blockIdx.x * SLAB + c;
      float s = 0.f;
      for (int gg = 0; gg < KG; ++gg) s += red[gg][c];
      if (col < N) out[(int64_t)m * N + col] = from_f<T>(s);
    }
  }
}

template <typename T, int MT>
cudaError_t launch(const void* x, const void* w, void* out, int M, int N,
                   int K, cudaStream_t stream) {
  constexpr int V = Vec<T>::V;
  const bool vec = N % V == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  auto kern = vec ? jacquard_gemv_kernel<T, MT, true>
                  : jacquard_gemv_kernel<T, MT, false>;
  const dim3 grid((N + LANES * V - 1) / (LANES * V));
  const size_t smem = sizeof(float) * MT * min(K, XS_BYTES / (4 * MT));
  kern<<<grid, NT, smem, stream>>>(static_cast<const T*>(x),
                                   static_cast<const T*>(w),
                                   static_cast<T*>(out), M, N, K);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_m(const void* x, const void* w, void* out, int M, int N,
                     int K, cudaStream_t st) {
  if (M <= 1) return launch<T, 1>(x, w, out, M, N, K, st);
  if (M <= 2) return launch<T, 2>(x, w, out, M, N, K, st);
  if (M <= 4) return launch<T, 4>(x, w, out, M, N, K, st);
  if (M <= 8) return launch<T, 8>(x, w, out, M, N, K, st);
  return launch<T, 16>(x, w, out, M, N, K, st);
}

}  // namespace

// x: contiguous (M, K) with M <= 16, w: contiguous (K, N), out: (M, N), all
// of one dtype (0 = float32, 1 = bfloat16).  Returns cudaGetLastError()
// after the launch.
extern "C" int jacquard_gemv_fwd(const void* x, const void* w, void* out,
                                 int dtype, int M, int N, int K,
                                 void* stream) {
  if (M <= 0 || M > 16 || N <= 0 || K <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_m<float>(x, w, out, M, N, K, st);
  if (dtype == 1) return launch_m<__nv_bfloat16>(x, w, out, M, N, K, st);
  return cudaErrorInvalidValue;
}
