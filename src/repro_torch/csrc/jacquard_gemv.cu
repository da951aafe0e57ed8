// Jacquard weight-streaming GEMV for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/jacquard_gemv/kernel.py
// (_gemv_kernel, launched by jacquard_gemv_raw).  Same function:
// out = x (M, K) @ w (K, N) for a skinny x (M <= 16 here), x and w of one
// dtype (float32 or bfloat16), the sum in float32, the output in x's dtype.
// The TPU grid walks w's (K, N) tiles once with x resident in VMEM and a
// float32 accumulator per N tile.
//
// Design.  A block of 256 threads owns a slab of N: 8 lanes across it, each
// lane V adjacent columns (V = 16 bytes / element: 4 float32 or 8 bf16, one
// 16-byte load a row where N is a multiple of V and w is 16-byte aligned,
// else V scalar loads), so the 8 lanes read one 128-byte run of a w row.
// The other factor of the block, KG = 32 groups of 8 lanes, splits K: group
// g reads rows g, g + 32, g + 64, ... of every KC-row chunk, 4 rows of loads
// in flight before their FMAs.  Every w byte is read once, by one thread.
// x is staged in shared memory KC = 128 rows at a time (all M rows of it,
// as float32), read there as a broadcast.  Each thread keeps M x V float32
// partial sums in registers; at the end the 32 groups' partials are summed
// in shared memory, in group order, one output row at a time.  Ragged N and
// K are masked; M is a template bound (1, 2, 4, 8 or 16 rows of sums).
//
// What bounds it.  The bytes of w: at M = 1, K = 1280, N = 8192 in float32
// (the LSTM1 model's output FC) 42 MB, 12.5 us at 3.35 TB/s, for 21 MFLOP.
// The grid has one block per slab, N / 32 (float32) or N / 64 (bf16) of
// them: 256 or 128 at N = 8192, on 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;          // threads per block
constexpr int LANES = 8;         // lanes across N
constexpr int KG = NT / LANES;   // groups along K
constexpr int KC = 128;          // rows of x staged at once
constexpr int UNROLL = 4;        // rows of w loaded before their FMAs

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

// V values of w's row k from column n, widened to float32 (0 past N)
template <typename T, bool VEC>
__device__ __forceinline__ void load_row(const T* __restrict__ w, int64_t k,
                                         int n, int N, float* out) {
  constexpr int V = Vec<T>::V;
  const T* p = w + k * N + n;
  if (VEC) {
    if (n < N) {
      const uint4 raw = *reinterpret_cast<const uint4*>(p);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int v = 0; v < V; ++v) out[v] = to_f(e[v]);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) out[v] = 0.f;
    }
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) out[v] = n + v < N ? to_f(p[v]) : 0.f;
  }
}

template <typename T, int MT, bool VEC>
__global__ void __launch_bounds__(NT)
jacquard_gemv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     T* __restrict__ out, int M, int N, int K) {
  constexpr int V = Vec<T>::V;
  constexpr int SLAB = LANES * V;
  __shared__ float xs[MT][KC];
  __shared__ float red[KG][SLAB];
  const int lane = threadIdx.x % LANES, g = threadIdx.x / LANES;
  const int n = blockIdx.x * SLAB + lane * V;
  float acc[MT][V];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[m][v] = 0.f;

  for (int k0 = 0; k0 < K; k0 += KC) {
    const int kc = min(KC, K - k0);
    __syncthreads();              // every thread is done with the last chunk
    for (int i = threadIdx.x; i < MT * KC; i += NT) {
      const int m = i / KC, kk = i % KC;
      xs[m][kk] = (m < M && kk < kc) ? to_f(x[(int64_t)m * K + k0 + kk])
                                     : 0.f;
    }
    __syncthreads();
    int kk = g;
    for (; kk + (UNROLL - 1) * KG < kc; kk += UNROLL * KG) {
      float wv[UNROLL][V];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        load_row<T, VEC>(w, k0 + kk + u * KG, n, N, wv[u]);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float xv = xs[m][kk + u * KG];
#pragma unroll
          for (int v = 0; v < V; ++v)
            acc[m][v] = fmaf(xv, wv[u][v], acc[m][v]);
        }
    }
    for (; kk < kc; kk += KG) {
      float wv[V];
      load_row<T, VEC>(w, k0 + kk, n, N, wv);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float xv = xs[m][kk];
#pragma unroll
        for (int v = 0; v < V; ++v) acc[m][v] = fmaf(xv, wv[v], acc[m][v]);
      }
    }
  }

  // the KG groups' partial sums, one output row at a time
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
  constexpr int SLAB = LANES * Vec<T>::V;
  const dim3 grid((N + SLAB - 1) / SLAB);
  const bool vec = N % Vec<T>::V == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (vec)
    jacquard_gemv_kernel<T, MT, true><<<grid, NT, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<T*>(out), M, N, K);
  else
    jacquard_gemv_kernel<T, MT, false><<<grid, NT, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
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
