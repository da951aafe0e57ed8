// RG-LRU linear recurrence for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/pavlov_rglru/kernel.py
// (_rglru_kernel, launched by pavlov_rglru_raw).  Same function:
// h_t = a_t * h_{t-1} + b_t elementwise over (B, T, E), from h = 0 (the
// caller folds a carried state into b[:, 0]), the state in float32, the
// output in a's dtype.
//
// Design.  The TPU grid tiles E across cores and walks T sequentially with
// the state in VMEM scratch.  Here each thread owns one (b, e) channel and
// keeps h in a float32 register while it walks t = 0..T-1; threads of a
// warp lie along E, so every load of a[b, t, :] / b[b, t, :] and every store
// of h[b, t, :] is coalesced.  The loads do not depend on h, so the loop
// reads UNROLL steps ahead into registers before it runs their updates:
// the recurrence waits on arithmetic, not on a load per step.
//
// Rounding.  The update is written __fadd_rn(__fmul_rn(a, h), b): two
// roundings, never contracted into one FMA, which is how the plain PyTorch
// version (a multiply, then an add) rounds.  So in float32 the kernel and
// its plain version agree bit for bit.
//
// What bounds it.  Each element of a and b is read once and each of h
// written once, 3 * B * T * E * 4 bytes in float32, against two operations
// per element: it is bound by bytes.  This kernel runs B * E threads, one
// sequential walk each; with B * E = 10,240 at the serving shape that is
// fewer threads in flight than the card can use to hide latency, so it
// stays above its bound (splitting T into chunks with a second pass for the
// carries is the next step).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 64;              // threads per block, along E
constexpr int UNROLL = 8;           // steps loaded ahead of their updates

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

template <typename T>
__global__ void __launch_bounds__(NT)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  T* __restrict__ h_out, int T_len, int E) {
  const int e = blockIdx.x * NT + threadIdx.x;
  if (e >= E) return;
  const int64_t base = (int64_t)blockIdx.y * T_len * E + e;
  const T* ap = a + base;
  const T* bp = b + base;
  T* hp = h_out + base;
  float h = 0.f;
  int t = 0;
  for (; t + UNROLL <= T_len; t += UNROLL) {
    float av[UNROLL], bv[UNROLL];
#pragma unroll
    for (int i = 0; i < UNROLL; ++i) {
      av[i] = to_f(ap[(int64_t)(t + i) * E]);
      bv[i] = to_f(bp[(int64_t)(t + i) * E]);
    }
#pragma unroll
    for (int i = 0; i < UNROLL; ++i) {
      h = __fadd_rn(__fmul_rn(av[i], h), bv[i]);
      hp[(int64_t)(t + i) * E] = from_f<T>(h);
    }
  }
  for (; t < T_len; ++t) {
    h = __fadd_rn(__fmul_rn(to_f(ap[(int64_t)t * E]), h),
                  to_f(bp[(int64_t)t * E]));
    hp[(int64_t)t * E] = from_f<T>(h);
  }
}

template <typename T>
cudaError_t launch(const void* a, const void* b, void* h, int B, int T_len,
                   int E, cudaStream_t stream) {
  dim3 grid((E + NT - 1) / NT, B);
  rglru_scan_kernel<T><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(h),
      T_len, E);
  return cudaGetLastError();
}

}  // namespace

// a, b, h: contiguous (B, T, E) of one dtype (0 = float32, 1 = bfloat16).
// Returns cudaGetLastError() after the launch.
extern "C" int pavlov_rglru_fwd(const void* a, const void* b, void* h,
                                int dtype, int B, int T, int E,
                                void* stream) {
  if (B <= 0 || T <= 0 || E <= 0 || B > 65535) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, b, h, B, T, E, st);
  if (dtype == 1) return launch<__nv_bfloat16>(a, b, h, B, T, E, st);
  return cudaErrorInvalidValue;
}
