// Pascal output-stationary matmul for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/pascal_matmul/kernel.py
// (_matmul_kernel, launched by pascal_matmul_raw).  Same function:
// out = x (M, K) @ w (K, N), x and w of one dtype (float32 or bfloat16),
// the sum in float32, the output in x's dtype.  The TPU grid walks K
// innermost over one float32 VMEM accumulator per output tile; ops.py pads
// every dim to a block multiple.  Here the kernel masks the ragged M, N and
// K edges itself, so nothing is padded.
//
// Design.  A block of 256 threads owns one BM x BN = 64 x 128 output tile;
// each thread owns a 4 x 8 register micro-tile of float32 sums (rows
// 4 ty .. 4 ty + 3; columns 4 tx .. 4 tx + 3 and 64 + 4 tx .. 64 + 4 tx + 3,
// two float4 reads of shared memory a step).  K streams through shared
// memory BK = 16 at a time: the x tile is stored transposed (k-major, so a
// thread's 4 rows are one float4), the w tile as it lies; global loads run
// along K for x and along N for w, neighbouring threads on neighbouring
// addresses, and anything past an edge loads as 0.  Both tiles are held in
// float32 in shared memory (a bf16 input is widened on the way in).
//
// Rounding.  Each output is one thread's FMA chain over k = 0 .. K-1 in
// order: a row's result depends on that row of x and on w only, never on M
// or on the other rows, so a product of one row equals that row of a
// product of many, bit for bit (the LSTM layer's carried single steps rely
// on it).  The plain version sums in the same order with a separate
// multiply and add, so float32 outputs agree to a few roundings.
//
// What bounds it.  At the LSTM stack's hoisted input GEMM (M = B T = 200,
// K = 2048, N = 8192) in float32: 6.7 GFLOP on the float32 units (100 us
// at 67 TFLOP/s) against 75 MB (22 us at 3.35 TB/s): operations.  In bf16
// the bound is the bytes (37.6 MB, 11 us) since tensor cores would do the
// operations in 6.8 us; this kernel uses no tensor cores (mma/wgmma is the
// next step), so it is held to the float32 rate in either dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;       // output rows per block
constexpr int BN = 128;      // output columns per block
constexpr int BK = 16;       // K per shared-memory stage
constexpr int NT = 256;      // threads: 16 (rows of 4) x 16 (columns of 8)
constexpr int PAD = 4;       // keeps xs rows 16-byte aligned, spreads banks

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
pascal_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     T* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) float xs[BK][BM + PAD];
  __shared__ __align__(16) float ws[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x tile: 64 rows x 16 k, 4 per thread, k fastest across threads
#pragma unroll
    for (int r = 0; r < BM * BK / NT; ++r) {
      const int idx = tid + r * NT;
      const int mm = idx / BK, kk = idx % BK;
      const int m = m0 + mm, k = k0 + kk;
      xs[kk][mm] = (m < M && k < K) ? to_f(x[(int64_t)m * K + k]) : 0.f;
    }
    // w tile: 16 k x 128 columns, 8 per thread, n fastest across threads
#pragma unroll
    for (int r = 0; r < BK * BN / NT; ++r) {
      const int idx = tid + r * NT;
      const int kk = idx / BN, nn = idx % BN;
      const int k = k0 + kk, n = n0 + nn;
      ws[kk][nn] = (k < K && n < N) ? to_f(w[(int64_t)k * N + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&ws[kk][4 * tx]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&ws[kk][64 + 4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + 4 * ty + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4);
      if (n < N) out[(int64_t)m * N + n] = from_f<T>(acc[i][j]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* out, int M, int N,
                   int K, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  pascal_matmul_kernel<T><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(out), M, N, K);
  return cudaGetLastError();
}

}  // namespace

// x: contiguous (M, K), w: contiguous (K, N), out: (M, N), all of one dtype
// (0 = float32, 1 = bfloat16).  Returns cudaGetLastError() after the launch.
extern "C" int pascal_matmul_fwd(const void* x, const void* w, void* out,
                                 int dtype, int M, int N, int K,
                                 void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || (M + BM - 1) / BM > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, out, M, N, K, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, out, M, N, K, st);
  return cudaErrorInvalidValue;
}
