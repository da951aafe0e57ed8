// RG-LRU linear recurrence for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/pavlov_rglru/kernel.py
// (_rglru_kernel, launched by pavlov_rglru_raw).  Same function:
// h_t = a_t * h_{t-1} + b_t elementwise over (B, T, E), from h = 0 (the
// caller folds a carried state into b[:, 0]), the state in float32, the
// output in a's dtype.
//
// What bounds it.  Each element of a and b is read once and each of h
// written once, 3 * B * T * E * 4 bytes in float32 (31.5 MB at the serving
// prefill shape B=4, T=256, E=2560: 9.4 us at 3.35 TB/s), against two
// operations per element: it is bound by bytes.  The recurrence itself is
// cheap: 256 dependent multiply-adds are about a microsecond.  What a
// byte-bound kernel needs is enough bytes in flight: at ~0.8 us of DRAM
// latency, 3.35 TB/s takes ~2.7 MB in flight across the card, ~20 KB an SM.
// A thread a channel reading a few steps ahead into registers (the first
// version) kept about a quarter of that in flight, and ran at about a
// quarter of the rate.
//
// Design.  The TPU grid tiles E across cores and walks T sequentially with
// the state in VMEM scratch.  Here one lane still owns one (b, e) channel
// and keeps h in a float32 register while it walks t, so the recurrence is
// never reassociated; what changes is how a and b arrive.  A CTA is one
// warp that owns a strip of W = 32 channels (128 bytes in float32) of one
// batch row.  Lane 0 streams T-chunks of TC steps of a and b into a ring of
// ST stages in shared memory, each a 2-D TMA box of the (B * T, E) view
// whose completion an mbarrier counts; the warp copies a stage into
// registers, lane 0 refills the slot at once, and the lanes then run the
// stage's updates and store h coalesced.  A CTA keeps up to ST * TC * W * 8
// = 16 KB in flight (float32), and the card holds 2-3 such CTAs an SM at
// B=4: about 40 KB an SM, twice what the byte rate needs (8 stages were no
// faster on the card, 2 or 3 slower).  The layout depends on nothing but W:
// never on B or T.
//
// Two routes, one arithmetic.  The ring needs a 16-byte aligned a and b
// and rows of a multiple of 16 bytes (E % 4 == 0 in float32, % 8 in bf16);
// at T = 1 (a decode step, one load each) its set-up buys nothing.  Those
// calls take the element route: a thread a channel, loads UNROLL steps
// ahead of their updates.  Both routes run the same update, in t order.
//
// Rounding.  The update is written __fadd_rn(__fmul_rn(a, h), b): two
// roundings, never contracted into one FMA, which is how the plain PyTorch
// version (a multiply, then an add) rounds.  So in float32 the kernel and
// its plain version agree bit for bit, a row's bits do not depend on the
// batch, and a prompt scanned in one call equals the same prompt scanned in
// two calls whose caller folds the carried state into b[:, 0].

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int W = 32;               // channels a ring CTA (one warp)
constexpr int TC = 16;              // steps a stage
constexpr int ST = 4;               // stages in the ring
constexpr int NT = 64;              // element route: threads a block
constexpr int UNROLL = 8;           // element route: steps loaded ahead

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

// the one update both routes run
__device__ __forceinline__ float step(float a, float h, float b) {
  return __fadd_rn(__fmul_rn(a, h), b);
}

// ---- ring route: one warp, W channels of batch row blockIdx.y
template <typename T>
__global__ void __launch_bounds__(W)
rglru_ring_kernel(const __grid_constant__ CUtensorMap ta,
                  const __grid_constant__ CUtensorMap tb,
                  T* __restrict__ h_out, int T_len, int E) {
  __shared__ __align__(128) T sa[ST][TC][W];
  __shared__ __align__(128) T sb[ST][TC][W];
  __shared__ __align__(8) uint64_t full[ST];
  constexpr int STAGE_BYTES = 2 * TC * W * (int)sizeof(T);
  const int lane = threadIdx.x;
  const int e0 = blockIdx.x * W;
  const int row0 = blockIdx.y * T_len;       // row of (b, t = 0)
  const int chunks = (T_len + TC - 1) / TC;

  // lane 0: chunk k into slot k % ST (a box past B * T reads zeros; rows
  // of the next batch row past T are read and never used)
  auto issue = [&](int k) {
    const int st = k % ST;
    const uint32_t bar = smem_u32(&full[st]);
    mbar_expect_tx(bar, STAGE_BYTES);
    tma_load_2d(smem_u32(&sa[st][0][0]), &ta, e0, row0 + k * TC, bar);
    tma_load_2d(smem_u32(&sb[st][0][0]), &tb, e0, row0 + k * TC, bar);
  };
  if (lane == 0) {
    for (int i = 0; i < ST; ++i) mbar_init(smem_u32(&full[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int k = 0; k < min(ST, chunks); ++k) issue(k);
  }
  __syncwarp();

  const int e = e0 + lane;
  const bool live = e < E;
  T* hp = h_out + (int64_t)row0 * E + e;
  float h = 0.f;
  for (int k = 0; k < chunks; ++k) {
    const int st = k % ST, t0 = k * TC;
    const int tc = min(TC, T_len - t0);
    mbar_wait(smem_u32(&full[st]), (k / ST) & 1);
    float av[TC], bv[TC];
#pragma unroll
    for (int i = 0; i < TC; ++i) {
      av[i] = to_f(sa[st][i][lane]);
      bv[i] = to_f(sb[st][i][lane]);
    }
    __syncwarp();                   // every lane holds the stage: refill it
    if (lane == 0 && k + ST < chunks) issue(k + ST);
#pragma unroll
    for (int i = 0; i < TC; ++i) {
      if (i < tc) {
        h = step(av[i], h, bv[i]);
        if (live) hp[(int64_t)(t0 + i) * E] = from_f<T>(h);
      }
    }
  }
}

// ---- element route: a thread a channel, UNROLL steps loaded ahead
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
      h = step(av[i], h, bv[i]);
      hp[(int64_t)(t + i) * E] = from_f<T>(h);
    }
  }
  for (; t < T_len; ++t) {
    h = step(to_f(ap[(int64_t)t * E]), h, to_f(bp[(int64_t)t * E]));
    hp[(int64_t)t * E] = from_f<T>(h);
  }
}

template <typename T>
cudaError_t launch(const void* a, const void* b, void* h, int B, int T_len,
                   int E, cudaStream_t stream) {
  const int64_t row_bytes = (int64_t)E * sizeof(T);
  if (T_len > 1 && aligned_rows(a, row_bytes) && aligned_rows(b, row_bytes)) {
    const CUtensorMapDataType type = sizeof(T) == 4
                                         ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    CUtensorMap ta, tb;
    cudaError_t e = tensor_map_2d(&ta, a, type, sizeof(T), E,
                                  (int64_t)B * T_len, W, TC);
    if (e == cudaSuccess)
      e = tensor_map_2d(&tb, b, type, sizeof(T), E, (int64_t)B * T_len, W,
                        TC);
    if (e != cudaSuccess) return e;
    rglru_ring_kernel<T><<<dim3((E + W - 1) / W, B), W, 0, stream>>>(
        ta, tb, static_cast<T*>(h), T_len, E);
    return cudaGetLastError();
  }
  rglru_scan_kernel<T><<<dim3((E + NT - 1) / NT, B), NT, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(h),
      T_len, E);
  return cudaGetLastError();
}

}  // namespace

// a, b, h: contiguous (B, T, E) of one dtype (0 = float32, 1 = bfloat16).
// The route (ring or element) is chosen here, from T > 1 and the 16-byte
// alignment of a, b and their rows.  Returns cudaGetLastError() after the
// launch.
extern "C" int pavlov_rglru_fwd(const void* a, const void* b, void* h,
                                int dtype, int B, int T, int E,
                                void* stream) {
  if (B <= 0 || T <= 0 || E <= 0 || B > 65535 ||
      (int64_t)B * T > 0x7fffffff)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, b, h, B, T, E, st);
  if (dtype == 1) return launch<__nv_bfloat16>(a, b, h, B, T, E, st);
  return cudaErrorInvalidValue;
}
