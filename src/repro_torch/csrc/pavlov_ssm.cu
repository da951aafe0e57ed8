// Mamba-1 selective scan for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/pavlov_ssm/kernel.py
// (_ssm_kernel, launched by pavlov_ssm_raw).  Same function, per step t:
//   h   = exp(delta_t * a) * h + (delta_t * x_t) * B_t      (D, N) state
//   y_t = sum_n h * C_t + d_skip * x_t
// over delta, x (B, T, D), B_t = bc (B, T, N), C_t = cc (B, T, N), a (D, N),
// d_skip (D,), the state in float32.  Serving also needs what
// repro.models.recurrent.mamba_ssm's XLA route gives: a carried h0 in, a
// prefix mask (a step with t >= length[b] leaves h as it was, bit for bit,
// and its y is read from that h), and h_T out.  With h0 = 0 and no mask this
// is the TPU kernel's function.
//
// What bounds it.  It reads delta and x and writes y once (3 B T D values),
// reads B, C, a, d_skip and h0 and writes h_T: at B=4, T=256, D=8192, N=16
// in float32, about 105 MB, 31.5 us at 3.35 TB/s.  It does about 7 float32
// operations per (b, t, d, n) state-step, 0.94 GFLOP (14 us at 67 TFLOP/s),
// and one exponential each, 134 M, which the SFU issues at 16 an SM a clock:
// 32-36 us, the largest of the three limits.  What the first version ran
// into was instruction issue: ~18 instructions a state-step (8 of them the
// accurate expf), block barriers every 32 steps to stage B_t and C_t, four
// lanes loading the same delta and x, and a shuffle sum of y every step.
// This one issues about six: delta * a2, ex2, dx * B, the update's FMA,
// y's FMA, and a share of the step's reads, y sum and store.
//
// Design.  The TPU grid tiles D across cores and walks T sequentially with
// the (B, bd, N) state in VMEM scratch and A resident.  Here a group of G
// lanes owns one (b, d) channel for all of T and walks t itself, each lane
// holding S = min(N, 8) of its N states, h[n] and a[d, n], in registers
// (G = N / S: one lane a channel for N <= 8, two at N = 16); G comes from N
// only, so y's sum order, and its bits, never depend on B.  Per step a lane
// shares the delta and x reads, delta * x, the B_t / C_t reads and the y
// store among its S states, whose S independent chains are the ILP that
// hides the exponential's latency.  The exponential is 2^(delta * a2) on
// the SFU (ex2.approx), with a2 = a * log2(e) rounded once per lane at load:
// two instructions a state-step where the accurate expf took about eight
// (Mamba's own CUDA scan does the same).
//
// A CTA is CH = 32 channels of one batch row, with a producer warp.  Its
// lane 0 streams T-chunks of TC steps into a ring of ST stages in shared
// memory, each stage counted by an mbarrier: delta and x as 2-D TMA boxes of
// the (B * T, D) views, B_t and C_t (the same for every channel of the row)
// as bulk copies of TC contiguous rows.  Consumer warps wait on a stage's
// full barrier, read delta and x and broadcast 16-byte reads of B_t and C_t,
// and release the slot on its empty barrier: no block barrier in the loop.
// The mask is uniform over a CTA (one batch row), so the steps past
// length[b] run a loop of their own that leaves h alone.  The ring needs
// N in {4, 8, 16, 32} (8, 16, 32 in bf16), 16-byte aligned streams and
// rows of a multiple of 16 bytes; calls at T = 1 (a decode step) and any
// other shapes take the direct route: the same lanes and the same
// arithmetic, every load issued from global memory up front, no shared
// memory and no barrier.
//
// Rounding.  The plain PyTorch loop takes the accurate exp and rounds the
// decay, the product and the sum apart; here the exponential is ex2.approx
// (2 ulp) of the pre-scaled a, and the decay and the add are one FMA.  The
// recurrence contracts (|exp(delta * a)| < 1), so these differences do not
// grow along T: h_T agrees with the plain loop to a few float32 roundings,
// held to 1e-5 (it is ~1.5e-6 at phase 3's shapes).  y's sum over n is an
// FMA chain in n order and a butterfly over the G lanes, another order than
// PyTorch's reduction: it agrees to a few roundings of its scale.  Every
// state runs the same arithmetic at every step in t order on both routes,
// so a row's bits are the same alone and in a batch, a prompt scanned in
// one call equals it scanned in two calls that carry h, a T = 1 call
// equals the first step of a longer one, and two calls give the same bits.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int CH = 32;               // channels a ring CTA
constexpr int CHD = 64;              // channels a direct-route CTA
constexpr int TC = 16;               // steps a stage
constexpr int ST = 4;                // stages in the ring
constexpr int S_MAX = 8;             // states a lane holds, at most
constexpr float LOG2E = 1.4426950408889634f;

// a lane's share of the N <= NMAX states: S states, G lanes a channel
template <int NMAX>
struct Split {
  static constexpr int S = NMAX < S_MAX ? NMAX : S_MAX;
  static constexpr int G = NMAX / S;
};

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

// S values of B_t or C_t from shared memory, 16 bytes a load (the lanes of
// a warp read at most G distinct addresses: broadcasts)
template <int S>
__device__ __forceinline__ void lds_states(const float* p, float (&v)[S]) {
#pragma unroll
  for (int j = 0; j < S / 4; ++j) {
    const float4 q = reinterpret_cast<const float4*>(p)[j];
    v[4 * j] = q.x;
    v[4 * j + 1] = q.y;
    v[4 * j + 2] = q.z;
    v[4 * j + 3] = q.w;
  }
}
template <int S>
__device__ __forceinline__ void lds_states(const __nv_bfloat16* p,
                                           float (&v)[S]) {
  static_assert(S % 8 == 0, "bf16 states are read 8 at a time");
#pragma unroll
  for (int j = 0; j < S / 8; ++j) {
    const uint4 q = reinterpret_cast<const uint4*>(p)[j];
    const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(p2[k]);
      v[8 * j + 2 * k] = f.x;
      v[8 * j + 2 * k + 1] = f.y;
    }
  }
}

// S values of B_t or C_t from global memory, 0 past `valid`; 16-byte loads
// when whole (all S valid, p 16-byte aligned) and a load holds whole values
template <typename T, int S>
__device__ __forceinline__ void ld_bc(const T* p, int valid, bool whole,
                                      float (&v)[S]) {
  if constexpr (sizeof(T) == 4 || S % 8 == 0) {
    if (whole) {
      lds_states(p, v);
      return;
    }
  }
#pragma unroll
  for (int s = 0; s < S; ++s) v[s] = s < valid ? to_f(p[s]) : 0.f;
}

// S float32 values at p (a, h0), 0 past `valid`; 16-byte loads when whole
// (all S valid and p 16-byte aligned)
template <int S>
__device__ __forceinline__ void ld_states(const float* p, int valid,
                                          bool whole, float (&v)[S]) {
  if (whole) {
#pragma unroll
    for (int j = 0; j < S / 4; ++j) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p) + j);
      v[4 * j] = q.x;
      v[4 * j + 1] = q.y;
      v[4 * j + 2] = q.z;
      v[4 * j + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int s = 0; s < S; ++s) v[s] = s < valid ? p[s] : 0.f;
  }
}
template <int S>
__device__ __forceinline__ void st_states(float* p, int valid, bool whole,
                                          const float (&v)[S]) {
  if (whole) {
#pragma unroll
    for (int j = 0; j < S / 4; ++j)
      reinterpret_cast<float4*>(p)[j] =
          make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
  } else {
#pragma unroll
    for (int s = 0; s < S; ++s)
      if (s < valid) p[s] = v[s];
  }
}

// h = exp(delta * a) * h + (delta * x) * B_t for a lane's S states, with
// exp(delta * a) = 2^(delta * a2) and the decay and the add one FMA: the
// one update both routes run, four instructions a state
template <int S>
__device__ __forceinline__ void update(float (&h)[S], const float (&a2)[S],
                                       float dv, float xv,
                                       const float (&bs)[S]) {
  const float dx = __fmul_rn(dv, xv);
#pragma unroll
  for (int s = 0; s < S; ++s)
    h[s] = __fmaf_rn(exp2_approx(__fmul_rn(dv, a2[s])), h[s],
                     __fmul_rn(dx, bs[s]));
}

// y_t = sum_n h * C_t + d_skip * x_t: the lane's S states in n order as a
// chain of FMAs, then the G lanes of the channel by a butterfly (every lane
// of the group ends with the same bits)
template <int S, int G>
__device__ __forceinline__ float y_of(const float (&h)[S],
                                      const float (&cs)[S], float xv,
                                      float ds) {
  float acc = __fmul_rn(h[0], cs[0]);
#pragma unroll
  for (int s = 1; s < S; ++s) acc = __fmaf_rn(h[s], cs[s], acc);
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  return __fadd_rn(acc, __fmul_rn(xv, ds));
}

// What a consumer lane holds for the whole call: its channel, states and
// the row's mask
template <int NMAX, int CHANS>
struct Lane {
  static constexpr int S = Split<NMAX>::S, G = Split<NMAX>::G;
  int d, g, valid;
  bool live;
  float h[S], a2[S], ds;

  __device__ __forceinline__ Lane(int b, int D, int N, const float* a,
                                  const float* d_skip, const float* h0,
                                  bool vec) {
    const int c = threadIdx.x / G;
    g = threadIdx.x % G;
    d = blockIdx.x * CHANS + c;
    live = d < D;
    const int n0 = g * S;
    valid = live ? max(0, min(S, N - n0)) : 0;
    const bool whole = vec && live;
    float av[S];
    ld_states(a + (int64_t)d * N + n0, valid, whole, av);
#pragma unroll
    for (int s = 0; s < S; ++s) a2[s] = __fmul_rn(av[s], LOG2E);
    if (h0 != nullptr) {
      ld_states(h0 + ((int64_t)b * D + d) * N + n0, valid, whole, h);
    } else {
#pragma unroll
      for (int s = 0; s < S; ++s) h[s] = 0.f;
    }
    ds = live ? d_skip[d] : 0.f;
  }

  __device__ __forceinline__ void finish(int b, int D, int N, float* h_out,
                                         bool vec) const {
    if (live)
      st_states(h_out + ((int64_t)b * D + d) * N + g * S, valid, vec, h);
  }
};

// ---- ring route: CH channels of batch row blockIdx.y; CH * G consumer
// threads, then one producer warp
template <typename T, int NMAX>
__global__ void __launch_bounds__(CH * Split<NMAX>::G + 32)
ssm_ring_kernel(const __grid_constant__ CUtensorMap tdelta,
                const __grid_constant__ CUtensorMap tx,
                const T* __restrict__ bc, const T* __restrict__ cc,
                const float* __restrict__ a, const float* __restrict__ d_skip,
                const float* __restrict__ h0, const int* __restrict__ length,
                T* __restrict__ y, float* __restrict__ h_out, int T_len,
                int D, bool vec) {
  constexpr int S = Split<NMAX>::S, G = Split<NMAX>::G, N = NMAX;
  constexpr int NC = CH * G;        // consumer threads
  constexpr int DX = TC * CH;       // delta (or x) values a stage
  constexpr int BCN = TC * N;       // B (or C) values a stage
  __shared__ __align__(128) T s_d[ST][DX];
  __shared__ __align__(128) T s_x[ST][DX];
  __shared__ __align__(128) T s_b[ST][BCN];
  __shared__ __align__(128) T s_c[ST][BCN];
  __shared__ __align__(8) uint64_t full[ST], empty[ST];
  const int tid = threadIdx.x, b = blockIdx.y, d0 = blockIdx.x * CH;
  const int chunks = (T_len + TC - 1) / TC;
  const int64_t row0 = (int64_t)b * T_len;  // row of (b, t = 0)

  if (tid == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(smem_u32(&full[i]), 1);
      mbar_init(smem_u32(&empty[i]), NC / 32);   // lane 0 of each consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // ---- producer: chunk k into slot k % ST once its last reader is done (a
  // delta / x box past B * T reads zeros; rows past T of the last chunk are
  // the next batch row's, read and never used)
  if (tid >= NC) {
    if (tid == NC) {
      for (int k = 0; k < chunks; ++k) {
        const int st = k % ST, t0 = k * TC;
        const int rows = min(TC, T_len - t0);
        if (k >= ST) mbar_wait(smem_u32(&empty[st]), (k / ST - 1) & 1);
        const uint32_t bar = smem_u32(&full[st]);
        mbar_expect_tx(bar, (2 * DX + 2 * rows * N) * (int)sizeof(T));
        tma_load_2d(smem_u32(s_d[st]), &tdelta, d0, (int)(row0 + t0), bar);
        tma_load_2d(smem_u32(s_x[st]), &tx, d0, (int)(row0 + t0), bar);
        bulk_load(smem_u32(s_b[st]), bc + (row0 + t0) * N,
                  rows * N * (int)sizeof(T), bar);
        bulk_load(smem_u32(s_c[st]), cc + (row0 + t0) * N,
                  rows * N * (int)sizeof(T), bar);
      }
    }
    return;
  }

  // ---- consumers
  Lane<NMAX, CH> L(b, D, N, a, d_skip, h0, vec);
  const int c = tid / G, n0 = L.g * S;
  const int len = length != nullptr ? length[b] : T_len;
  const bool store = L.live && L.g == 0;
  T* yp = y + row0 * D + L.d;
  for (int k = 0; k < chunks; ++k) {
    const int st = k % ST, t0 = k * TC;
    const int tc = min(TC, T_len - t0);
    const int mid = max(0, min(tc, len - t0));   // steps that update h
    mbar_wait(smem_u32(&full[st]), (k / ST) & 1);
    const T* sd = s_d[st];
    const T* sx = s_x[st];
    const T* sb = s_b[st];
    const T* sc = s_c[st];
    auto run = [&](int i, bool upd) {
      const float dv = to_f(sd[i * CH + c]), xv = to_f(sx[i * CH + c]);
      float cs[S];
      if (upd) {
        float bs[S];
        lds_states(sb + i * N + n0, bs);
        update(L.h, L.a2, dv, xv, bs);
      }
      lds_states(sc + i * N + n0, cs);
      const float yv = y_of<S, G>(L.h, cs, xv, L.ds);
      if (store) yp[(t0 + i) * (int64_t)D] = from_f<T>(yv);
    };
    if (mid == TC) {                // a whole chunk, every step valid
#pragma unroll 4
      for (int i = 0; i < TC; ++i) run(i, true);
    } else {                        // the last chunk, or one past length[b]
      for (int i = 0; i < tc; ++i) run(i, i < mid);
    }
    __syncwarp();
    if ((tid & 31) == 0) mbar_arrive(smem_u32(&empty[st]));
  }
  L.finish(b, D, N, h_out, vec);
}

// ---- direct route: the same lanes and arithmetic, loads from global memory
template <typename T, int NMAX>
__global__ void __launch_bounds__(CHD * Split<NMAX>::G)
ssm_direct_kernel(const T* __restrict__ delta, const T* __restrict__ x,
                  const T* __restrict__ bc, const T* __restrict__ cc,
                  const float* __restrict__ a,
                  const float* __restrict__ d_skip,
                  const float* __restrict__ h0, const int* __restrict__ length,
                  T* __restrict__ y, float* __restrict__ h_out, int T_len,
                  int D, int N, bool vec, bool bc_vec) {
  constexpr int S = Split<NMAX>::S, G = Split<NMAX>::G;
  const int b = blockIdx.y;
  Lane<NMAX, CHD> L(b, D, N, a, d_skip, h0, vec);
  const int n0 = L.g * S;
  const int len = length != nullptr ? length[b] : T_len;
  for (int t = 0; t < T_len; ++t) {
    const int64_t row = (int64_t)b * T_len + t;
    const float dv = L.live ? to_f(delta[row * D + L.d]) : 0.f;
    const float xv = L.live ? to_f(x[row * D + L.d]) : 0.f;
    float bs[S], cs[S];
    ld_bc(bc + row * N + n0, L.valid, bc_vec, bs);
    ld_bc(cc + row * N + n0, L.valid, bc_vec, cs);
    if (t < len) update(L.h, L.a2, dv, xv, bs);
    const float yv = y_of<S, G>(L.h, cs, xv, L.ds);
    if (L.live && L.g == 0) y[row * D + L.d] = from_f<T>(yv);
  }
  L.finish(b, D, N, h_out, vec);
}

template <typename T, int NMAX>
cudaError_t launch(const void* delta, const void* x, const void* bc,
                   const void* cc, const void* a, const void* d_skip,
                   const void* h0, const void* length, void* y, void* h_out,
                   int B, int T_len, int D, int N, cudaStream_t stream) {
  constexpr int G = Split<NMAX>::G;
  // 16-byte loads of a, h0 and h_T where every lane's S states are whole,
  // and of B_t and C_t where their rows are 16-byte multiples too
  const bool vec = N == NMAX && aligned_rows(a, 0) &&
                   (h0 == nullptr || aligned_rows(h0, 0)) &&
                   aligned_rows(h_out, 0);
  const int64_t d_row = (int64_t)D * sizeof(T), n_row = N * sizeof(T);
  const bool bc_vec = N == NMAX && aligned_rows(bc, n_row) &&
                      aligned_rows(cc, n_row);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  if constexpr (NMAX * sizeof(T) % 16 == 0) {
    if (T_len > 1 && bc_vec && aligned_rows(delta, d_row) &&
        aligned_rows(x, d_row)) {
      const dim3 grid((D + CH - 1) / CH, B);
      const CUtensorMapDataType type = sizeof(T) == 4
                                           ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                           : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
      CUtensorMap td, tx;
      cudaError_t e = tensor_map_2d(&td, delta, type, sizeof(T), D,
                                    (int64_t)B * T_len, CH, TC);
      if (e == cudaSuccess)
        e = tensor_map_2d(&tx, x, type, sizeof(T), D, (int64_t)B * T_len, CH,
                          TC);
      if (e != cudaSuccess) return e;
      ssm_ring_kernel<T, NMAX><<<grid, CH * G + 32, 0, stream>>>(
          td, tx, static_cast<const T*>(bc), static_cast<const T*>(cc), f(a),
          f(d_skip), f(h0), static_cast<const int*>(length),
          static_cast<T*>(y), static_cast<float*>(h_out), T_len, D, vec);
      return cudaGetLastError();
    }
  }
  ssm_direct_kernel<T, NMAX><<<dim3((D + CHD - 1) / CHD, B), CHD * G, 0,
                               stream>>>(
      static_cast<const T*>(delta), static_cast<const T*>(x),
      static_cast<const T*>(bc), static_cast<const T*>(cc), f(a), f(d_skip),
      f(h0), static_cast<const int*>(length), static_cast<T*>(y),
      static_cast<float*>(h_out), T_len, D, N, vec, bc_vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_n(const void* delta, const void* x, const void* bc,
                     const void* cc, const void* a, const void* d_skip,
                     const void* h0, const void* length, void* y, void* h_out,
                     int B, int T_len, int D, int N, cudaStream_t st) {
  if (N <= 4)
    return launch<T, 4>(delta, x, bc, cc, a, d_skip, h0, length, y, h_out,
                        B, T_len, D, N, st);
  if (N <= 8)
    return launch<T, 8>(delta, x, bc, cc, a, d_skip, h0, length, y, h_out,
                        B, T_len, D, N, st);
  if (N <= 16)
    return launch<T, 16>(delta, x, bc, cc, a, d_skip, h0, length, y, h_out,
                         B, T_len, D, N, st);
  return launch<T, 32>(delta, x, bc, cc, a, d_skip, h0, length, y, h_out, B,
                       T_len, D, N, st);
}

}  // namespace

// delta, x, y: contiguous (B, T, D) and bc, cc: (B, T, N), all of one dtype
// (0 = float32, 1 = bfloat16); a: (D, N), d_skip: (D,), h0 and h_out:
// (B, D, N), all float32; length: (B,) int32.  h0 and length may be null
// (zero state; every step valid).  The route (ring or direct) is chosen
// here, from N, T > 1 and the 16-byte alignment of the streams and their
// rows.  Returns cudaGetLastError() after the launch.
extern "C" int pavlov_ssm_fwd(const void* delta, const void* x,
                              const void* bc, const void* cc, const void* a,
                              const void* d_skip, const void* h0,
                              const void* length, void* y, void* h_out,
                              int dtype, int B, int T_len, int D, int N,
                              void* stream) {
  if (B <= 0 || T_len <= 0 || D <= 0 || N <= 0 || N > 32 || B > 65535 ||
      (int64_t)B * T_len > 0x7fffffff)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_n<float>(delta, x, bc, cc, a, d_skip, h0, length, y, h_out,
                           B, T_len, D, N, st);
  if (dtype == 1)
    return launch_n<__nv_bfloat16>(delta, x, bc, cc, a, d_skip, h0, length,
                                   y, h_out, B, T_len, D, N, st);
  return cudaErrorInvalidValue;
}
