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
// Design.  The TPU grid tiles D across cores and walks T sequentially with
// the (B, bd, N) state in VMEM scratch and A resident.  Blocks on the GPU run
// in no order, so here a group of G lanes owns one (b, d) channel for all of
// T and walks t itself: each lane holds S = 4 of its N states, h[n] and
// a[d, n], in registers (G = 4 lanes for N = 16), and y_t is each lane's sum
// over its 4 states, then a 2-step __shfl_xor_sync sum over the group.  The
// 4 states per lane are independent recurrences the lane interleaves; 4
// lanes per channel give the card 4x the threads of a thread per channel
// (131,072 at B=4, 32,768 at B=1), which is what hides each step's
// latency: a thread per channel left B=1 as slow as B=4.  B_t and C_t are
// the same for every channel of a batch row: a block (one b, NT / G
// channels) stages TC steps of them in shared memory with coalesced loads,
// and each lane reads its 4 values there as one 16-byte load.  delta and x
// (a group's lanes read the same value, neighbouring groups neighbouring
// values) do not depend on h, so each lane loads a group of UNROLL steps
// of them at once, and the group's steps run without a branch between them
// (a masked step is a select), so the compiler overlaps one step's expf
// with the last one's update.
//
// Rounding.  Each product and sum is __fmul_rn / __fadd_rn, never
// contracted into an FMA, and exp is the accurate expf (no fast math): the
// update rounds where the plain PyTorch loop rounds, and h_T agrees with
// it.  y's sum over n runs in another order than PyTorch's reduction, so y
// agrees to a few roundings, not to the bit.
//
// What bounds it.  It reads delta and x and writes y once (3 B T D values),
// reads B, C, a, d_skip and h0 and writes h_T: at B=4, T=256, D=8192, N=16
// in float32, about 105 MB, 31.5 us at 3.35 TB/s.  It does about 7 float32
// operations per (b, t, d, n), 0.94 GFLOP (14 us at 67 TFLOP/s), and one
// expf each, 134 M, which the SFU issues at 16 per SM per clock: about
// 32 us, a second limit as large as the bytes.  Issuing its ~18
// instructions per state element and step (8 of them the expf, counted
// from the code) takes longer than either.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;      // threads per block: NT / G channels
constexpr int S = 4;         // states per lane
constexpr int TC = 32;       // steps of B_t, C_t staged in shared memory
constexpr int UNROLL = 8;    // steps of delta, x loaded together

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

// One step of a lane's S states: h = exp(delta * a) * h + (delta * x) * B_t
// where ``on`` (a masked step keeps every bit of h, by a select and not a
// branch, so the steps of an unrolled group stay one block of code the
// compiler can interleave: a step's expf does not wait for the last step's
// h), then y_t summed over the lane's states and the G lanes of its group.
template <typename T, int G>
__device__ __forceinline__ void ssm_step(float (&h)[S], const float (&av)[S],
                                         float dv, float xv,
                                         const float* sb_row,
                                         const float* sc_row, bool on,
                                         float ds, T* yp, bool store) {
  const float4 bv = *reinterpret_cast<const float4*>(sb_row);
  const float4 cv = *reinterpret_cast<const float4*>(sc_row);
  const float bs[S] = {bv.x, bv.y, bv.z, bv.w};
  const float cs[S] = {cv.x, cv.y, cv.z, cv.w};
  const float dx = __fmul_rn(dv, xv);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const float alpha = expf(__fmul_rn(dv, av[s]));
    const float hn = __fadd_rn(__fmul_rn(alpha, h[s]), __fmul_rn(dx, bs[s]));
    h[s] = on ? hn : h[s];
  }
  float acc = __fmul_rn(h[0], cs[0]);
#pragma unroll
  for (int s = 1; s < S; ++s) acc = __fadd_rn(acc, __fmul_rn(h[s], cs[s]));
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  if (store) *yp = from_f<T>(__fadd_rn(acc, __fmul_rn(xv, ds)));
}

// NMAX: N rounded up to 4, 8, 16 or 32, held by G = NMAX / S lanes; the
// states past N hold 0 (a = 0, B = C = 0), so they stay 0 and add 0 to y.
// Every lane of a warp runs every step (a lane past D computes on zeros and
// stores nothing), so the shuffles always see the whole warp.
template <typename T, int NMAX>
__global__ void __launch_bounds__(NT)
ssm_scan_kernel(const T* __restrict__ delta, const T* __restrict__ x,
                const T* __restrict__ bc, const T* __restrict__ cc,
                const float* __restrict__ a, const float* __restrict__ d_skip,
                const float* __restrict__ h0, const int* __restrict__ length,
                T* __restrict__ y, float* __restrict__ h_out, int T_len,
                int D, int N) {
  constexpr int G = NMAX / S;
  __shared__ __align__(16) float sb[TC][NMAX];
  __shared__ __align__(16) float sc[TC][NMAX];
  const int b = blockIdx.y;
  const int lane = threadIdx.x % G;
  const int d = blockIdx.x * (NT / G) + threadIdx.x / G;
  const int n0 = lane * S;
  const bool live = d < D;
  const int len = length ? length[b] : T_len;
  const int64_t hbase = ((int64_t)b * D + d) * N + n0;
  float h[S], av[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const bool on = live && n0 + s < N;
    av[s] = on ? a[(int64_t)d * N + n0 + s] : 0.f;
    h[s] = (on && h0) ? h0[hbase + s] : 0.f;
  }
  const float ds = live ? d_skip[d] : 0.f;
  const bool store = live && lane == 0;
  const int64_t row = (int64_t)b * T_len;      // row of (b, t = 0)
  for (int t0 = 0; t0 < T_len; t0 += TC) {
    const int tc = min(TC, T_len - t0);
    __syncthreads();            // every thread is done with the last chunk
    for (int i = threadIdx.x; i < tc * NMAX; i += NT) {
      const int tt = i / NMAX, n = i % NMAX;
      const int64_t src = (row + t0 + tt) * N + n;
      sb[tt][n] = n < N ? to_f(bc[src]) : 0.f;
      sc[tt][n] = n < N ? to_f(cc[src]) : 0.f;
    }
    __syncthreads();
    for (int u0 = 0; u0 < tc; u0 += UNROLL) {
      float dv[UNROLL], xv[UNROLL];
#pragma unroll
      for (int i = 0; i < UNROLL; ++i) {
        const int64_t off = (row + t0 + u0 + i) * D + d;
        const bool in = live && u0 + i < tc;
        dv[i] = in ? to_f(delta[off]) : 0.f;
        xv[i] = in ? to_f(x[off]) : 0.f;
      }
      if (u0 + UNROLL <= tc) {  // a whole group: no branch between steps
#pragma unroll
        for (int i = 0; i < UNROLL; ++i) {
          const int t = t0 + u0 + i;
          ssm_step<T, G>(h, av, dv[i], xv[i], &sb[u0 + i][n0],
                         &sc[u0 + i][n0], t < len, ds,
                         y + (row + t) * D + d, store);
        }
      } else {                  // the chunk's ragged tail (and T = 1)
#pragma unroll
        for (int i = 0; i < UNROLL; ++i) {
          const int t = t0 + u0 + i;
          if (u0 + i < tc)
            ssm_step<T, G>(h, av, dv[i], xv[i], &sb[u0 + i][n0],
                           &sc[u0 + i][n0], t < len, ds,
                           y + (row + t) * D + d, store);
        }
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int s = 0; s < S; ++s)
    if (n0 + s < N) h_out[hbase + s] = h[s];
}

template <typename T, int NMAX>
cudaError_t launch(const void* delta, const void* x, const void* bc,
                   const void* cc, const void* a, const void* d_skip,
                   const void* h0, const void* length, void* y, void* h_out,
                   int B, int T_len, int D, int N, cudaStream_t stream) {
  constexpr int CH = NT / (NMAX / S);          // channels per block
  dim3 grid((D + CH - 1) / CH, B);
  ssm_scan_kernel<T, NMAX><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(delta), static_cast<const T*>(x),
      static_cast<const T*>(bc), static_cast<const T*>(cc),
      static_cast<const float*>(a), static_cast<const float*>(d_skip),
      static_cast<const float*>(h0), static_cast<const int*>(length),
      static_cast<T*>(y), static_cast<float*>(h_out), T_len, D, N);
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
// (zero state; every step valid).  Returns cudaGetLastError() after the
// launch.
extern "C" int pavlov_ssm_fwd(const void* delta, const void* x,
                              const void* bc, const void* cc, const void* a,
                              const void* d_skip, const void* h0,
                              const void* length, void* y, void* h_out,
                              int dtype, int B, int T_len, int D, int N,
                              void* stream) {
  if (B <= 0 || T_len <= 0 || D <= 0 || N <= 0 || N > 32 || B > 65535)
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
