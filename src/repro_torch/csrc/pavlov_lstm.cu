// Pavlov LSTM recurrence for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/pavlov_lstm/kernel.py
// (_lstm_kernel, launched by pavlov_lstm_raw).  Same function, per step t,
// from precomputed input gates xg (B, T, 4H) (the hoisted x_t @ W_x + b):
//   gates = xg_t + h_{t-1} @ W_h            (B, 4H), float32
//   i = sigmoid(gates[:, 0:H])      f = sigmoid(gates[:, H:2H] + 1)
//   g = tanh(gates[:, 2H:3H])       o = sigmoid(gates[:, 3H:4H])
//   c_t = f * c_{t-1} + i * g       h_t = o * tanh(c_t)
// with W_h (H, 4H) of xg's dtype (float32 or bfloat16) widened to float32,
// h_t written in xg's dtype.  The TPU kernel starts from h = c = 0 and keeps
// them in VMEM scratch; this one also takes a carried (h0, c0) in float32
// and leaves (h_T, c_T) in float32 (the LSTM layer's function), which with
// zero state is the TPU kernel's.
//
// Design.  The TPU runs grid=(T,) in order on one core with W_h resident in
// VMEM.  On the card, step t needs all of h_{t-1}, which no block has until
// every block has finished step t-1: so the C entry enqueues one launch per
// step on the caller's stream (T launches per call, one ctypes call), and
// the kernel boundary is the grid-wide barrier.  A launch gives each block
// U = 16 hidden units and all four gate columns of those units (4 runs of
// 16 columns of W_h), so a unit's c and h are updated where its gates are
// summed: H / 16 blocks, 128 at H = 2048.  Within a block, lanes lie across
// the 64 columns, V adjacent columns each (one 16-byte load a row where H
// is a multiple of V and W_h is 16-byte aligned, else V scalar loads), and
// the other factor of the 256 threads splits K = H into KG groups (16 in
// float32, 32 in bf16), 4 rows of loads in flight before their FMAs.
// h_{t-1} comes from a float32 double buffer in global memory (step t reads
// buffer t % 2, writes t+1 % 2), staged in shared memory KC rows at a time
// for BB batch rows (1, 2 or 4; a larger batch runs in groups of 4, W_h read
// again per group); c lives in global memory between launches, each unit's
// c touched by the one block that owns it.  The KG partial sums are added
// in shared memory in group order.
//
// Rounding.  Every step runs the same code whatever T is, and a sum's order
// depends on H and the block's layout only: T single-step calls that carry
// (h, c) give the bits of one call over T.  The cell update rounds as the
// plain PyTorch loop does (each product and sum apart, no FMA contraction),
// with the accurate expf / tanhf (no fast math); the dot products are FMA
// chains in another order than the plain version's matmul.
//
// What bounds it.  Each step reads all of W_h: 67 MB in float32 at
// H = 2048, more than the 50 MB L2, so about 20 us a step from device
// memory (4.0 ms for T = 200); 33.5 MB in bf16, which fits in L2.  The
// least the function needs, W_h read once, is 0.02 ms (float32 bytes) or
// 0.1 ms (float32 operations, 6.7 GFLOP at B = 1, T = 200); keeping W_h in
// the SMs across steps (a persistent kernel with a grid barrier, W_h slices
// in shared memory and registers) is the redesign that approaches it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;      // threads per block
constexpr int U = 16;        // hidden units per block
constexpr int COLS = 4 * U;  // gate columns per block
constexpr int KC = 256;      // rows of h staged at once
constexpr int UNROLL = 4;    // rows of W_h loaded before their FMAs

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

__device__ __forceinline__ float sigmoid_rn(float x) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x)));
}

// V values of W_h's row k from column j, widened to float32; the first
// ``valid`` of them are in range (all or none on the vector path)
template <typename T, bool VEC>
__device__ __forceinline__ void load_row(const T* __restrict__ wh,
                                         int64_t k, int64_t ld, int j,
                                         int valid, float* out) {
  constexpr int V = Vec<T>::V;
  const T* p = wh + k * ld + j;
  if (VEC) {
    if (valid > 0) {
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
    for (int v = 0; v < V; ++v) out[v] = v < valid ? to_f(p[v]) : 0.f;
  }
}

// One step: xg_t = xg + t * 4H (row b at b * T * 4H), y_t likewise.
template <typename T, int BB, bool VEC>
__global__ void __launch_bounds__(NT)
lstm_step_kernel(const T* __restrict__ xg, const T* __restrict__ wh,
                 const float* __restrict__ h_prev, float* __restrict__ h_next,
                 float* __restrict__ c, T* __restrict__ y, int B, int T_len,
                 int t, int H) {
  constexpr int V = Vec<T>::V;
  constexpr int LANES = COLS / V;   // 16 (float32) or 8 (bf16)
  constexpr int KG = NT / LANES;    // 16 or 32
  __shared__ float hs[BB][KC];
  __shared__ float red[KG][BB][COLS];
  const int lane = threadIdx.x % LANES, g = threadIdx.x / LANES;
  const int u0 = blockIdx.x * U;
  // this lane's V columns: gate ``gate``, units u0 + cu .. u0 + cu + V - 1
  const int gate = lane * V / U, cu = lane * V % U;
  const int j = gate * H + u0 + cu;
  const int valid = min(V, H - (u0 + cu));
  const int64_t ld = 4 * (int64_t)H;

  for (int b0 = 0; b0 < B; b0 += BB) {
    float acc[BB][V];
#pragma unroll
    for (int bb = 0; bb < BB; ++bb)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[bb][v] = 0.f;
    for (int k0 = 0; k0 < H; k0 += KC) {
      const int kc = min(KC, H - k0);
      __syncthreads();            // every thread is done with hs and red
      for (int i = threadIdx.x; i < BB * KC; i += NT) {
        const int bb = i / KC, kk = i % KC;
        hs[bb][kk] = (b0 + bb < B && kk < kc)
                         ? h_prev[(int64_t)(b0 + bb) * H + k0 + kk] : 0.f;
      }
      __syncthreads();
      int kk = g;
      for (; kk + (UNROLL - 1) * KG < kc; kk += UNROLL * KG) {
        float wv[UNROLL][V];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
          load_row<T, VEC>(wh, k0 + kk + u * KG, ld, j, valid, wv[u]);
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
#pragma unroll
          for (int bb = 0; bb < BB; ++bb) {
            const float hv = hs[bb][kk + u * KG];
#pragma unroll
            for (int v = 0; v < V; ++v)
              acc[bb][v] = fmaf(hv, wv[u][v], acc[bb][v]);
          }
      }
      for (; kk < kc; kk += KG) {
        float wv[V];
        load_row<T, VEC>(wh, k0 + kk, ld, j, valid, wv);
#pragma unroll
        for (int bb = 0; bb < BB; ++bb) {
          const float hv = hs[bb][kk];
#pragma unroll
          for (int v = 0; v < V; ++v)
            acc[bb][v] = fmaf(hv, wv[v], acc[bb][v]);
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int bb = 0; bb < BB; ++bb)
#pragma unroll
      for (int v = 0; v < V; ++v) red[g][bb][lane * V + v] = acc[bb][v];
    __syncthreads();
    // the cell update: one thread per (batch row, unit)
    for (int i = threadIdx.x; i < BB * U; i += NT) {
      const int bb = i / U, uu = i % U;
      const int b = b0 + bb, u = u0 + uu;
      if (b >= B || u >= H) continue;
      float s[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float acc_q = 0.f;
        for (int gg = 0; gg < KG; ++gg)
          acc_q = __fadd_rn(acc_q, red[gg][bb][q * U + uu]);
        s[q] = __fadd_rn(
            to_f(xg[((int64_t)b * T_len + t) * ld + q * H + u]), acc_q);
      }
      const float ig = sigmoid_rn(s[0]);
      const float fg = sigmoid_rn(__fadd_rn(s[1], 1.f));
      const float cg = tanhf(s[2]);
      const float og = sigmoid_rn(s[3]);
      const int64_t su = (int64_t)b * H + u;
      const float cn = __fadd_rn(__fmul_rn(fg, c[su]), __fmul_rn(ig, cg));
      const float hn = __fmul_rn(og, tanhf(cn));
      c[su] = cn;
      h_next[su] = hn;
      y[((int64_t)b * T_len + t) * H + u] = from_f<T>(hn);
    }
  }
}

template <typename T, int BB, bool VEC>
cudaError_t run_steps(const void* xg, const void* wh, float* hbuf, float* c,
                      void* y, int B, int T_len, int H, cudaStream_t stream) {
  const dim3 grid((H + U - 1) / U);
  const int64_t plane = (int64_t)B * H;
  for (int t = 0; t < T_len; ++t) {
    lstm_step_kernel<T, BB, VEC><<<grid, NT, 0, stream>>>(
        static_cast<const T*>(xg), static_cast<const T*>(wh),
        hbuf + (t % 2) * plane, hbuf + ((t + 1) % 2) * plane, c,
        static_cast<T*>(y), B, T_len, t, H);
    if (t == 0) {                 // a refused launch is refused at once
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
  }
  return cudaGetLastError();
}

template <typename T, int BB>
cudaError_t launch_vec(const void* xg, const void* wh, float* hbuf, float* c,
                       void* y, int B, int T_len, int H, cudaStream_t st) {
  if (H % Vec<T>::V == 0 && reinterpret_cast<uintptr_t>(wh) % 16 == 0)
    return run_steps<T, BB, true>(xg, wh, hbuf, c, y, B, T_len, H, st);
  return run_steps<T, BB, false>(xg, wh, hbuf, c, y, B, T_len, H, st);
}

template <typename T>
cudaError_t launch_b(const void* xg, const void* wh, float* hbuf, float* c,
                     void* y, int B, int T_len, int H, cudaStream_t st) {
  if (B == 1) return launch_vec<T, 1>(xg, wh, hbuf, c, y, B, T_len, H, st);
  if (B == 2) return launch_vec<T, 2>(xg, wh, hbuf, c, y, B, T_len, H, st);
  return launch_vec<T, 4>(xg, wh, hbuf, c, y, B, T_len, H, st);
}

}  // namespace

// xg: contiguous (B, T, 4H), wh: contiguous (H, 4H), y: (B, T, H), all of
// one dtype (0 = float32, 1 = bfloat16); hbuf: (2, B, H) float32 with the
// initial h in hbuf[0]; c: (B, H) float32 holding the initial c.  Enqueues
// T launches; afterwards h_T is in hbuf[T % 2] and c_T in c.  Returns
// cudaGetLastError() after the first and after the last launch.
extern "C" int pavlov_lstm_fwd(const void* xg, const void* wh, void* hbuf,
                               void* c, void* y, int dtype, int B, int T_len,
                               int H, void* stream) {
  if (B <= 0 || T_len <= 0 || H <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* hb = static_cast<float*>(hbuf);
  float* cc = static_cast<float*>(c);
  if (dtype == 0) return launch_b<float>(xg, wh, hb, cc, y, B, T_len, H, st);
  if (dtype == 1)
    return launch_b<__nv_bfloat16>(xg, wh, hb, cc, y, B, T_len, H, st);
  return cudaErrorInvalidValue;
}
