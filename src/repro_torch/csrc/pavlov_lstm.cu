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
// Design: one persistent cooperative launch per call.  The TPU runs
// grid=(T,) in order on one core with W_h resident in VMEM.  Here at most
// one CTA an SM (cudaLaunchCooperativeKernel: all co-resident, or the
// launch is refused) owns U hidden units (U the power of two >= H / SMs:
// 16 at H = 2048, so 128 CTAs) and their four gate columns, so a unit's c
// and h are updated where its gates are summed; c stays in shared memory
// for the whole call.
//   W_h stays on the SMs across T.  At the start each CTA packs its slice
// (H rows x 4U columns) once into 16-byte chunks: thread (g, lane) owns V
// adjacent columns (V = 4 float32, 8 bf16) of rows g R .. g R + R - 1 (KG
// = 256 / (4U / V) row groups of R rows).  A thread's first RR rows live in
// registers (a register array indexed only by unrolled constants; RR = 32
// in float32, 20 / 16 / 8 in bf16 by batch group, the most that compile
// without a spill), the next SR in shared memory (as many as fit beside h
// and the partial sums; a warp reads 512 contiguous bytes), the rest in a
// global scratch in the same order, re-read each step from L2 (coalesced,
// 8 rows of loads in flight).  At H = 2048 a bf16 slice (256 KB) fits on
// chip at B <= 2; a float32 slice (512 KB) keeps ~336 KB on chip and the
// CTAs re-read ~22 MB a step from L2.
//   Between steps: h_t goes to a float32 double buffer in global memory
// (step t reads buffer t % 2, writes (t + 1) % 2), then the grid-wide
// barrier of cooperative_groups, then each row group's lanes stage its R
// values of h_{t-1} from L2 (ld.global.cg, 16 bytes a load, up to 4 in
// flight) into shared memory, BB batch rows at a time (1, 2 or 4; a larger
// batch runs in groups of 4, the slice reused).  Each thread's FMA chains
// run over its rows in order; the KG partial sums are added in shared
// memory in group order by one thread per (row, unit), which holds that
// step's xg, loaded before h arrives.
//
// Rounding.  Every step runs the same code whatever T is, and a sum's order
// depends on H and the layout (the SM count) only, not on T, B or where a
// row of the slice lives: T single-step calls that carry (h, c) give the
// bits of one call over T.  The cell update rounds as the plain PyTorch
// loop does (each product and sum apart, no FMA contraction), with the
// accurate expf / tanhf (no fast math); the dot products are FMA chains in
// another order than the plain version's matmul.
//
// What bounds it.  The function needs W_h once: 0.1 ms of float32
// operations at B = 1, T = 200, H = 2048 (6.7 GFLOP), or 67 MB read once
// (0.02 ms).  This kernel reads W_h from device memory once a call; then
// each step is bound by latency, the grid barrier and h's round trip
// through L2, and by the on-chip FMAs (in bf16 one widening a weight), and
// in float32 by the L2 rate for the ~22 MB of slices that stay off chip.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;             // threads a CTA
constexpr int CHUNK = 16;           // bytes of a packed chunk (uint4)
constexpr int SMEM_MAX = 232448;    // a Hopper block's 227 KB

template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int code = 0;
  static constexpr int V = 4;       // values a chunk
  static constexpr int SU = 8;      // scratch rows of loads in flight
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int code = 1;
  static constexpr int V = 8;
  static constexpr int SU = 4;
};

// rows of a thread's slice held in registers, by dtype (0 float32, 1 bf16)
// and batch group: as many as fit in 255 registers without a spill beside
// the sums (BB x V) and, in bf16, the widened weights
__host__ __device__ constexpr int reg_rows(int dtype, int BB) {
  return dtype == 0 ? 32 : BB == 1 ? 20 : BB == 2 ? 16 : 8;
}

// How a call is laid out; made by the host (plan()), identical in every CTA
struct Plan {
  int U;             // hidden units a CTA (a power of two)
  int lanes;         // 4U / V: column chunks of the slice
  int kg;            // NT / lanes: row groups
  int R;             // rows a thread (a multiple of 4); kg * R >= H
  int SR;            // of them in shared memory after the RR in registers
  int hs_ld;         // R + 4: a row group's stride in the staged h
  int grid;          // CTAs: ceil(H / U), at most the SM count
  int sms;           // the card's SMs
  int scratch_rows;  // R - RR - SR, or 0: rows re-read from the scratch
  int smem;          // dynamic shared memory bytes
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

__device__ __forceinline__ uint32_t bits(float x) {
  return __float_as_uint(x);
}
__device__ __forceinline__ uint32_t bits(__nv_bfloat16 x) {
  return __bfloat16_as_ushort(x);
}

// a chunk's V values, widened to float32 (a bf16 is the high half of its
// float32)
__device__ __forceinline__ void widen(const uint4& c, float (&w)[4]) {
  w[0] = __uint_as_float(c.x);
  w[1] = __uint_as_float(c.y);
  w[2] = __uint_as_float(c.z);
  w[3] = __uint_as_float(c.w);
}
__device__ __forceinline__ void widen(const uint4& c, float (&w)[8]) {
  const uint32_t u[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[2 * i] = __uint_as_float(u[i] << 16);
    w[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float sigmoid_rn(float x) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x)));
}

// The chunk of W_h at row k for this thread's V columns: column c = lane V
// + v of the CTA's 4U is gate c / U, unit u0 + c % U; zeros past H.  VEC
// (U % V == 0, H % V == 0, W_h 16-byte aligned): one 16-byte load
template <typename T, bool VEC>
__device__ __forceinline__ uint4 load_chunk(const T* __restrict__ wh, int k,
                                            int H, int u0, int U, int lane) {
  constexpr int V = Vec<T>::V;
  uint4 out = make_uint4(0u, 0u, 0u, 0u);
  if (k >= H) return out;
  const T* row = wh + (int64_t)k * 4 * H;
  const int c0 = lane * V;
  if (VEC) {
    const int uu = c0 % U;
    if (u0 + uu < H)
      out = __ldg(reinterpret_cast<const uint4*>(row + (c0 / U) * H + u0 +
                                                 uu));
    return out;
  }
  uint32_t word[4] = {0u, 0u, 0u, 0u};   // V / 4 values a word, low first
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int c = c0 + v, u = u0 + c % U;
    if (u < H)
      word[v * 4 / V] |= bits(row[(c / U) * H + u])
                         << (V == 8 ? 16 * (v & 1) : 0);
  }
  return make_uint4(word[0], word[1], word[2], word[3]);
}

// 4 consecutive floats of h row b from k (k % 4 == 0), zeros past B and H
__device__ __forceinline__ float4 load_h4(const float* __restrict__ h, int b,
                                          int k, int B, int H) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (b >= B || k >= H) return v;
  const float* p = h + (int64_t)b * H + k;
  if (H % 4 == 0) return __ldcg(reinterpret_cast<const float4*>(p));
  v.x = __ldcg(p);
  if (k + 1 < H) v.y = __ldcg(p + 1);
  if (k + 2 < H) v.z = __ldcg(p + 2);
  if (k + 3 < H) v.w = __ldcg(p + 3);
  return v;
}

// acc[b][v] += h[b][r + j] * w_j[v] for the 4 rows j of a block, in order
template <typename T, int BB>
__device__ __forceinline__ void fma_rows(float (&acc)[BB][Vec<T>::V],
                                         const float* hg, int hb, int r,
                                         const uint4 (&w4)[4]) {
  constexpr int V = Vec<T>::V;
  float4 hv[BB];
#pragma unroll
  for (int bb = 0; bb < BB; ++bb)
    hv[bb] = *reinterpret_cast<const float4*>(hg + bb * hb + r);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float w[V];
    widen(w4[j], w);
#pragma unroll
    for (int bb = 0; bb < BB; ++bb) {
      const float h = j == 0 ? hv[bb].x : j == 1 ? hv[bb].y
                    : j == 2 ? hv[bb].z : hv[bb].w;
#pragma unroll
      for (int v = 0; v < V; ++v) acc[bb][v] = fmaf(h, w[v], acc[bb][v]);
    }
  }
}

template <typename T, int BB, bool VEC>
__global__ void __launch_bounds__(NT, 1)
lstm_kernel(const T* __restrict__ xg, const T* __restrict__ wh,
            float* __restrict__ hbuf, float* __restrict__ c_io,
            T* __restrict__ y, uint4* __restrict__ scratch, int B, int T_len,
            int H, Plan p) {
  constexpr int V = Vec<T>::V;
  constexpr int RR = reg_rows(Vec<T>::code, BB);
  constexpr int SU = Vec<T>::SU;
  constexpr int HB = BB == 1 ? 4 : BB == 2 ? 2 : 1;   // h loads in flight
  extern __shared__ __align__(16) uint8_t smem[];
  uint4* ws = reinterpret_cast<uint4*>(smem);             // SR x NT chunks
  float* hs = reinterpret_cast<float*>(ws + (size_t)p.SR * NT);
  const int hb = p.kg * p.hs_ld;                          // hs per batch row
  float* red = hs + BB * hb;                              // kg x BB x 4U
  float* cs = red + p.kg * BB * 4 * p.U;                  // B x U
  const int tid = threadIdx.x;
  const int lane = tid % p.lanes, g = tid / p.lanes;
  const int u0 = blockIdx.x * p.U;
  const int64_t ld = 4 * (int64_t)H;
  const int k0 = g * p.R;                                 // this thread's rows
  const int s_end = RR + p.SR;                            // smem rows end
  uint4* mine = scratch + (int64_t)blockIdx.x * p.scratch_rows * NT + tid;

  // ---- the slice, once: registers, shared memory, scratch
  uint4 wr[RR];
#pragma unroll
  for (int r = 0; r < RR; ++r)
    wr[r] = r < p.R ? load_chunk<T, VEC>(wh, k0 + r, H, u0, p.U, lane)
                    : make_uint4(0u, 0u, 0u, 0u);
  for (int r0 = RR; r0 < p.R; r0 += 8) {
    uint4 w[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      w[j] = r0 + j < p.R ? load_chunk<T, VEC>(wh, k0 + r0 + j, H, u0, p.U,
                                               lane)
                          : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = r0 + j;
      if (r < s_end)
        ws[(r - RR) * NT + tid] = w[j];
      else if (r < p.R)
        mine[(int64_t)(r - s_end) * NT] = w[j];
    }
  }
  for (int i = tid; i < B * p.U; i += NT) {
    const int u = u0 + i % p.U;
    cs[i] = u < H ? c_io[(int64_t)(i / p.U) * H + u] : 0.f;
  }

  // the cell update's thread: (batch row b0 + cb, unit u0 + cu)
  const int cb = tid / p.U, cu = tid % p.U;
  float* hg = hs + g * p.hs_ld;
  cg::grid_group grid = cg::this_grid();
  for (int t = 0; t < T_len; ++t) {
    const float* h_prev = hbuf + (int64_t)(t & 1) * B * H;
    float* h_next = hbuf + (int64_t)((t + 1) & 1) * B * H;
    for (int b0 = 0; b0 < B; b0 += BB) {
      const int b = b0 + cb, u = u0 + cu;
      const bool cell = cb < BB && b < B && u < H;
      float xq[4] = {0.f, 0.f, 0.f, 0.f};
      if (cell) {
        const T* xr = xg + ((int64_t)b * T_len + t) * ld + u;
#pragma unroll
        for (int q = 0; q < 4; ++q) xq[q] = to_f(xr[q * H]);
      }
      __syncthreads();            // hs and red are free
      // h_{t-1}, rows b0 .. b0 + BB - 1: each row group's R values (k0 ..
      // k0 + R - 1), 4 at a time by the group's lanes, HB loads in flight
      for (int c0 = lane; 4 * c0 < p.R; c0 += HB * p.lanes) {
        float4 v[HB][BB];
#pragma unroll
        for (int j = 0; j < HB; ++j)
#pragma unroll
          for (int bb = 0; bb < BB; ++bb)
            v[j][bb] = 4 * (c0 + j * p.lanes) < p.R
                           ? load_h4(h_prev, b0 + bb,
                                     k0 + 4 * (c0 + j * p.lanes), B, H)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int j = 0; j < HB; ++j)
          if (4 * (c0 + j * p.lanes) < p.R)
#pragma unroll
            for (int bb = 0; bb < BB; ++bb)
              *reinterpret_cast<float4*>(hg + bb * hb +
                                         4 * (c0 + j * p.lanes)) = v[j][bb];
      }
      __syncthreads();

      float acc[BB][V];
#pragma unroll
      for (int bb = 0; bb < BB; ++bb)
#pragma unroll
        for (int v = 0; v < V; ++v) acc[bb][v] = 0.f;
#pragma unroll
      for (int r = 0; r < RR; r += 4) {
        if (r < p.R) {
          const uint4 w4[4] = {wr[r], wr[r + 1], wr[r + 2], wr[r + 3]};
          fma_rows<T, BB>(acc, hg, hb, r, w4);
        }
      }
      for (int r = RR; r < s_end; r += 4) {
        const uint4 w4[4] = {ws[(r - RR) * NT + tid],
                             ws[(r - RR + 1) * NT + tid],
                             ws[(r - RR + 2) * NT + tid],
                             ws[(r - RR + 3) * NT + tid]};
        fma_rows<T, BB>(acc, hg, hb, r, w4);
      }
      int r = s_end;
      for (; r + SU <= p.R; r += SU) {
        uint4 w[SU];
#pragma unroll
        for (int j = 0; j < SU; ++j)
          w[j] = __ldcg(mine + (int64_t)(r - s_end + j) * NT);
#pragma unroll
        for (int j = 0; j < SU; j += 4) {
          const uint4 w4[4] = {w[j], w[j + 1], w[j + 2], w[j + 3]};
          fma_rows<T, BB>(acc, hg, hb, r + j, w4);
        }
      }
      for (; r < p.R; r += 4) {
        uint4 w4[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          w4[j] = __ldcg(mine + (int64_t)(r - s_end + j) * NT);
        fma_rows<T, BB>(acc, hg, hb, r, w4);
      }

      // partial sums by row group, then the cell update where the four
      // gates of (row, unit) meet
#pragma unroll
      for (int bb = 0; bb < BB; ++bb)
#pragma unroll
        for (int v = 0; v < V; v += 4)
          *reinterpret_cast<float4*>(red + (g * BB + bb) * 4 * p.U +
                                     lane * V + v) =
              make_float4(acc[bb][v], acc[bb][v + 1], acc[bb][v + 2],
                          acc[bb][v + 3]);
      __syncthreads();
      if (cell) {
        float s[4] = {0.f, 0.f, 0.f, 0.f};
        const float* rc = red + cb * 4 * p.U + cu;
#pragma unroll 4
        for (int gg = 0; gg < p.kg; ++gg)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            s[q] = __fadd_rn(s[q], rc[gg * BB * 4 * p.U + q * p.U]);
#pragma unroll
        for (int q = 0; q < 4; ++q) s[q] = __fadd_rn(xq[q], s[q]);
        const float ig = sigmoid_rn(s[0]);
        const float fg = sigmoid_rn(__fadd_rn(s[1], 1.f));
        const float cgt = tanhf(s[2]);
        const float og = sigmoid_rn(s[3]);
        float* cp = cs + b * p.U + cu;
        const float cn = __fadd_rn(__fmul_rn(fg, *cp), __fmul_rn(ig, cgt));
        const float hn = __fmul_rn(og, tanhf(cn));
        *cp = cn;
        h_next[(int64_t)b * H + u] = hn;
        y[((int64_t)b * T_len + t) * H + u] = from_f<T>(hn);
      }
    }
    if (t + 1 < T_len) grid.sync();  // every h_t is written and visible
  }
  __syncthreads();
  for (int i = tid; i < B * p.U; i += NT) {
    const int u = u0 + i % p.U;
    if (u < H) c_io[(int64_t)(i / p.U) * H + u] = cs[i];
  }
}

struct Device {
  int sms, smem, coop;
};

cudaError_t device(Device* d) {
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&d->sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&d->smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&d->coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess && !d->coop) e = cudaErrorNotSupported;
  d->smem = d->smem < SMEM_MAX ? d->smem : SMEM_MAX;
  return e;
}

int batch_group(int B) { return B == 1 ? 1 : B == 2 ? 2 : 4; }

// The layout of a call; refused (cudaErrorInvalidValue) where a CTA's units
// of one batch group outnumber its threads or h and the sums do not fit
cudaError_t plan(int dtype, int B, int H, Plan* p) {
  Device d;
  const cudaError_t e = device(&d);
  if (e != cudaSuccess) return e;
  const int V = dtype == 0 ? 4 : 8, BB = batch_group(B);
  const int need = (H + d.sms - 1) / d.sms;
  int U = V / 4;
  while (U < need) U *= 2;
  if (BB * U > NT) return cudaErrorInvalidValue;
  p->U = U;
  p->sms = d.sms;
  p->lanes = 4 * U / V;
  p->kg = NT / p->lanes;
  p->R = ((H + p->kg - 1) / p->kg + 3) / 4 * 4;
  p->hs_ld = p->R + 4;
  p->grid = (H + U - 1) / U;
  const int64_t fixed =
      4 * ((int64_t)BB * p->kg * p->hs_ld + (int64_t)p->kg * BB * 4 * U +
           (int64_t)B * U);
  if (fixed > d.smem) return cudaErrorInvalidValue;
  const int RR = reg_rows(dtype, BB);
  const int fit = (int)((d.smem - fixed) / (NT * CHUNK)) / 4 * 4;
  const int rest = p->R > RR ? p->R - RR : 0;
  p->SR = rest < fit ? rest : fit;
  p->scratch_rows = rest - p->SR;
  p->smem = (int)(p->SR * NT * CHUNK + fixed);
  return cudaSuccess;
}

template <typename T, int BB, bool VEC>
cudaError_t launch(const void* xg, const void* wh, void* hbuf, void* c,
                   void* y, void* scratch, int B, int T_len, int H,
                   const Plan& p, cudaStream_t stream) {
  auto kern = lstm_kernel<T, BB, VEC>;
  static const cudaError_t set = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (set != cudaSuccess) return set;
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kern, NT, p.smem);
  if (e != cudaSuccess) return e;
  if (p.grid > per_sm * p.sms) return cudaErrorCooperativeLaunchTooLarge;
  const T* a0 = static_cast<const T*>(xg);
  const T* a1 = static_cast<const T*>(wh);
  float* a2 = static_cast<float*>(hbuf);
  float* a3 = static_cast<float*>(c);
  T* a4 = static_cast<T*>(y);
  uint4* a5 = static_cast<uint4*>(scratch);
  Plan a9 = p;
  void* args[] = {&a0, &a1, &a2, &a3, &a4, &a5, &B, &T_len, &H, &a9};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern),
                                  dim3(p.grid), dim3(NT), args, p.smem,
                                  stream);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename T, int BB>
cudaError_t launch_vec(const void* xg, const void* wh, void* hbuf, void* c,
                       void* y, void* scratch, int B, int T_len, int H,
                       const Plan& p, cudaStream_t st) {
  constexpr int V = Vec<T>::V;
  if (p.U % V == 0 && H % V == 0 &&
      reinterpret_cast<uintptr_t>(wh) % 16 == 0)
    return launch<T, BB, true>(xg, wh, hbuf, c, y, scratch, B, T_len, H, p,
                               st);
  return launch<T, BB, false>(xg, wh, hbuf, c, y, scratch, B, T_len, H, p,
                              st);
}

template <typename T>
cudaError_t launch_b(const void* xg, const void* wh, void* hbuf, void* c,
                     void* y, void* scratch, int B, int T_len, int H,
                     const Plan& p, cudaStream_t st) {
  switch (batch_group(B)) {
    case 1:
      return launch_vec<T, 1>(xg, wh, hbuf, c, y, scratch, B, T_len, H, p,
                              st);
    case 2:
      return launch_vec<T, 2>(xg, wh, hbuf, c, y, scratch, B, T_len, H, p,
                              st);
    default:
      return launch_vec<T, 4>(xg, wh, hbuf, c, y, scratch, B, T_len, H, p,
                              st);
  }
}

}  // namespace

// The bytes of scratch a call of this dtype (0 = float32, 1 = bfloat16), B
// and H needs on the current device: the rows of W_h's slices that stay
// off chip.  Returns a cudaError_t.
extern "C" int pavlov_lstm_scratch(int dtype, int B, int H, int64_t* bytes) {
  if (B <= 0 || H <= 0 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  Plan p;
  const cudaError_t e = plan(dtype, B, H, &p);
  if (e != cudaSuccess) return e;
  *bytes = (int64_t)p.grid * p.scratch_rows * NT * CHUNK;
  return cudaSuccess;
}

// xg: contiguous (B, T, 4H), wh: contiguous (H, 4H), y: (B, T, H), all of
// one dtype (0 = float32, 1 = bfloat16); hbuf: (2, B, H) float32 with the
// initial h in hbuf[0]; c: (B, H) float32 holding the initial c; scratch:
// 16-byte aligned, pavlov_lstm_scratch's bytes.  One cooperative launch;
// afterwards h_T is in hbuf[T % 2] and c_T in c.  Returns the launch's
// error, or cudaGetLastError() after it.
extern "C" int pavlov_lstm_fwd(const void* xg, const void* wh, void* hbuf,
                               void* c, void* y, void* scratch, int dtype,
                               int B, int T_len, int H, void* stream) {
  if (B <= 0 || T_len <= 0 || H <= 0 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  Plan p;
  const cudaError_t e = plan(dtype, B, H, &p);
  if (e != cudaSuccess) return e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_b<float>(xg, wh, hbuf, c, y, scratch, B, T_len, H, p, st);
  return launch_b<__nv_bfloat16>(xg, wh, hbuf, c, y, scratch, B, T_len, H, p,
                                 st);
}
