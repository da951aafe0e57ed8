// Paged decode attention for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention/kernel.py
// (_paged_decode_kernel, launched by paged_decode_attention_raw).  Same
// function: one query token per slot attends to its logical KV sequence,
// which lives scattered over a global pool of fixed-size blocks; logical
// block j of slot b is physical block table[b, j]; positions are visible
// while kv_pos <= lengths[b] (lengths counts the tokens cached before this
// one, whose K/V the caller has already written); online softmax over the
// blocks in float32; GQA in the kernel; 1/sqrt(hd) applied to float32 q;
// output acc / max(l, 1e-30) in the input dtype.
//
// Design.  The TPU version prefetches the table as scalars ahead of its
// grid and walks (slot, block) sequentially.  Here one block of threads
// owns one (slot, kv head) pair: it reads its own table row and length,
// walks only the logical blocks that hold a visible position (the loop ends
// at block lengths[b] / bs, so the work follows the live tokens, not the
// table's width), and serves the `group` q heads of that kv head from one
// read of each K/V row.  Scores: one warp per token, lanes across head_dim,
// a shuffle reduction per q head.  Softmax update: one thread per q head.
// P·V: one thread per head_dim column, accumulators in shared memory.
//
// What bounds it.  Decode is bound by the bytes it reads: K and V of every
// live token, once.  This first kernel issues narrow loads and has only
// (slots x kv heads) blocks in flight; splitting long sequences across
// blocks and vector loads come in a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int NT = 128;

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
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool,
                    const int* __restrict__ table,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int H, int KVH, int hd, int bs, int nb, float scale) {
  const int group = H / KVH;
  extern __shared__ float smem[];
  float* s_q = smem;                       // group x hd (scaled)
  float* s_acc = s_q + group * hd;         // group x hd
  float* s_s = s_acc + group * hd;         // group x bs (scores, then p)
  float* s_m = s_s + group * bs;           // group
  float* s_l = s_m + group;                // group
  float* s_c = s_l + group;                // group (rescale factor)

  const int b = blockIdx.x, n = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = NT / 32;
  const int len = lengths[b];
  const int64_t tok_stride = (int64_t)KVH * hd;   // between tokens of a block

  const T* qb = q + ((int64_t)b * H + (int64_t)n * group) * hd;
  for (int i = tid; i < group * hd; i += NT) {
    s_q[i] = to_f(qb[i]) * scale;
    s_acc[i] = 0.f;
  }
  if (tid < group) {
    s_m[tid] = NEG_INF;
    s_l[tid] = 0.f;
  }
  const int last = min(len / bs, nb - 1);
  __syncthreads();

  for (int j = 0; j <= last; ++j) {
    const int64_t blk = table[(int64_t)b * nb + j];
    const T* kb = k_pool + blk * bs * tok_stride + (int64_t)n * hd;
    const T* vb = v_pool + blk * bs * tok_stride + (int64_t)n * hd;
    for (int t = warp; t < bs; t += nwarps) {
      const T* kr = kb + t * tok_stride;
      const bool visible = j * bs + t <= len;
      for (int g = 0; g < group; ++g) {
        float part = 0.f;
        for (int d = lane; d < hd; d += 32) part += s_q[g * hd + d] * to_f(kr[d]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        if (lane == 0) s_s[g * bs + t] = visible ? part : NEG_INF;
      }
    }
    __syncthreads();
    if (tid < group) {
      const int g = tid;
      float mt = NEG_INF;
      for (int t = 0; t < bs; ++t) mt = fmaxf(mt, s_s[g * bs + t]);
      const float m_new = fmaxf(s_m[g], mt);
      const float corr = expf(s_m[g] - m_new);
      float sum = 0.f;
      for (int t = 0; t < bs; ++t) {
        const float p = expf(s_s[g * bs + t] - m_new);
        s_s[g * bs + t] = p;
        sum += p;
      }
      s_l[g] = s_l[g] * corr + sum;
      s_m[g] = m_new;
      s_c[g] = corr;
    }
    __syncthreads();
    for (int d = tid; d < hd; d += NT) {
      for (int g = 0; g < group; ++g) {
        float a = s_acc[g * hd + d] * s_c[g];
        for (int t = 0; t < bs; ++t)
          a += s_s[g * bs + t] * to_f(vb[t * tok_stride + d]);
        s_acc[g * hd + d] = a;
      }
    }
    __syncthreads();                       // s_s is rewritten next block
  }

  T* ob = out + ((int64_t)b * H + (int64_t)n * group) * hd;
  for (int i = tid; i < group * hd; i += NT)
    ob[i] = from_f<T>(s_acc[i] / fmaxf(s_l[i / hd], 1e-30f));
}

template <typename T>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int* table, const int* lengths, void* out, int B,
                   int H, int KVH, int hd, int bs, int nb, float scale,
                   cudaStream_t st) {
  const int group = H / KVH;
  const size_t smem = sizeof(float) * (2 * group * hd + group * bs + 3 * group);
  auto kern = paged_decode_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3(B, KVH), NT, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), table, lengths, static_cast<T*>(out), H, KVH,
      hd, bs, nb, scale);
  return cudaGetLastError();
}

}  // namespace

// q: (B, H, hd); k_pool / v_pool: (N, bs, KVH, hd); table: (B, nb) int32
// with every entry in [0, N); lengths: (B,) int32; out: (B, H, hd).  All
// contiguous.  dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError().
extern "C" int paged_decode_attention_fwd(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* lengths, void* out, int dtype, int B, int H, int KVH, int hd,
    int bs, int nb, float scale, void* stream) {
  if (B <= 0 || KVH <= 0 || H % KVH != 0 || hd <= 0 || bs <= 0 || nb <= 0)
    return cudaErrorInvalidValue;
  const int* tbl = static_cast<const int*>(table);
  const int* lens = static_cast<const int*>(lengths);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pool, v_pool, tbl, lens, out, B, H, KVH, hd, bs,
                         nb, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, tbl, lens, out, B, H, KVH,
                                 hd, bs, nb, scale, st);
  return cudaErrorInvalidValue;
}
