// Flash (online-softmax) attention forward for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention/kernel.py
// (_flash_kernel, launched by flash_attention_raw).  Same function: causal
// mask kv <= q, optional sliding window kv > q - window, q positions aligned
// to the end of the KV sequence (+ skv - sq), GQA through kv head h / group,
// float32 m / l / acc, output acc / max(l, 1e-30) in the input dtype, and the
// 1/sqrt(hd) scale applied to float32 q.
//
// Design.  The TPU grid walks KV tiles sequentially with its accumulators in
// VMEM scratch; here one block owns a (32-row q tile, batch*head) pair and
// loops over 32-row KV tiles itself, skipping tiles that lie wholly outside
// the causal / window horizon of every row in the q tile.  Q, K and V tiles
// are staged in shared memory as float32 (rows padded by one word against
// bank conflicts); four threads share each q row: each scores 8 of the 32
// keys, the row max / sum are reduced across the four lanes with shuffles,
// and each keeps a quarter of the row's accumulator (hd/4 floats) in
// registers.  K and V are read once per q tile and never repeated for GQA.
// Shapes need not divide the tiles: ragged q rows are not written, ragged
// KV rows are masked.
//
// What bounds it.  A causal prefill's intensity grows with S (qwen3-0.6b in
// bf16: about (S+1)/3 operations per byte against the H100's ~295), so it is
// bound by bytes below S of about 900 and by operations above.  This first
// kernel uses scalar float32 FMAs from shared memory, far from either bound
// and from the tensor cores (wgmma / TMA come in a later change).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;  // finite: exp(NEG_INF - NEG_INF) == 1
constexpr int BQ = 32;
constexpr int BK = 32;
constexpr int NT = 128;             // 4 threads per q row

struct Strides {
  int64_t b, s, h;                  // innermost (head_dim) stride is 1
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

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((BQ + 2 * BK) * (HD + 1) + BQ * (BK + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, Strides qs,
                 Strides ks, Strides vs, Strides os, int H, int group, int sq,
                 int skv, int causal, int window, float scale) {
  constexpr int LD = HD + 1;
  constexpr int PER = HD / 4;       // accumulator columns per thread
  extern __shared__ float smem[];
  float* s_q = smem;                // BQ x LD
  float* s_k = s_q + BQ * LD;       // BK x LD
  float* s_v = s_k + BK * LD;       // BK x LD
  float* s_p = s_v + BK * LD;       // BQ x (BK + 1)

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H, kh = h / group;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int r = tid >> 2;           // q row within the tile
  const int c = tid & 3;            // lane within the row's four
  const int shift = skv - sq;       // q aligned to the KV end

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kh * ks.h;
  const T* vb = v + b * vs.b + kh * vs.h;
  for (int i = tid; i < BQ * HD; i += NT) {
    const int rr = i / HD, d = i % HD, qi = q0 + rr;
    s_q[rr * LD + d] = qi < sq ? to_f(qb[qi * qs.s + d]) * scale : 0.f;
  }

  // KV tiles that hold a visible key for at least one real row of the tile
  const int q_lo = q0 + shift;
  const int q_hi = min(q0 + BQ, sq) - 1 + shift;
  const int kv_end = causal ? min(skv, q_hi + 1) : skv;
  int kv_begin = window > 0 ? max(0, q_lo - window + 1) : 0;
  kv_begin = (kv_begin / BK) * BK;

  const int qpos = q0 + r + shift;
  float m = NEG_INF, l = 0.f;
  float acc[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) acc[i] = 0.f;

  for (int kv0 = kv_begin; kv0 < kv_end; kv0 += BK) {
    __syncthreads();                // the previous tile is consumed
    for (int i = tid; i < BK * HD; i += NT) {
      const int rr = i / HD, d = i % HD, kp = kv0 + rr;
      const bool in = kp < skv;
      s_k[rr * LD + d] = in ? to_f(kb[kp * ks.s + d]) : 0.f;
      s_v[rr * LD + d] = in ? to_f(vb[kp * vs.s + d]) : 0.f;
    }
    __syncthreads();

    float s[BK / 4];
#pragma unroll
    for (int j = 0; j < BK / 4; ++j) s[j] = 0.f;
    for (int d = 0; d < HD; ++d) {
      const float qd = s_q[r * LD + d];
#pragma unroll
      for (int j = 0; j < BK / 4; ++j) s[j] += qd * s_k[(c + 4 * j) * LD + d];
    }
    float mt = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK / 4; ++j) {
      const int kp = kv0 + c + 4 * j;
      bool ok = kp < skv;
      if (causal) ok = ok && kp <= qpos;
      if (window > 0) ok = ok && kp > qpos - window;
      s[j] = ok ? s[j] : NEG_INF;
      mt = fmaxf(mt, s[j]);
    }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m, mt);
    const float corr = expf(m - m_new);
    float ps = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 4; ++j) {
      const float p = expf(s[j] - m_new);
      s_p[r * (BK + 1) + c + 4 * j] = p;
      ps += p;
    }
    ps += __shfl_xor_sync(0xffffffffu, ps, 1);
    ps += __shfl_xor_sync(0xffffffffu, ps, 2);
    l = l * corr + ps;
    m = m_new;
    __syncwarp();                   // a row's p comes from its own warp
#pragma unroll
    for (int i = 0; i < PER; ++i) acc[i] *= corr;
    for (int j = 0; j < BK; ++j) {
      const float p = s_p[r * (BK + 1) + j];
#pragma unroll
      for (int i = 0; i < PER; ++i) acc[i] += p * s_v[j * LD + c + 4 * i];
    }
  }

  const int qi = q0 + r;
  if (qi < sq) {
    T* ob = o + b * os.b + h * os.h + qi * os.s;
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < PER; ++i) ob[c + 4 * i] = from_f<T>(acc[i] / den);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   Strides qs, Strides ks, Strides vs, Strides os, int B,
                   int H, int KVH, int sq, int skv, int causal, int window,
                   float scale, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, HD>;
  constexpr size_t smem = smem_bytes<HD>();
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((sq + BQ - 1) / BQ, B * H);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), qs, ks, vs, os, H,
      H / KVH, sq, skv, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        void* o, Strides qs, Strides ks, Strides vs,
                        Strides os, int B, int H, int KVH, int sq, int skv,
                        int causal, int window, float scale,
                        cudaStream_t st) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, o, qs, ks, vs, os, B, H, KVH, sq, skv,
                           causal, window, scale, st);
    case 64:
      return launch<T, 64>(q, k, v, o, qs, ks, vs, os, B, H, KVH, sq, skv,
                           causal, window, scale, st);
    case 128:
      return launch<T, 128>(q, k, v, o, qs, ks, vs, os, B, H, KVH, sq, skv,
                            causal, window, scale, st);
    case 256:
      return launch<T, 256>(q, k, v, o, qs, ks, vs, os, B, H, KVH, sq, skv,
                            causal, window, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B, Sq, H, hd), k / v: (B, Skv, KVH, hd), o: (B, Sq, H, hd), each given
// by its (batch, seq, head) element strides with a unit head_dim stride.
// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after launch.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int H, int KVH, int sq, int skv, int hd, int64_t q_sb, int64_t q_ss,
    int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
    int64_t v_ss, int64_t v_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh,
    int causal, int window, float scale, void* stream) {
  if (B <= 0 || sq <= 0 || skv <= 0 || KVH <= 0 || H % KVH != 0)
    return cudaErrorInvalidValue;
  Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh},
      os{o_sb, o_ss, o_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, o, qs, ks, vs, os, B, H, KVH, sq,
                              skv, causal, window, scale, st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, qs, ks, vs, os, B, H,
                                      KVH, sq, skv, causal, window, scale,
                                      st);
  return cudaErrorInvalidValue;
}
