// Paged decode attention for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention/kernel.py
// (_paged_decode_kernel, launched by paged_decode_attention_raw).  Same
// function: one query token per slot attends to its logical KV sequence,
// which lives scattered over a global pool of fixed-size blocks; logical
// block j of slot b is physical block table[b, j]; positions are visible
// while kv_pos <= lengths[b] (lengths counts the tokens cached before this
// one, whose K/V the caller has already written); online softmax in
// float32; GQA in the kernel; 1/sqrt(hd) applied to float32 q; output
// acc / max(l, 1e-30) in the input dtype.
//
// What bounds it.  A decode tick reads K and V of every live token once
// (2 · live · KVH · hd elements) and does about 2 operations per element
// read for each q head of a group: bound by bytes.  At serving's shapes
// that is a few MB, so the time is latency unless the whole card is busy:
// the TPU version walks (slot, block) in order with the table prefetched
// as scalars; one CTA per (slot, kv head) walking the blocks in order (the
// first version here, 80x its bound) keeps 32 of 132 SMs busy at qwen3's
// 4 slots and waits on each block's loads in turn.
//
// Design.  Flash decoding, in two launches.
//   1. paged_split_kernel: a CTA owns (slot b, split s, a chunk of at most
// 16 q heads): split s is a fixed run of `spb` logical blocks, and the C
// entry chooses spb from the table's width nb and the card's SM count only
// (at most one split a SM for a slot; never from lengths, which live on
// the card), so a slot's splits, and with them its bits, depend on its own
// length, nb and the SM count alone.  A CTA whose split starts past block
// lengths[b] / bs writes an empty partial (m = NEG_INF, l = 0) and exits.
// A live CTA streams its blocks through a 3-stage ring in shared memory:
// thread 0 reads the table entry itself (the split's first one beside the
// length) and copies a stage's K and V with the bulk-copy engine
// (cp.async.bulk, completion counted by an mbarrier) — one copy each when
// the CTA covers every kv head (a block's tokens for all kv heads lie
// contiguous in the (N, bs, KVH, hd) pool), one a token otherwise.  A
// stage holds up to 32 KB (a block, or `tb` of its tokens), so two CTAs
// share an SM.  Warps own q heads (two each, one kv head for even
// groups), q in float32 registers, pre-scaled by 1/sqrt(hd) · log2(e).
// Lanes own (token, 16-byte chunks of hd), R tokens a pass of the warp:
// a score is a dot product over a lane's chunks and a shuffle sum over
// its token's lanes, the online softmax takes a pass's R tokens at once
// (a shuffle max over them), and P·V accumulates each lane's chunks in
// float32 registers; the R rows' sums meet once, at the end.  (Computing
// a stage's scores first, then its softmax with lanes over tokens, then
// P·V, measured slower.)  Each split writes its float32 (m, l, acc) to a
// scratch the wrapper allocates.
//   2. paged_combine_kernel: a CTA per (slot, q head) merges
// the slot's live splits with weights exp2(m_s - M), every sum in a fixed
// order and no atomics, so two calls give the same bits.  Split 0 always
// holds position 0, so every slot has a live split.
//   What is left (PERF.md §6): at long lengths most of the time is the
// copies themselves; at serving's lengths, each CTA's chain of dependent
// reads (length, table entry, first stage) and the combine's launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float NEG_INF = -1e30f;  // finite: exp(NEG_INF - NEG_INF) == 1
constexpr float LOG2E = 1.4426950408889634f;
constexpr int NW = 8;              // warps a CTA
constexpr int NT = 32 * NW;
constexpr int MAXQ = 2;            // q heads a warp serves
constexpr int QMAX = NW * MAXQ;    // q heads a CTA serves
constexpr int ST = 3;              // stages in the ring
constexpr int STAGE_BYTES = 32 * 1024;  // K + V of a stage, at most
constexpr int NC = 128;            // threads of a combine CTA
constexpr int NS_MAX = 1024;       // splits a slot, at most

// a CTA's launch plan, the same for every slot
struct Plan {
  int spb, ns;       // logical blocks a split, splits a slot
  int hq, nchunks;   // q heads a CTA, CTAs across the q heads
  int cmax;          // kv heads a CTA's q heads span, at most
  int tb, nsub;      // tokens a stage, stages a block
  size_t smem;
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

// 16 bytes of shared memory as VEC floats
template <typename T>
__device__ __forceinline__ void chunk_f(const uint8_t* p, float* f);
template <>
__device__ __forceinline__ void chunk_f<float>(const uint8_t* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}
template <>
__device__ __forceinline__ void chunk_f<__nv_bfloat16>(const uint8_t* p,
                                                       float* f) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {     // a bf16 is a float32's top 16 bits
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Lanes over one token's row of hd: VEC elements a 16-byte chunk, L lanes
// a row (CPL chunks each), R rows (tokens) a pass of the warp.  Eight
// lanes a row where a lane's share fits its registers (16 floats, 8 at
// hd = 256): a quarter-warp then reads one row's 128 contiguous bytes (no
// bank conflict), and a score's sum over the lanes is 3 shuffles
template <typename T, int HD>
struct Lanes {
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int CH = HD / VEC;
  static constexpr int LMIN = CH < 8 ? CH : 8;
  static constexpr int LREG = CH * VEC / (HD <= 128 ? 16 : 8);
  static constexpr int L = LREG > LMIN ? LREG : LMIN;
  static constexpr int CPL = CH / L;
  static constexpr int R = 32 / L;
  static constexpr int QF = CPL * VEC;   // floats of a row a lane holds
  static_assert(CH % L == 0 && 32 % L == 0, "head_dim");
};

__device__ __forceinline__ int last_block(int len, int bs, int nb) {
  return min(len / bs, nb - 1);
}

// part_acc: (B, H, ns, hd) float32, then part_ml: (B, H, ns) float2 (m, l)
template <typename T, int HD>
__global__ void __launch_bounds__(NT, 2)
paged_split_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                   const T* __restrict__ v_pool,
                   const int* __restrict__ table,
                   const int* __restrict__ lengths,
                   float2* __restrict__ part_ml,
                   float* __restrict__ part_acc, int H, int KVH, int bs,
                   int nb, Plan p, float scale_log2) {
  using LN = Lanes<T, HD>;
  constexpr int L = LN::L, R = LN::R, CPL = LN::CPL, QF = LN::QF;
  const int s = blockIdx.x, chunk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int group = H / KVH;
  const int h0 = chunk * p.hq;
  const int hq = min(p.hq, H - h0);          // q heads of this CTA
  const int n_lo = h0 / group;
  const int C = (h0 + hq - 1) / group - n_lo + 1;   // kv heads it spans
  const int j0 = s * p.spb;
  // the split's first table entry, fetched beside the length (j0 < nb)
  const int blk0 = tid == 0 ? table[(int64_t)b * nb + j0] : 0;
  const int len = lengths[b];
  const int last = last_block(len, bs, nb);
  const size_t row0 = ((size_t)b * H + h0) * p.ns + s;   // (b, h0, s)

  if (j0 > last) {                  // past the slot's length: empty
    if (tid < hq)
      part_ml[row0 + (size_t)tid * p.ns] = make_float2(NEG_INF, 0.f);
    return;
  }
  const int j1 = min(j0 + p.spb, last + 1);
  // stages: (block j, tokens tc * tb ..) in order, those that start at a
  // visible position
  const int n_st = (j1 - 1 < last)
                       ? (j1 - j0) * p.nsub
                       : (last - j0) * p.nsub +
                             min(p.nsub, (len - last * bs) / p.tb + 1);

  extern __shared__ __align__(128) uint8_t smem[];
  const int tok_bytes = C * HD * (int)sizeof(T);   // a token's K (or V)
  const int kv_bytes = p.tb * p.cmax * HD * (int)sizeof(T);  // K of a stage
  const uint32_t base = smem_u32(smem);
  const uint32_t bars = base + ST * 2 * kv_bytes;
  auto k_at = [&](int st) { return st * 2 * kv_bytes; };
  auto v_at = [&](int st) { return (2 * st + 1) * kv_bytes; };

  auto issue = [&](int i) {         // thread 0: stage i into its slot
    const int st = i % ST;
    const int j = j0 + i / p.nsub, t0 = (i % p.nsub) * p.tb;
    const int ntok = min(p.tb, bs - t0);
    const int blk = j == j0 ? blk0 : table[(int64_t)b * nb + j];
    const int64_t tok = (int64_t)blk * bs + t0;
    mbar_expect_tx(bars + 8 * st, 2 * ntok * tok_bytes);
    if (C == KVH) {
      const int64_t off = tok * KVH * HD;
      bulk_load(base + k_at(st), k_pool + off, ntok * tok_bytes, bars + 8 * st);
      bulk_load(base + v_at(st), v_pool + off, ntok * tok_bytes, bars + 8 * st);
    } else {
      for (int t = 0; t < ntok; ++t) {
        const int64_t off = ((tok + t) * KVH + n_lo) * HD;
        bulk_load(base + k_at(st) + t * tok_bytes, k_pool + off, tok_bytes,
                  bars + 8 * st);
        bulk_load(base + v_at(st) + t * tok_bytes, v_pool + off, tok_bytes,
                  bars + 8 * st);
      }
    }
  };

  if (tid == 0) {
    for (int i = 0; i < ST; ++i) mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < min(ST, n_st); ++i) issue(i);
  }

  // this lane: row r of a pass, chunks cl + L * c of hd
  const int r = lane / L, cl = lane % L;
  // the warp's q heads: local 2 * warp, 2 * warp + 1 (one kv head when
  // the group is even), q in float32 registers, scaled
  float qv[MAXQ][QF], acc[MAXQ][QF], m[MAXQ], l[MAXQ];
  int kvl[MAXQ];
  bool on[MAXQ];
#pragma unroll
  for (int k = 0; k < MAXQ; ++k) {
    const int qh = warp * MAXQ + k;
    on[k] = qh < hq;
    kvl[k] = on[k] ? (h0 + qh) / group - n_lo : 0;
    const T* qr = q + ((int64_t)b * H + h0 + (on[k] ? qh : 0)) * HD;
#pragma unroll
    for (int c = 0; c < CPL; ++c)
#pragma unroll
      for (int e = 0; e < LN::VEC; ++e) {
        qv[k][c * LN::VEC + e] =
            to_f(qr[(cl + L * c) * LN::VEC + e]) * scale_log2;
        acc[k][c * LN::VEC + e] = 0.f;
      }
    m[k] = NEG_INF;
    l[k] = 0.f;
  }
  __syncthreads();                  // barriers initialised

  for (int i = 0; i < n_st; ++i) {
    const int st = i % ST;
    const int j = j0 + i / p.nsub, t0 = (i % p.nsub) * p.tb;
    const int ntok = min(p.tb, bs - t0);
    const int pos0 = j * bs + t0;
    mbar_wait(bars + 8 * st, (i / ST) & 1);
    const uint8_t* ks = smem + k_at(st);
    const uint8_t* vs = smem + v_at(st);
    for (int tt = 0; tt < ntok; tt += R) {
      const int t = tt + r;
      const bool valid = t < ntok && pos0 + t <= len;
      float kf[QF], vf[QF];
      int held = -1;                // kv head whose K/V chunk kf/vf hold
#pragma unroll
      for (int k = 0; k < MAXQ; ++k) {
        if (!on[k]) continue;       // uniform over the warp
        if (kvl[k] != held) {
          held = kvl[k];
#pragma unroll
          for (int c = 0; c < CPL; ++c) {
            const int at = (t * C + held) * HD * (int)sizeof(T) +
                           (cl + L * c) * 16;
            if (t < ntok) {
              chunk_f<T>(ks + at, kf + c * LN::VEC);
              chunk_f<T>(vs + at, vf + c * LN::VEC);
            } else {
#pragma unroll
              for (int e = 0; e < LN::VEC; ++e)
                kf[c * LN::VEC + e] = vf[c * LN::VEC + e] = 0.f;
            }
          }
        }
        float sc = 0.f;
#pragma unroll
        for (int e = 0; e < QF; ++e) sc = fmaf(qv[k][e], kf[e], sc);
#pragma unroll
        for (int off = L / 2; off > 0; off >>= 1)
          sc += __shfl_xor_sync(0xffffffffu, sc, off);
        float mx = valid ? sc : NEG_INF;
#pragma unroll
        for (int off = L; off < 32; off <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[k], mx);
        const float corr = exp2_approx(m[k] - m_new);
        const float pr = valid ? exp2_approx(sc - m_new) : 0.f;
        l[k] = fmaf(l[k], corr, pr);
#pragma unroll
        for (int e = 0; e < QF; ++e) {
          const float a = acc[k][e] * corr;
          acc[k][e] = valid ? fmaf(pr, vf[e], a) : a;
        }
        m[k] = m_new;
      }
    }
    __syncthreads();                // every warp is done with the slot
    if (tid == 0 && i + ST < n_st) issue(i + ST);
  }

  // the rows' partial sums into one (a fixed order), then this split's
  // (m, l, acc) for each of the warp's q heads
#pragma unroll
  for (int k = 0; k < MAXQ; ++k) {
    if (!on[k]) continue;
#pragma unroll
    for (int off = L; off < 32; off <<= 1)
      l[k] += __shfl_xor_sync(0xffffffffu, l[k], off);
#pragma unroll
    for (int off = L; off < 32; off <<= 1)
#pragma unroll
      for (int e = 0; e < QF; ++e)
        acc[k][e] += __shfl_xor_sync(0xffffffffu, acc[k][e], off);
    const size_t row = row0 + (size_t)(warp * MAXQ + k) * p.ns;
    if (r == 0) {
      float* dst = part_acc + row * HD;
#pragma unroll
      for (int c = 0; c < CPL; ++c)
#pragma unroll
        for (int e = 0; e < LN::VEC; e += 4)
          *reinterpret_cast<float4*>(dst + (cl + L * c) * LN::VEC + e) =
              make_float4(acc[k][c * LN::VEC + e], acc[k][c * LN::VEC + e + 1],
                          acc[k][c * LN::VEC + e + 2],
                          acc[k][c * LN::VEC + e + 3]);
    }
    if (lane == 0) part_ml[row] = make_float2(m[k], l[k]);
  }
}

// a CTA per (slot, q head): the live splits' partials merged with
// weights exp2(m_s - M), each sum in a fixed order (thread tid takes splits
// tid, tid + NC, ... in increasing order, then a fixed tree), divided by
// max(l, 1e-30), in the output dtype.  hd / 4 threads across hd in float4s,
// NC / (hd / 4) groups of them across the splits
template <typename T>
__global__ void __launch_bounds__(NC)
paged_combine_kernel(const float2* __restrict__ part_ml,
                     const float* __restrict__ part_acc,
                     const int* __restrict__ lengths, T* __restrict__ out,
                     int H, int hd, int bs, int nb, int spb, int ns) {
  __shared__ float s_w[NS_MAX];             // weight of split s
  __shared__ float s_red[NC / 32];
  __shared__ __align__(16) float s_acc[NC * 4];
  const int row = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int live = last_block(lengths[row / H], bs, nb) / spb + 1;
  const float2* ml = part_ml + (size_t)row * ns;
  const float* pa = part_acc + (size_t)row * ns * hd;

  // M: the largest m (max is exact in any order)
  float mx = NEG_INF;
  for (int s = tid; s < live; s += NC) mx = fmaxf(mx, ml[s].x);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (lane == 0) s_red[warp] = mx;
  __syncthreads();
  mx = s_red[0];
#pragma unroll
  for (int w = 1; w < NC / 32; ++w) mx = fmaxf(mx, s_red[w]);
  __syncthreads();                          // s_red is reused below
  // the weights, and l = sum w_s l_s
  float den = 0.f;
  for (int s = tid; s < live; s += NC) {
    const float2 v = ml[s];
    const float w = exp2_approx(v.x - mx);
    s_w[s] = w;
    den = fmaf(w, v.y, den);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    den += __shfl_xor_sync(0xffffffffu, den, off);
  if (lane == 0) s_red[warp] = den;
  __syncthreads();
  den = s_red[0];
#pragma unroll
  for (int w = 1; w < NC / 32; ++w) den += s_red[w];

  // acc: thread (g, c) sums float4 column c over splits g, g + G, ...
  const int cols = hd / 4, G = NC / cols;
  const int c = tid % cols, g = tid / cols;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int s = g; s < live; s += G) {
    const float w = s_w[s];
    const float4 x =
        *reinterpret_cast<const float4*>(pa + (size_t)s * hd + 4 * c);
    a.x = fmaf(w, x.x, a.x);
    a.y = fmaf(w, x.y, a.y);
    a.z = fmaf(w, x.z, a.z);
    a.w = fmaf(w, x.w, a.w);
  }
  *reinterpret_cast<float4*>(s_acc + 4 * tid) = a;
  __syncthreads();
  const float inv = 1.f / fmaxf(den, 1e-30f);
  T* o = out + (size_t)row * hd;
  for (int d = tid; d < hd; d += NC) {
    float sum = s_acc[d];                   // group 0's column d
    for (int gg = 1; gg < G; ++gg) sum += s_acc[gg * hd + d];
    o[d] = from_f<T>(sum * inv);
  }
}

// ---- host
int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return sms;
}

// The plan of a call: from the shapes, nb and the card's SM count only
cudaError_t plan(int elt, int H, int KVH, int hd, int bs, int nb, Plan* p) {
  if (KVH <= 0 || H % KVH != 0 || bs <= 0 || nb <= 0 ||
      (hd != 16 && hd != 64 && hd != 128 && hd != 256))
    return cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorNoDevice;
  const int group = H / KVH;
  // splits: at most one a block, and no more than the card has SMs
  p->spb = (nb + sms - 1) / sms;
  p->ns = (nb + p->spb - 1) / p->spb;
  if (p->ns > NS_MAX) return cudaErrorInvalidValue;
  // q heads: whole groups a CTA where a group fits, up to QMAX
  p->hq = group <= QMAX ? (QMAX / group) * group : QMAX;
  if (p->hq > H) p->hq = H;
  p->nchunks = (H + p->hq - 1) / p->hq;
  p->cmax = group <= QMAX ? p->hq / group : 2;
  if (p->cmax > KVH) p->cmax = KVH;
  // tokens a stage: the whole block where K + V fit STAGE_BYTES, else
  // halves of it (a token's K + V for cmax kv heads is at most 32 KB)
  const int tok = 2 * p->cmax * hd * elt;
  p->tb = bs;
  while (p->tb > 1 && p->tb * tok > STAGE_BYTES) p->tb = (p->tb + 1) / 2;
  p->nsub = (bs + p->tb - 1) / p->tb;
  p->smem = (size_t)ST * p->tb * tok + 8 * ST;
  return cudaSuccess;
}

template <typename T, int HD>
cudaError_t launch_split(const void* q, const void* kp, const void* vp,
                         const int* table, const int* lengths, float2* ml,
                         float* acc, int B, int H, int KVH, int bs, int nb,
                         const Plan& p, float scale, cudaStream_t st) {
  auto kern = paged_split_kernel<T, HD>;
  static const cudaError_t set = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      ST * STAGE_BYTES + 8 * ST);
  if (set != cudaSuccess) return set;
  kern<<<dim3(p.ns, p.nchunks, B), NT, p.smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), table, lengths, ml, acc, H, KVH, bs, nb, p,
      scale * LOG2E);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int* table, const int* lengths, void* out,
                   void* scratch, int B, int H, int KVH, int hd, int bs,
                   int nb, const Plan& p, float scale, cudaStream_t st) {
  float* acc = static_cast<float*>(scratch);
  float2* ml = reinterpret_cast<float2*>(acc + (size_t)B * H * p.ns * hd);
  cudaError_t e = cudaErrorInvalidValue;
#define PAGED_SPLIT(D)                                                      \
  if (hd == D)                                                              \
    e = launch_split<T, D>(q, kp, vp, table, lengths, ml, acc, B, H, KVH,   \
                           bs, nb, p, scale, st);
  PAGED_SPLIT(16)
  PAGED_SPLIT(64)
  PAGED_SPLIT(128)
  PAGED_SPLIT(256)
#undef PAGED_SPLIT
  if (e != cudaSuccess) return e;
  paged_combine_kernel<T><<<B * H, NC, 0, st>>>(
      ml, acc, lengths, static_cast<T*>(out), H, hd, bs, nb, p.spb, p.ns);
  return cudaGetLastError();
}

int elt_of(int dtype) { return dtype == 0 ? 4 : dtype == 1 ? 2 : 0; }

}  // namespace

// Bytes of float32 scratch paged_decode_attention_fwd needs for these
// shapes on the current card: hd sums and (m, l) a (slot, q head, split).
extern "C" int paged_decode_attention_scratch(int dtype, int B, int H,
                                              int KVH, int hd, int bs,
                                              int nb, int64_t* bytes) {
  Plan p;
  if (B <= 0 || elt_of(dtype) == 0) return cudaErrorInvalidValue;
  const cudaError_t e = plan(elt_of(dtype), H, KVH, hd, bs, nb, &p);
  if (e != cudaSuccess) return e;
  *bytes = (int64_t)B * H * p.ns * (hd + 2) * 4;
  return cudaSuccess;
}

// q: (B, H, hd); k_pool / v_pool: (N, bs, KVH, hd), 16-byte aligned;
// table: (B, nb) int32 with every entry in [0, N); lengths: (B,) int32;
// out: (B, H, hd); scratch: 16-byte aligned, paged_decode_attention_
// scratch's bytes.  All contiguous.  dtype: 0 = float32, 1 = bfloat16.
// Two launches on the stream; returns cudaGetLastError() after them.
extern "C" int paged_decode_attention_fwd(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* lengths, void* out, void* scratch, int dtype, int B, int H,
    int KVH, int hd, int bs, int nb, float scale, void* stream) {
  Plan p;
  if (B <= 0 || elt_of(dtype) == 0) return cudaErrorInvalidValue;
  const cudaError_t e = plan(elt_of(dtype), H, KVH, hd, bs, nb, &p);
  if (e != cudaSuccess) return e;
  const int* tbl = static_cast<const int*>(table);
  const int* lens = static_cast<const int*>(lengths);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pool, v_pool, tbl, lens, out, scratch, B, H,
                         KVH, hd, bs, nb, p, scale, st);
  return launch<__nv_bfloat16>(q, k_pool, v_pool, tbl, lens, out, scratch, B,
                               H, KVH, hd, bs, nb, p, scale, st);
}
