// Flash (online-softmax) attention forward for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention/kernel.py
// (_flash_kernel, launched by flash_attention_raw).  Same function: causal
// mask kv <= q, optional sliding window kv > q - window, q positions aligned
// to the end of the KV sequence (+ skv - sq), GQA through kv head h / group,
// float32 m / l / acc, output acc / max(l, 1e-30) in the input dtype, and the
// 1/sqrt(hd) scale applied in float32 (never to a q rounded to bf16).
//
// Two routes, chosen by dtype (not a fallback: each dtype has exactly one;
// float32's copies are 16-byte or element loads, by alignment):
//
// bfloat16 -> tc::flash_tc_kernel, on the tensor cores.  A CTA is one
// consumer warpgroup (128 threads) and one producer warp, and owns one
// (batch, kv head) and 64 packed rows: row pr is (position pr / group,
// q head kv_head * group + pr % group), so the q heads that share a kv head
// share every K/V tile it loads (qwen3's group 2, recurrentgemma's MQA
// group 10), and a short prefill still fills the tile.
//   Copies: Q by cp.async 16-byte copies, once; K and V tiles of BK rows
// by TMA (a 4-D tensor map over (hd, heads, seq, batch) with the caller's
// strides, encoded per call by cuTensorMapEncodeTiled, zero-filled
// past seq and past hd) into a 3-stage ring in shared memory with the
// 128-byte swizzle, full and empty mbarriers between the producer warp and
// the warpgroup.  hd = 16 runs the hd = 64 layout (one k step for S).
//   Products: S = Q.K^T is wgmma m64n{BK}k16 with Q and K from shared
// memory (both K-major: head_dim is contiguous as stored); O += P.V is
// wgmma m64n{hd}k16 with P from registers (the float32 accumulator
// fragment of 16 columns is wgmma's register-A fragment of one k step, so
// P is rounded to bf16 in place) and V from shared memory as stored
// (head_dim contiguous, the transpose-B bit set): no copy of V is
// transposed.  Rounding P to bf16 is the one numerical change against the
// Pallas kernel, whose p is float32.
//   Softmax: online, on the accumulator fragment in float32 registers, a
// row's max and sum reduced over the 4 lanes that share it; the 1/sqrt(hd)
// scale and log2(e) folded into one float32 multiply of S, then 2^x.
//   Pipeline: S of tile t is issued before P.V of tile t - 1; the softmax
// of tile t runs while that P.V is in the tensor cores, and only the
// rescale of O waits for it.  KV tiles wholly past the causal horizon or
// before the window of every row are skipped; only tiles that reach the
// diagonal, the window edge or the ragged end are masked.
//   Geometry: 64 rows a CTA, a grid of (ceil(Sq * group / 64), B * KVH),
// BK = 128 at hd <= 64 and 64 above (the O accumulator is 64 x hd float32
// a warpgroup, 128 registers a thread at hd = 256); the shared memory each
// instantiation needs is checked against Hopper's 227 KB when it compiles.
//
// float32 -> simt::flash_f32_kernel, exact float32 FMAs on the CUDA cores.
// wgmma has no full-float32 mode, and plain TF32 keeps 10 mantissa bits,
// too few for float32's 1e-4; a 3xTF32 split (hi and lo parts, three
// products, as PyTorch's memory-efficient attention runs float32) would
// hold it.  Here the work is register-tiled instead, as the Pascal SIMT
// GEMM is: a CTA of 128 threads owns (batch, kv head) and 64 packed rows,
// packed as the bf16 route packs them, so every K/V tile serves the
// group's q heads; Q sits in shared memory, scaled once by 1/sqrt(hd) ·
// log2(e); K/V tiles of 32 rows arrive through a 2-stage cp.async ring
// (16-byte copies where every base and stride allow, else element loads:
// the route is the C entry's, by alignment).  A thread holds a 4 x 4
// micro-tile of S (rows ty + 16 i, keys tx + 8 j) and 4 rows of O across
// hd / 32 16-byte chunks in registers; every shared-memory read is 16
// bytes (8 FMAs a read in S, about 13 in P.V), and a warp's reads fall in
// distinct bank groups (odd row pitches in 16-byte chunks).  A row's
// softmax is reduced over the 8 lanes that hold its columns; P goes
// through shared memory to the same warp.  Row tiles are ordered to pair
// a long causal row tile with a short one on an SM (the longer half
// first); tiles past the horizon or before the window stay skipped; each
// output is one thread's fixed-order sum, so two calls give the same
// bits.  Shared memory: 107 KB at hd = 128 (two CTAs an SM), 203 KB at
// hd = 256.
//
// What bounds it.  A causal prefill's intensity grows with S (qwen3-0.6b in
// bf16: about (S+1)/3 operations per byte against the H100's ~295), so it is
// bound by bytes below S of about 900 and by operations above.  The bf16
// kernel sits between: with one warpgroup a CTA and two CTAs an SM, each
// tile's chain (S, softmax, P.V) waits on latency (PERF.md).  In float32
// the operations bound it from short S on (1.08 GFLOP at B=4, S=256, H=16,
// hd=128 is 16 us at the 67 TFLOP/s of the CUDA cores); the SIMT route
// spends about 12% more on the diagonal tiles' masked half.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -1e30f;  // finite: exp(NEG_INF - NEG_INF) == 1

struct Strides {
  int64_t b, s, h;                  // innermost (head_dim) stride is 1
};

// ------------------------------------------------ float32: the SIMT kernel
namespace simt {

using namespace hopper;

constexpr int ROWS = 64;            // packed rows a CTA (as the bf16 route)
constexpr int BK = 32;              // KV rows a tile
constexpr int NT = 128;
constexpr int TX = 8;               // threads across S columns / O chunks
constexpr int TY = NT / TX;         // threads across rows: rows ty + 16 i
constexpr int RPT = ROWS / TY;      // rows a thread (4)
constexpr int SPT = BK / TX;        // S columns a thread: tx + 8 j (4)

// shared memory, in floats: Q (ROWS x LDQ), 2 stages of K (BK x LDQ) and
// V (BK x HD), P (ROWS x LDP).  Q and K rows hold an odd number of 16-byte
// chunks, so a warp's 4 consecutive Q rows and 8 consecutive K rows sit in
// distinct bank groups; P rows likewise
template <int HD>
struct Smem {
  static constexpr int LDQ = HD + 4;
  static constexpr int LDP = BK + 4;
  static constexpr int K_OFF = ROWS * LDQ;
  static constexpr int V_OFF = K_OFF + 2 * BK * LDQ;
  static constexpr int P_OFF = V_OFF + 2 * BK * HD;
  static constexpr size_t BYTES = sizeof(float) * (P_OFF + ROWS * LDP);
  static_assert(BYTES <= 232448, "more than a Hopper block's 227 KB");
};

// 16 bytes of row data into shared memory: cp.async where VEC, else four
// element loads (the caller's strides allow no 16-byte copy); zeros when
// !ok.  `mul` scales an element load (Q), 1 elsewhere
template <bool VEC>
__device__ __forceinline__ void load16(float* dst, const float* src, bool ok,
                                       float mul) {
  if (VEC) {
    cp_async16(smem_u32(dst), src, ok);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[e] = ok ? src[e] * mul : 0.f;
  }
}

template <int HD, bool VEC>
__global__ void __launch_bounds__(NT, HD <= 128 ? 2 : 1)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 Strides qs, Strides ks, Strides vs, Strides os, int KVH,
                 int group, int sq, int skv, int causal, int window,
                 float scale_log2) {
  using L = Smem<HD>;
  constexpr int LDQ = L::LDQ, LDP = L::LDP;
  constexpr int CH = HD / 4;                 // 16-byte chunks a row
  constexpr int CPT = (CH + TX - 1) / TX;    // O chunks a thread: tx + 8 c
  extern __shared__ __align__(16) float sm[];
  float* s_q = sm;
  float* s_k = sm + L::K_OFF;
  float* s_v = sm + L::V_OFF;
  float* s_p = sm + L::P_OFF;

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int b = blockIdx.x / KVH, kh = blockIdx.x % KVH;
  // row tiles: the longer half first, longest first, then the shorter
  // half, shortest first, so an SM's two CTAs tend to pair a long causal
  // row tile with a short one
  const int nty = gridDim.y, hy = (nty + 1) / 2;
  const int row0 =
      (blockIdx.y < hy ? nty - 1 - blockIdx.y : blockIdx.y - hy) * ROWS;
  const int rows_total = sq * group;
  const int shift = skv - sq;               // q aligned to the KV end
  const int row_hi = min(row0 + ROWS, rows_total) - 1;
  const int p_lo = row0 / group + shift, p_hi = row_hi / group + shift;
  // KV tiles that hold a visible key for at least one row of the CTA
  const int kv_end = causal ? min(skv, p_hi + 1) : skv;
  int kv_begin = window > 0 ? max(0, p_lo - window + 1) : 0;
  kv_begin = (kv_begin / BK) * BK;
  const int n_t = kv_end > kv_begin ? (kv_end - kv_begin + BK - 1) / BK : 0;

  // Q: packed row pr is (position pr / group, q head kh * group + pr %
  // group), scaled by 1/sqrt(hd) · log2(e) in float32
  const float* qb = q + b * qs.b + (int64_t)kh * group * qs.h;
  for (int i = tid; i < ROWS * CH; i += NT) {
    const int r = i / CH, c = i % CH, pr = row0 + r;
    const int pos = pr / group, hq = pr - pos * group;
    const bool ok = pr < rows_total;
    load16<VEC>(s_q + r * LDQ + 4 * c,
                ok ? qb + pos * qs.s + hq * qs.h + 4 * c : q, ok, scale_log2);
  }
  cp_async_commit();
  const float* kb = k + b * ks.b + kh * ks.h;
  const float* vb = v + b * vs.b + kh * vs.h;
  auto load_tile = [&](int t) {
    const int st = t & 1, kv0 = kv_begin + t * BK;
    for (int i = tid; i < BK * CH; i += NT) {
      const int r = i / CH, c = i % CH, kp = kv0 + r;
      const bool ok = kp < skv;
      load16<VEC>(s_k + (st * BK + r) * LDQ + 4 * c,
                  ok ? kb + kp * ks.s + 4 * c : k, ok, 1.f);
      load16<VEC>(s_v + (st * BK + r) * HD + 4 * c,
                  ok ? vb + kp * vs.s + 4 * c : v, ok, 1.f);
    }
    cp_async_commit();
  };
  if (n_t > 0) load_tile(0);
  else cp_async_commit();           // an empty group: the wait below holds
  if (VEC) {                        // this thread's Q copies are in: scale
    cp_async_wait<1>();
    for (int i = tid; i < ROWS * CH; i += NT) {
      float4* x = reinterpret_cast<float4*>(s_q + (i / CH) * LDQ +
                                            4 * (i % CH));
      float4 y = *x;
      y.x *= scale_log2;
      y.y *= scale_log2;
      y.z *= scale_log2;
      y.w *= scale_log2;
      *x = y;
    }
  }

  // this thread's rows ty + 16 i: the keys each may see, kp in (lo, hi]
  int hi[RPT], lo[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int pos = (row0 + ty + 16 * i) / group + shift;
    hi[i] = causal ? min(pos, skv - 1) : skv - 1;
    lo[i] = window > 0 ? pos - window : -1;
  }
  float m[RPT], l[RPT], acc[RPT][CPT][4];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  }

  for (int t = 0; t < n_t; ++t) {
    const int st = t & 1, kv0 = kv_begin + t * BK;
    if (t + 1 < n_t) {
      load_tile(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                // tile t (and Q) visible to all
    const float* kt = s_k + st * BK * LDQ;
    const float* vt = s_v + st * BK * HD;

    // S = Q . K^T: a 4 x 4 micro-tile, 16-byte reads along hd
    float s[RPT][SPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < SPT; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < CH; ++c) {
      float4 qa[RPT], ka[SPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        qa[i] = *reinterpret_cast<const float4*>(s_q + (ty + 16 * i) * LDQ +
                                                 4 * c);
#pragma unroll
      for (int j = 0; j < SPT; ++j)
        ka[j] = *reinterpret_cast<const float4*>(kt + (tx + 8 * j) * LDQ +
                                                 4 * c);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < SPT; ++j) {
          s[i][j] = fmaf(qa[i].x, ka[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, ka[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, ka[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, ka[j].w, s[i][j]);
        }
    }

    // online softmax of the rows (a row's 32 columns lie in the 8 lanes
    // of one tx group); masks only on tiles at the diagonal, the window
    // edge or the ragged end.  P to shared memory for P . V
    const bool edge = kv0 + BK > skv || (causal && kv0 + BK - 1 > p_lo) ||
                      (window > 0 && kv0 <= p_hi - window);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      bool vis[SPT];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        const int kp = kv0 + tx + 8 * j;
        vis[j] = !edge || (kp <= hi[i] && kp > lo[i]);
        if (vis[j]) mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float corr = exp2_approx(m[i] - m_new);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        // a masked key's p is 0, also while the row has seen no key
        const float p = vis[j] ? exp2_approx(s[i][j] - m_new) : 0.f;
        s_p[(ty + 16 * i) * LDP + tx + 8 * j] = p;
        sum += p;
      }
      l[i] = fmaf(l[i], corr, sum);
#pragma unroll
      for (int c = 0; c < CPT; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= corr;
    }
    __syncwarp();                   // a row's P comes from its own warp

    // O += P . V: 4 rows x CPT chunks, 4 keys a step
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pa[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        pa[i] = *reinterpret_cast<const float4*>(s_p + (ty + 16 * i) * LDP +
                                                 kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          if (tx + 8 * c >= CH) continue;   // hd = 16: 4 chunks a row
          const float4 vv = *reinterpret_cast<const float4*>(
              vt + (kk + u) * HD + 4 * (tx + 8 * c));
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            const float pu = u == 0   ? pa[i].x
                             : u == 1 ? pa[i].y
                             : u == 2 ? pa[i].z
                                      : pa[i].w;
            acc[i][c][0] = fmaf(pu, vv.x, acc[i][c][0]);
            acc[i][c][1] = fmaf(pu, vv.y, acc[i][c][1]);
            acc[i][c][2] = fmaf(pu, vv.z, acc[i][c][2]);
            acc[i][c][3] = fmaf(pu, vv.w, acc[i][c][3]);
          }
        }
      }
    }
    __syncthreads();                // stage st and P are free again
  }

  // O / max(l, 1e-30); rows past the last position not written
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    float den = l[i];
    den += __shfl_xor_sync(0xffffffffu, den, 1);
    den += __shfl_xor_sync(0xffffffffu, den, 2);
    den += __shfl_xor_sync(0xffffffffu, den, 4);
    const int pr = row0 + ty + 16 * i;
    if (pr >= rows_total) continue;
    const int pos = pr / group, h = kh * group + pr - pos * group;
    float* ob = o + b * os.b + pos * os.s + h * os.h;
    const float inv = 1.f / fmaxf(den, 1e-30f);
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      if (tx + 8 * c >= CH) continue;
      float* dst = ob + 4 * (tx + 8 * c);
      const float4 y = make_float4(acc[i][c][0] * inv, acc[i][c][1] * inv,
                                   acc[i][c][2] * inv, acc[i][c][3] * inv);
      if (VEC) {
        *reinterpret_cast<float4*>(dst) = y;
      } else {
        dst[0] = y.x;
        dst[1] = y.y;
        dst[2] = y.z;
        dst[3] = y.w;
      }
    }
  }
}

template <int HD, bool VEC>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   Strides qs, Strides ks, Strides vs, Strides os, int B,
                   int KVH, int group, int sq, int skv, int causal,
                   int window, float scale, cudaStream_t stream) {
  auto kern = flash_f32_kernel<HD, VEC>;
  constexpr size_t smem = Smem<HD>::BYTES;
  static const cudaError_t set = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (set != cudaSuccess) return set;
  const dim3 grid(B * KVH, (sq * group + ROWS - 1) / ROWS);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), qs, ks, vs, os,
      KVH, group, sq, skv, causal, window, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace simt

// ---------------------------------------------- bfloat16: the wgmma kernel
namespace tc {

using namespace hopper;
using bf16 = __nv_bfloat16;
constexpr int ROWS = 64;            // packed rows a CTA owns (wgmma's M)
constexpr int ST = 3;               // K/V ring stages: tile t + 1 loads
                                    // while t and t - 1 are in use
constexpr int NT = 160;             // a consumer warpgroup, a producer warp

template <int D>
__host__ __device__ constexpr int padded() { return D < 64 ? 64 : D; }

// byte offset of 16-byte chunk ch of row r in a tile of R rows stored for
// the 128-byte swizzle: 64-column slabs of R rows x 128 bytes, chunk
// (ch % 8) of a row at (ch % 8) ^ (r % 8)
template <int R>
__device__ __forceinline__ uint32_t sw128(int r, int ch) {
  return (ch >> 3) * (R * 128) + r * 128 + ((((ch & 7) ^ (r & 7))) << 4);
}

// order this thread's generic-proxy writes to shared memory (cp.async,
// st.shared) before the async proxy's wgmma reads of them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma m64nNk16, f32 += bf16 * bf16.  _ss: A and B from shared memory,
// both K-major.  _rs: A from registers (4 x bf16x2 a thread), B from shared
// memory MN-major (the transpose-B bit set).  accumulate == 0 overwrites d.
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void mma_ss_n128(float (&d)[64], uint64_t da,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void mma_rs_n64(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}
__device__ __forceinline__ void mma_rs_n128(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, "
      "1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}
__device__ __forceinline__ void mma_rs_n256(float (&d)[128],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, "
      "%71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, "
      "%85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, "
      "%99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, "
      "%121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, "
      "%132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t da,
                                       uint64_t db, int accumulate) {
  if constexpr (N == 64) mma_ss_n64(d, da, db, accumulate);
  else mma_ss_n128(d, da, db, accumulate);
}
template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 64) mma_rs_n64(d, a, db, 1);
  else if constexpr (N == 128) mma_rs_n128(d, a, db, 1);
  else mma_rs_n256(d, a, db, 1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// KV tiles that hold a visible key for at least one of packed rows
// r_lo..r_hi: [begin, begin + n * BK)
struct Tiles {
  int begin, n;
};
__device__ __forceinline__ Tiles kv_tiles(int r_lo, int r_hi, int group,
                                          int shift, int skv, int causal,
                                          int window, int bk) {
  const int p_lo = r_lo / group + shift, p_hi = r_hi / group + shift;
  const int end = causal ? min(skv, p_hi + 1) : skv;
  int begin = window > 0 ? max(0, p_lo - window + 1) : 0;
  begin = (begin / bk) * bk;
  return {begin, end > begin ? (end - begin + bk - 1) / bk : 0};
}

// shared memory: the Q tile, ST K tiles, ST V tiles (each 1024-byte
// aligned, the swizzle's period, from the 1024-aligned base of dynamic
// shared memory), then 3 * ST mbarriers
template <int D, int BK>
struct Smem {
  static constexpr int HDP = padded<D>();
  static constexpr int Q_TILE = ROWS * HDP * 2;
  static constexpr int KV_TILE = BK * HDP * 2;
  static constexpr int K_OFF = Q_TILE;
  static constexpr int V_OFF = K_OFF + ST * KV_TILE;
  static constexpr int BAR_OFF = V_OFF + ST * KV_TILE;
  static constexpr size_t BYTES = BAR_OFF + 3 * ST * 8;
  static_assert(BYTES <= 232448, "more than a Hopper block's 227 KB");
};

// The rows of one thread in the wgmma fragment (ra and ra + 8): the keys
// each may see, kp in (lo, hi], as plain compares (no division per key)
struct RowLimits {
  int hi_a, lo_a, hi_b, lo_b;
};

// 2^x on the special-function unit (ex2.approx: 2 ulp; no range fixups,
// which x <= 0 never needs)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Scale (float32, log2 e folded in), mask (edge tiles only), online
// softmax of one tile's S in place: s becomes p (float32); m and l move
// on; corr is what the accumulator must be multiplied by
template <int BK, bool MASK>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], float& m_a,
                                             float& m_b, float& l_a,
                                             float& l_b, float& corr_a,
                                             float& corr_b, int kv0, int c2,
                                             RowLimits lim,
                                             float scale_log2) {
  float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
  for (int i = 0; i < BK / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float x = s[4 * i + j] * scale_log2;
      if (MASK) {
        const int kp = kv0 + 8 * i + c2 + (j & 1);
        const bool ok = j < 2 ? (kp <= lim.hi_a && kp > lim.lo_a)
                              : (kp <= lim.hi_b && kp > lim.lo_b);
        x = ok ? x : NEG_INF;
      }
      s[4 * i + j] = x;
      if (j < 2) mx_a = fmaxf(mx_a, x);
      else mx_b = fmaxf(mx_b, x);
    }
  mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
  mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
  mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
  mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
  const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
  corr_a = ex2(m_a - mn_a);
  corr_b = ex2(m_b - mn_b);
  m_a = mn_a;
  m_b = mn_b;
  float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float p = ex2(s[4 * i + j] - (j < 2 ? mn_a : mn_b));
      s[4 * i + j] = p;
      if (j < 2) sum_a += p;
      else sum_b += p;
    }
  sum_a += __shfl_xor_sync(0xffffffffu, sum_a, 1);
  sum_a += __shfl_xor_sync(0xffffffffu, sum_a, 2);
  sum_b += __shfl_xor_sync(0xffffffffu, sum_b, 1);
  sum_b += __shfl_xor_sync(0xffffffffu, sum_b, 2);
  l_a = l_a * corr_a + sum_a;
  l_b = l_b * corr_b + sum_b;
}

// D: head_dim (16, 64, 128, 256); BK: KV rows a tile.  Threads 0..127 are
// the consumer warpgroup, the last warp the producer.
template <int D, int BK>
__global__ void __launch_bounds__(NT, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const bf16* __restrict__ q, bf16* __restrict__ o, Strides qs,
                Strides os, int KVH, int group, int sq, int skv, int causal,
                int window, float scale_log2) {
  using L = Smem<D, BK>;
  constexpr int HDP = L::HDP;
  constexpr int CH = D / 8;         // 16-byte chunks of a row in global
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t base = smem_u32(smem);
  const uint32_t s_k = base + L::K_OFF, s_v = base + L::V_OFF;
  const uint32_t bars = base + L::BAR_OFF;
  auto full_k = [&](int i) { return bars + 8 * i; };
  auto full_v = [&](int i) { return bars + 8 * (ST + i); };
  auto empty = [&](int i) { return bars + 8 * (2 * ST + i); };

  const int tid = threadIdx.x;
  const int b = blockIdx.y / KVH, kh = blockIdx.y % KVH;
  const int row0 = blockIdx.x * ROWS;
  const int rows_total = sq * group;
  const int shift = skv - sq;       // q aligned to the KV end
  const int row_hi = min(row0 + ROWS, rows_total) - 1;
  const Tiles cta = kv_tiles(row0, row_hi, group, shift, skv, causal,
                             window, BK);

  if (tid == 0) {
    if (base & 1023) asm volatile("trap;");  // the swizzle needs it
    for (int i = 0; i < ST; ++i) {
      mbar_init(full_k(i), 1);
      mbar_init(full_v(i), 1);
      mbar_init(empty(i), 4);         // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // ---- producer: one thread keeps the ring full, K before V
  if (tid >= 128) {
    if (tid == 128) {
      for (int t = 0; t < cta.n; ++t) {
        const int st = t % ST, kv0 = cta.begin + t * BK;
        if (t >= ST) mbar_wait(empty(st), (t / ST - 1) & 1);
        mbar_expect_tx(full_k(st), L::KV_TILE);
#pragma unroll
        for (int c = 0; c < HDP / 64; ++c)
          tma_load(s_k + st * L::KV_TILE + c * BK * 128, &tk, 64 * c, kh,
                   kv0, b, full_k(st));
        mbar_expect_tx(full_v(st), L::KV_TILE);
#pragma unroll
        for (int c = 0; c < HDP / 64; ++c)
          tma_load(s_v + st * L::KV_TILE + c * BK * 128, &tv, 64 * c, kh,
                   kv0, b, full_v(st));
      }
    }
    return;
  }

  // ---- the consumer warpgroup: packed rows row0 .. row0 + 63
  const int warp = tid >> 5, lane = tid & 31;
  const uint32_t s_q = base;
  const bf16* qb = q + b * qs.b + (int64_t)kh * group * qs.h;
  for (int i = tid; i < ROWS * CH; i += 128) {
    const int r = i / CH, ch = i % CH, pr = row0 + r;
    const int pos = pr / group, hq = pr - pos * group;
    const bool ok = pr < rows_total;
    const bf16* src = ok ? qb + pos * qs.s + hq * qs.h + ch * 8 : q;
    cp_async16(s_q + sw128<ROWS>(r, ch), src, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  asm volatile("bar.sync 1, 128;\n" ::: "memory");  // Q is in, warpgroup

  const int p_lo = row0 / group + shift, p_hi = row_hi / group + shift;
  // this thread's two rows of the wgmma fragment: ra and ra + 8
  const int ra = 16 * warp + (lane >> 2);
  RowLimits lim;
  {
    const int pos_a = (row0 + ra) / group + shift;
    const int pos_b = (row0 + ra + 8) / group + shift;
    lim.hi_a = causal ? min(pos_a, skv - 1) : skv - 1;
    lim.hi_b = causal ? min(pos_b, skv - 1) : skv - 1;
    lim.lo_a = window > 0 ? pos_a - window : -1;
    lim.lo_b = window > 0 ? pos_b - window : -1;
  }
  const int c2 = 2 * (lane & 3);    // the fragment's first column
  auto is_edge = [&](int kv0) {
    return kv0 + BK > skv || (causal && kv0 + BK - 1 > p_lo) ||
           (window > 0 && kv0 <= p_hi - window);
  };
  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;
  float corr_a, corr_b;
  // descriptors: a byte offset moves the start address field (addr >> 4)
  const uint64_t dq = desc_sw128(s_q, 16, 1024);
  const uint64_t dk = desc_sw128(s_k, 16, 1024);
  const uint64_t dv = desc_sw128(s_v, BK * 128, 1024);
  // S = Q . K^T of the tile in stage st, D / 16 k steps (not waited)
  auto issue_s = [&](float (&s)[BK / 2], int st) {
    const uint64_t dks = dk + st * (L::KV_TILE >> 4);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int off = (kk & 3) * 32;        // 16 columns a step
      mma_ss<BK>(s, dq + (((kk >> 2) * (ROWS * 128) + off) >> 4),
                 dks + (((kk >> 2) * (BK * 128) + off) >> 4), kk > 0);
    }
  };
  // O += P . V of the tile in stage st, BK / 16 k steps (not waited)
  auto issue_pv = [&](float (&acc)[HDP / 2], const uint32_t (&pf)[BK / 16][4],
                      int st) {
    const uint64_t dvs = dv + st * (L::KV_TILE >> 4);
#pragma unroll
    for (int j = 0; j < BK / 16; ++j)
      mma_rs<HDP>(acc, pf[j], dvs + ((j * 16 * 128) >> 4));
  };
  auto softmax = [&](float (&s)[BK / 2], int kv0) {
    if (is_edge(kv0))
      softmax_tile<BK, true>(s, m_a, m_b, l_a, l_b, corr_a, corr_b, kv0, c2,
                             lim, scale_log2);
    else
      softmax_tile<BK, false>(s, m_a, m_b, l_a, l_b, corr_a, corr_b, kv0,
                              c2, lim, scale_log2);
  };
  // P to bf16: columns 16j..16j+15 of the accumulator fragment are k step
  // j's register-A fragment
  auto pack = [&](uint32_t (&pf)[BK / 16][4], const float (&s)[BK / 2]) {
#pragma unroll
    for (int j = 0; j < BK / 16; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pf[j][r] = pack_bf16(s[8 * j + 2 * r], s[8 * j + 2 * r + 1]);
  };

  float acc[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) acc[i] = 0.f;
  float s[BK / 2];
  uint32_t pf[BK / 16][4];

  // Software pipeline over the tiles: S of tile t is in the tensor cores
  // while P . V of tile t - 1 follows it; the softmax of tile t overlaps
  // that P . V, and only the rescale of O waits for it.
  if (cta.n > 0) {
    mbar_wait(full_k(0), 0);
    wgmma_fence();
    issue_s(s, 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    softmax(s, cta.begin);
    pack(pf, s);
  }
  for (int t = 1; t < cta.n; ++t) {
    const int st = t % ST, prev = (t - 1) % ST;
    const int kv0 = cta.begin + t * BK;
    mbar_wait(full_k(st), (t / ST) & 1);
    wgmma_fence();
    issue_s(s, st);
    wgmma_commit();
    mbar_wait(full_v(prev), ((t - 1) / ST) & 1);
    issue_pv(acc, pf, prev);
    wgmma_commit();
    wgmma_wait<1>();                // S of tile t is in
    fence_regs(s);
    softmax(s, kv0);
    wgmma_wait<0>();                // P . V of tile t - 1 is in
    fence_regs(acc);
    fence_regs(pf);
    if (lane == 0) mbar_arrive(empty(prev));
#pragma unroll
    for (int i = 0; i < HDP / 8; ++i) {
      acc[4 * i] *= corr_a;
      acc[4 * i + 1] *= corr_a;
      acc[4 * i + 2] *= corr_b;
      acc[4 * i + 3] *= corr_b;
    }
    pack(pf, s);
  }
  if (cta.n > 0) {
    const int last = (cta.n - 1) % ST;
    mbar_wait(full_v(last), ((cta.n - 1) / ST) & 1);
    wgmma_fence();
    issue_pv(acc, pf, last);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pf);
  }

  // O / max(l, 1e-30), bf16, rows past the last position not written
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int pr = row0 + ra + 8 * half;
    if (pr >= rows_total) continue;
    const int pos = pr / group, h = kh * group + pr - pos * group;
    bf16* ob = o + b * os.b + pos * os.s + h * os.h;
    const float inv = 1.f / fmaxf(half ? l_b : l_a, 1e-30f);
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const __nv_bfloat162 val = __floats2bfloat162_rn(
          acc[4 * i + 2 * half] * inv, acc[4 * i + 2 * half + 1] * inv);
      *reinterpret_cast<__nv_bfloat162*>(ob + 8 * i + c2) = val;
    }
  }
}

// ---- host: the K and V tensor maps (hopper::encoder), and the launch
// (hd, heads, seq, batch) with the caller's strides; a box of 64 columns
// (zero-filled past hd), one head, bk rows (zero-filled past seq), one
// batch row, stored with the 128-byte swizzle
cudaError_t kv_map(CUtensorMap* map, const void* ptr, Strides st, int hd,
                   int heads, int seq, int batch, int bk) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)seq, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)st.h * 2, (cuuint64_t)st.s * 2,
                                 (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)bk, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = enc(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D, int BK>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   Strides qs, Strides ks, Strides vs, Strides os, int B,
                   int KVH, int group, int sq, int skv, int causal,
                   int window, float scale, cudaStream_t stream) {
  auto kern = flash_tc_kernel<D, BK>;
  constexpr size_t smem = Smem<D, BK>::BYTES;
  static const cudaError_t set = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (set != cudaSuccess) return set;
  CUtensorMap tk, tv;
  cudaError_t e = kv_map(&tk, k, ks, D, KVH, skv, B, BK);
  if (e == cudaSuccess) e = kv_map(&tv, v, vs, D, KVH, skv, B, BK);
  if (e != cudaSuccess) return e;
  const dim3 grid((sq * group + ROWS - 1) / ROWS, B * KVH);
  kern<<<grid, NT, smem, stream>>>(
      tk, tv, static_cast<const bf16*>(q), static_cast<bf16*>(o), qs, os,
      KVH, group, sq, skv, causal, window, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace tc

// 16-byte copies where every base is 16-byte aligned and every stride a
// multiple of 4 floats (the models' layouts), else element loads
bool aligned16(const void* p, Strides st) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st.b % 4 == 0 &&
         st.s % 4 == 0 && st.h % 4 == 0;
}

cudaError_t launch_simt(int hd, const void* q, const void* k, const void* v,
                        void* o, Strides qs, Strides ks, Strides vs,
                        Strides os, int B, int KVH, int group, int sq,
                        int skv, int causal, int window, float scale,
                        cudaStream_t st) {
  const bool vec = aligned16(q, qs) && aligned16(k, ks) &&
                   aligned16(v, vs) && aligned16(o, os);
#define FLASH_SIMT(D)                                                        \
  if (hd == D)                                                               \
    return vec ? simt::launch<D, true>(q, k, v, o, qs, ks, vs, os, B, KVH,   \
                                       group, sq, skv, causal, window,       \
                                       scale, st)                            \
               : simt::launch<D, false>(q, k, v, o, qs, ks, vs, os, B, KVH,  \
                                        group, sq, skv, causal, window,      \
                                        scale, st);
  FLASH_SIMT(16)
  FLASH_SIMT(64)
  FLASH_SIMT(128)
  FLASH_SIMT(256)
#undef FLASH_SIMT
  return cudaErrorInvalidValue;
}

cudaError_t launch_tc(int hd, const void* q, const void* k, const void* v,
                      void* o, Strides qs, Strides ks, Strides vs,
                      Strides os, int B, int KVH, int group, int sq, int skv,
                      int causal, int window, float scale, cudaStream_t st) {
#define FLASH_TC(D, BK)                                                     \
  if (hd == D)                                                              \
    return tc::launch<D, BK>(q, k, v, o, qs, ks, vs, os, B, KVH, group, sq, \
                             skv, causal, window, scale, st);
  FLASH_TC(16, 128)
  FLASH_TC(64, 128)
  FLASH_TC(128, 64)
  FLASH_TC(256, 64)
#undef FLASH_TC
  return cudaErrorInvalidValue;
}

}  // namespace

// q: (B, Sq, H, hd), k / v: (B, Skv, KVH, hd), o: (B, Sq, H, hd), each given
// by its (batch, seq, head) element strides with a unit head_dim stride.
// dtype: 0 = float32 (SIMT route), 1 = bfloat16 (tensor-core route).
// Returns cudaGetLastError() after the launch.
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
    return launch_simt(hd, q, k, v, o, qs, ks, vs, os, B, KVH, H / KVH, sq,
                       skv, causal, window, scale, st);
  if (dtype == 1)
    return launch_tc(hd, q, k, v, o, qs, ks, vs, os, B, KVH, H / KVH, sq,
                     skv, causal, window, scale, st);
  return cudaErrorInvalidValue;
}
