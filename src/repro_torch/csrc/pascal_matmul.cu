// Pascal output-stationary matmul for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/pascal_matmul/kernel.py
// (_matmul_kernel, launched by pascal_matmul_raw).  Same function:
// out = x (M, K) @ w (K, N), x and w of one dtype (float32 or bfloat16),
// the sum in float32, the output in x's dtype.  The TPU grid walks K
// innermost over one float32 VMEM accumulator per output tile; ops.py pads
// every dim to a block multiple.  Here the kernels mask the ragged M, N and
// K edges themselves, so nothing is padded.
//
// Two routes, chosen in the C entry by dtype, K, N and alignment (never by
// M, so a row's route is the same in a product of one row and of many):
//
// bfloat16 with K and N multiples of 8 and x, w, out 16-byte aligned ->
// tc::pascal_tc_kernel, on the tensor cores.  A CTA owns a 128 x 128
// output tile: two consumer warpgroups of 64 rows each and one producer
// warp.  The producer keeps a 4-stage ring of (x tile 128 x 64, w tile
// 64 x 128) in shared memory full by TMA (2-D tensor maps, 128-byte
// swizzle, zero fill past M, N and K) through full/empty mbarriers; the
// consumers run wgmma m64n128k16 with both operands in shared memory: x
// K-major as it lies, w (K, N) row-major as it lies, which is MN-major for
// wgmma (the transpose-B bit; two 64-column slabs of the 128-byte
// swizzle).  float32 accumulators stay in registers; the epilogue rounds
// to bf16.  At M = 200, N = 8192: 64 x 2 = 128 CTAs, one wave.
//
// Every other case (float32, the LSTM stack's dtype; bf16 shapes TMA cannot
// address) -> simt::pascal_simt_kernel, SIMT FMAs, no TF32.  A CTA of 256
// threads owns a 128 x 128 output tile, a thread an 8 x 8 register
// micro-tile (8 contiguous rows; columns 4 tx .. 4 tx + 3 and 64 + 4 tx ..
// 64 + 4 tx + 3).  K streams through a 2-stage shared-memory ring of
// BK = 32: 16-byte cp.async copies where K and N are multiples of 4 and
// the pointers 16-byte aligned (float32 on the main path), else element
// loads widened to float32 on the way in; one __syncthreads a stage, the
// next stage's copies in flight under this one's FMAs.  x's tile keeps its
// rows (K contiguous, read 4 k at a time) with its 16-byte chunks
// XOR-swizzled by row group, so a warp's row groups read distinct bank
// groups.  A warp whose 16 rows all lie past M skips the products.  At
// M = 200: 64 x 2 = 128 CTAs, one wave.
//
// Rounding.  Every output's k-reduction runs k-tiles in increasing order:
// no split-K, no tile size chosen by M, so a row's result depends on that
// row of x and on w only, and a product of one row equals that row of a
// product of many, bit for bit, in both routes (the LSTM layer's carried
// single steps rely on it).  On the SIMT route each output is one thread's
// fmaf chain over k = 0 .. K-1; the plain version sums in the same order
// with a separate multiply and add, so float32 outputs agree to a few
// roundings.  The tensor cores sum each k16 step in their own fixed order.
//
// What bounds it.  At the LSTM stack's hoisted input GEMM (M = B T = 200,
// K = 2048, N = 8192) in float32: operations, 6.7 GFLOP on the float32
// units (100 us at 67 TFLOP/s) against 75 MB (22 us at 3.35 TB/s); the
// busiest SM does a full 128 x 128 tile's 33.5 M FMAs where an even spread
// over 132 SMs would give it 25.4 M, so 1.3x the bound at best.  In bf16:
// bytes, 37.6 MB (11 us at 3.35 TB/s) against 6.8 us of tensor-core
// operations; each CTA also streams its 1 MB of x and w tiles from L2.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

// ------------------------------------------------ the SIMT route (float32)
namespace simt {

constexpr int BM = 128;      // output rows a CTA
constexpr int BN = 128;      // output columns a CTA
constexpr int BK = 32;       // K a stage
constexpr int ST = 2;        // stages in the ring
constexpr int TN = 8;        // columns of a thread's micro-tile
constexpr int TXN = BN / TN; // threads across the columns
constexpr int NT = BM / 8 * TXN;   // threads: rows of 8 x columns of TN
constexpr int WROWS = 8 * 32 / TXN;  // output rows of a warp
constexpr int X_STAGE = BM * BK;     // floats of x a stage
constexpr int W_STAGE = BK * BN;     // floats of w a stage
constexpr size_t SMEM = sizeof(float) * ST * (X_STAGE + W_STAGE);
static_assert(SMEM <= 232448, "more than a Hopper block's 227 KB");

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

// float offset of k-chunk c (4 floats) of row m in an x stage: rows of BK
// floats, the chunk swizzled by the row's group of 8
__device__ __forceinline__ int xs_at(int m, int c) {
  return m * BK + ((c ^ ((m >> 3) & 3)) << 2);
}

// stage s <- x[m0.., k0..] (BM x BK) and w[k0.., n0..] (BK x BN), zeros
// past M, N and K.  VEC: 16-byte cp.async (K % 4 == 0, N % 4 == 0, aligned
// pointers); else element loads widened to float32
template <typename T, bool VEC>
__device__ __forceinline__ void load_stage(const T* __restrict__ x,
                                           const T* __restrict__ w,
                                           float* xs, float* ws, int m0,
                                           int n0, int k0, int M, int N,
                                           int K) {
  const int tid = threadIdx.x;
  if (VEC) {
#pragma unroll
    for (int j = 0; j < (BM * BK / 4 + NT - 1) / NT; ++j) {
      const int i = tid + j * NT, m = i / (BK / 4), c = i % (BK / 4);
      if (i >= BM * BK / 4) break;
      const int gm = m0 + m, gk = k0 + 4 * c;
      const bool ok = gm < M && gk < K;
      cp_async16(smem_u32(xs + xs_at(m, c)),
                 ok ? x + (int64_t)gm * K + gk : x, ok);
    }
#pragma unroll
    for (int j = 0; j < (BK * BN / 4 + NT - 1) / NT; ++j) {
      const int i = tid + j * NT, kk = i / (BN / 4), c = i % (BN / 4);
      if (i >= BK * BN / 4) break;
      const int gk = k0 + kk, gn = n0 + 4 * c;
      const bool ok = gk < K && gn < N;
      cp_async16(smem_u32(ws + kk * BN + 4 * c),
                 ok ? w + (int64_t)gk * N + gn : w, ok);
    }
  } else {
#pragma unroll 4
    for (int j = 0; j < (BM * BK + NT - 1) / NT; ++j) {
      const int i = tid + j * NT, m = i / BK, kk = i % BK;
      if (i >= BM * BK) break;
      const int gm = m0 + m, gk = k0 + kk;
      xs[xs_at(m, kk >> 2) + (kk & 3)] =
          gm < M && gk < K ? to_f(x[(int64_t)gm * K + gk]) : 0.f;
    }
#pragma unroll 4
    for (int j = 0; j < (BK * BN + NT - 1) / NT; ++j) {
      const int i = tid + j * NT, kk = i / BN, nn = i % BN;
      if (i >= BK * BN) break;
      const int gk = k0 + kk, gn = n0 + nn;
      ws[kk * BN + nn] =
          gk < K && gn < N ? to_f(w[(int64_t)gk * N + gn]) : 0.f;
    }
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(NT)
pascal_simt_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   T* __restrict__ out, int M, int N, int K) {
  extern __shared__ __align__(16) float smem_f[];
  float* xs = smem_f;                     // ST x stages of x, then of w
  float* ws = smem_f + ST * X_STAGE;
  const int tid = threadIdx.x;
  const int tx = tid % TXN, ty = tid / TXN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int sw = ty & 3;                  // (m >> 3) & 3 of this thread's rows
  // the warp's rows: all past M -> no FMAs
  const bool live = m0 + WROWS * (tid / 32) < M;
  const int nk = (K + BK - 1) / BK;
  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < nk)
      load_stage<T, VEC>(x, w, xs + s * X_STAGE, ws + s * W_STAGE, m0, n0,
                         s * BK, M, N, K);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<ST - 2>();              // this thread's copies of tile kt
    __syncthreads();                      // everyone's; tile kt - 1 is done
    const int pre = kt + ST - 1;          // into the stage tile kt - 1 held
    if (pre < nk)
      load_stage<T, VEC>(x, w, xs + pre % ST * X_STAGE,
                         ws + pre % ST * W_STAGE, m0, n0, pre * BK, M, N, K);
    cp_async_commit();
    if (!live) continue;
    const float* a_s = xs + kt % ST * X_STAGE;
    const float* b_s = ws + kt % ST * W_STAGE;
#pragma unroll
    for (int c = 0; c < BK / 4; ++c) {
      float a[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(
            a_s + (8 * ty + i) * BK + ((c ^ sw) << 2));
        a[i][0] = v.x; a[i][1] = v.y; a[i][2] = v.z; a[i][3] = v.w;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* brow = b_s + (4 * c + kk) * BN;
        float b[TN];
#pragma unroll
        for (int h = 0; h < TN / 4; ++h) {
          const float4 v =
              *reinterpret_cast<const float4*>(brow + BN / 2 * h + 4 * tx);
          b[4 * h] = v.x; b[4 * h + 1] = v.y; b[4 * h + 2] = v.z;
          b[4 * h + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = fmaf(a[i][kk], b[j], acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + 8 * ty + i;
    if (m >= M) continue;
    T* row = out + (int64_t)m * N;
#pragma unroll
    for (int h = 0; h < TN / 4; ++h) {
      const int n = n0 + BN / 2 * h + 4 * tx;
      if (VEC && n < N) {
        *reinterpret_cast<float4*>(row + n) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
      } else if (!VEC) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < N) row[n + j] = from_f<T>(acc[i][4 * h + j]);
      }
    }
  }
}

template <typename T, bool VEC>
cudaError_t launch(const void* x, const void* w, void* out, int M, int N,
                   int K, cudaStream_t stream) {
  auto kern = pascal_simt_kernel<T, VEC>;
  if (SMEM > 48 * 1024) {
    static const cudaError_t set = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
    if (set != cudaSuccess) return set;
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kern<<<grid, NT, SMEM, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(out), M, N, K);
  return cudaGetLastError();
}

}  // namespace simt

// ------------------------------------------- the tensor-core route (bf16)
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int BM = 128;                 // output rows a CTA: two warpgroups
constexpr int BN = 128;                 // output columns a CTA
constexpr int BK = 64;                  // K a stage: one 128-byte row of x
constexpr int ST = 4;                   // ring stages
constexpr int NT = 288;                 // two consumer warpgroups, a producer
constexpr int X_TILE = BM * BK * 2;     // 128 rows x 128 bytes, swizzled
constexpr int W_TILE = BK * BN * 2;     // two 64-column slabs of BK rows
constexpr int STAGE = X_TILE + W_TILE;
constexpr int BAR_OFF = ST * STAGE;
constexpr size_t SMEM = BAR_OFF + 2 * ST * 8;
static_assert(SMEM <= 232448, "more than a Hopper block's 227 KB");

// wgmma m64n128k16, f32 += bf16 * bf16, A and B from shared memory: A
// K-major, B MN-major (the transpose-B bit)
__device__ __forceinline__ void mma_ss_n128_tb(float (&d)[64], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n}\n"
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
      : "l"(da), "l"(db), "r"(1));
}

// Threads 0..255 are the consumer warpgroups (rows 64 wg .. 64 wg + 63 of
// the tile), the last warp the producer.
__global__ void __launch_bounds__(NT, 1)
pascal_tc_kernel(const __grid_constant__ CUtensorMap tx,
                 const __grid_constant__ CUtensorMap tw,
                 bf16* __restrict__ out, int M, int N, int K) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t base = smem_u32(smem);
  const uint32_t bars = base + BAR_OFF;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (ST + s); };
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = (K + BK - 1) / BK;

  if (tid == 0) {
    if (base & 1023) asm volatile("trap;");  // the swizzle needs it
    for (int s = 0; s < ST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);               // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // ---- producer: one thread keeps the ring full
  if (tid >= 256) {
    if (tid == 256) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % ST;
        const uint32_t st = base + s * STAGE;
        if (kt >= ST) mbar_wait(empty(s), (kt / ST - 1) & 1);
        mbar_expect_tx(full(s), STAGE);
        tma_load_2d(st, &tx, kt * BK, m0, full(s));
        tma_load_2d(st + X_TILE, &tw, n0, kt * BK, full(s));
        tma_load_2d(st + X_TILE + BK * 128, &tw, n0 + 64, kt * BK, full(s));
      }
    }
    return;
  }

  // ---- consumers
  const int wg = tid / 128, warp = tid / 32, lane = tid % 32;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  // descriptors: a byte offset moves the start address field (addr >> 4)
  const uint64_t dx = desc_sw128(base + wg * 64 * 128, 16, 1024);
  const uint64_t dw = desc_sw128(base + X_TILE, BK * 128, 1024);
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % ST;
    mbar_wait(full(s), (kt / ST) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      mma_ss_n128_tb(acc, dx + ((s * STAGE + kk * 32) >> 4),
                     dw + ((s * STAGE + kk * 16 * 128) >> 4));
    wgmma_commit();
    wgmma_wait<1>();                      // tile kt - 1's products are done
    fence_regs(acc);
    if (kt > 0 && lane == 0) mbar_arrive(empty((kt - 1) % ST));
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // bf16 out; rows past M and columns past N not written
  const int ra = 16 * (warp % 4) + (lane >> 2), c2 = 2 * (lane & 3);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = m0 + 64 * wg + ra + 8 * half;
    if (m >= M) continue;
    bf16* row = out + (int64_t)m * N;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int n = n0 + 8 * i + c2;
      if (n < N)
        *reinterpret_cast<__nv_bfloat162*>(row + n) = __floats2bfloat162_rn(
            acc[4 * i + 2 * half], acc[4 * i + 2 * half + 1]);
    }
  }
}

// a row-major (rows, cols) bf16 matrix as a 2-D tensor map: boxes of
// box_cols (64: 128 bytes) x box_rows, 128-byte swizzle, zeros past the edge
cudaError_t map_2d(CUtensorMap* map, const void* ptr, int rows, int cols,
                   int box_rows) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = enc(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

cudaError_t launch(const void* x, const void* w, void* out, int M, int N,
                   int K, cudaStream_t stream) {
  static const cudaError_t set = cudaFuncSetAttribute(
      pascal_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM);
  if (set != cudaSuccess) return set;
  CUtensorMap tx, tw;
  cudaError_t e = map_2d(&tx, x, M, K, BM);
  if (e == cudaSuccess) e = map_2d(&tw, w, K, N, BK);
  if (e != cudaSuccess) return e;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  pascal_tc_kernel<<<grid, NT, SMEM, stream>>>(tx, tw, static_cast<bf16*>(out),
                                               M, N, K);
  return cudaGetLastError();
}

}  // namespace tc

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// x: contiguous (M, K), w: contiguous (K, N), out: (M, N), all of one dtype
// (0 = float32, 1 = bfloat16).  The route is chosen here, by dtype, K, N
// and alignment, never by M.  Returns cudaGetLastError() after the launch.
extern "C" int pascal_matmul_fwd(const void* x, const void* w, void* out,
                                 int dtype, int M, int N, int K,
                                 void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || (M + simt::BM - 1) / simt::BM > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool aligned = aligned16(x) && aligned16(w) && aligned16(out);
  if (dtype == 0) {
    if (aligned && K % 4 == 0 && N % 4 == 0)
      return simt::launch<float, true>(x, w, out, M, N, K, st);
    return simt::launch<float, false>(x, w, out, M, N, K, st);
  }
  if (dtype == 1) {
    if (aligned && K % 8 == 0 && N % 8 == 0)
      return tc::launch(x, w, out, M, N, K, st);
    return simt::launch<__nv_bfloat16, false>(x, w, out, M, N, K, st);
  }
  return cudaErrorInvalidValue;
}
