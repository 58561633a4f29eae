// The FMA GEMMs, f32 only: the f32 tiled GEMM with a fused epilogue, the
// int8-weight GEMM with f32 activations, and the dual-GEMM SwiGLU kernel
// in f32. Their bf16 instances, the main paths', run on the tensor cores
// in matmul_tc.cuh (mma.sync and wgmma).
//
// Replaces the f32 instances of the Pallas kernels `matmul_tiled`
// (_matmul_kernel), `matmul_q_tiled` (_matmul_q_kernel) and
// `gated_matmul_tiled` (_gated_matmul_kernel) of
// src/repro/kernels/matmul.py. They stay on the FMA units on purpose: the
// f32 GEMM is Table 2's f32 "tiled" route (the paper's Listing 4, the
// shared-memory kernel that Fig 8 measures), and the depth-2 f32 train
// and Mamba-2 steps are held to the CPU at rtol 1e-4, which TF32 would
// not meet.
//
// Bound: operations. A 4096^2 f32 GEMM is 137.4 GFLOP, 2.051 ms at the
// H100's 67 TFLOP/s of f32 FMA; its bytes take 0.06 ms. So the kernel has
// to keep the FMA pipes issuing: every other instruction (shared-memory
// loads, address arithmetic, waits on device memory) is time lost.
//
// Two tiles, picked by `f32_tile_plan` (kernels/matmul.py):
// - the wide tile, from 128 rows where its grid has a block for half the
//   SMs at least: 128x128 outputs a block of 256 threads, 8x8 a thread as 2x2
//   sub-tiles of 4x4 (rows 4 ty + {0..3, 64..67}, cols 4 tx + {0..3,
//   64..67}; a warp is 4 x 8 threads), a k-step of 16, two blocks an SM.
//   A and B are staged k-major (As[k][m], Bs[k][n]), so a thread reads
//   its 8 rows and 8 columns of one k with four 16-byte loads, which a
//   warp takes without a bank conflict: 4 loads for 64 FMAs (the 64x64
//   tile: 5 for 16). Stage k + 1 is fetched while stage k computes (two
//   buffers, one barrier a stage): an operand that lies k-major in
//   memory (B as [K, N], A as a [K, M] view) by 16-byte cp.async straight
//   into shared memory; one that must be transposed (A as [M, K], B as an
//   [N, K] view) by 16-byte loads into registers, stored after the FMAs
//   of stage k. An operand whose rows are not 16-byte aligned (offset
//   views, a leading dim not a multiple of 4) takes the same path element
//   by element (4-byte cp.async or scalar loads).
// - the 64x64 tile, for small M and N (decode, a few hundred rows at a
//   model's widths), where 128x128 blocks would leave SMs idle: 256
//   threads, 4x4 outputs a thread (rows ty + 16 i, cols tx + 16 j), a
//   k-step of 32, one synchronous stage between two barriers, the
//   multiply-adds of rows past M skipped. The int8-weight GEMM and the
//   dual GEMM keep this body in f32: no timed path runs them.
//
// Both tiles sum each output as acc = fmaf(a[k], b[k], acc) from 0, over
// k in ascending order (the zero fill past K adds +0, which changes no
// sum): no split of K, no atomic. So an output has the same bits in
// either tile, at any M, in any layout. The epilogue is applied once, on
// the f32 accumulator, at the flush: none | bias | bias_gelu (tanh
// form) | bias_silu | residual, then one rounding to the output type. The
// int8 variant (`matmul_q`) stages an int8 [K, N] B tile, widened to f32
// (|q| <= 127 is exact), and multiplies the per-channel f32 scale onto
// the accumulator at the flush, before the epilogue. The gated kernel
// stages one A tile against two [K, N] weight tiles, keeps two
// accumulators, and stores silu(g) * u without ever writing g or u.
//
// Edges are masked in the kernel (no padding on the host). The f32 GEMM
// reads B either as [K, N] row-major or as [N, K] (`b_nk`) and A either as
// [M, K] row-major or as [K, M] (`a_km`); the int8 B is [K, N].
//
// The batched forms of the f32 GEMM and the dual GEMM (the MoE expert
// banks, the vmapped Pallas kernels' counterpart: a bank of E matrices,
// one launch for all) run expert blockIdx.z's operands through the same
// tile, so an expert's output is the 2-D kernel's on its operands, bit for
// bit. The batched GEMM reads each bank in either layout of the 2-D GEMM
// (the banks' backward: g B^T and A^T g), the dual GEMM row-major banks.
// They serve the f32 checks of the moe family on the card.

#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

using repro::from_f32;
using repro::to_f32;

constexpr int BM = 64, BN = 64, BK = 32, THREADS = 256;
constexpr int TM = 4, TN = 4;  // a thread owns rows ty + 16 i, cols tx + 16 j

enum Epilogue { EP_NONE = 0, EP_BIAS = 1, EP_BIAS_GELU = 2, EP_BIAS_SILU = 3, EP_RESIDUAL = 4 };

__device__ __forceinline__ float silu(float x) { return x / (1.0f + expf(-x)); }

__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.0f + tanhf(c * (x + 0.044715f * x * x * x)));
}

__device__ __forceinline__ float load_any(const void* p, int is_bf16, long long i) {
  return is_bf16 ? to_f32(static_cast<const __nv_bfloat16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

// The epilogue of output (gm, gn) on its f32 sum v.
__device__ __forceinline__ float finish(float v, const void* E, int e_bf16, long long lde,
                                        int epilogue, int gm, int gn) {
  if (epilogue == EP_RESIDUAL) {
    v += load_any(E, e_bf16, (long long)gm * lde + gn);
  } else if (epilogue != EP_NONE) {
    v += load_any(E, e_bf16, gn);
    if (epilogue == EP_BIAS_GELU) v = gelu_tanh(v);
    else if (epilogue == EP_BIAS_SILU) v = silu(v);
  }
  return v;
}

template <typename TIn, bool KM = false>
__device__ __forceinline__ void load_a(float (*As)[BK + 1], const TIn* A, int M, int K,
                                       long long lda, int m0, int k0, int tid) {
#pragma unroll
  for (int i = 0; i < BM * BK / THREADS; ++i) {
    const int idx = tid + i * THREADS;
    // consecutive threads walk the contiguous dim of A in either layout
    const int m = KM ? idx % BM : idx / BK;
    const int k = KM ? idx / BM : idx % BK;
    const int gm = m0 + m, gk = k0 + k;
    float x = 0.f;
    if (gm < M && gk < K) x = to_f32(KM ? A[(long long)gk * lda + gm] : A[(long long)gm * lda + gk]);
    As[m][k] = x;
  }
}

template <typename TB, bool NK>
__device__ __forceinline__ void load_b(float (*Bs)[BN + 1], const TB* B, int N, int K,
                                       long long ldb, int n0, int k0, int tid) {
#pragma unroll
  for (int i = 0; i < BN * BK / THREADS; ++i) {
    const int idx = tid + i * THREADS;
    // consecutive threads walk the contiguous dim of B in either layout
    const int k = NK ? idx % BK : idx / BN;
    const int n = NK ? idx / BK : idx % BN;
    const int gn = n0 + n, gk = k0 + k;
    float x = 0.f;
    if (gn < N && gk < K) x = to_f32(NK ? B[(long long)gn * ldb + gk] : B[(long long)gk * ldb + gn]);
    Bs[k][n] = x;
  }
}

// TB: B's element type (TIn, or int8_t with the per-channel scale S).
// NK: B is [N, K]; KM: A is [K, M].
template <typename TIn, typename TB, typename TOut, bool NK, bool KM>
__device__ __forceinline__ void matmul_tile(const TIn* __restrict__ A, const TB* __restrict__ B,
                                            const float* __restrict__ S,
                                            const void* __restrict__ E, TOut* __restrict__ C,
                                            int M, int N, int K, long long lda, long long ldb,
                                            long long lde, int e_bf16, int epilogue) {
  __shared__ float As[BM][BK + 1];
  __shared__ float Bs[BK][BN + 1];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  // rows of this thread that exist: skip the multiply-adds of rows past M
  const int rows = max(0, min(TM, (M - m0 - ty + 15) / 16));

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    load_a<TIn, KM>(As, A, M, K, lda, m0, k0, tid);
    load_b<TB, NK>(Bs, B, N, K, ldb, n0, k0, tid);
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float b[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        if (i < rows) {
          const float a = As[ty + 16 * i][kk];
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a, b[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn >= N) continue;
      float v = acc[i][j];
      if (S != nullptr) v *= S[gn];  // dequantize before the epilogue
      C[(long long)gm * N + gn] = from_f32<TOut>(finish(v, E, e_bf16, lde, epilogue, gm, gn));
    }
  }
}

template <typename TIn, typename TB, typename TOut, bool NK, bool KM>
__global__ void __launch_bounds__(THREADS)
matmul_kernel(const TIn* __restrict__ A, const TB* __restrict__ B, const float* __restrict__ S,
              const void* __restrict__ E, TOut* __restrict__ C, int M, int N, int K,
              long long lda, long long ldb, long long lde, int e_bf16, int epilogue) {
  matmul_tile<TIn, TB, TOut, NK, KM>(A, B, S, E, C, M, N, K, lda, ldb, lde, e_bf16, epilogue);
}

// The batched forms (the expert banks, f32, no epilogue): expert
// blockIdx.z's operands sa, sb (A, B and U) and M * N (C) elements on, the
// 2-D kernel's tile on them, in its layout (NK, KM).
template <bool NK, bool KM>
__global__ void __launch_bounds__(THREADS)
matmul_batched_kernel(const float* __restrict__ A, const float* __restrict__ B,
                      float* __restrict__ C, int M, int N, int K, long long lda, long long ldb,
                      long long sa, long long sb) {
  const long long z = blockIdx.z;
  matmul_tile<float, float, float, NK, KM>(A + z * sa, B + z * sb, nullptr, nullptr,
                                           C + z * M * N, M, N, K, lda, ldb, 0, 0, EP_NONE);
}

// ---- the wide tile: 128x128 outputs a block, 8x8 a thread, k-step 16 ----

constexpr int WB = 128, WBK = 16, WLD = WB + 4;  // WLD: a padded row of As/Bs
constexpr int WSTAGE = WBK * WLD;                // floats of one k-stage of A or B

// One k-stage of an operand that lies k-major (element (k, c) at
// X[k * ld + c]: B as [K, N], A as a [K, M] view): WBK rows of WB, copied
// as they lie by cp.async, 16 bytes at a time where `vec` (ld % 4 == 0
// and a 16-byte aligned base), else 4; zero past the edges.
__device__ __forceinline__ void stage_kmajor(float* S, const float* X, int extent, int K,
                                             long long ld, int c0, int k0, int tid, int vec) {
  if (vec) {
#pragma unroll
    for (int i = 0; i < WBK * WB / 4 / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int k = idx / (WB / 4), c = idx % (WB / 4) * 4;
      const int gk = k0 + k, gc = c0 + c;
      const int n = gk < K ? min(4, max(0, extent - gc)) : 0;
      repro::cp_async16(S + k * WLD + c, n > 0 ? X + (long long)gk * ld + gc : X, 4 * n);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < WBK * WB / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int k = idx / WB, c = idx % WB;
      const int gk = k0 + k, gc = c0 + c;
      const bool in = gk < K && gc < extent;
      repro::cp_async4(S + k * WLD + c, in ? X + (long long)gk * ld + gc : X, in ? 4 : 0);
    }
  }
}

// The same stage of an operand that lies c-major (element (k, c) at
// X[c * ld + k]: A as [M, K], B as an [N, K] view), fetched into
// registers (four consecutive k of two rows a thread, 16 bytes a load
// where `vec` and all four exist) ...
__device__ __forceinline__ void fetch_cmajor(float (&r)[2][4], const float* X, int extent, int K,
                                             long long ld, int c0, int k0, int tid, int vec) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = tid + i * THREADS;
    const int c = idx / (WBK / 4), k = idx % (WBK / 4) * 4;
    const int gc = c0 + c, gk = k0 + k;
    const float* p = X + (long long)gc * ld + gk;
    if (vec && gc < extent && gk + 3 < K) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p));
      r[i][0] = v.x, r[i][1] = v.y, r[i][2] = v.z, r[i][3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) r[i][j] = gc < extent && gk + j < K ? __ldg(p + j) : 0.f;
    }
  }
}

// ... and stored k-major once the stage before it has been used.
__device__ __forceinline__ void store_cmajor(float* S, const float (&r)[2][4], int tid) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = tid + i * THREADS;
    const int c = idx / (WBK / 4), k = idx % (WBK / 4) * 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) S[(k + j) * WLD + c] = r[i][j];
  }
}

// NK: B is [N, K]; KM: A is [K, M]. vec_a, vec_b: the operand's rows are
// 16-byte aligned.
template <typename TOut, bool NK, bool KM>
__device__ __forceinline__ void matmul_wide_tile(const float* __restrict__ A,
                                                 const float* __restrict__ B,
                                                 const void* __restrict__ E, TOut* __restrict__ C,
                                                 int M, int N, int K, long long lda,
                                                 long long ldb, long long lde, int e_bf16,
                                                 int epilogue, int vec_a, int vec_b) {
  __shared__ __align__(16) float As[2][WSTAGE];
  __shared__ __align__(16) float Bs[2][WSTAGE];
  // a warp is 4 x 8 threads: as fast as 2 x 16 on an H100 in three
  // layouts and 11% faster with A as [M, K] and B as [N, K]; with 2 x 16
  // ptxas spilled registers in two instances (experiments/probe_fma_kernels.py)
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tx = lane % 8 + 8 * (warp % 2), ty = lane / 8 + 4 * (warp / 2);
  const int m0 = blockIdx.y * WB, n0 = blockIdx.x * WB;
  float ra[2][4], rb[2][4];  // the next stage of a c-major operand

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // start stage t's copies into buffer t % 2; `settle` stores its
  // registers there
  auto fetch = [&](int t) {
    const int k0 = t * WBK;
    if constexpr (KM) stage_kmajor(As[t & 1], A, M, K, lda, m0, k0, tid, vec_a);
    else fetch_cmajor(ra, A, M, K, lda, m0, k0, tid, vec_a);
    if constexpr (NK) fetch_cmajor(rb, B, N, K, ldb, n0, k0, tid, vec_b);
    else stage_kmajor(Bs[t & 1], B, N, K, ldb, n0, k0, tid, vec_b);
    repro::cp_async_commit();
  };
  auto settle = [&](int t) {
    if constexpr (!KM) store_cmajor(As[t & 1], ra, tid);
    if constexpr (NK) store_cmajor(Bs[t & 1], rb, tid);
  };

  const int stages = (K + WBK - 1) / WBK;
  if (stages > 0) {
    fetch(0);
    settle(0);
  }
  for (int t = 0; t < stages; ++t) {
    repro::cp_async_wait<0>();
    __syncthreads();  // stage t is in; every thread is done with stage t - 1
    if (t + 1 < stages) fetch(t + 1);
    const float* as = As[t & 1];
    const float* bs = Bs[t & 1];
#pragma unroll
    for (int kk = 0; kk < WBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + kk * WLD + 4 * ty);
      const float4 a1 = *reinterpret_cast<const float4*>(as + kk * WLD + 64 + 4 * ty);
      const float4 b0 = *reinterpret_cast<const float4*>(bs + kk * WLD + 4 * tx);
      const float4 b1 = *reinterpret_cast<const float4*>(bs + kk * WLD + 64 + 4 * tx);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (t + 1 < stages) settle(t + 1);
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + 4 * ty + i % 4 + 64 * (i / 4);
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = n0 + 4 * tx + j % 4 + 64 * (j / 4);
      if (gn < N)
        C[(long long)gm * N + gn] =
            from_f32<TOut>(finish(acc[i][j], E, e_bf16, lde, epilogue, gm, gn));
    }
  }
}

template <typename TOut, bool NK, bool KM>
__global__ void __launch_bounds__(THREADS, 2)
matmul_wide_kernel(const float* __restrict__ A, const float* __restrict__ B,
                   const void* __restrict__ E, TOut* __restrict__ C, int M, int N, int K,
                   long long lda, long long ldb, long long lde, int e_bf16, int epilogue,
                   int vec_a, int vec_b) {
  matmul_wide_tile<TOut, NK, KM>(A, B, E, C, M, N, K, lda, ldb, lde, e_bf16, epilogue, vec_a,
                                 vec_b);
}

template <bool NK, bool KM>
__global__ void __launch_bounds__(THREADS, 2)
matmul_batched_wide_kernel(const float* __restrict__ A, const float* __restrict__ B,
                           float* __restrict__ C, int M, int N, int K, long long lda,
                           long long ldb, long long sa, long long sb, int vec_a, int vec_b) {
  const long long z = blockIdx.z;
  matmul_wide_tile<float, NK, KM>(A + z * sa, B + z * sb, nullptr, C + z * M * N, M, N, K, lda,
                                  ldb, 0, 0, EP_NONE, vec_a, vec_b);
}

template <typename T>
__device__ __forceinline__ void gated_tile(const T* __restrict__ A, const T* __restrict__ G,
                                           const T* __restrict__ U, T* __restrict__ C, int M,
                                           int N, int K, long long lda, long long ldb) {
  __shared__ float As[BM][BK + 1];
  __shared__ float Gs[BK][BN + 1];
  __shared__ float Us[BK][BN + 1];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int rows = max(0, min(TM, (M - m0 - ty + 15) / 16));

  float accg[TM][TN], accu[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) accg[i][j] = accu[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    load_a<T>(As, A, M, K, lda, m0, k0, tid);
    load_b<T, false>(Gs, G, N, K, ldb, n0, k0, tid);
    load_b<T, false>(Us, U, N, K, ldb, n0, k0, tid);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float g[TN], u[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        g[j] = Gs[kk][tx + 16 * j];
        u[j] = Us[kk][tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        if (i < rows) {
          const float a = As[ty + 16 * i][kk];
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            accg[i][j] = fmaf(a, g[j], accg[i][j]);
            accu[i][j] = fmaf(a, u[j], accu[i][j]);
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N) C[(long long)gm * N + gn] = from_f32<T>(silu(accg[i][j]) * accu[i][j]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
gated_matmul_kernel(const T* __restrict__ A, const T* __restrict__ G, const T* __restrict__ U,
                    T* __restrict__ C, int M, int N, int K, long long lda, long long ldb) {
  gated_tile<T>(A, G, U, C, M, N, K, lda, ldb);
}

__global__ void __launch_bounds__(THREADS)
gated_matmul_batched_kernel(const float* __restrict__ A, const float* __restrict__ G,
                            const float* __restrict__ U, float* __restrict__ C, int M, int N,
                            int K, long long lda, long long ldb, long long sa, long long sb) {
  const long long z = blockIdx.z;
  gated_tile<float>(A + z * sa, G + z * sb, U + z * sb, C + z * M * N, M, N, K, lda, ldb);
}

// rows of a 16-byte aligned base and a leading dim of whole 16 bytes
int aligned16(const void* p, long long ld) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && ld % 4 == 0;
}

template <typename TOut, bool NK, bool KM>
void launch_matmul_layout(const void* a, const void* b, const void* e, void* c, int M, int N,
                          int K, long long lda, long long ldb, long long lde, int e_bf16,
                          int epilogue, int tile, cudaStream_t s) {
  const float* pa = static_cast<const float*>(a);
  const float* pb = static_cast<const float*>(b);
  if (tile == 1) {
    const dim3 grid((N + WB - 1) / WB, (M + WB - 1) / WB);
    matmul_wide_kernel<TOut, NK, KM><<<grid, THREADS, 0, s>>>(
        pa, pb, e, static_cast<TOut*>(c), M, N, K, lda, ldb, lde, e_bf16, epilogue,
        aligned16(a, lda), aligned16(b, ldb));
  } else {
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    matmul_kernel<float, float, TOut, NK, KM><<<grid, THREADS, 0, s>>>(
        pa, pb, nullptr, e, static_cast<TOut*>(c), M, N, K, lda, ldb, lde, e_bf16, epilogue);
  }
}

template <typename TOut>
void launch_matmul(const void* a, const void* b, const void* e, void* c, int M, int N, int K,
                   long long lda, long long ldb, long long lde, int a_km, int b_nk, int e_bf16,
                   int epilogue, int tile, cudaStream_t s) {
  if (a_km && b_nk)
    launch_matmul_layout<TOut, true, true>(a, b, e, c, M, N, K, lda, ldb, lde, e_bf16, epilogue, tile, s);
  else if (a_km)
    launch_matmul_layout<TOut, false, true>(a, b, e, c, M, N, K, lda, ldb, lde, e_bf16, epilogue, tile, s);
  else if (b_nk)
    launch_matmul_layout<TOut, true, false>(a, b, e, c, M, N, K, lda, ldb, lde, e_bf16, epilogue, tile, s);
  else
    launch_matmul_layout<TOut, false, false>(a, b, e, c, M, N, K, lda, ldb, lde, e_bf16, epilogue, tile, s);
}

template <bool NK, bool KM>
void launch_matmul_batched(const float* a, const float* b, float* c, int E, int M, int N, int K,
                           long long lda, long long ldb, long long sa, long long sb, int tile,
                           cudaStream_t s) {
  if (tile == 1) {
    const dim3 grid((N + WB - 1) / WB, (M + WB - 1) / WB, E);
    matmul_batched_wide_kernel<NK, KM><<<grid, THREADS, 0, s>>>(
        a, b, c, M, N, K, lda, ldb, sa, sb, aligned16(a, lda) && sa % 4 == 0,
        aligned16(b, ldb) && sb % 4 == 0);
  } else {
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, E);
    matmul_batched_kernel<NK, KM><<<grid, THREADS, 0, s>>>(a, b, c, M, N, K, lda, ldb, sa, sb);
  }
}

template <typename TOut>
void launch_matmul_q(const void* a, const void* bq, const float* scale, const void* e, void* c,
                     int M, int N, int K, long long lda, long long ldb, long long lde,
                     int e_bf16, int epilogue, cudaStream_t s) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  matmul_kernel<float, int8_t, TOut, false, false><<<grid, THREADS, 0, s>>>(
      static_cast<const float*>(a), static_cast<const int8_t*>(bq), scale, e,
      static_cast<TOut*>(c), M, N, K, lda, ldb, lde, e_bf16, epilogue);
}

}  // namespace

// f32 operands; bf16 ones go to repro_matmul_tc (matmul_tc.cu). tile: 0
// the 64x64 tile, 1 the wide one (`f32_tile_plan`).
extern "C" int repro_matmul(const void* a, const void* b, const void* e, void* c, int M, int N,
                            int K, long long lda, long long ldb, long long lde, int a_km,
                            int b_nk, int out_bf16, int e_bf16, int epilogue, int tile,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M > 0 && N > 0) {
    if (out_bf16)
      launch_matmul<__nv_bfloat16>(a, b, e, c, M, N, K, lda, ldb, lde, a_km, b_nk, e_bf16, epilogue, tile, s);
    else
      launch_matmul<float>(a, b, e, c, M, N, K, lda, ldb, lde, a_km, b_nk, e_bf16, epilogue, tile, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// f32 activations; bf16 ones go to repro_matmul_q_tc (matmul_tc.cu).
extern "C" int repro_matmul_q(const void* a, const void* bq, const float* scale, const void* e,
                              void* c, int M, int N, int K, long long lda, long long ldb,
                              long long lde, int out_bf16, int e_bf16, int epilogue,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M > 0 && N > 0) {
    if (out_bf16)
      launch_matmul_q<__nv_bfloat16>(a, bq, scale, e, c, M, N, K, lda, ldb, lde, e_bf16, epilogue, s);
    else
      launch_matmul_q<float>(a, bq, scale, e, c, M, N, K, lda, ldb, lde, e_bf16, epilogue, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// f32; bf16 goes to repro_gated_matmul_tc (matmul_tc.cu).
extern "C" int repro_gated_matmul(const void* a, const void* g, const void* u, void* c, int M,
                                  int N, int K, long long lda, long long ldb, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M > 0 && N > 0) {
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    gated_matmul_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(g), static_cast<const float*>(u),
        static_cast<float*>(c), M, N, K, lda, ldb);
  }
  return static_cast<int>(cudaGetLastError());
}

// The batched forms over E experts (`blockIdx.z`), f32: a [E, M, K], b (g,
// u) [E, K, N] banks with row strides lda, ldb and expert strides sa, sb;
// c [E, M, N] contiguous. The GEMM's banks are row-major or (a_km, b_nk)
// every matrix the transpose view of a row-major [K, M] or [N, K], as
// repro_matmul's; the dual GEMM's row-major. tile: `f32_tile_plan`'s for
// one expert's (M, K, N). bf16 goes to repro_*_batched_tc (matmul_tc_batched.cu).
extern "C" int repro_matmul_batched(const void* a, const void* b, void* c, int E, int M, int N,
                                    int K, long long lda, long long ldb, long long sa,
                                    long long sb, int a_km, int b_nk, int tile, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E > 0 && M > 0 && N > 0) {
    const float* pa = static_cast<const float*>(a);
    const float* pb = static_cast<const float*>(b);
    float* pc = static_cast<float*>(c);
    if (a_km && b_nk)
      launch_matmul_batched<true, true>(pa, pb, pc, E, M, N, K, lda, ldb, sa, sb, tile, s);
    else if (a_km)
      launch_matmul_batched<false, true>(pa, pb, pc, E, M, N, K, lda, ldb, sa, sb, tile, s);
    else if (b_nk)
      launch_matmul_batched<true, false>(pa, pb, pc, E, M, N, K, lda, ldb, sa, sb, tile, s);
    else
      launch_matmul_batched<false, false>(pa, pb, pc, E, M, N, K, lda, ldb, sa, sb, tile, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_gated_matmul_batched(const void* a, const void* g, const void* u, void* c,
                                          int E, int M, int N, int K, long long lda,
                                          long long ldb, long long sa, long long sb,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E > 0 && M > 0 && N > 0) {
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, E);
    gated_matmul_batched_kernel<<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(g), static_cast<const float*>(u),
        static_cast<float*>(c), M, N, K, lda, ldb, sa, sb);
  }
  return static_cast<int>(cudaGetLastError());
}
