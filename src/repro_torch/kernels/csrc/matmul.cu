// The FMA GEMMs, f32 only: the f32 tiled GEMM with a fused epilogue, the
// int8-weight GEMM with f32 activations, and the dual-GEMM SwiGLU kernel
// in f32. Their bf16 instances, the main paths', run on the tensor cores
// in matmul_tc.cu (mma.sync and wgmma).
//
// Replaces the f32 instances of the Pallas kernels `matmul_tiled`
// (_matmul_kernel), `matmul_q_tiled` (_matmul_q_kernel) and
// `gated_matmul_tiled` (_gated_matmul_kernel) of
// src/repro/kernels/matmul.py. It is the paper's Listing 4 on the hardware
// family it was written for: 64x64 output tiles, a k-step of 32, A and B
// tiles staged in shared memory as f32, __syncthreads() around each
// stage, and an f32 accumulator in registers (4x4 outputs a thread) on the
// FMA units. These kernels stay here on purpose: the f32 GEMM is Table 2's
// f32 "tiled" route (the paper's shared-memory kernel, which Fig 8
// measures), and the depth-2 f32 train and Mamba-2 steps are held to the
// CPU at rtol 1e-4, which TF32 would not meet. The epilogue is applied
// once, on the f32 accumulator, at the flush: none | bias | bias_gelu
// (tanh form) | bias_silu | residual, then one rounding to the output
// type. The int8 variant (`matmul_q`) is the same kernel with an int8
// [K, N] B tile, widened to f32 as it is staged (|q| <= 127 is exact),
// and the per-channel f32 scale multiplied onto the accumulator at the
// flush, before the epilogue. The gated kernel stages one A tile against
// two [K, N] weight tiles, keeps two accumulators, and stores silu(g) * u
// without ever writing g or u.
//
// Bound: at M = 512..2048 the f32 operation count, 67 TFLOP/s on the FMA
// units; at M = 4 the weight's bytes. These kernels reach neither: at
// M = 4 each block's serial k-loop, not the bytes, sets the time.
//
// Edges are masked in the kernel (no padding on the host). The f32 GEMM
// reads B either as [K, N] row-major or as [N, K] (`b_nk`) and A either as
// [M, K] row-major or as [K, M] (`a_km`); the int8 B is [K, N]. There is
// no split-K and no atomic: each output's sum runs over k in ascending
// order whatever M is, so a row computes the same bits at batch 1 as at
// batch 4.

#include <stdint.h>

#include "common.cuh"

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
__global__ void __launch_bounds__(THREADS)
matmul_kernel(const TIn* __restrict__ A, const TB* __restrict__ B, const float* __restrict__ S,
              const void* __restrict__ E, TOut* __restrict__ C, int M, int N, int K,
              long long lda, long long ldb, long long lde, int e_bf16, int epilogue) {
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
      if (epilogue == EP_RESIDUAL) {
        v += load_any(E, e_bf16, (long long)gm * lde + gn);
      } else if (epilogue != EP_NONE) {
        v += load_any(E, e_bf16, gn);
        if (epilogue == EP_BIAS_GELU) v = gelu_tanh(v);
        else if (epilogue == EP_BIAS_SILU) v = silu(v);
      }
      C[(long long)gm * N + gn] = from_f32<TOut>(v);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
gated_matmul_kernel(const T* __restrict__ A, const T* __restrict__ G, const T* __restrict__ U,
                    T* __restrict__ C, int M, int N, int K, long long lda, long long ldb) {
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

template <typename TIn, typename TOut, bool NK, bool KM>
void launch_matmul_layout(const void* a, const void* b, const void* e, void* c, int M, int N,
                          int K, long long lda, long long ldb, long long lde, int e_bf16,
                          int epilogue, cudaStream_t s) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  matmul_kernel<TIn, TIn, TOut, NK, KM><<<grid, THREADS, 0, s>>>(
      static_cast<const TIn*>(a), static_cast<const TIn*>(b), nullptr, e, static_cast<TOut*>(c),
      M, N, K, lda, ldb, lde, e_bf16, epilogue);
}

template <typename TIn, typename TOut>
void launch_matmul(const void* a, const void* b, const void* e, void* c, int M, int N, int K,
                   long long lda, long long ldb, long long lde, int a_km, int b_nk, int e_bf16,
                   int epilogue, cudaStream_t s) {
  if (a_km && b_nk)
    launch_matmul_layout<TIn, TOut, true, true>(a, b, e, c, M, N, K, lda, ldb, lde, e_bf16, epilogue, s);
  else if (a_km)
    launch_matmul_layout<TIn, TOut, false, true>(a, b, e, c, M, N, K, lda, ldb, lde, e_bf16, epilogue, s);
  else if (b_nk)
    launch_matmul_layout<TIn, TOut, true, false>(a, b, e, c, M, N, K, lda, ldb, lde, e_bf16, epilogue, s);
  else
    launch_matmul_layout<TIn, TOut, false, false>(a, b, e, c, M, N, K, lda, ldb, lde, e_bf16, epilogue, s);
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

// f32 operands; bf16 ones go to repro_matmul_tc (matmul_tc.cu).
extern "C" int repro_matmul(const void* a, const void* b, const void* e, void* c, int M, int N,
                            int K, long long lda, long long ldb, long long lde, int a_km,
                            int b_nk, int out_bf16, int e_bf16, int epilogue, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M > 0 && N > 0) {
    if (out_bf16)
      launch_matmul<float, __nv_bfloat16>(a, b, e, c, M, N, K, lda, ldb, lde, a_km, b_nk, e_bf16, epilogue, s);
    else
      launch_matmul<float, float>(a, b, e, c, M, N, K, lda, ldb, lde, a_km, b_nk, e_bf16, epilogue, s);
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
