// The naive GEMM, C = A @ B: the paper's Listing 3, as it was written for
// CUDA.
//
// Replaces the Pallas kernel `matmul_naive` (_naive_kernel) of
// src/repro/kernels/matmul_naive.py, which could only approximate Listing 3
// on a TPU (a kernel there computes on staged blocks). Here it is the
// listing itself: one thread for each output element, in 16 x 16 blocks of
// threads (the paper's block edge); each thread walks k, reading its row of
// A and its column of B from device memory, with no shared memory and no
// k-tiling. threadIdx.x walks the columns, so the 16 threads of a row read
// 16 neighbouring elements of B's row k together, and the row of A is one
// address for all of them.
//
// Bound: operations, for a square product at the paper's size. 4096^3 f32
// is 137 GFLOP, 2.05 ms at the H100's 67 TFLOP/s on the FMA units; its
// operands and result are 201 MB, 0.060 ms at 3.35 TB/s. This kernel is
// the negative control, slow by design: the bound is not its target. It
// rereads A's row for every column and B's column for every row, N + M
// reads of each element (550 GB at 4096^2 f32), and only the caches stand
// between those reads and device memory. Its time against the tiled
// kernel's (csrc/matmul.cu, Listing 4) is the paper's Fig 8.
//
// Accumulation: f32 for f32 and bf16 inputs, f64 for f64, over k in
// ascending order; the sum is rounded once to the output type. Edges are
// masked (any M, N and K); indices are 64-bit.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int BLOCK = 16;  // the paper's block edge

enum Dtype { DT_F32 = 0, DT_BF16 = 1, DT_F64 = 2 };

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ double widen(double x) { return x; }

template <typename Out> __device__ __forceinline__ Out narrow(float x);
template <> __device__ __forceinline__ float narrow<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <typename Out> __device__ __forceinline__ Out narrow(double x);
template <> __device__ __forceinline__ double narrow<double>(double x) { return x; }

template <typename T, typename Acc, typename Out>
__global__ void __launch_bounds__(BLOCK * BLOCK)
    naive_gemm_kernel(const T* a, const T* b, Out* c, int M, int N, int K, long long lda,
                      long long ldb) {
  const long long row = (long long)blockIdx.y * BLOCK + threadIdx.y;
  const long long col = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (row >= M || col >= N) return;
  Acc sum = 0;
  for (long long k = 0; k < K; ++k) sum += widen(a[row * lda + k]) * widen(b[k * ldb + col]);
  c[row * N + col] = narrow<Out>(sum);
}

template <typename T, typename Acc, typename Out>
void launch(const void* a, const void* b, void* c, int M, int N, int K, long long lda,
            long long ldb, cudaStream_t s) {
  dim3 grid((N + BLOCK - 1) / BLOCK, (M + BLOCK - 1) / BLOCK);
  dim3 block(BLOCK, BLOCK);
  naive_gemm_kernel<T, Acc, Out><<<grid, block, 0, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<Out*>(c), M, N, K, lda, ldb);
}

}  // namespace

// C [M, N] row-major = A [M, K] @ B [K, N], both with a unit column
// stride and row strides lda, ldb. in_dtype / out_dtype: 0 f32, 1 bf16,
// 2 f64; f64 goes with f64 only.
extern "C" int repro_matmul_naive(const void* a, const void* b, void* c, int M, int N, int K,
                                  long long lda, long long ldb, int in_dtype, int out_dtype,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M > 0 && N > 0) {
    if (in_dtype == DT_F64)
      launch<double, double, double>(a, b, c, M, N, K, lda, ldb, s);
    else if (in_dtype == DT_BF16 && out_dtype == DT_BF16)
      launch<__nv_bfloat16, float, __nv_bfloat16>(a, b, c, M, N, K, lda, ldb, s);
    else if (in_dtype == DT_BF16)
      launch<__nv_bfloat16, float, float>(a, b, c, M, N, K, lda, ldb, s);
    else if (out_dtype == DT_BF16)
      launch<float, float, __nv_bfloat16>(a, b, c, M, N, K, lda, ldb, s);
    else
      launch<float, float, float>(a, b, c, M, N, K, lda, ldb, s);
  }
  return static_cast<int>(cudaGetLastError());
}
