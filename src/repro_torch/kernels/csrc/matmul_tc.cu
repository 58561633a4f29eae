// The 2-D entry points of the bf16 GEMMs on Hopper's tensor cores: the
// tiled GEMM, the int8-weight GEMM and the dual GEMM (matmul_tc.cuh holds
// the kernels; the batched forms are in matmul_tc_batched.cu).

#include "matmul_tc.cuh"

// a, b bf16; c bf16 (out_bf16) or f32; e the epilogue operand (bf16 or f32
// by e_bf16, or null); plan: the instance `tile_plan` chose.
extern "C" int repro_matmul_tc(const void* a, const void* b, const void* e, void* c, int M, int N,
                               int K, long long lda, long long ldb, long long lde, int a_km,
                               int b_nk, int out_bf16, int e_bf16, int epilogue, int plan,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M == 0 || N == 0) return static_cast<int>(cudaGetLastError());
  const Args p{static_cast<const bf16*>(a), static_cast<const bf16*>(b), e, c, M, N, K, lda,
               ldb, lde, e_bf16, epilogue,
               reinterpret_cast<uintptr_t>(a) % 16 == 0 && lda % 8 == 0,
               reinterpret_cast<uintptr_t>(b) % 16 == 0 && ldb % 8 == 0};
  const cudaError_t err = out_bf16 ? launch_out<bf16>(p, a_km, b_nk, plan, s)
                                   : launch_out<float>(p, a_km, b_nk, plan, s);
  return static_cast<int>(err);
}

// a bf16 [M, K] row-major; bq int8 [K, N] row-major (ldb); scale f32 (N,);
// c and e as repro_matmul_tc's.
extern "C" int repro_matmul_q_tc(const void* a, const void* bq, const float* scale, const void* e,
                                 void* c, int M, int N, int K, long long lda, long long ldb,
                                 long long lde, int out_bf16, int e_bf16, int epilogue, int plan,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M == 0 || N == 0) return static_cast<int>(cudaGetLastError());
  Args p{static_cast<const bf16*>(a), bq, e, c, M, N, K, lda, ldb, lde, e_bf16, epilogue,
         reinterpret_cast<uintptr_t>(a) % 16 == 0 && lda % 8 == 0,
         reinterpret_cast<uintptr_t>(bq) % 16 == 0 && ldb % 16 == 0};
  p.S = scale;
  const cudaError_t err = out_bf16 ? launch_q<bf16>(p, plan, s) : launch_q<float>(p, plan, s);
  return static_cast<int>(err);
}

// a bf16 [M, K] row-major; g, u bf16 [K, N] row-major with one row stride
// ldb; h bf16 [M, N] = silu(a g) * (a u).
extern "C" int repro_gated_matmul_tc(const void* a, const void* g, const void* u, void* h, int M,
                                     int N, int K, long long lda, long long ldb, int plan,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M == 0 || N == 0) return static_cast<int>(cudaGetLastError());
  Args p{static_cast<const bf16*>(a), g, nullptr, h, M, N, K, lda, ldb, 0, 0, EP_NONE,
         reinterpret_cast<uintptr_t>(a) % 16 == 0 && lda % 8 == 0,
         reinterpret_cast<uintptr_t>(g) % 16 == 0 && reinterpret_cast<uintptr_t>(u) % 16 == 0 &&
             ldb % 8 == 0};
  p.U = static_cast<const bf16*>(u);
  return static_cast<int>(launch_gated(p, plan, s));
}

