// The batched entry points of the bf16 GEMM and dual GEMM over expert
// banks (matmul_tc.cuh holds the kernels): a translation unit of their
// own, so that nvcc compiles their instances beside the 2-D ones.

#include "matmul_tc.cuh"

// The batched forms over E experts (`blockIdx.z`): a bf16 [E, M, K], b (and
// u) bf16 [E, K, N] banks with row strides lda, ldb and expert strides sa,
// sb; c bf16 [E, M, N] contiguous. c[e] = a[e] b[e] (no epilogue), each
// bank of the batched GEMM row-major or (a_km, b_nk) every matrix the
// transpose view of a row-major [K, M] or [N, K], as repro_matmul_tc's;
// h[e] = silu(a[e] g[e]) * (a[e] u[e]) on row-major banks. plan: the
// instance `tile_plan` (`gated_tile_plan`) chose for one expert's
// (M, K, N) in its layout.
extern "C" int repro_matmul_batched_tc(const void* a, const void* b, void* c, int E, int M, int N,
                                       int K, long long lda, long long ldb, long long sa,
                                       long long sb, int a_km, int b_nk, int plan,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E == 0 || M == 0 || N == 0) return static_cast<int>(cudaGetLastError());
  Args p{static_cast<const bf16*>(a), b, nullptr, c, M, N, K, lda, ldb, 0, 0, EP_NONE,
         vec16(a, lda, sa), vec16(b, ldb, sb)};
  p.batch = E, p.sa = sa, p.sb = sb, p.sc = (long long)M * N;
  return static_cast<int>(launch_out<bf16, true>(p, a_km, b_nk, plan, s));
}

extern "C" int repro_gated_matmul_batched_tc(const void* a, const void* g, const void* u, void* h,
                                             int E, int M, int N, int K, long long lda,
                                             long long ldb, long long sa, long long sb, int plan,
                                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E == 0 || M == 0 || N == 0) return static_cast<int>(cudaGetLastError());
  Args p{static_cast<const bf16*>(a), g, nullptr, h, M, N, K, lda, ldb, 0, 0, EP_NONE,
         vec16(a, lda, sa), vec16(g, ldb, sb) && vec16(u, ldb, sb)};
  p.U = static_cast<const bf16*>(u);
  p.batch = E, p.sa = sa, p.sb = sb, p.sc = (long long)M * N;
  return static_cast<int>(launch_gated<true>(p, plan, s));
}
