// Elementwise kernels: C = A op B (op: add, sub, mul) and alpha * x + y.
//
// Replaces the Pallas kernels `binary_op` (_binary_kernel) and `axpy`
// (_axpy_kernel) of src/repro/kernels/elementwise.py: the paper's matrix
// addition study (Fig 9), where an add gains nothing from the accelerator.
//
// Bound: bytes. Each element is read from two operands and written once,
// one operation for every 3 elements moved: a 4096 x 4096 f32 add moves
// 201 MB, 0.060 ms at the H100's 3.35 TB/s, and does 16.8 M operations.
//
// What the design does about it: keep enough loads in flight to cover
// the memory's latency, and spend nothing else. The operands are taken
// flat (any shape, contiguous). Where all three pointers are 16-byte
// aligned, each thread moves UNROLL vectors of 16 bytes (4 floats, 8 bf16
// or 2 doubles) of each operand, all its loads issued before any
// arithmetic, neighbouring threads on neighbouring vectors, and stores
// with the streaming hint (__stcs: the result is not read again here);
// the grid covers the operands once (no grid-stride loop), and the
// ragged tail, under one vector, is done one element a thread by the
// first block. Otherwise every element is moved alone, as many a thread
// as the vector path moves, in the same pattern. On an H100 one vector a
// thread (UNROLL = 1: two 16-byte loads in flight) timed best of 1, 2
// and 4, 256 threads a block as well as 128 or 512, and the streaming
// stores better than plain ones (experiments/probe_fma_kernels.py).
//
// Rounding matches PyTorch bit for bit: add, sub and mul are each one
// correctly rounded operation (__fadd_rn and kin, which nvcc never
// contracts), bf16 computed in f32 and rounded once to bf16, as PyTorch
// computes a bf16 op. axpy rounds twice, alpha * x and then + y, as the
// two PyTorch ops of its plain version do: in bf16 the product is rounded
// to bf16 before the add. alpha is cast to x's type first; it comes as a
// number, or through a pointer to a one-element tensor on the card (read
// by the kernel, never copied to the host), which takes the place of the
// Pallas kernel's scalar-prefetched alpha_ref.

#include <stdint.h>

#include "common.cuh"

namespace {

using repro::from_f32;
using repro::to_f32;

constexpr int THREADS = 256, UNROLL = 1;

enum Dtype { DT_F32 = 0, DT_BF16 = 1, DT_F64 = 2 };
enum Op { OP_ADD = 0, OP_SUB = 1, OP_MUL = 2 };

template <int OP> __device__ __forceinline__ float apply(float a, float b) {
  return OP == OP_ADD ? __fadd_rn(a, b) : OP == OP_SUB ? __fsub_rn(a, b) : __fmul_rn(a, b);
}
template <int OP> __device__ __forceinline__ double apply(double a, double b) {
  return OP == OP_ADD ? __dadd_rn(a, b) : OP == OP_SUB ? __dsub_rn(a, b) : __dmul_rn(a, b);
}
template <int OP> __device__ __forceinline__ __nv_bfloat16 apply(__nv_bfloat16 a, __nv_bfloat16 b) {
  return from_f32<__nv_bfloat16>(apply<OP>(to_f32(a), to_f32(b)));
}

// alpha * x, rounded to the storage type, then + y, rounded again
__device__ __forceinline__ float axpy1(float a, float x, float y) {
  return apply<OP_ADD>(apply<OP_MUL>(a, x), y);
}
__device__ __forceinline__ double axpy1(double a, double x, double y) {
  return apply<OP_ADD>(apply<OP_MUL>(a, x), y);
}
__device__ __forceinline__ __nv_bfloat16 axpy1(__nv_bfloat16 a, __nv_bfloat16 x, __nv_bfloat16 y) {
  return apply<OP_ADD>(apply<OP_MUL>(a, x), y);
}

// a number cast to the storage type as PyTorch casts it: a double to
// float, and a double to bf16 through float
template <typename T> __device__ __forceinline__ T cast_alpha(double a);
template <> __device__ __forceinline__ float cast_alpha<float>(double a) { return __double2float_rn(a); }
template <> __device__ __forceinline__ double cast_alpha<double>(double a) { return a; }
template <> __device__ __forceinline__ __nv_bfloat16 cast_alpha<__nv_bfloat16>(double a) {
  return from_f32<__nv_bfloat16>(__double2float_rn(a));
}

// Elements a thread where the operands are not aligned: one at a time,
// as many as the vector path moves a thread.
template <typename T>
__host__ __device__ constexpr int scalars_a_thread() { return UNROLL * 16 / sizeof(T); }

// UNROLL 16-byte vectors of a and b per thread, all loaded before any is
// used, then the tail; or, for unaligned operands, scalars_a_thread
// elements a thread. F maps (element of a, element of b) to the element
// of c.
template <typename T, typename F>
__device__ __forceinline__ void walk(const T* __restrict__ a, const T* __restrict__ b,
                                     T* __restrict__ c, long long n, int vec, F f) {
  constexpr int V = 16 / sizeof(T);
  const long long first = (long long)blockIdx.x * THREADS * UNROLL + threadIdx.x;
  if (vec) {
    const long long nv = n / V;
    uint4 ra[UNROLL], rb[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = first + u * THREADS;
      if (i < nv) {
        ra[u] = reinterpret_cast<const uint4*>(a)[i];
        rb[u] = reinterpret_cast<const uint4*>(b)[i];
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = first + u * THREADS;
      if (i < nv) {
        uint4 rc;
        const T* pa = reinterpret_cast<const T*>(&ra[u]);
        const T* pb = reinterpret_cast<const T*>(&rb[u]);
        T* pc = reinterpret_cast<T*>(&rc);
#pragma unroll
        for (int j = 0; j < V; ++j) pc[j] = f(pa[j], pb[j]);
        __stcs(reinterpret_cast<uint4*>(c) + i, rc);  // streaming: c is not read again
      }
    }
    const long long i = nv * V + threadIdx.x;
    if (blockIdx.x == 0 && i < n) c[i] = f(a[i], b[i]);
  } else {
    constexpr int E = scalars_a_thread<T>();
    const long long first_e = (long long)blockIdx.x * THREADS * E + threadIdx.x;
    T xa[E], xb[E];
#pragma unroll
    for (int u = 0; u < E; ++u) {
      const long long i = first_e + u * THREADS;
      if (i < n) xa[u] = a[i], xb[u] = b[i];
    }
#pragma unroll
    for (int u = 0; u < E; ++u) {
      const long long i = first_e + u * THREADS;
      if (i < n) c[i] = f(xa[u], xb[u]);
    }
  }
}

template <typename T, int OP>
__global__ void __launch_bounds__(THREADS)
    binary_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ c,
                  long long n, int vec) {
  walk(a, b, c, n, vec, [](T x, T y) { return apply<OP>(x, y); });
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    axpy_kernel(const T* __restrict__ alpha_p, double alpha_v, const T* __restrict__ x,
                const T* __restrict__ y, T* __restrict__ c, long long n, int vec) {
  const T alpha = alpha_p != nullptr ? alpha_p[0] : cast_alpha<T>(alpha_v);
  walk(x, y, c, n, vec, [alpha](T xi, T yi) { return axpy1(alpha, xi, yi); });
}

// Blocks that cover n once: UNROLL vectors, or scalars_a_thread elements,
// a thread. A grid of vectors has a block at least, whose first threads
// take the tail.
template <typename T>
int blocks_for(long long n, int vec) {
  const long long per_block = (long long)THREADS * (vec ? UNROLL : scalars_a_thread<T>());
  const long long units = vec ? n / (16 / sizeof(T)) : n;
  return static_cast<int>(units > 0 ? (units + per_block - 1) / per_block : 1);
}

template <typename T>
void launch_binary(const void* a, const void* b, void* c, long long n, int op, int vec,
                   cudaStream_t s) {
  const int grid = blocks_for<T>(n, vec);
  const T* pa = static_cast<const T*>(a);
  const T* pb = static_cast<const T*>(b);
  T* pc = static_cast<T*>(c);
  if (op == OP_ADD)
    binary_kernel<T, OP_ADD><<<grid, THREADS, 0, s>>>(pa, pb, pc, n, vec);
  else if (op == OP_SUB)
    binary_kernel<T, OP_SUB><<<grid, THREADS, 0, s>>>(pa, pb, pc, n, vec);
  else
    binary_kernel<T, OP_MUL><<<grid, THREADS, 0, s>>>(pa, pb, pc, n, vec);
}

template <typename T>
void launch_axpy(const void* alpha_p, double alpha_v, const void* x, const void* y, void* c,
                 long long n, int vec, cudaStream_t s) {
  axpy_kernel<T><<<blocks_for<T>(n, vec), THREADS, 0, s>>>(
      static_cast<const T*>(alpha_p), alpha_v, static_cast<const T*>(x),
      static_cast<const T*>(y), static_cast<T*>(c), n, vec);
}

}  // namespace

// C[i] = A[i] op B[i] for i < n; dtype 0 f32, 1 bf16, 2 f64; op 0 add,
// 1 sub, 2 mul; vec: all three pointers 16-byte aligned.
extern "C" int repro_binary_op(const void* a, const void* b, void* c, long long n, int dtype,
                               int op, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    if (dtype == DT_BF16)
      launch_binary<__nv_bfloat16>(a, b, c, n, op, vec, s);
    else if (dtype == DT_F64)
      launch_binary<double>(a, b, c, n, op, vec, s);
    else
      launch_binary<float>(a, b, c, n, op, vec, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// C[i] = alpha * X[i] + Y[i] for i < n; alpha is *alpha_p (x's type) if
// alpha_p is not null, else alpha_v cast to x's type.
extern "C" int repro_axpy(const void* alpha_p, double alpha_v, const void* x, const void* y,
                          void* c, long long n, int dtype, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    if (dtype == DT_BF16)
      launch_axpy<__nv_bfloat16>(alpha_p, alpha_v, x, y, c, n, vec, s);
    else if (dtype == DT_F64)
      launch_axpy<double>(alpha_p, alpha_v, x, y, c, n, vec, s);
    else
      launch_axpy<float>(alpha_p, alpha_v, x, y, c, n, vec, s);
  }
  return static_cast<int>(cudaGetLastError());
}
