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
// What the design does about it: the operands are taken flat (any shape,
// contiguous), so every thread walks consecutive addresses in a
// grid-stride loop. Where all three pointers are 16-byte aligned each
// thread moves 16 bytes a load and a store (4 floats, 8 bf16 or 2
// doubles), and the ragged tail is done one element a thread; otherwise
// every element is. The grid stops at 32 blocks of 256 threads an SM,
// enough loads in flight to cover the memory's latency.
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

constexpr int THREADS = 256;
constexpr long long MAX_BLOCKS = 132 * 32;

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

// One 16-byte vector of a, b (and c) per step of the loop, then the tail
// (or everything, for unaligned operands) one element at a time. F maps
// (element of a, element of b) to the element of c.
template <typename T, typename F>
__device__ __forceinline__ void walk(const T* __restrict__ a, const T* __restrict__ b,
                                     T* __restrict__ c, long long n, int vec, F f) {
  constexpr int V = 16 / sizeof(T);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long head = 0;
  if (vec) {
    const long long nv = n / V;
    for (long long i = tid; i < nv; i += stride) {
      uint4 ra = reinterpret_cast<const uint4*>(a)[i];
      uint4 rb = reinterpret_cast<const uint4*>(b)[i];
      uint4 rc;
      const T* pa = reinterpret_cast<const T*>(&ra);
      const T* pb = reinterpret_cast<const T*>(&rb);
      T* pc = reinterpret_cast<T*>(&rc);
#pragma unroll
      for (int j = 0; j < V; ++j) pc[j] = f(pa[j], pb[j]);
      reinterpret_cast<uint4*>(c)[i] = rc;
    }
    head = nv * V;
  }
  for (long long i = head + tid; i < n; i += stride) c[i] = f(a[i], b[i]);
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

int blocks_for(long long n, int vec, int itemsize) {
  const long long units = vec ? n / (16 / itemsize) + 1 : n;
  long long blocks = (units + THREADS - 1) / THREADS;
  return static_cast<int>(blocks < MAX_BLOCKS ? blocks : MAX_BLOCKS);
}

template <typename T>
void launch_binary(const void* a, const void* b, void* c, long long n, int op, int vec,
                   cudaStream_t s) {
  const int grid = blocks_for(n, vec, sizeof(T));
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
  axpy_kernel<T><<<blocks_for(n, vec, sizeof(T)), THREADS, 0, s>>>(
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
