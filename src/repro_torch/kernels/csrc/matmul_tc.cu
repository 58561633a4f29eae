// The bf16 tiled GEMM on Hopper's tensor cores, with the fused epilogue.
//
// Replaces the Pallas kernel `matmul_tiled` (_matmul_kernel) of
// src/repro/kernels/matmul.py for bf16 operands; its f32 instantiations,
// the int8-weight GEMM and the dual GEMM stay on the FMA kernel of
// matmul.cu. C[M, N] = epilogue(A @ B), with bf16 products summed in f32
// on the tensor cores. The epilogue (none | bias | bias_gelu (tanh form) |
// bias_silu | residual) is applied on the f32 accumulator fragments at
// the flush, then the one rounding to bf16 or f32.
//
// Two paths, by tile plan (chosen by `kernels/matmul.py` `tile_plan` and
// passed here by number):
//   - `wide`, 128 x 128 (128 x 192 where that saves a wave of blocks),
//     for every M > 16 (prefill and training): the Hopper path. One
//     producer warpgroup keeps TMA loads of 64-deep k-stages in flight
//     into 128-byte-swizzled shared memory, and two consumer warpgroups
//     run wgmma.m64nNk16 on each stage as its mbarrier completes,
//     releasing it to the producer when done: no block-wide barrier in
//     the k-loop. An operand TMA cannot take (a base or leading dim not
//     16-byte aligned), or K = 0, goes to a 128 x 64 tile on mma.sync
//     (the `narrow` tile), with the same bits.
//   - `rows16` for M <= 16 (decode), one warp and a 16-row tile with 8
//     (N < 32768) or 32 columns and a deep k-stage, so that a decode GEMM's
//     weight streams through hundreds of blocks at once.
//   The mma.sync tiles run mma.sync.m16n8k16 from ldmatrix fragments, fed
//   by a ring of shared-memory stages that cp.async fills 16 bytes at a
//   time while the tensor cores work on the stage before.
//
// Layouts, read in place: A as [M, K] row-major or as the transpose view
// of a [K, M] one (`a_km`: an activation in a weight gradient a^T g), B as
// [K, N] row-major or as the transpose view of an [N, K] one (`b_nk`: the
// tied embedding, W^T in an input gradient). A K-contiguous tile feeds
// ldmatrix (and wgmma) as it is and an M- or N-contiguous one through
// ldmatrix.trans (wgmma's transposed operand), so no layout is copied or
// transposed on the host. Ragged M, N and K are zero-filled by the loads
// (TMA fills past a tensor's edge with zeros); an operand whose base or
// leading dim is not 16-byte aligned is loaded element by element on the
// mma.sync paths (correct, slower).
//
// Bound at the main path's shapes (H100, bf16): a decode GEMM (M = 4)
// does 4 multiply-adds per weight byte pair and is bound by the weight's
// bytes (the tied-embedding logits: 311 MB, 93 us at 3.35 TB/s); a prefill
// or training GEMM (M = 2048) by the tensor cores (M=2048 K=1024 N=3072:
// 12.9 GFLOP, 13 us at the 989 TFLOP/s dense bf16 peak). The wide tile
// still leaves time there: one block an SM, so whole waves of blocks (the
// 192-wide tile takes M=1024 N=3072 from 1.45 waves to 1), each epilogue
// unhidden, and each tile re-reads its A rows and B columns from L2.
//
// Batch invariance: every plan sums each output in one order, fixed by K
// alone: ceil(K / 16) k-steps of 16 in ascending order from a zero f32
// accumulator, steps past K skipped, no split of K across warps or blocks
// and no atomics. An m16n8k16 mma.sync step and an m64nNk16 wgmma step
// give the same bits, so a tile plan changes which rows and columns share
// a block, never a row's bits: one row of C is the same at M = 1, 4, 136
// or 2048 (`tests/test_torch_cuda.py` checks it on the card).

#include <cuda.h>
#include <dlfcn.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

using repro::bf16;
using repro::from_f32;
using repro::padded;

enum Epilogue { EP_NONE = 0, EP_BIAS = 1, EP_BIAS_GELU = 2, EP_BIAS_SILU = 3, EP_RESIDUAL = 4 };

// The epilogue's arithmetic is written out in rounded intrinsics, so that
// no instantiation contracts it into an FMA another does not: a row's
// bits then match across the tile plans after the flush too.
__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  const float x3 = __fmul_rn(__fmul_rn(x, x), x);
  const float inner = __fmul_rn(c, __fadd_rn(x, __fmul_rn(0.044715f, x3)));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, tanhf(inner)));
}

__device__ __forceinline__ float silu(float x) { return __fdiv_rn(x, __fadd_rn(1.0f, expf(-x))); }

__device__ __forceinline__ float load_any(const void* p, int is_bf16, long long i) {
  return is_bf16 ? __bfloat162float(static_cast<const bf16*>(p)[i]) : static_cast<const float*>(p)[i];
}

struct Args {
  const bf16* A;
  const bf16* B;
  const void* E;
  void* C;
  int M, N, K;
  long long lda, ldb, lde;
  int e_bf16, epilogue;
  bool a_vec, b_vec;  // 16-byte aligned base and a leading dim of 8k elements
};

__device__ __forceinline__ float flush_one(const Args& p, float v, int gm, int gn) {
  if (p.epilogue == EP_RESIDUAL) {
    v = __fadd_rn(v, load_any(p.E, p.e_bf16, (long long)gm * p.lde + gn));
  } else if (p.epilogue != EP_NONE) {
    v = __fadd_rn(v, load_any(p.E, p.e_bf16, gn));
    if (p.epilogue == EP_BIAS_GELU) v = gelu_tanh(v);
    else if (p.epilogue == EP_BIAS_SILU) v = silu(v);
  }
  return v;
}

// Two neighbouring outputs (gm, gn) and (gm, gn + 1) of one accumulator
// fragment: epilogue, rounding, store (a paired store where aligned).
template <typename TOut>
__device__ __forceinline__ void flush_pair(const Args& p, float v0, float v1, int gm, int gn) {
  if (gm >= p.M || gn >= p.N) return;
  TOut* c = static_cast<TOut*>(p.C) + (long long)gm * p.N + gn;
  const TOut o0 = from_f32<TOut>(flush_one(p, v0, gm, gn));
  if (gn + 1 < p.N) {
    const TOut o1 = from_f32<TOut>(flush_one(p, v1, gm, gn + 1));
    if (p.N % 2 == 0) {
      if constexpr (sizeof(TOut) == 2) {
        __nv_bfloat162 pair;
        pair.x = o0;
        pair.y = o1;
        *reinterpret_cast<__nv_bfloat162*>(c) = pair;
      } else {
        *reinterpret_cast<float2*>(c) = make_float2(o0, o1);
      }
      return;
    }
    c[1] = o1;
  }
  c[0] = o0;
}

// The A and B fragments of k-step kk of a warp's WM x WN sub-tile from the
// stage's shared tiles.
template <int MT, int NT, int WM, int WN, int A_LD, int B_LD, bool A_KM, bool B_NK>
__device__ __forceinline__ void load_frags(uint32_t (&af)[MT][4], uint32_t (&bfr)[NT][2],
                                           const bf16* a, const bf16* b, int kk, int wm, int wn,
                                           int lane) {
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int mb = wm * WM + i * 16;
    if constexpr (A_KM)
      repro::ldmatrix_x4_trans(
          af[i], a + (kk * 16 + (lane & 7) + (lane >> 4) * 8) * A_LD + mb + ((lane >> 3) & 1) * 8);
    else
      repro::ldmatrix_x4(af[i], a + (mb + (lane & 15)) * A_LD + kk * 16 + (lane >> 4) * 8);
  }
  if constexpr (NT == 1) {
    const int nb = wn * WN;
    if constexpr (B_NK)
      repro::ldmatrix_x2(bfr[0], b + (nb + (lane & 7)) * B_LD + kk * 16 + ((lane >> 3) & 1) * 8);
    else
      repro::ldmatrix_x2_trans(bfr[0], b + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * B_LD + nb);
  } else {
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      const int nb = wn * WN + j * 16;
      uint32_t r[4];
      if constexpr (B_NK)
        repro::ldmatrix_x4(r, b + (nb + (lane & 7) + (lane >> 4) * 8) * B_LD + kk * 16 +
                                  ((lane >> 3) & 1) * 8);
      else
        repro::ldmatrix_x4_trans(r, b + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * B_LD + nb +
                                        (lane >> 4) * 8);
      bfr[2 * j][0] = r[0];
      bfr[2 * j][1] = r[1];
      bfr[2 * j + 1][0] = r[2];
      bfr[2 * j + 1][1] = r[3];
    }
  }
}

// One block computes a BM x BN tile of C with (BM / WM) x (BN / WN) warps,
// each a WM x WN sub-tile of (WM / 16) x (WN / 8) m16n8 accumulators.
// A_KM: A is [K, M]; B_NK: B is [N, K].
template <int BM, int BN, int BK, int WM, int WN, int STAGES, int MIN_BLOCKS, bool A_KM,
          bool B_NK, typename TOut>
__global__ void __launch_bounds__((BM / WM) * (BN / WN) * 32, MIN_BLOCKS)
mma_matmul_kernel(Args p) {
  constexpr int WARPS_N = BN / WN, THREADS = (BM / WM) * WARPS_N * 32;
  constexpr int MT = WM / 16, NT = WN / 8;
  // shared tiles: A as [BM][BK] (K contiguous) or [BK][BM]; B as [BN][BK]
  // or [BK][BN]
  constexpr int A_LD = A_KM ? padded(BM) : padded(BK);
  constexpr int B_LD = B_NK ? padded(BK) : padded(BN);
  constexpr int A_ELEMS = (A_KM ? BK : BM) * A_LD, B_ELEMS = (B_NK ? BN : BK) * B_LD;
  static_assert(NT == 1 || NT % 2 == 0, "B fragments load in pairs of n8 tiles");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);
  bf16* Bs = As + STAGES * A_ELEMS;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int kt_n = (p.K + BK - 1) / BK;

  auto load_stage = [&](int slot, int k0) {
    bf16* a = As + slot * A_ELEMS;
    bf16* b = Bs + slot * B_ELEMS;
    if constexpr (A_KM)
      repro::load_tile<BK, BM, THREADS>(a, p.A, p.lda, k0, p.K, m0, p.M, p.a_vec, tid);
    else
      repro::load_tile<BM, BK, THREADS>(a, p.A, p.lda, m0, p.M, k0, p.K, p.a_vec, tid);
    if constexpr (B_NK)
      repro::load_tile<BN, BK, THREADS>(b, p.B, p.ldb, n0, p.N, k0, p.K, p.b_vec, tid);
    else
      repro::load_tile<BK, BN, THREADS>(b, p.B, p.ldb, k0, p.K, n0, p.N, p.b_vec, tid);
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < kt_n) load_stage(s, s * BK);
    repro::cp_async_commit();
  }

  for (int kt = 0; kt < kt_n; ++kt) {
    repro::cp_async_wait<STAGES - 2>();  // stage kt has landed
    __syncthreads();                     // ... for every thread; stage kt - 1 is free
    const int next = kt + STAGES - 1;
    if (next < kt_n) load_stage(next % STAGES, next * BK);
    repro::cp_async_commit();

    const bf16* a = As + (kt % STAGES) * A_ELEMS;
    const bf16* b = Bs + (kt % STAGES) * B_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      if (kt * BK + kk * 16 >= p.K) break;  // the k-order: ceil(K / 16) steps
      uint32_t af[MT][4], bfr[NT][2];
      load_frags<MT, NT, WM, WN, A_LD, B_LD, A_KM, B_NK>(af, bfr, a, b, kk, wm, wn, lane);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) repro::mma_bf16(acc[i][j], af[i], bfr[j][0], bfr[j][1]);
    }
  }
  repro::cp_async_wait<0>();

  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int gm = m0 + wm * WM + i * 16 + g;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int gn = n0 + wn * WN + j * 8 + 2 * t;
      flush_pair<TOut>(p, acc[i][j][0], acc[i][j][1], gm, gn);
      flush_pair<TOut>(p, acc[i][j][2], acc[i][j][3], gm + 8, gn);
    }
  }
}

template <int BM, int BN, int BK, int WM, int WN, int STAGES, int MIN_BLOCKS, bool A_KM,
          bool B_NK, typename TOut>
cudaError_t launch_plan(const Args& p, cudaStream_t s) {
  constexpr int A_LD = A_KM ? padded(BM) : padded(BK);
  constexpr int B_LD = B_NK ? padded(BK) : padded(BN);
  constexpr int SMEM = STAGES * 2 * ((A_KM ? BK : BM) * A_LD + (B_NK ? BN : BK) * B_LD);
  constexpr int THREADS = (BM / WM) * (BN / WN) * 32;
  auto kernel = mma_matmul_kernel<BM, BN, BK, WM, WN, STAGES, MIN_BLOCKS, A_KM, B_NK, TOut>;
  // above 48 KB a block's shared memory must be asked for, once a kernel
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.M + BM - 1) / BM, (p.N + BN - 1) / BN);
  kernel<<<grid, THREADS, SMEM, s>>>(p);
  return cudaGetLastError();
}

// The wide tile on wgmma, fed by TMA: a 128 x BN block of C (BN = 128, or
// 192 where that takes a wave of blocks off), one producer warpgroup whose
// first thread keeps TMA loads of 64-deep k-stages in flight (A and B
// boxes in 128-byte-swizzled atoms, zero past the edges), and two
// consumer warpgroups of 64 rows that wait on a stage's "full" mbarrier,
// run its 4 m64nBNk16 steps (fewer at K's end) and, once the steps of the
// stage before are done, release that stage on its "empty" mbarrier. No
// block-wide barrier in the k-loop.
constexpr int TMA_STAGES = 4, TMA_A = 128 * 64 * 2;  // bytes of an A stage

template <int BN>
constexpr int tma_smem() { return TMA_STAGES * (TMA_A + BN * 64 * 2) + 1024 + TMA_STAGES * 16; }

template <int BN, bool A_KM, bool B_NK, typename TOut>
__global__ void __launch_bounds__(384, 1)
tma_matmul_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b, Args p) {
  constexpr int BK = 64, STAGES = TMA_STAGES, A_BYTES = TMA_A, B_BYTES = BN * BK * 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the swizzle works on address bits: atoms must sit on 1024-byte bounds
  const uint32_t As = (repro::smem_u32(smem_raw) + 1023) & ~1023u, Bs = As + STAGES * A_BYTES;
  const uint32_t full = Bs + STAGES * B_BYTES, empty = full + STAGES * 8;  // mbarriers
  const int tid = threadIdx.x, wg = tid / 128;
  const int m0 = blockIdx.x * 128, n0 = blockIdx.y * BN;
  const int kt_n = (p.K + BK - 1) / BK;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      repro::mbar_init(full + 8 * s, 1);
      repro::mbar_init(empty + 8 * s, 256);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // the producer
    if (tid == 0) {
      for (int kt = 0; kt < kt_n; ++kt) {
        const int s = kt % STAGES, k0 = kt * BK;
        const uint32_t bar = full + 8 * s, a = As + s * A_BYTES, b = Bs + s * B_BYTES;
        repro::mbar_wait(empty + 8 * s, ((kt / STAGES) & 1) ^ 1);
        repro::mbar_arrive_tx(bar, A_BYTES + B_BYTES);
        if (A_KM) {  // 64-wide atom columns along M, 8 KB each
          repro::tma_load_2d(a, &map_a, bar, m0, k0);
          repro::tma_load_2d(a + 8192, &map_a, bar, m0 + 64, k0);
        } else {
          repro::tma_load_2d(a, &map_a, bar, k0, m0);
        }
        if (B_NK) {
          repro::tma_load_2d(b, &map_b, bar, k0, n0);
        } else {
#pragma unroll
          for (int c = 0; c < BN / 64; ++c)
            repro::tma_load_2d(b + 8192 * c, &map_b, bar, n0 + 64 * c, k0);
        }
      }
    }
    return;
  }

  // a consumer: rows [64 c, 64 c + 64) of the tile. A K-major operand: rows
  // of 128 bytes in 8-row atoms 1024 bytes apart (the leading offset is
  // unused), a k-step 32 bytes into the row. An MN-major one: 64-wide atom
  // columns 8 KB apart, 8-deep k groups 1024 bytes apart, a k-step two k
  // groups.
  const int c = wg - 1, ct = tid % 128;
  const uint32_t a_off = A_KM ? c * 8192 : c * 64 * 128;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < kt_n; ++kt) {
    const int s = kt % STAGES;
    repro::mbar_wait(full + 8 * s, (kt / STAGES) & 1);
    const uint32_t a = As + s * A_BYTES + a_off, b = Bs + s * B_BYTES;
    const int steps = min(BK / 16, (p.K - kt * BK + 15) / 16);  // the k-order: ceil(K / 16) steps
    repro::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      if (kk >= steps) break;
      const uint64_t da = A_KM ? repro::gmma_desc_sw128(a + kk * 2048, 8192, 1024)
                               : repro::gmma_desc_sw128(a + kk * 32, 16, 1024);
      const uint64_t db = B_NK ? repro::gmma_desc_sw128(b + kk * 32, 16, 1024)
                               : repro::gmma_desc_sw128(b + kk * 2048, 8192, 1024);
      repro::wgmma_m64k16<BN, A_KM, !B_NK>(acc, da, db);
    }
    repro::wgmma_commit();
    repro::wgmma_wait<1>();  // the steps of stage kt - 1 are done: release it
    if (kt > 0) repro::mbar_arrive(empty + 8 * ((kt - 1) % STAGES));
  }
  repro::wgmma_wait<0>();

  const int lane = ct % 32, g = lane / 4, t = lane % 4, gm = m0 + c * 64 + ct / 32 * 16 + g;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int gn = n0 + j * 8 + 2 * t;
    flush_pair<TOut>(p, acc[4 * j], acc[4 * j + 1], gm, gn);
    flush_pair<TOut>(p, acc[4 * j + 2], acc[4 * j + 3], gm + 8, gn);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A TMA map of a row-major bf16 matrix of `rows` x `cols` (row stride ld),
// in boxes of box_rows x 64 columns, 128-byte swizzled, zero past its edge.
cudaError_t make_map(CUtensorMap* map, const void* ptr, int rows, int cols, long long ld,
                     int box_rows) {
  // libcuda's own entry point (the runtime API has no tensor-map encoder),
  // from the copy the CUDA runtime has loaded
  static EncodeTiled encode = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows}, steps[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                            strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int BN, bool A_KM, bool B_NK, typename TOut>
cudaError_t launch_tma(const Args& p, cudaStream_t s) {
  constexpr int SMEM = tma_smem<BN>();
  auto kernel = tma_matmul_kernel<BN, A_KM, B_NK, TOut>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (attr != cudaSuccess) return attr;
  CUtensorMap map_a, map_b;
  cudaError_t err = A_KM ? make_map(&map_a, p.A, p.K, p.M, p.lda, 64)
                         : make_map(&map_a, p.A, p.M, p.K, p.lda, 128);
  if (err == cudaSuccess)
    err = B_NK ? make_map(&map_b, p.B, p.N, p.K, p.ldb, BN)
               : make_map(&map_b, p.B, p.K, p.N, p.ldb, 64);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.M + 127) / 128, (p.N + BN - 1) / BN);
  kernel<<<grid, 384, SMEM, s>>>(map_a, map_b, p);
  return cudaGetLastError();
}

// The instance numbers of `kernels/matmul.py` `tile_plan`.
enum Plan { ROWS16_N8 = 0, ROWS16_N32 = 1, WIDE = 2, WIDE192 = 3 };

template <bool A_KM, bool B_NK, typename TOut>
cudaError_t launch_layout(const Args& p, int plan, cudaStream_t s) {
  // TMA takes 16-byte aligned operands and K > 0; the narrow tile the rest
  const bool tma = p.a_vec && p.b_vec && p.K > 0;
  switch (plan) {
    case ROWS16_N8: return launch_plan<16, 8, 256, 16, 8, 4, 4, A_KM, B_NK, TOut>(p, s);
    case ROWS16_N32: return launch_plan<16, 32, 128, 16, 32, 4, 4, A_KM, B_NK, TOut>(p, s);
    case WIDE: if (tma) return launch_tma<128, A_KM, B_NK, TOut>(p, s); break;
    case WIDE192: if (tma) return launch_tma<192, A_KM, B_NK, TOut>(p, s); break;
    default: return cudaErrorInvalidValue;
  }
  return launch_plan<128, 64, 64, 64, 32, 3, 2, A_KM, B_NK, TOut>(p, s);
}

template <typename TOut>
cudaError_t launch_out(const Args& p, int a_km, int b_nk, int plan, cudaStream_t s) {
  if (a_km && b_nk) return launch_layout<true, true, TOut>(p, plan, s);
  if (a_km) return launch_layout<true, false, TOut>(p, plan, s);
  if (b_nk) return launch_layout<false, true, TOut>(p, plan, s);
  return launch_layout<false, false, TOut>(p, plan, s);
}

}  // namespace

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
