// The bf16 GEMMs on Hopper's tensor cores: the tiled GEMM with its fused
// epilogue, the int8-weight GEMM and the SwiGLU dual GEMM.
//
// Replaces, for bf16 activations, the Pallas kernels of
// src/repro/kernels/matmul.py: `matmul_tiled` (_matmul_kernel),
// `matmul_q_tiled` (_matmul_q_kernel) and `gated_matmul_tiled`
// (_gated_matmul_kernel); their f32 instances stay on the FMA kernels of
// matmul.cu. C[M, N] = epilogue(A @ B), with bf16 products summed in f32
// on the tensor cores. The epilogue (none | bias | bias_gelu (tanh form) |
// bias_silu | residual) is applied on the f32 accumulator fragments at
// the flush, then the one rounding to bf16 or f32.
//
// The int8-weight GEMM, C = epilogue((A @ widen(Wq)) * scale), stages the
// int8 [K, N] tile by cp.async (16 bytes at a time; 8 for an 8-column
// tile) and widens each thread's B fragment from shared memory into
// packed bf16 pairs: int8 -> bf16 is exact (|q| <= 127 fits bf16's 8
// significant bits), so an mma.sync bf16 step on the widened fragment is
// the JAX kernel's bf16 dot of A against the widened tile. The (N,) f32
// scale multiplies the f32 accumulator at the flush, before the epilogue.
// It takes the `rows16` tile at decode (8 or 16 columns a block, by N)
// and the 128 x 64 mma.sync tile for M > 16 (wgmma reads B from shared
// memory in A's type, so int8 there would need a widening pass between
// TMA and wgmma).
//
// The dual GEMM, H = silu(A @ Wg) * (A @ Wu), stages the same columns of
// Wg and Wu side by side in one B tile, so one A fragment feeds both
// products and the thread that holds column n of g holds column n of u
// in the same position of its other accumulator: the flush takes
// silu(g) * u on the f32 accumulators (rounded intrinsics) and rounds
// once to bf16; neither g nor u is written. At decode a one-warp 16-row
// tile with 16 columns of each; for M > 16 the TMA + wgmma tile,
// whose B stage is one (or two) 64-column boxes of Wg beside the same of
// Wu, so one m64n128k16 (m64n256k16) step yields 64 (128) columns of g
// in the first half of the accumulator groups and of u in the second,
// and a block writes 128 x 64 (128 x 128) of H.
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
// bytes (the tied-embedding logits: 311 MB, 93 us at 3.35 TB/s; an int8
// up-projection, K=1024 N=3072: 3.15 MB, 0.94 us; the dual GEMM's two
// bf16 weights: 12.6 MB a layer, 3.8 us); a prefill or training GEMM
// (M = 2048) by the tensor cores (M=2048 K=1024 N=3072: 12.9 GFLOP, 13 us
// at the 989 TFLOP/s dense bf16 peak; the dual GEMM twice that, 26 us). The wide tile
// still leaves time there: one block an SM, so whole waves of blocks (the
// 192-wide tile takes M=1024 N=3072 from 1.45 waves to 1), each epilogue
// unhidden, and each tile re-reads its A rows and B columns from L2.
//
// Batched forms (the MoE expert banks; the counterpart of the JAX package's
// vmapped `matmul_tiled` and `gated_matmul_tiled`): one launch for E
// experts, blockIdx.z the expert, a pointer offset an expert for A, B, U and
// C on the mma.sync tiles, rank-3 TMA maps (columns, rows, experts) on the
// wgmma tile. Each expert runs the tile plan the 2-D plan function picks
// for its (M, K, N) and layout, the same code on its own operands, so an
// expert's output is the 2-D kernel's on them, bit for bit. The batched
// GEMM takes the 2-D GEMM's four layouts (a bank's backward reads
// g[e] B[e]^T and A[e]^T g[e] in place: a transposed map's boxes are the
// 2-D kernel's `a_km` and `b_nk` boxes, one matrix deep); the batched
// dual GEMM row-major banks. A training step's bank GEMM at mixtral's
// widths (8 experts of 640 slots, 6144 x 16384) is 1.03 TFLOP in any of
// its three layouts, 1.04 ms at the 989 TFLOP/s bf16 peak. A decode step's bank
// GEMM (M = 4 slots an expert) is bound by the bank's bytes: mixtral's
// dual GEMM (2 x 8 x 6144 x 16384 bf16, 3.2 GB) takes at least 0.96 ms a
// layer at 3.35 TB/s.
//
// Batch invariance: every plan of the three GEMMs sums each output in one
// order, fixed by K alone: ceil(K / 16) k-steps of 16 in ascending order
// from a zero f32 accumulator, steps past K skipped, no split of K across
// warps or blocks and no atomics. An m16n8k16 mma.sync step and an
// m64nNk16 wgmma step give the same bits, and the flush (scale, epilogue,
// silu(g) * u) is written in rounded intrinsics that no instance contracts
// differently, so a tile plan changes which rows and columns share a
// block, never a row's bits: one row of C is the same at M = 1, 4, 136 or
// 2048 (`tests/test_torch_cuda.py` checks it on the card for each GEMM).
//
// The kernels and their launchers live here, in an anonymous namespace;
// matmul_tc.cu holds the 2-D entry points and matmul_tc_batched.cu the
// batched ones, two translation units that nvcc compiles at once (each
// instantiates only the kernels its entry points reach).

#pragma once

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
  const void* B;  // bf16, or int8 for the int8-weight GEMM; Wg for the dual GEMM
  const void* E;
  void* C;
  int M, N, K;
  long long lda, ldb, lde;
  int e_bf16, epilogue;
  bool a_vec, b_vec;  // 16-byte aligned bases and a leading dim of 16 bytes' multiple
  const bf16* U = nullptr;   // the dual GEMM's Wu (B's row stride)
  const float* S = nullptr;  // the int8 weight's (N,) scale
  // a batched launch (the expert banks): blockIdx.z is the expert, and sa,
  // sb, sc one expert's elements of A, of B (and U) and of C
  int batch = 1;
  long long sa = 0, sb = 0, sc = 0;
};

// The operands of expert blockIdx.z of a batched launch: a pointer offset
// each, so that an expert's blocks run the 2-D kernel's tile on its own
// matrices and give that kernel's bits.
template <typename TOut>
__device__ __forceinline__ Args expert(const Args& p) {
  const long long z = blockIdx.z;
  Args q = p;
  q.A = p.A + z * p.sa;
  q.B = static_cast<const bf16*>(p.B) + z * p.sb;
  if (p.U != nullptr) q.U = p.U + z * p.sb;
  q.C = static_cast<TOut*>(p.C) + z * p.sc;
  return q;
}

// silu(g) * u on the dual GEMM's f32 accumulators.
__device__ __forceinline__ float glu(float g, float u) { return __fmul_rn(silu(g), u); }

__device__ __forceinline__ float flush_one(const Args& p, float v, int gm, int gn) {
  if (p.S != nullptr) v = __fmul_rn(v, p.S[gn]);  // dequantize before the epilogue
  if (p.epilogue == EP_RESIDUAL) {
    v = __fadd_rn(v, load_any(p.E, p.e_bf16, (long long)gm * p.lde + gn));
  } else if (p.epilogue != EP_NONE) {
    v = __fadd_rn(v, load_any(p.E, p.e_bf16, gn));
    if (p.epilogue == EP_BIAS_GELU) v = gelu_tanh(v);
    else if (p.epilogue == EP_BIAS_SILU) v = silu(v);
  }
  return v;
}

// Two neighbouring outputs (gm, gn) and (gm, gn + 1): out(i, column) is
// output i's f32 value, then the rounding and the store (a paired store
// where aligned).
template <typename TOut, typename Out>
__device__ __forceinline__ void store_pair(const Args& p, int gm, int gn, Out out) {
  if (gm >= p.M || gn >= p.N) return;
  TOut* c = static_cast<TOut*>(p.C) + (long long)gm * p.N + gn;
  const TOut o0 = from_f32<TOut>(out(0, gn));
  if (gn + 1 < p.N) {
    const TOut o1 = from_f32<TOut>(out(1, gn + 1));
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

// Two neighbouring outputs of one accumulator fragment: scale, epilogue,
// rounding, store.
template <typename TOut>
__device__ __forceinline__ void flush_pair(const Args& p, float v0, float v1, int gm, int gn) {
  store_pair<TOut>(p, gm, gn, [&](int i, int n) { return flush_one(p, i ? v1 : v0, gm, n); });
}

// The dual GEMM's two outputs from their g and u accumulators.
template <typename TOut>
__device__ __forceinline__ void flush_glu(const Args& p, float g0, float g1, float u0, float u1,
                                          int gm, int gn) {
  store_pair<TOut>(p, gm, gn, [&](int i, int) { return i ? glu(g1, u1) : glu(g0, u0); });
}

// The A fragments of k-step kk of a warp's WM-row sub-tile from the
// stage's shared tile.
template <int MT, int WM, int A_LD, bool A_KM>
__device__ __forceinline__ void load_a_frags(uint32_t (&af)[MT][4], const bf16* a, int kk, int wm,
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
}

// The B fragments of k-step kk of a warp's WN-column sub-tile from the
// stage's shared bf16 tile.
template <int NT, int WN, int B_LD, bool B_NK>
__device__ __forceinline__ void load_b_frags(uint32_t (&bfr)[NT][2], const bf16* b, int kk, int wn,
                                             int lane) {
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

// The same from a shared int8 [BK][B_LD] tile, widened: lane 4 g + t takes
// column g of k rows 2t, 2t + 1, 8 + 2t and 9 + 2t of each n8 tile (the
// fragment ldmatrix.trans would give of a bf16 tile), as two packed bf16
// pairs. int8 -> f32 -> bf16 is exact.
template <int NT, int WN, int B_LD>
__device__ __forceinline__ void load_b_frags_i8(uint32_t (&bfr)[NT][2], const int8_t* b, int kk,
                                                int wn, int lane) {
  const int8_t* q = b + (kk * 16 + 2 * (lane % 4)) * B_LD + wn * WN + lane / 4;
#pragma unroll
  for (int j = 0; j < NT; ++j, q += 8) {
    bfr[j][0] = repro::pack_bf16(static_cast<float>(q[0]), static_cast<float>(q[B_LD]));
    bfr[j][1] = repro::pack_bf16(static_cast<float>(q[8 * B_LD]), static_cast<float>(q[9 * B_LD]));
  }
}

// The shared-memory layout of an mma.sync tile's stages: A as [BM][BK]
// (K contiguous) or [BK][BM]; B as [BN][BK], [BK][BN] bf16 or [BK][BN]
// int8 (TB). Every stage starts 16-byte aligned.
template <int BM, int BN, int BK, bool A_KM, bool B_NK, typename TB>
struct Tiles {
  static constexpr bool I8 = sizeof(TB) == 1;
  static constexpr int A_LD = A_KM ? padded(BM) : padded(BK);
  static constexpr int B_LD = I8 ? repro::padded_i8(BN) : B_NK ? padded(BK) : padded(BN);
  static constexpr int A_BYTES = (A_KM ? BK : BM) * A_LD * 2;
  static constexpr int B_BYTES = (B_NK ? BN : BK) * B_LD * (int)sizeof(TB);
  static_assert(A_BYTES % 16 == 0 && B_BYTES % 16 == 0, "stages on 16-byte bounds");
};

// One block computes a BM x BN tile of C with (BM / WM) x (BN / WN) warps,
// each a WM x WN sub-tile of (WM / 16) x (WN / 8) m16n8 accumulators.
// A_KM: A is [K, M]; B_NK: B is [N, K]; TB: B's element type (bf16, or
// int8 widened in the fragments); GATED: the dual GEMM, whose B tile holds
// BN / 2 columns of Wg and then the same columns of Wu (every warp spans
// the whole tile, so accumulator j and j + NT / 2 are g and u of one
// column), and which writes BN / 2 columns of H.
template <int BM, int BN, int BK, int WM, int WN, int STAGES, bool A_KM, bool B_NK, typename TB,
          bool GATED, typename TOut>
__device__ __forceinline__ void mma_tile(const Args& p) {
  using T = Tiles<BM, BN, BK, A_KM, B_NK, TB>;
  constexpr int WARPS_N = BN / WN, THREADS = (BM / WM) * WARPS_N * 32;
  constexpr int MT = WM / 16, NT = WN / 8;
  static_assert(T::I8 || NT == 1 || NT % 2 == 0, "B fragments load in pairs of n8 tiles");
  static_assert(!GATED || (WARPS_N == 1 && NT % 2 == 0 && !A_KM && !B_NK && !T::I8),
                "a dual-GEMM warp holds g and u of the same columns");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* As = smem_raw;
  unsigned char* Bs = As + STAGES * T::A_BYTES;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * (GATED ? BN / 2 : BN);
  const int kt_n = (p.K + BK - 1) / BK;

  auto load_stage = [&](int slot, int k0) {
    bf16* a = reinterpret_cast<bf16*>(As + slot * T::A_BYTES);
    unsigned char* b = Bs + slot * T::B_BYTES;
    if constexpr (A_KM)
      repro::load_tile<BK, BM, THREADS>(a, p.A, p.lda, k0, p.K, m0, p.M, p.a_vec, tid);
    else
      repro::load_tile<BM, BK, THREADS>(a, p.A, p.lda, m0, p.M, k0, p.K, p.a_vec, tid);
    if constexpr (T::I8) {
      repro::load_tile_i8<BK, BN, THREADS>(reinterpret_cast<int8_t*>(b),
                                           static_cast<const int8_t*>(p.B), p.ldb, k0, p.K, n0,
                                           p.N, p.b_vec, tid);
    } else if constexpr (GATED) {
      bf16* bb = reinterpret_cast<bf16*>(b);
      repro::load_tile<BK, BN / 2, THREADS, T::B_LD>(bb, static_cast<const bf16*>(p.B), p.ldb,
                                                     k0, p.K, n0, p.N, p.b_vec, tid);
      repro::load_tile<BK, BN / 2, THREADS, T::B_LD>(bb + BN / 2, p.U, p.ldb, k0, p.K, n0, p.N,
                                                     p.b_vec, tid);
    } else if constexpr (B_NK) {
      repro::load_tile<BN, BK, THREADS>(reinterpret_cast<bf16*>(b),
                                        static_cast<const bf16*>(p.B), p.ldb, n0, p.N, k0, p.K,
                                        p.b_vec, tid);
    } else {
      repro::load_tile<BK, BN, THREADS>(reinterpret_cast<bf16*>(b),
                                        static_cast<const bf16*>(p.B), p.ldb, k0, p.K, n0, p.N,
                                        p.b_vec, tid);
    }
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

    const bf16* a = reinterpret_cast<const bf16*>(As + (kt % STAGES) * T::A_BYTES);
    const unsigned char* b = Bs + (kt % STAGES) * T::B_BYTES;
    // a decode tile's warp (one m16 tile) keeps its fragments in two
    // register sets: k-step kk + 1's are read from shared memory ahead of
    // kk's mma.sync, so their latency overlaps it (in the larger tiles
    // the second set costs more than it hides)
    constexpr int R = MT == 1 ? 2 : 1;
    uint32_t af[R][MT][4], bfr[R][NT][2];
    auto load_step = [&](int kk, int r) {
      load_a_frags<MT, WM, T::A_LD, A_KM>(af[r], a, kk, wm, lane);
      if constexpr (T::I8)
        load_b_frags_i8<NT, WN, T::B_LD>(bfr[r], reinterpret_cast<const int8_t*>(b), kk, wn,
                                         lane);
      else
        load_b_frags<NT, WN, T::B_LD, B_NK>(bfr[r], reinterpret_cast<const bf16*>(b), kk, wn,
                                            lane);
    };
    if constexpr (R == 2) load_step(0, 0);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      if (kt * BK + kk * 16 >= p.K) break;  // the k-order: ceil(K / 16) steps
      if constexpr (R == 2) {
        if (kk + 1 < BK / 16) load_step(kk + 1, (kk + 1) % 2);
      } else {
        load_step(kk, 0);
      }
      const int r = kk % R;
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          repro::mma_bf16(acc[i][j], af[r][i], bfr[r][j][0], bfr[r][j][1]);
    }
  }
  repro::cp_async_wait<0>();

  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int gm = m0 + wm * WM + i * 16 + g;
    if constexpr (GATED) {
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        const float(&gv)[4] = acc[i][j];
        const float(&uv)[4] = acc[i][j + NT / 2];
        const int gn = n0 + j * 8 + 2 * t;
        flush_glu<TOut>(p, gv[0], gv[1], uv[0], uv[1], gm, gn);
        flush_glu<TOut>(p, gv[2], gv[3], uv[2], uv[3], gm + 8, gn);
      }
    } else {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int gn = n0 + wn * WN + j * 8 + 2 * t;
        flush_pair<TOut>(p, acc[i][j][0], acc[i][j][1], gm, gn);
        flush_pair<TOut>(p, acc[i][j][2], acc[i][j][3], gm + 8, gn);
      }
    }
  }
}

// The GEMM (TB = bf16) and the int8-weight GEMM (TB = int8_t) on mma.sync.
template <int BM, int BN, int BK, int WM, int WN, int STAGES, int MIN_BLOCKS, bool A_KM,
          bool B_NK, typename TOut, typename TB>
__global__ void __launch_bounds__((BM / WM) * (BN / WN) * 32, MIN_BLOCKS)
mma_matmul_kernel(Args p) {
  mma_tile<BM, BN, BK, WM, WN, STAGES, A_KM, B_NK, TB, false, TOut>(p);
}

// The dual GEMM on mma.sync (row-major A, [K, N] Wg and Wu, bf16 H).
template <int BM, int BN, int BK, int WM, int WN, int STAGES, int MIN_BLOCKS>
__global__ void __launch_bounds__((BM / WM) * (BN / WN) * 32, MIN_BLOCKS)
mma_gated_matmul_kernel(Args p) {
  mma_tile<BM, BN, BK, WM, WN, STAGES, false, false, bf16, true, bf16>(p);
}

// The batched forms of both (banks of bf16 matrices, one expert a
// blockIdx.z; the dual GEMM's row-major): the same tiles on each expert's
// operands.
template <int BM, int BN, int BK, int WM, int WN, int STAGES, int MIN_BLOCKS, bool A_KM,
          bool B_NK, typename TOut>
__global__ void __launch_bounds__((BM / WM) * (BN / WN) * 32, MIN_BLOCKS)
mma_matmul_batched_kernel(Args p) {
  mma_tile<BM, BN, BK, WM, WN, STAGES, A_KM, B_NK, bf16, false, TOut>(expert<TOut>(p));
}

template <int BM, int BN, int BK, int WM, int WN, int STAGES, int MIN_BLOCKS>
__global__ void __launch_bounds__((BM / WM) * (BN / WN) * 32, MIN_BLOCKS)
mma_gated_matmul_batched_kernel(Args p) {
  mma_tile<BM, BN, BK, WM, WN, STAGES, false, false, bf16, true, bf16>(expert<bf16>(p));
}

template <int BM, int BN, int BK, int WM, int WN, int STAGES, int MIN_BLOCKS, bool A_KM,
          bool B_NK, typename TOut, typename TB = bf16, bool GATED = false, bool BATCHED = false>
cudaError_t launch_plan(const Args& p, cudaStream_t s) {
  using T = Tiles<BM, BN, BK, A_KM, B_NK, TB>;
  static_assert(!BATCHED || !T::I8, "a batched launch reads bf16 banks");
  constexpr int SMEM = STAGES * (T::A_BYTES + T::B_BYTES);
  constexpr int THREADS = (BM / WM) * (BN / WN) * 32, BN_OUT = GATED ? BN / 2 : BN;
  void (*kernel)(Args);
  if constexpr (BATCHED && GATED)
    kernel = mma_gated_matmul_batched_kernel<BM, BN, BK, WM, WN, STAGES, MIN_BLOCKS>;
  else if constexpr (BATCHED)
    kernel = mma_matmul_batched_kernel<BM, BN, BK, WM, WN, STAGES, MIN_BLOCKS, A_KM, B_NK, TOut>;
  else if constexpr (GATED)
    kernel = mma_gated_matmul_kernel<BM, BN, BK, WM, WN, STAGES, MIN_BLOCKS>;
  else
    kernel = mma_matmul_kernel<BM, BN, BK, WM, WN, STAGES, MIN_BLOCKS, A_KM, B_NK, TOut, TB>;
  // above 48 KB a block's shared memory must be asked for, once a kernel
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.M + BM - 1) / BM, (p.N + BN_OUT - 1) / BN_OUT, p.batch);
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
// block-wide barrier in the k-loop. GATED (BN = 128 or 256): the dual
// GEMM, whose B stage is BN / 2 columns of Wg (map_b) beside the same of
// Wu (map_u); the block writes 128 x BN / 2 of H. BATCHED: the maps are
// rank 3 (columns, rows, experts) in either layout, and a block loads
// expert blockIdx.z's boxes (a box of a flat 2-D map of E x rows would
// read into the next expert's rows).
constexpr int TMA_STAGES = 4, TMA_A = 128 * 64 * 2;  // bytes of an A stage

template <int BN>
constexpr int tma_smem() { return TMA_STAGES * (TMA_A + BN * 64 * 2) + 1024 + TMA_STAGES * 16; }

template <int BN, bool A_KM, bool B_NK, bool GATED, typename TOut, bool BATCHED = false>
__device__ __forceinline__ void tma_tile(const CUtensorMap& map_a, const CUtensorMap& map_b,
                                         const CUtensorMap& map_u, const Args& p) {
  constexpr int BK = 64, STAGES = TMA_STAGES, A_BYTES = TMA_A, B_BYTES = BN * BK * 2;
  static_assert(!GATED || ((BN == 128 || BN == 256) && !A_KM && !B_NK),
                "the dual GEMM's wide tile");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the swizzle works on address bits: atoms must sit on 1024-byte bounds
  const uint32_t As = (repro::smem_u32(smem_raw) + 1023) & ~1023u, Bs = As + STAGES * A_BYTES;
  const uint32_t full = Bs + STAGES * B_BYTES, empty = full + STAGES * 8;  // mbarriers
  const int tid = threadIdx.x, wg = tid / 128;
  const int m0 = blockIdx.x * 128, n0 = blockIdx.y * (GATED ? BN / 2 : BN);
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
        auto load = [&](uint32_t dst, const CUtensorMap* map, int c0, int c1) {
          if constexpr (BATCHED)
            repro::tma_load_3d(dst, map, bar, c0, c1, blockIdx.z);
          else
            repro::tma_load_2d(dst, map, bar, c0, c1);
        };
        repro::mbar_wait(empty + 8 * s, ((kt / STAGES) & 1) ^ 1);
        repro::mbar_arrive_tx(bar, A_BYTES + B_BYTES);
        if (A_KM) {  // 64-wide atom columns along M, 8 KB each
          load(a, &map_a, m0, k0);
          load(a + 8192, &map_a, m0 + 64, k0);
        } else {
          load(a, &map_a, k0, m0);
        }
        if (B_NK) {
          load(b, &map_b, k0, n0);
        } else if (GATED) {  // BN / 2 columns of Wg, then the same of Wu
#pragma unroll
          for (int c = 0; c < BN / 128; ++c) {
            load(b + 8192 * c, &map_b, n0 + 64 * c, k0);
            load(b + 8192 * (BN / 128 + c), &map_u, n0 + 64 * c, k0);
          }
        } else {
#pragma unroll
          for (int c = 0; c < BN / 64; ++c) load(b + 8192 * c, &map_b, n0 + 64 * c, k0);
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
  if constexpr (GATED) {  // group j of g pairs with group j + BN / 16 of u
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      const int gn = n0 + j * 8 + 2 * t, u = 4 * j + BN / 4;
      flush_glu<TOut>(p, acc[4 * j], acc[4 * j + 1], acc[u], acc[u + 1], gm, gn);
      flush_glu<TOut>(p, acc[4 * j + 2], acc[4 * j + 3], acc[u + 2], acc[u + 3], gm + 8, gn);
    }
  } else {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int gn = n0 + j * 8 + 2 * t;
      flush_pair<TOut>(p, acc[4 * j], acc[4 * j + 1], gm, gn);
      flush_pair<TOut>(p, acc[4 * j + 2], acc[4 * j + 3], gm + 8, gn);
    }
  }
}

template <int BN, bool A_KM, bool B_NK, typename TOut>
__global__ void __launch_bounds__(384, 1)
tma_matmul_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b, Args p) {
  tma_tile<BN, A_KM, B_NK, false, TOut>(map_a, map_b, map_b, p);
}

template <int BN>
__global__ void __launch_bounds__(384, 1)
tma_gated_matmul_kernel(const __grid_constant__ CUtensorMap map_a,
                        const __grid_constant__ CUtensorMap map_g,
                        const __grid_constant__ CUtensorMap map_u, Args p) {
  tma_tile<BN, false, false, true, bf16>(map_a, map_g, map_u, p);
}

template <int BN, bool A_KM, bool B_NK, typename TOut>
__global__ void __launch_bounds__(384, 1)
tma_matmul_batched_kernel(const __grid_constant__ CUtensorMap map_a,
                          const __grid_constant__ CUtensorMap map_b, Args p) {
  tma_tile<BN, A_KM, B_NK, false, TOut, true>(map_a, map_b, map_b, expert<TOut>(p));
}

template <int BN>
__global__ void __launch_bounds__(384, 1)
tma_gated_matmul_batched_kernel(const __grid_constant__ CUtensorMap map_a,
                                const __grid_constant__ CUtensorMap map_g,
                                const __grid_constant__ CUtensorMap map_u, Args p) {
  tma_tile<BN, false, false, true, bf16, true>(map_a, map_g, map_u, expert<bf16>(p));
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A TMA map of a row-major bf16 matrix of `rows` x `cols` (row stride ld),
// in boxes of box_rows x 64 columns, 128-byte swizzled, zero past its edge;
// with batch > 0, of a bank of `batch` such matrices batch_ld elements
// apart (rank 3, a box one matrix deep).
cudaError_t make_map(CUtensorMap* map, const void* ptr, int rows, int cols, long long ld,
                     int box_rows, int batch = 0, long long batch_ld = 0) {
  // libcuda's own entry point (the runtime API has no tensor-map encoder),
  // from the copy the CUDA runtime has loaded
  static EncodeTiled encode = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t batches = batch > 0 ? batch : 1;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, batches};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 2, (cuuint64_t)batch_ld * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1}, steps[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, batch > 0 ? 3 : 2,
                            const_cast<void*>(ptr), dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int BN, bool A_KM, bool B_NK, typename TOut, bool GATED = false, bool BATCHED = false>
cudaError_t launch_tma(const Args& p, cudaStream_t s) {
  constexpr int SMEM = tma_smem<BN>(), BN_OUT = GATED ? BN / 2 : BN;
  const void* kernel;
  if constexpr (BATCHED && GATED)
    kernel = reinterpret_cast<const void*>(tma_gated_matmul_batched_kernel<BN>);
  else if constexpr (BATCHED)
    kernel = reinterpret_cast<const void*>(tma_matmul_batched_kernel<BN, A_KM, B_NK, TOut>);
  else if constexpr (GATED)
    kernel = reinterpret_cast<const void*>(tma_gated_matmul_kernel<BN>);
  else
    kernel = reinterpret_cast<const void*>(tma_matmul_kernel<BN, A_KM, B_NK, TOut>);
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (attr != cudaSuccess) return attr;
  const int nb = BATCHED ? p.batch : 0;  // rank-3 maps over the experts
  CUtensorMap map_a, map_b, map_u;
  cudaError_t err = A_KM ? make_map(&map_a, p.A, p.K, p.M, p.lda, 64, nb, p.sa)
                         : make_map(&map_a, p.A, p.M, p.K, p.lda, 128, nb, p.sa);
  if (err == cudaSuccess)
    err = B_NK ? make_map(&map_b, p.B, p.N, p.K, p.ldb, BN, nb, p.sb)
               : make_map(&map_b, p.B, p.K, p.N, p.ldb, 64, nb, p.sb);
  if (err == cudaSuccess && GATED) err = make_map(&map_u, p.U, p.K, p.N, p.ldb, 64, nb, p.sb);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.M + 127) / 128, (p.N + BN_OUT - 1) / BN_OUT, p.batch);
  if constexpr (BATCHED && GATED)
    tma_gated_matmul_batched_kernel<BN><<<grid, 384, SMEM, s>>>(map_a, map_b, map_u, p);
  else if constexpr (BATCHED)
    tma_matmul_batched_kernel<BN, A_KM, B_NK, TOut><<<grid, 384, SMEM, s>>>(map_a, map_b, p);
  else if constexpr (GATED)
    tma_gated_matmul_kernel<BN><<<grid, 384, SMEM, s>>>(map_a, map_b, map_u, p);
  else
    tma_matmul_kernel<BN, A_KM, B_NK, TOut><<<grid, 384, SMEM, s>>>(map_a, map_b, p);
  return cudaGetLastError();
}

// The instance numbers of `kernels/matmul.py` `tile_plan`, `q_tile_plan`
// and `gated_tile_plan` (ROWS16_N<w>: the decode tile, w output columns a
// block).
enum Plan { ROWS16_N8 = 0, ROWS16_N32 = 1, WIDE = 2, WIDE192 = 3, ROWS16_N16 = 4, WIDE256 = 5 };

// BATCHED: the batched GEMM, each expert on the plan the 2-D GEMM takes
// for its (M, K, N) in this layout.
template <bool A_KM, bool B_NK, typename TOut, bool BATCHED = false>
cudaError_t launch_layout(const Args& p, int plan, cudaStream_t s) {
  using B = bf16;
  // TMA takes 16-byte aligned operands and K > 0; the narrow tile the rest
  const bool tma = p.a_vec && p.b_vec && p.K > 0;
  switch (plan) {
    case ROWS16_N8:
      return launch_plan<16, 8, 256, 16, 8, 4, 4, A_KM, B_NK, TOut, B, false, BATCHED>(p, s);
    case ROWS16_N32:
      return launch_plan<16, 32, 128, 16, 32, 4, 4, A_KM, B_NK, TOut, B, false, BATCHED>(p, s);
    case WIDE: if (tma) return launch_tma<128, A_KM, B_NK, TOut, false, BATCHED>(p, s); break;
    case WIDE192: if (tma) return launch_tma<192, A_KM, B_NK, TOut, false, BATCHED>(p, s); break;
    default: return cudaErrorInvalidValue;
  }
  return launch_plan<128, 64, 64, 64, 32, 3, 2, A_KM, B_NK, TOut, B, false, BATCHED>(p, s);
}

// The int8-weight GEMM: the decode tile 8 or 16 columns wide, else the
// 128 x 64 tile (WIDE; no TMA path for an int8 B).
template <typename TOut>
cudaError_t launch_q(const Args& p, int plan, cudaStream_t s) {
  using I8 = int8_t;
  switch (plan) {
    case ROWS16_N8: return launch_plan<16, 8, 256, 16, 8, 4, 4, false, false, TOut, I8>(p, s);
    case ROWS16_N16: return launch_plan<16, 16, 256, 16, 16, 4, 4, false, false, TOut, I8>(p, s);
    case WIDE: return launch_plan<128, 64, 64, 64, 32, 3, 2, false, false, TOut, I8>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

// The dual GEMM: the decode tile with 16 columns of each weight, the
// TMA + wgmma tile with 64 (WIDE) or 128 (WIDE256) of each, or (an operand
// TMA cannot take, K = 0) a 128-row mma.sync tile with 32 of each.
// BATCHED: its batched form over banks of Wg and Wu.
template <bool BATCHED = false>
cudaError_t launch_gated(const Args& p, int plan, cudaStream_t s) {
  using B = bf16;
  const bool tma = p.a_vec && p.b_vec && p.K > 0;
  switch (plan) {
    case ROWS16_N16:
      return launch_plan<16, 32, 128, 16, 32, 4, 4, false, false, B, B, true, BATCHED>(p, s);
    case WIDE: if (tma) return launch_tma<128, false, false, B, true, BATCHED>(p, s); break;
    case WIDE256: if (tma) return launch_tma<256, false, false, B, true, BATCHED>(p, s); break;
    default: return cudaErrorInvalidValue;
  }
  return launch_plan<128, 64, 64, 32, 64, 3, 2, false, false, B, B, true, BATCHED>(p, s);
}

// a 16-byte aligned base, and row and expert strides of whole 16 bytes (a
// bank of stride 0, one matrix for every expert, takes no TMA map)
bool vec16(const void* p, long long ld, long long sz) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && ld % 8 == 0 && sz % 8 == 0 && sz != 0;
}

template <typename TOut, bool BATCHED = false>
cudaError_t launch_out(const Args& p, int a_km, int b_nk, int plan, cudaStream_t s) {
  if (a_km && b_nk) return launch_layout<true, true, TOut, BATCHED>(p, plan, s);
  if (a_km) return launch_layout<true, false, TOut, BATCHED>(p, plan, s);
  if (b_nk) return launch_layout<false, true, TOut, BATCHED>(p, plan, s);
  return launch_layout<false, false, TOut, BATCHED>(p, plan, s);
}

}  // namespace
