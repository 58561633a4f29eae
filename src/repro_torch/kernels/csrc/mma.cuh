// Building blocks of the port's tensor-core kernels (the bf16, dual and
// int8-weight GEMMs of matmul_tc.cuh, the bf16 flash-attention forward and
// backward, the SSD kernel) and of the decode kernel's staging: 16-, 8-
// and 4-byte cp.async with zero fill, ldmatrix, mma.sync.m16n8k16 bf16 ->
// f32, mma.sync.m16n8k8 tf32 -> f32 with the hi + lo split of an f32, and
// tile loaders (bf16 and int8) that mask ragged and unaligned edges; and,
// for the GEMM's wide tile, wgmma.m64nNk16, its shared-memory
// descriptors, mbarriers and TMA loads.
//
// Fragments (PTX ISA, mma.m16n8k16 with .bf16): lane = 4 g + t. A (16x16,
// row) is 4 registers of 2 bf16: (row g, k 2t..2t+1), (g + 8, 2t..),
// (g, 8 + 2t..), (g + 8, 8 + 2t..). B (16x8, col) is 2: (k 2t..2t+1, col g),
// (k 8 + 2t.., g). C/D (16x8 f32) is 4: (g, 2t), (g, 2t + 1), (g + 8, 2t),
// (g + 8, 2t + 1). ldmatrix hands lane l row l / 4, elements 2 (l % 4)..
// of each 8x8 matrix (with .trans, of its transpose), which is exactly
// these layouts, so a tile stored with K contiguous feeds A and an [N, K]
// B without .trans, and a tile stored with M or N contiguous feeds them
// with .trans.
//
// Shared tiles are row-major with a padded row (`padded`): its length in
// 16-byte chunks is odd, so the 8 rows one ldmatrix phase reads fall in 8
// different 16-byte bank groups (no bank conflict), and every row starts
// 16-byte aligned, as cp.async needs.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace repro {

using bf16 = __nv_bfloat16;

// Row length (elements) of a shared tile of `cols` bf16 columns.
__host__ __device__ constexpr int padded(int cols) {
  return (cols + 7) / 8 % 2 == 1 ? (cols + 7) / 8 * 8 : (cols + 7) / 8 * 8 + 8;
}

// Row length (bytes) of a shared tile of `cols` int8 columns: an odd
// number of 16-byte chunks, as `padded`; a row under 16 bytes as it is.
__host__ __device__ constexpr int padded_i8(int cols) {
  return cols < 16 ? cols : (cols / 16 % 2 == 1 ? cols : cols + 16);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; the bytes past
// `src_bytes` are zero-filled (0: nothing is read).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_u32(smem)), "l"(gmem), "r"(src_bytes) : "memory");
}

// 8 bytes the same way (src_bytes 0..8).
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               ::"r"(smem_u32(smem)), "l"(gmem), "r"(src_bytes) : "memory");
}

// 4 bytes the same way (src_bytes 4 or 0).
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(smem_u32(smem)), "l"(gmem), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_u32(p)));
}

// d += A B, one m16n8k16 step with an f32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += A B, one m16n8k8 step on tf32 operands with an f32 accumulator.
// Fragments (PTX ISA, mma.m16n8k8 with .tf32): lane = 4 g + t. A (16x8,
// row) is 4 registers: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4). B
// (8x8, col) is 2: (t, g), (t + 4, g). C/D as m16n8k16's. The unit reads
// the top 19 bits of each operand register (sign, exponent, 10 mantissa
// bits) and ignores the other 13.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An f32 as hi + lo, two tf32 operands, for the 3xTF32 product
// a b ~ a_hi b_hi + a_hi b_lo + a_lo b_hi. hi is x truncated to tf32 (its
// low 13 bits cleared, as CUTLASS's fast 3xTF32 rounds the big part);
// lo = x - hi is exact in f32, |lo| < 2^-10 |x|, and the unit reads its
// top 11 significant bits. So the two parts hold x to ~2^-20 |x|, and the
// product is within ~2^-19 |a b|, against 2^-11 for one tf32 pass. Two
// instructions (a mask and a subtraction); Veltkamp's rounded split takes
// four and cvt.rna.tf32.f32 is slower still on an H100
// (`experiments/probe_ssd_kernels.py`).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));
}

// Two f32 as one register of two bf16 (round to nearest even), lo first.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Rows [r0, r0 + ROWS) x columns [c0, c0 + COLS) of a row-major bf16
// matrix (row stride ld, `nrows` x `ncols`) into a shared tile of
// ROWS x LDS, by the NT threads: past the matrix's edge the tile is zero.
// `vec`: the base pointer is 16-byte aligned and ld a multiple of 8, so
// each 8-column chunk is one 16-byte cp.async (a ragged one reads only its
// valid bytes, 0 for a chunk past the edge); otherwise each element is
// loaded on its own (the slow path for unaligned operands).
template <int ROWS, int COLS, int NT, int LDS = padded(COLS)>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* __restrict__ src, long long ld,
                                          int r0, int nrows, int c0, int ncols, bool vec,
                                          int tid) {
  constexpr int CH = COLS / 8, RSTEP = NT / CH;
  static_assert(COLS % 8 == 0 && NT % CH == 0 && ROWS % RSTEP == 0,
                "each thread copies one chunk column of ROWS / RSTEP rows");
  if (!vec) {  // a rolled loop, so that the 16-byte path stays a short run of code
#pragma unroll 1
    for (int idx = tid; idx < ROWS * COLS; idx += NT) {
      const int r = idx / COLS, c = idx % COLS, gr = r0 + r, gc = c0 + c;
      tile[r * LDS + c] = gr < nrows && gc < ncols ? src[(long long)gr * ld + gc]
                                                   : __float2bfloat16_rn(0.f);
    }
    return;
  }
  const int c = tid % CH * 8, gc = c0 + c, cvalid = min(8, max(0, ncols - gc));
#pragma unroll
  for (int i = 0; i < ROWS / RSTEP; ++i) {
    const int r = tid / CH + i * RSTEP, gr = r0 + r, valid = gr < nrows ? cvalid : 0;
    cp_async16(tile + r * LDS + c, valid > 0 ? src + (long long)gr * ld + gc : src, 2 * valid);
  }
}

// The same for an int8 matrix into a tile of ROWS x padded_i8(COLS)
// bytes, in chunks of min(16, COLS) bytes. `vec`: the base pointer is
// 16-byte aligned and ld a multiple of 16.
template <int ROWS, int COLS, int NT>
__device__ __forceinline__ void load_tile_i8(int8_t* tile, const int8_t* __restrict__ src,
                                             long long ld, int r0, int nrows, int c0, int ncols,
                                             bool vec, int tid) {
  constexpr int CB = COLS < 16 ? COLS : 16, CH = COLS / CB, LDS = padded_i8(COLS),
                RSTEP = NT / CH;
  static_assert((CB == 8 || CB == 16) && COLS % CB == 0 && NT % CH == 0 && ROWS % RSTEP == 0,
                "each thread copies one chunk column of ROWS / RSTEP rows");
  if (!vec) {
#pragma unroll 1
    for (int idx = tid; idx < ROWS * COLS; idx += NT) {
      const int r = idx / COLS, c = idx % COLS, gr = r0 + r, gc = c0 + c;
      tile[r * LDS + c] = gr < nrows && gc < ncols ? src[(long long)gr * ld + gc] : int8_t(0);
    }
    return;
  }
  const int c = tid % CH * CB, gc = c0 + c, cvalid = min(CB, max(0, ncols - gc));
#pragma unroll
  for (int i = 0; i < ROWS / RSTEP; ++i) {
    const int r = tid / CH + i * RSTEP, gr = r0 + r, valid = gr < nrows ? cvalid : 0;
    const int8_t* from = valid > 0 ? src + (long long)gr * ld + gc : src;
    if constexpr (CB == 16) cp_async16(tile + r * LDS + c, from, valid);
    else cp_async8(tile + r * LDS + c, from, valid);
  }
}

// -- Hopper (sm_90a): wgmma fed by TMA through mbarriers ------------------
//
// wgmma: one warpgroup (4 warps, 128 threads) multiplies a 64 x 16 A by a
// 16 x N B, both read from shared memory through matrix descriptors, into
// 64 x N f32 accumulators spread over its registers as mma.sync's: warp w
// holds rows 16 w + g and 16 w + g + 8, and register 4 j + e column
// 8 j + 2 t + (e & 1). It gives mma.sync's bits, step for step.
//
// The tiles use the 128-byte swizzle, which TMA writes and wgmma reads: an
// atom is 8 rows of 128 bytes (64 elements along the operand's contiguous
// dim: K for a K-major operand, M or N for an MN-major one, which the
// instruction reads transposed), 1024 bytes on a 1024-byte bound, with
// the 16-byte chunk c of row r at chunk c ^ r. A descriptor gives the
// first atom's address (plus a k-step's byte offset inside a K-major row),
// the byte step between atoms along M or N (leading) and along the other
// dim (stride).
__device__ __forceinline__ uint64_t gmma_desc_sw128(uint32_t smem_addr, uint32_t lbo,
                                                    uint32_t sbo) {
  return ((uint64_t)((smem_addr & 0x3FFFF) >> 4)) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);  // base offset 0
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d += A B for a 64 x 16 A and a 16 x N B, N = 128, 192 or 256; TA / TB: A / B
// is MN-major.
template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_m64k16(float (&d)[N / 2], uint64_t da, uint64_t db) {
  static_assert(N == 128 || N == 192 || N == 256, "the wide tile's widths");
  if constexpr (N == 128) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, %67, %68;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  } else if constexpr (N == 192) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, %96, %97, p, 1, 1, %99, %100;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, %131, %132;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Arrive, and expect `bytes` of TMA writes before the phase completes.
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}

// A 2D box of the tensor `map` at (c0 along its contiguous dim, c1) into
// shared memory, completing `bytes` on the mbarrier; past the tensor's
// edge the box is zero.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map, uint32_t bar, int c0,
                                            int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(dst), "l"(map), "r"(bar), "r"(c0), "r"(c1) : "memory");
}

// The same from a rank-3 map (columns, rows, a batch index c2: one
// expert's matrix of a bank).
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const void* map, uint32_t bar, int c0,
                                            int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(dst), "l"(map), "r"(bar), "r"(c0), "r"(c1), "r"(c2) : "memory");
}

}  // namespace repro
