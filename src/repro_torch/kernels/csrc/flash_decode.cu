// Decode attention: the new query tokens of each slot against the slot's
// KV cache, dense or paged. One token a slot is a decode step; t > 1 is a
// speculative verify step (the pending token and the draft's proposals).
//
// Replaces the Pallas kernels `flash_decode` (_flash_decode_kernel) and
// `flash_decode_paged` (_flash_decode_paged_kernel) of
// src/repro/kernels/flash_attention.py. Query row (b, h) attends keys
// [max(0, pos[b] - window + 1), pos[b]] of KV head h / (H / Hkv) (GQA), with
// an f32 softmax; q is scaled by D^-0.5 before the dot; a slot with pos < 0
// (idle) sees no key and gets a zero output; pos past Tk is clamped to the
// cache's last key.
//
// Multi-row form: q carries Tq rows a slot, and row r sits at position
// pos[b] + r: it attends keys [max(0, pos[b] + r - window + 1), pos[b] + r]
// and is what the one-row kernel gives at pos[b] + r, bit for bit. Rows
// r >= n_valid[b] (all Tq valid without n_valid), and every row of an idle
// slot, give zeros.
//
// Where a key row lives is the only difference between the two entry
// points, so the kernel body is templated on it:
//   - dense: the cache [B, Tk, Hkv, D] read in place through strides;
//   - paged: logical key t of slot b at pool page table[b, t / ps], row
//     t % ps, of the layer's pool [P, ps, Hkv, D] (read in place as a view
//     of the (L, P, ps, Hkv, D) stack; no gather into a dense copy);
//   - paged int8: the same with each element widened to f32 and multiplied
//     by its (page, head, row) scale from the [P, Hkv, ps] f32 plane before
//     the dot, the order of the Pallas kernel.
// Only the row offsets are templated; every pointer stays a __restrict__
// kernel parameter (a version that loaded through a struct of pointers ran
// the dense kernel 2.5x slower). The arithmetic is one piece of code, so a
// bf16 pool gives the same bits as the dense kernel over the same K/V
// values. The engine maps a slot's write page before the step, so table
// entries of -1 lie past pos and are never read; an entry of -1 inside
// [lo, pos] reads page 0, as the plain version's clamp does.
//
// Bound at the main path's shapes (qwen3-0.6b on an H100, 4 slots, 16
// query and 8 KV heads of 128): decode attention reads each valid K and V
// row once and does 4 flops a byte of cache at most, so it is bound by the
// bytes of the prefix it must read. At phase 3's shape (pos
// [-1, 0, 700, 2047], 2750 keys in all) bf16 reads 2750 x 8 x 128 x 2 B x 2
// = 11.3 MB, about 3.4 us at 3.35 TB/s; an int8 pool reads 5.6 MB plus
// 0.18 MB of scales, about 1.7 us. Beside a layer's weights this is small.
// Reaching that bound takes many bytes in flight at once: a block that
// walks its keys one by one, each key a load, a reduction and a second
// load, waits two device-memory latencies a key.
//
// The design (flash-decoding's shape): the key axis is cut into splits of
// SPLIT keys at fixed positions (split s holds keys [s SPLIT, s SPLIT +
// SPLIT)), clipped to the slot's [lo, pos]. One block of 4 warps takes one
// (split, KV head, slot), and a block whose split misses [lo, pos] returns
// at once, so the grid spreads a deep slot over many SMs and a young one
// costs a few blocks. The block serves all g query heads of its KV head, so
// each K and V row crosses device memory once. It first reads the split's
// row addresses (for a pool, its page-table entries) into shared memory,
// then stages the split's K rows and V rows with 16-byte cp.async, two
// groups in flight at once: V lands while K is scored. Warp w scores keys
// 16 w .. 16 w + 15 of the split, two lanes a key, each lane summing its
// half of the 16-byte chunks of the row in ascending order before one
// shuffle adds the halves; the softmax over the split's keys (its max m,
// p = exp(s - m), l = sum p by one butterfly over the key positions) and
// acc = sum p V (ascending keys) give the split's partial (m, l, acc), f32,
// in scratch the wrapper allocates. A second kernel merges a row's splits
// in ascending order, o = sum acc_s e^(m_s - M) / sum l_s e^(m_s - M), and
// writes zeros for a row that sees no key. No atomics: which thread sums
// which key, and in what order, depends only on the key's position, never
// on Tk, B, the pool or the page layout, so a row gives the same bits at
// any cache depth, batch and page placement
// (tests/test_torch_cuda.py::test_flash_decode_is_batch_invariant). The
// FMA units suffice: with 2 query rows a KV head the tensor cores buy
// nothing, and the bound is bytes.
//
// The multi-row form keeps that design: a block stages its split's keys
// once, the union of what its slot's valid rows see, and then runs each
// row in turn through the same scoring, softmax and sum, over that row's
// own clipped key range [j0, j1] of the split, into the row's own
// partial; the merge takes each row's own splits. So a row's arithmetic,
// its splits and their order are those of the one-row kernel at its
// position, and a verify step writes the decode step's bits
// (tests/test_torch_cuda.py::test_flash_decode_rows_match_one_row).

#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

using repro::from_f32;
using repro::to_f32;

constexpr int WARPS = 4, THREADS = 32 * WARPS;
constexpr int SPLIT = 64;                  // keys of a split (DECODE_SPLIT in
                                           // kernels/flash_attention.py)
constexpr int LPK = THREADS / SPLIT;       // lanes that score one key
constexpr int GB = WARPS;                  // query heads a pass over the staged rows
constexpr int DMAX = 256;                  // head_dim limit (checked by the wrapper)
static_assert(SPLIT == 64 && LPK == 2, "the softmax takes 2 keys a lane");

// Bytes of a staged row: the 16-byte chunks of D elements, an odd count of
// them, so that rows start in different bank groups.
__host__ __device__ constexpr int row_bytes(int d, int elem) {
  return ((d * elem + 15) / 16 | 1) * 16;
}

// The split's rows [j0, j1] of one operand (row offsets `off`, elements)
// into shared rows of `rb` bytes: 16-byte cp.async where the operand
// allows it (the ragged last chunk zero-filled), else element by element.
template <typename TP>
__device__ __forceinline__ void stage_rows(unsigned char* dst, const TP* __restrict__ src,
                                           const long long* off, int j0, int j1, int D, int rb,
                                           bool vec) {
  constexpr int E = 16 / sizeof(TP);
  const int nch = (D + E - 1) / E;
  for (int idx = j0 * nch + threadIdx.x; idx < (j1 + 1) * nch; idx += THREADS) {
    const int j = idx / nch, c = idx % nch;
    unsigned char* to = dst + j * rb + 16 * c;
    if (vec) {
      const int valid = min(E, D - c * E) * (int)sizeof(TP);
      repro::cp_async16(to, src + off[j] + c * E, valid);
    } else {
      uint4 u = make_uint4(0, 0, 0, 0);
      TP* e = reinterpret_cast<TP*>(&u);
#pragma unroll
      for (int i = 0; i < E; ++i)
        if (c * E + i < D) e[i] = src[off[j] + c * E + i];
      *reinterpret_cast<uint4*>(to) = u;
    }
  }
}

// One (split, KV head, slot): the split's partial (m, l, acc[D]) of each of
// the g query heads of each of the slot's valid rows r, at
// part_acc/part_ml[((b Tq + r) H + h) ns + split].
// PAGED: rows through the page table; SCALED: int8 rows with f32 scales.
// Strides: dense k_s0/k_st/k_sh = batch/time/head of the cache; paged
// k_s0/k_st/k_sh = page/row/head of the pool (the same for v).
template <typename T, typename TP, bool PAGED, bool SCALED>
__global__ void __launch_bounds__(THREADS)
flash_decode_kernel(const T* __restrict__ q, const TP* __restrict__ k,
                    const TP* __restrict__ v, const float* __restrict__ ks,
                    const float* __restrict__ vs, const int* __restrict__ table,
                    const int* __restrict__ pos, const int* __restrict__ n_valid,
                    float* __restrict__ part_acc, float* __restrict__ part_ml, int Tq, int H,
                    int Hkv, int D, int Tk, int ps, long long q_sb, long long q_st,
                    long long q_sh, long long k_s0, long long k_st,
                    long long k_sh, long long v_s0, long long v_st, long long v_sh,
                    long long c_page, long long c_head, int window, float scale, bool vec) {
  constexpr int E = 16 / sizeof(TP);       // elements of a 16-byte chunk
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ long long koff[SPLIT], voff[SPLIT];
  __shared__ float ksc[SPLIT], vsc[SPLIT];
  __shared__ __align__(16) float qs[GB][DMAX];
  __shared__ float prob[GB][SPLIT];
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z, ns = gridDim.x;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, g = H / Hkv;
  const int p0 = pos[b], nv = n_valid ? min(n_valid[b], Tq) : Tq;
  if (p0 < 0 || nv <= 0) return;           // an idle slot
  // the keys of the split that some valid row sees: [J0, J1]
  const int hi_all = min(p0 + nv - 1, Tk - 1), lo_all = window > 0 ? max(0, p0 - window + 1) : 0;
  const int t0 = split * SPLIT;
  const int J0 = max(lo_all, t0) - t0, J1 = min(hi_all, t0 + SPLIT - 1) - t0;
  if (J0 > J1) return;                     // the split misses every row's keys
  const int rb = row_bytes(D, sizeof(TP)), nch = (D + E - 1) / E;
  unsigned char* Ks = smem;
  unsigned char* Vs = smem + SPLIT * rb;

  // where each key's rows live, the page table read once
  long long phys = 0;
  int off = 0;
  if (tid >= J0 && tid <= J1) {            // THREADS >= SPLIT
    const int t = t0 + tid;
    if constexpr (PAGED) {
      // -1 (unmapped) reads page 0, as the plain version's clamp does
      phys = max(table[(long long)b * (Tk / ps) + t / ps], 0);
      off = t % ps;
      koff[tid] = phys * k_s0 + off * k_st + hk * k_sh;
      voff[tid] = phys * v_s0 + off * v_st + hk * v_sh;
    } else {
      koff[tid] = b * k_s0 + t * k_st + hk * k_sh;
      voff[tid] = b * v_s0 + t * v_st + hk * v_sh;
    }
  }
  __syncthreads();
  stage_rows(Ks, k, koff, J0, J1, D, rb, vec);
  repro::cp_async_commit();
  stage_rows(Vs, v, voff, J0, J1, D, rb, vec);
  repro::cp_async_commit();
  if constexpr (SCALED) {
    if (tid >= J0 && tid <= J1) {
      ksc[tid] = ks[phys * c_page + hk * c_head + off];
      vsc[tid] = vs[phys * c_page + hk * c_head + off];
    }
  }

  const int j = warp * (SPLIT / WARPS) + lane / LPK, half = lane % LPK;
  bool first = true;                       // the block's first pass
  for (int r = 0; r < nv; ++r) {
  // row r: the one-row kernel's body at position p, over its own [j0, j1]
  const int p = p0 + r;
  const int hi = min(p, Tk - 1), lo = window > 0 ? max(0, p - window + 1) : 0;
  const int j0 = max(lo, t0) - t0, j1 = min(hi, t0 + SPLIT - 1) - t0;
  if (j0 > j1) continue;                   // row r sees no key of the split
  const bool valid = j >= j0 && j <= j1;
  const long long qrow = (long long)b * Tq + r;
  for (int hb = 0; hb < g; hb += GB) {
    const int ng = min(GB, g - hb);
    if (!first) __syncthreads();           // the last pass's readers are done
    for (int idx = tid; idx < GB * nch * E; idx += THREADS) {
      const int hh = idx / (nch * E), d = idx % (nch * E);
      qs[hh][d] = hh < ng && d < D
                      ? to_f32(q[b * q_sb + r * q_st + (hk * g + hb + hh) * q_sh + d]) * scale
                      : 0.f;
    }
    if (first) repro::cp_async_wait<1>();  // K has landed; V may be in flight
    __syncthreads();

    // scores: lane half `half` of key j sums its chunks in ascending order
    float s[GB];
#pragma unroll
    for (int hh = 0; hh < GB; ++hh) s[hh] = 0.f;
    const unsigned char* krow = Ks + j * rb;
    for (int c = half; c < nch; c += LPK) {
      const uint4 u = *reinterpret_cast<const uint4*>(krow + 16 * c);
      const TP* e = reinterpret_cast<const TP*>(&u);
#pragma unroll
      for (int i = 0; i < E; ++i) {
        float kx = to_f32(e[i]);
        if constexpr (SCALED) kx *= ksc[j];  // dequantize on f32, before the dot
#pragma unroll
        for (int hh = 0; hh < GB; ++hh) s[hh] = fmaf(qs[hh][c * E + i], kx, s[hh]);
      }
    }
#pragma unroll
    for (int hh = 0; hh < GB; ++hh) {
      s[hh] += __shfl_xor_sync(0xffffffffu, s[hh], 1);
      if (half == 0) prob[hh][j] = valid ? s[hh] : -INFINITY;
    }
    __syncthreads();

    // the split's softmax, warp hh for head hh: lane l holds keys l, l + 32
    if (warp < ng) {
      const float a = prob[warp][lane], c = prob[warp][lane + 32];
      float m = fmaxf(a, c);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      const float pa = lane >= j0 && lane <= j1 ? expf(a - m) : 0.f;
      const float pc = lane + 32 >= j0 && lane + 32 <= j1 ? expf(c - m) : 0.f;
      float l = pa + pc;
      // xor butterfly: every lane ends with the same bits of the sum
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
      prob[warp][lane] = pa;
      prob[warp][lane + 32] = pc;
      if (lane == 0) {
        const long long row = (qrow * H + hk * g + hb + warp) * ns + split;
        part_ml[2 * row] = m;
        part_ml[2 * row + 1] = l;
      }
    }
    if (first) repro::cp_async_wait<0>();  // V has landed
    __syncthreads();

    // acc = sum p V over the split's keys, ascending
    for (int idx = tid; idx < ng * D; idx += THREADS) {
      const int hh = idx / D, d = idx % D;
      float acc = 0.f;
#pragma unroll 8
      for (int jj = j0; jj <= j1; ++jj) {
        float vx = to_f32(reinterpret_cast<const TP*>(Vs + jj * rb)[d]);
        if constexpr (SCALED) vx *= vsc[jj];
        acc = fmaf(prob[hh][jj], vx, acc);
      }
      part_acc[((qrow * H + hk * g + hb + hh) * ns + split) * D + d] = acc;
    }
    first = false;
  }
  }
}

// One query row (b, r, h): its splits merged in ascending order. Instanced
// with the split kernel's template arguments, so that a trace tells the
// dense merge from the paged one.
template <typename T, typename TP, bool PAGED, bool SCALED>
__global__ void __launch_bounds__(THREADS)
flash_decode_merge_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                          const int* __restrict__ pos, const int* __restrict__ n_valid,
                          T* __restrict__ o, int Tq, int H, int D, int Tk, int ns, int window) {
  const int bh = blockIdx.x, b = bh / (Tq * H), r = bh / H % Tq;   // bh = (b Tq + r) H + h
  const int nv = n_valid ? min(n_valid[b], Tq) : Tq;
  const int p = pos[b] < 0 || r >= nv ? -1 : pos[b] + r;
  const int hi = min(p, Tk - 1), lo = window > 0 ? max(0, p - window + 1) : 0;
  T* orow = o + (long long)bh * D;
  if (p < 0 || hi < lo) {                  // no key: a zero row
    for (int d = threadIdx.x; d < D; d += THREADS) orow[d] = from_f32<T>(0.f);
    return;
  }
  __shared__ float warp_max[WARPS];
  const int s0 = lo / SPLIT, s1 = hi / SPLIT;
  const float* ml = part_ml + (long long)bh * ns * 2;
  // the splits' max, their loads all in flight at once (a max is exact in
  // any order)
  float mx = -INFINITY;
  for (int s = s0 + threadIdx.x; s <= s1; s += THREADS) mx = fmaxf(mx, ml[2 * s]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = mx;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, warp_max[w]);
  for (int d = threadIdx.x; d < D; d += THREADS) {
    float l = 0.f, acc = 0.f;
#pragma unroll 8
    for (int s = s0; s <= s1; ++s) {
      const float w = expf(ml[2 * s] - mx);
      l = fmaf(ml[2 * s + 1], w, l);
      acc = fmaf(part_acc[((long long)bh * ns + s) * D + d], w, acc);
    }
    orow[d] = from_f32<T>(acc / l);
  }
}

template <typename T, typename TP, bool PAGED, bool SCALED>
cudaError_t launch(const void* q, const void* k, const void* v, const float* ks, const float* vs,
                   const int* table, const int* pos, const int* n_valid, void* o, float* scratch,
                   int B, int Tq, int H, int Hkv, int D, int Tk, int ps, long long q_sb,
                   long long q_st, long long q_sh, long long k_s0,
                   long long k_st, long long k_sh, long long v_s0, long long v_st, long long v_sh,
                   long long c_page, long long c_head, int window, float scale, cudaStream_t s) {
  // above 48 KB a block's shared memory must be asked for, once a kernel
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_decode_kernel<T, TP, PAGED, SCALED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      2 * SPLIT * row_bytes(DMAX, sizeof(TP)));
  if (attr != cudaSuccess) return attr;
  const int ns = (Tk + SPLIT - 1) / SPLIT;
  float* part_acc = scratch;
  float* part_ml = scratch + (long long)B * Tq * H * ns * D;
  constexpr int A = 16 / sizeof(TP);       // elements of 16 bytes
  const bool vec = ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16 == 0) &&
                   ((k_s0 | k_st | k_sh | v_s0 | v_st | v_sh) % A == 0);
  if (ns > 0) {
    flash_decode_kernel<T, TP, PAGED, SCALED>
        <<<dim3(ns, Hkv, B), THREADS, 2 * SPLIT * row_bytes(D, sizeof(TP)), s>>>(
            static_cast<const T*>(q), static_cast<const TP*>(k), static_cast<const TP*>(v), ks,
            vs, table, pos, n_valid, part_acc, part_ml, Tq, H, Hkv, D, Tk, ps, q_sb, q_st, q_sh,
            k_s0, k_st, k_sh, v_s0, v_st, v_sh, c_page, c_head, window, scale, vec);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  flash_decode_merge_kernel<T, TP, PAGED, SCALED><<<B * Tq * H, THREADS, 0, s>>>(
      part_acc, part_ml, pos, n_valid, static_cast<T*>(o), Tq, H, D, Tk, ns, window);
  return cudaGetLastError();
}

}  // namespace

// q [B, Tq, H, D] (strides q_sb, q_st, q_sh), o contiguous [B, Tq, H, D];
// n_valid: (B,) rows a slot, or null for all Tq. scratch: B Tq H
// ceil(Tk / SPLIT) (D + 2) floats, the splits' partials.
extern "C" int repro_flash_decode(const void* q, const void* k, const void* v, const int* pos,
                                  const int* n_valid, void* o, float* scratch, int B, int Tq,
                                  int H, int Hkv, int D, int Tk, long long q_sb, long long q_st,
                                  long long q_sh, long long k_sb, long long k_st,
                                  long long k_sh, long long v_sb, long long v_st, long long v_sh,
                                  int window, float scale, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || H == 0) return static_cast<int>(cudaGetLastError());
  const cudaError_t err =
      bf16 ? launch<__nv_bfloat16, __nv_bfloat16, false, false>(
                 q, k, v, nullptr, nullptr, nullptr, pos, n_valid, o, scratch, B, Tq, H, Hkv, D,
                 Tk, 1, q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, 0, 0, window, scale,
                 s)
           : launch<float, float, false, false>(q, k, v, nullptr, nullptr, nullptr, pos, n_valid,
                                                o, scratch, B, Tq, H, Hkv, D, Tk, 1, q_sb, q_st,
                                                q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, 0, 0,
                                                window, scale, s);
  return static_cast<int>(err);
}

// pool: the query's type, or int8 (int8_pool) with the f32 scale planes
// ks/vs. Strides: page, row and head of the pools (k and v alike), page
// and head of the scale planes (row stride 1). q, o, n_valid and scratch
// as above, Tk = pp ps.
extern "C" int repro_flash_decode_paged(const void* q, const void* kp, const void* vp,
                                        const float* ks, const float* vs, const int* table,
                                        const int* pos, const int* n_valid, void* o,
                                        float* scratch, int B, int Tq, int H, int Hkv, int D,
                                        int pp, int ps, long long q_sb, long long q_st,
                                        long long q_sh, long long s_page, long long s_row,
                                        long long s_head, long long c_page, long long c_head,
                                        int window, float scale, int bf16, int int8_pool,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int Tk = pp * ps;
  if (B == 0 || H == 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err;
  if (bf16 && int8_pool)
    err = launch<__nv_bfloat16, int8_t, true, true>(
        q, kp, vp, ks, vs, table, pos, n_valid, o, scratch, B, Tq, H, Hkv, D, Tk, ps, q_sb, q_st,
        q_sh, s_page, s_row, s_head, s_page, s_row, s_head, c_page, c_head, window, scale, s);
  else if (bf16)
    err = launch<__nv_bfloat16, __nv_bfloat16, true, false>(
        q, kp, vp, nullptr, nullptr, table, pos, n_valid, o, scratch, B, Tq, H, Hkv, D, Tk, ps,
        q_sb, q_st, q_sh, s_page, s_row, s_head, s_page, s_row, s_head, 0, 0, window, scale, s);
  else if (int8_pool)
    err = launch<float, int8_t, true, true>(
        q, kp, vp, ks, vs, table, pos, n_valid, o, scratch, B, Tq, H, Hkv, D, Tk, ps, q_sb, q_st,
        q_sh, s_page, s_row, s_head, s_page, s_row, s_head, c_page, c_head, window, scale, s);
  else
    err = launch<float, float, true, false>(
        q, kp, vp, nullptr, nullptr, table, pos, n_valid, o, scratch, B, Tq, H, Hkv, D, Tk, ps,
        q_sb, q_st, q_sh, s_page, s_row, s_head, s_page, s_row, s_head, 0, 0, window, scale, s);
  return static_cast<int>(err);
}
