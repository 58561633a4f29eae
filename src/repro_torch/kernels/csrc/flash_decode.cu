// Decode attention: one new query token per slot against the slot's KV
// cache, dense or paged.
//
// Replaces the Pallas kernels `flash_decode` (_flash_decode_kernel) and
// `flash_decode_paged` (_flash_decode_paged_kernel) of
// src/repro/kernels/flash_attention.py. Query row (b, h) attends keys
// [max(0, pos[b] - window + 1), pos[b]] of KV head h / (H / Hkv) (GQA), with
// an f32 online softmax; q is scaled by D^-0.5 before the dot; a slot with
// pos < 0 (idle) sees no key and gets a zero output (the l == 0 guard).
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
// Only the row offset is templated; every pointer stays a __restrict__
// kernel parameter, so the loads take the read-only path (a version that
// loaded through a struct of pointers ran the dense kernel 2.5x slower).
// The arithmetic is one piece of code, so a bf16 pool gives the same bits
// as the dense kernel over the same K/V values. The engine maps a slot's
// write page before the step, so table entries of -1 lie past pos and are
// never read; an entry of -1 inside [lo, pos] reads page 0, as the plain
// version's clamp does.
//
// Bound at the main path's shapes (qwen3-0.6b on an H100, 4 slots, 16
// query and 8 KV heads of 128): decode attention reads each valid K and V
// row once and does 4 flops a byte of cache at most, so it is bound by the
// bytes of the prefix it must read. At phase 3's shape (pos
// [-1, 0, 700, 2047], 2750 keys in all) bf16 reads 2750 x 8 x 128 x 2 B x 2
// = 11.3 MB, about 3.4 us at 3.35 TB/s; an int8 pool reads 5.6 MB plus
// 0.18 MB of scales, about 1.7 us. Beside a layer's weights this is small.
//
// What the design does about it: the key loop runs only over the slot's
// valid prefix [lo, pos], so a young slot in a deep cache (or a large
// pool) reads a few rows. One block of 4 warps serves one (slot, query
// head); warp w takes keys lo + w, lo + w + 4, ..., and the 4 partial
// softmax states are merged in a fixed order at the end. The 2 query heads
// of a KV head each read that head's rows (the second read mostly from
// L2). The assignment of keys to warps depends only on the key's position,
// never on Tk, B or the page layout, so a row gives the same bits at any
// cache depth, batch and page placement.

#include <stdint.h>

#include "common.cuh"

namespace {

using repro::from_f32;
using repro::to_f32;

constexpr int WARPS = 4;
constexpr int DMAX = 256;            // head_dim limit (checked by the wrapper)
constexpr int DPL = DMAX / 32;       // head_dim elements a lane holds

// PAGED: rows through the page table; SCALED: int8 rows with f32 scales.
// Strides: dense k_s0/k_st/k_sh = batch/time/head of the cache; paged
// k_s0/k_st/k_sh = page/row/head of the pool (the same for v).
template <typename T, typename TP, bool PAGED, bool SCALED>
__global__ void __launch_bounds__(WARPS * 32)
flash_decode_kernel(const T* __restrict__ q, const TP* __restrict__ k,
                    const TP* __restrict__ v, const float* __restrict__ ks,
                    const float* __restrict__ vs, const int* __restrict__ table,
                    const int* __restrict__ pos, T* __restrict__ o, int H, int Hkv, int D,
                    int Tk, int ps, long long q_sb, long long q_sh, long long k_s0,
                    long long k_st, long long k_sh, long long v_s0, long long v_st,
                    long long v_sh, long long c_page, long long c_head, int window,
                    float scale) {
  __shared__ float sm_m[WARPS], sm_l[WARPS];
  __shared__ float sm_acc[WARPS][DMAX];
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int p = pos[b];
  const int hi = min(p, Tk - 1);
  const int lo = window > 0 ? max(0, p - window + 1) : 0;
  const int* trow = PAGED ? table + (long long)b * (Tk / ps) : nullptr;

  float qr[DPL], acc[DPL];
  const T* qrow = q + b * q_sb + h * q_sh;
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int d = lane + 32 * i;
    qr[i] = d < D ? to_f32(qrow[d]) * scale : 0.f;
    acc[i] = 0.f;
  }
  float m = -1e30f, l = 0.f;
  const TP* kbase = k + (PAGED ? hk * k_sh : b * k_s0 + hk * k_sh);
  const TP* vbase = v + (PAGED ? hk * v_sh : b * v_s0 + hk * v_sh);

  for (int t = lo + warp; t <= hi; t += WARPS) {
    const TP* kr;
    const TP* vr;
    float ksc = 1.f, vsc = 1.f;
    if constexpr (PAGED) {
      // -1 (unmapped) reads page 0, as the plain version's clamp does
      const long long phys = max(trow[t / ps], 0);
      const int off = t % ps;
      kr = kbase + phys * k_s0 + off * k_st;
      vr = vbase + phys * v_s0 + off * v_st;
      if constexpr (SCALED) {
        ksc = ks[phys * c_page + hk * c_head + off];
        vsc = vs[phys * c_page + hk * c_head + off];
      }
    } else {
      kr = kbase + t * k_st;
      vr = vbase + t * v_st;
    }
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) {
        float kx = to_f32(kr[d]);
        if constexpr (SCALED) kx *= ksc;   // dequantize on f32, before the dot
        s = fmaf(qr[i], kx, s);
      }
    }
    // xor butterfly: every lane ends with the same bits of the sum
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    const float m_new = fmaxf(m, s);
    const float alpha = expf(m - m_new);
    const float pj = expf(s - m_new);
    l = l * alpha + pj;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) {
        float vx = to_f32(vr[d]);
        if constexpr (SCALED) vx *= vsc;
        acc[i] = fmaf(pj, vx, acc[i] * alpha);
      }
    }
    m = m_new;
  }

  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int d = lane + 32 * i;
    if (d < D) sm_acc[warp][d] = acc[i];
  }
  __syncthreads();

  float mx = sm_m[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) mx = fmaxf(mx, sm_m[w]);
  float scl[WARPS];
  float lsum = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    scl[w] = expf(sm_m[w] - mx);
    lsum += sm_l[w] * scl[w];
  }
  T* orow = o + (long long)bh * D;
  for (int d = threadIdx.x; d < D; d += WARPS * 32) {
    float acc_d = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) acc_d += sm_acc[w][d] * scl[w];
    orow[d] = from_f32<T>(lsum == 0.f ? 0.f : acc_d / lsum);
  }
}

template <typename T, typename TP, bool PAGED, bool SCALED>
void launch(const void* q, const void* k, const void* v, const float* ks, const float* vs,
            const int* table, const int* pos, void* o, int B, int H, int Hkv, int D, int Tk,
            int ps, long long q_sb, long long q_sh, long long k_s0, long long k_st,
            long long k_sh, long long v_s0, long long v_st, long long v_sh, long long c_page,
            long long c_head, int window, float scale, cudaStream_t s) {
  flash_decode_kernel<T, TP, PAGED, SCALED><<<B * H, WARPS * 32, 0, s>>>(
      static_cast<const T*>(q), static_cast<const TP*>(k), static_cast<const TP*>(v), ks, vs,
      table, pos, static_cast<T*>(o), H, Hkv, D, Tk, ps, q_sb, q_sh, k_s0, k_st, k_sh, v_s0,
      v_st, v_sh, c_page, c_head, window, scale);
}

}  // namespace

extern "C" int repro_flash_decode(const void* q, const void* k, const void* v, const int* pos,
                                  void* o, int B, int H, int Hkv, int D, int Tk, long long q_sb,
                                  long long q_sh, long long k_sb, long long k_st, long long k_sh,
                                  long long v_sb, long long v_st, long long v_sh, int window,
                                  float scale, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B > 0 && H > 0) {
    if (bf16)
      launch<__nv_bfloat16, __nv_bfloat16, false, false>(
          q, k, v, nullptr, nullptr, nullptr, pos, o, B, H, Hkv, D, Tk, 1, q_sb, q_sh, k_sb,
          k_st, k_sh, v_sb, v_st, v_sh, 0, 0, window, scale, s);
    else
      launch<float, float, false, false>(q, k, v, nullptr, nullptr, nullptr, pos, o, B, H, Hkv,
                                         D, Tk, 1, q_sb, q_sh, k_sb, k_st, k_sh, v_sb, v_st,
                                         v_sh, 0, 0, window, scale, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// pool: the query's type, or int8 (int8_pool) with the f32 scale planes
// ks/vs. Strides: page, row and head of the pools (k and v alike), page
// and head of the scale planes (row stride 1).
extern "C" int repro_flash_decode_paged(const void* q, const void* kp, const void* vp,
                                        const float* ks, const float* vs, const int* table,
                                        const int* pos, void* o, int B, int H, int Hkv, int D,
                                        int pp, int ps, long long q_sb, long long q_sh,
                                        long long s_page, long long s_row, long long s_head,
                                        long long c_page, long long c_head, int window,
                                        float scale, int bf16, int int8_pool, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int Tk = pp * ps;
  if (B > 0 && H > 0) {
    if (bf16 && int8_pool)
      launch<__nv_bfloat16, int8_t, true, true>(q, kp, vp, ks, vs, table, pos, o, B, H, Hkv, D,
                                                Tk, ps, q_sb, q_sh, s_page, s_row, s_head,
                                                s_page, s_row, s_head, c_page, c_head, window,
                                                scale, s);
    else if (bf16)
      launch<__nv_bfloat16, __nv_bfloat16, true, false>(
          q, kp, vp, nullptr, nullptr, table, pos, o, B, H, Hkv, D, Tk, ps, q_sb, q_sh, s_page,
          s_row, s_head, s_page, s_row, s_head, 0, 0, window, scale, s);
    else if (int8_pool)
      launch<float, int8_t, true, true>(q, kp, vp, ks, vs, table, pos, o, B, H, Hkv, D, Tk, ps,
                                        q_sb, q_sh, s_page, s_row, s_head, s_page, s_row,
                                        s_head, c_page, c_head, window, scale, s);
    else
      launch<float, float, true, false>(q, kp, vp, nullptr, nullptr, table, pos, o, B, H, Hkv,
                                        D, Tk, ps, q_sb, q_sh, s_page, s_row, s_head, s_page,
                                        s_row, s_head, 0, 0, window, scale, s);
  }
  return static_cast<int>(cudaGetLastError());
}
