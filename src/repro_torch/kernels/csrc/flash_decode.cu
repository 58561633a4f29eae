// Decode attention: one new query token per slot against the slot's KV cache.
//
// Replaces the Pallas kernel `flash_decode` (_flash_decode_kernel) of
// src/repro/kernels/flash_attention.py. Query row (b, h) attends keys
// [max(0, pos[b] - window + 1), pos[b]] of KV head h / (H / Hkv) (GQA), with
// an f32 online softmax; q is scaled by D^-0.5 before the dot; a slot with
// pos < 0 (idle) sees no key and gets a zero output (the l == 0 guard).
//
// Bound at the main path's shapes (qwen3-0.6b on an H100, bf16, 4 slots, 16
// query and 8 KV heads of 128): decode attention reads each valid K and V
// row once and does 4 flops a byte of cache at most, so it is bound by the
// bytes of the cache prefix it must read: at depth 544 that is
// 4 x 544 x 8 x 128 x 2 x 2 bytes = 8.9 MB a layer, about 2.7 us at
// 3.35 TB/s. Beside the 31.5 MB of a layer's weights this is small.
//
// What the design does about it: the cache is read in place, [B, Tk, Hkv, D]
// with strides (the JAX wrapper's transposed [B*Hkv, Tk, D] copies are a TPU
// layout need and are not made here), and the key loop runs only over the
// slot's valid prefix [lo, pos], so a young slot in a deep cache reads a few
// rows, not the cache. One block of 4 warps serves one (slot, query head);
// warp w takes keys lo + w, lo + w + 4, ..., and the 4 partial softmax
// states are merged in a fixed order at the end. The 2 query heads of a KV
// head each read that head's rows (the second read mostly from L2). The
// assignment of keys to warps depends only on the key's position, never on
// Tk or B, so a row gives the same bits at any cache depth and batch.

#include <stdint.h>

#include "common.cuh"

namespace {

using repro::from_f32;
using repro::to_f32;

constexpr int WARPS = 4;
constexpr int DMAX = 256;            // head_dim limit (checked by the wrapper)
constexpr int DPL = DMAX / 32;       // head_dim elements a lane holds

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ pos, T* __restrict__ o, int H, int Hkv, int D, int Tk,
                    long long q_sb, long long q_sh, long long k_sb, long long k_st,
                    long long k_sh, long long v_sb, long long v_st, long long v_sh, int window,
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

  float qr[DPL], acc[DPL];
  const T* qrow = q + b * q_sb + h * q_sh;
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int d = lane + 32 * i;
    qr[i] = d < D ? to_f32(qrow[d]) * scale : 0.f;
    acc[i] = 0.f;
  }
  float m = -1e30f, l = 0.f;
  const T* kbase = k + b * k_sb + hk * k_sh;
  const T* vbase = v + b * v_sb + hk * v_sh;

  for (int t = lo + warp; t <= hi; t += WARPS) {
    const T* kr = kbase + t * k_st;
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) s = fmaf(qr[i], to_f32(kr[d]), s);
    }
    // xor butterfly: every lane ends with the same bits of the sum
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    const float m_new = fmaxf(m, s);
    const float alpha = expf(m - m_new);
    const float pj = expf(s - m_new);
    l = l * alpha + pj;
    const T* vr = vbase + t * v_st;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) acc[i] = fmaf(pj, to_f32(vr[d]), acc[i] * alpha);
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

}  // namespace

extern "C" int repro_flash_decode(const void* q, const void* k, const void* v, const int* pos,
                                  void* o, int B, int H, int Hkv, int D, int Tk, long long q_sb,
                                  long long q_sh, long long k_sb, long long k_st, long long k_sh,
                                  long long v_sb, long long v_st, long long v_sh, int window,
                                  float scale, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B > 0 && H > 0) {
    if (bf16)
      flash_decode_kernel<__nv_bfloat16><<<B * H, WARPS * 32, 0, s>>>(
          static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v), pos, static_cast<__nv_bfloat16*>(o), H, Hkv, D,
          Tk, q_sb, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, window, scale);
    else
      flash_decode_kernel<float><<<B * H, WARPS * 32, 0, s>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), pos, static_cast<float*>(o), H, Hkv, D, Tk, q_sb, q_sh,
          k_sb, k_st, k_sh, v_sb, v_st, v_sh, window, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
