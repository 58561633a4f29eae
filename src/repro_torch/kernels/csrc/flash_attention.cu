// Flash attention for training: the online-softmax forward with its
// logsumexp residual, and the two-sweep recompute backward.
//
// Replaces the Pallas kernels `flash_attention` (_flash_kernel) and
// `flash_attention_bwd` (_flash_bwd_dkv_kernel, _flash_bwd_dq_kernel) of
// src/repro/kernels/flash_attention.py. Query row i of query head h attends
// the keys j of KV head h / (H / Hkv) (GQA) with j <= i under `causal` and
// j > i - window under a window; q is scaled by D^-0.5 (in f32) before the
// dot. All arithmetic is f32 and each output is rounded once to its type.
//
//   forward:  S = qs K^T, online softmax over key tiles, O = P V / l,
//             lse = m + log(l) in scaled-logit units; a row that sees no
//             key (l == 0) gets O = 0 and lse = 1e30 (the Pallas
//             kernel's sentinel), so the backward's exp(S - lse) is 0.
//   backward: P = exp(S - lse), dV = P^T dO, dP = dO V^T,
//             dS = P (dP - delta), dK = dS^T qs, dQ = D^-0.5 dS K, with
//             delta = rowsum(dO * O) taken by the caller in PyTorch, as
//             the JAX package takes it in XLA.
//
// Layouts: q/o/dO [B, Tq, H, D], k/v [B, Tk, Hkv, D] are read in place
// through their (batch, time, head) strides, with a contiguous head dim;
// there is no transposed or repeated copy of K/V for the GQA group. lse is
// [B, H, Tq] f32, delta [B, Tq, H] f32; o, dq, dk and dv are written
// contiguous. Ragged Tq and Tk are masked in the kernels, not padded.
//
// Bound at the main path's shape (qwen3-0.6b training, B=4, T=512, 16
// query / 8 KV heads of 128, causal, bf16): the forward moves q, k, v, o
// once (25.3 MB, 7.5 us at 3.35 TB/s) and does 4.3 GFLOP of unmasked
// products (4.4 us at 989 TFLOP/s), so it is bound by its bytes; the
// backward moves q, k, v, o, dO, dq, dk, dv (50.6 MB, 15 us) against 10.8
// GFLOP (11 us). A first kernel, this one is far from that: its products
// run on the FMA units from f32 tiles in shared memory (mma.sync / wgmma
// and TMA are later work).
//
// What the design does about the TPU kernel's shape: Pallas walks the key
// tiles (forward, dQ sweep) or query tiles (dK/dV sweep) along a
// sequential grid dim and carries the accumulator in VMEM scratch between
// grid steps. Here a block owns one output tile and loops over the tiles
// it needs inside the block, skipping tiles wholly outside the causal and
// window masks, so nothing carries between blocks. The dK/dV sweep holds a
// (64, D) dK and dV accumulator in registers while the query tiles of all
// g query heads of its KV head stream past: the GQA group-sum happens in
// the kernel (Pallas writes per-query-head dK/dV and the caller sums
// them, because it cannot revisit an output block). There are no atomics:
// every sum runs in a fixed order, so a gradient has the same bits from
// run to run.

#include <stdint.h>

#include "common.cuh"

namespace {

using repro::from_f32;
using repro::to_f32;

constexpr int THREADS = 256;          // 16 x 16 threads: tx = tid % 16, ty = tid / 16
constexpr int BQ = 64;                // query rows of a tile: a thread owns ty + 16 i
constexpr int FWD_BK = 32;            // key rows of a forward tile
constexpr int BWD_BK = 64;            // key rows of a backward tile
constexpr int DMAX = 128;             // head_dim limit (checked by the wrapper)
constexpr int DJ = DMAX / 16;         // D columns a thread owns: tx + 16 j
constexpr int LD = DMAX + 1;          // padded row of a (rows, D) tile
constexpr float NEG_INF = -1e30f;
constexpr float LSE_EMPTY = 1e30f;

struct Mask {
  int tq, tk, causal, window;
  // key kp is visible from query row qp
  __device__ __forceinline__ bool operator()(int qp, int kp) const {
    return qp < tq && kp < tk && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
  }
  // the key tiles [lo, hi) a query tile [q0, q0 + bq) can see
  __device__ __forceinline__ int key_lo(int q0) const { return window > 0 ? max(0, q0 - window + 1) : 0; }
  __device__ __forceinline__ int key_hi(int q0, int bq) const { return causal ? min(tk, q0 + bq) : tk; }
  // the query rows [lo, hi) that can see a key tile [k0, k0 + bk)
  __device__ __forceinline__ int query_lo(int k0) const { return causal ? k0 : 0; }
  __device__ __forceinline__ int query_hi(int k0, int bk) const {
    return window > 0 ? min(tq, k0 + bk - 1 + window) : tq;
  }
};

// rows [r0, r0 + rows) of a [T, D] slice (row stride ld) into a (rows, LD)
// f32 tile times `mul`; rows past T and columns past D are 0.
template <typename T>
__device__ __forceinline__ void load_tile(float* tile, const T* __restrict__ src, long long ld,
                                          int r0, int rows, int n, int d, float mul) {
  for (int idx = threadIdx.x; idx < rows * DMAX; idx += THREADS) {
    const int r = idx / DMAX, c = idx % DMAX;
    float x = 0.f;
    if (r0 + r < n && c < d) x = to_f32(src[(long long)(r0 + r) * ld + c]) * mul;
    tile[r * LD + c] = x;
  }
}

// The 16 lanes of a half warp share ty, so they own the same query rows.
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

constexpr int FWD_SMEM = (BQ * LD + FWD_BK * LD + FWD_BK * DMAX + BQ * (FWD_BK + 1)) * 4;

// One block per (query tile, b * H + h).
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
flash_attn_fwd_kernel(const T* __restrict__ Q, const T* __restrict__ K, const T* __restrict__ V,
                      T* __restrict__ O, float* __restrict__ LSE, int H, int Hkv, int D,
                      long long qb, long long qt, long long qh, long long kb, long long kt,
                      long long kh, long long vb, long long vt, long long vh, Mask mask,
                      float scale) {
  constexpr int JN = FWD_BK / 16;     // key columns a thread owns: tx + 16 j
  extern __shared__ float smem[];
  float* Qs = smem;                   // (BQ, LD), scaled
  float* Ks = Qs + BQ * LD;           // (FWD_BK, LD)
  float* Vs = Ks + FWD_BK * LD;       // (FWD_BK, DMAX)
  float* Ps = Vs + FWD_BK * DMAX;     // (BQ, FWD_BK + 1)
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int b = blockIdx.y / H, h = blockIdx.y % H, hk = h / (H / Hkv);
  const int q0 = blockIdx.x * BQ;
  const T* q = Q + b * qb + h * qh;
  const T* k = K + b * kb + hk * kh;
  const T* v = V + b * vb + hk * vh;

  load_tile(Qs, q, qt, q0, BQ, mask.tq, D, scale);
  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  const int hi = mask.key_hi(q0, BQ);
  for (int k0 = mask.key_lo(q0) / FWD_BK * FWD_BK; k0 < hi; k0 += FWD_BK) {
    __syncthreads();                  // the last tile's readers are done
    load_tile(Ks, k, kt, k0, FWD_BK, mask.tk, D, 1.f);
    for (int idx = tid; idx < FWD_BK * DMAX; idx += THREADS) {
      const int r = idx / DMAX, c = idx % DMAX;
      Vs[idx] = (k0 + r < mask.tk && c < D) ? to_f32(v[(long long)(k0 + r) * vt + c]) : 0.f;
    }
    __syncthreads();

    float s[4][JN];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < JN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kk[JN];
#pragma unroll
      for (int j = 0; j < JN; ++j) kk[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float qq = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
        for (int j = 0; j < JN; ++j) s[i][j] = fmaf(qq, kk[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      bool ok[JN];
      float tmax = NEG_INF;
#pragma unroll
      for (int j = 0; j < JN; ++j) {
        ok[j] = mask(qp, k0 + tx + 16 * j);
        if (ok[j]) tmax = fmaxf(tmax, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(tmax));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < JN; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty + 16 * i) * (FWD_BK + 1) + tx + 16 * j] = p;
        rs += p;
      }
      l[i] = l[i] * alpha + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < FWD_BK; ++kk) {
      float vv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[kk * DMAX + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[(ty + 16 * i) * (FWD_BK + 1) + kk];
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= mask.tq) continue;
    const float lsafe = l[i] == 0.f ? 1.f : l[i];
    T* o = O + (((long long)b * mask.tq + qp) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = tx + 16 * j;
      if (c < D) o[c] = from_f32<T>(acc[i][j] / lsafe);
    }
    if (tx == 0)
      LSE[((long long)b * H + h) * mask.tq + qp] = l[i] > 0.f ? m[i] + logf(lsafe) : LSE_EMPTY;
  }
}

// P and dS of a (BQ query, BWD_BK key) tile pair from the staged tiles, as
// the Pallas kernels' _bwd_tiles: thread (tx, ty) owns query rows
// ty + 16 i and key columns tx + 16 j. Qs is scaled.
struct BwdTile {
  float p[4][4], ds[4][4];
};

__device__ __forceinline__ void bwd_tile(BwdTile& t, const float* Qs, const float* dOs,
                                         const float* Ks, const float* Vs, const float* lse,
                                         const float* delta, int q0, int k0, int D,
                                         const Mask& mask) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; ++d) {
    float kk[4], vv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kk[j] = Ks[(tx + 16 * j) * LD + d];
      vv[j] = Vs[(tx + 16 * j) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float qq = Qs[(ty + 16 * i) * LD + d];
      const float oo = dOs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qq, kk[j], s[i][j]);
        dp[i][j] = fmaf(oo, vv[j], dp[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float p = mask(q0 + r, k0 + tx + 16 * j) ? expf(s[i][j] - lse[r]) : 0.f;
      t.p[i][j] = p;
      t.ds[i][j] = p * (dp[i][j] - delta[r]);
    }
  }
}

// lse and delta of query rows [q0, q0 + BQ) of head h into shared memory
__device__ __forceinline__ void load_rows(float* lse_s, float* delta_s, const float* __restrict__ LSE,
                                          const float* __restrict__ DELTA, int b, int h, int H,
                                          int q0, int tq) {
  for (int r = threadIdx.x; r < BQ; r += THREADS) {
    const int qp = q0 + r;
    lse_s[r] = qp < tq ? LSE[((long long)b * H + h) * tq + qp] : LSE_EMPTY;
    delta_s[r] = qp < tq ? DELTA[((long long)b * tq + qp) * H + h] : 0.f;
  }
}

constexpr int DKV_SMEM = (4 * 64 * LD + 2 * BQ * (BWD_BK + 1) + 2 * BQ) * 4;

// Sweep 1: one block per (key tile, b * Hkv + hk); the query tiles of the
// g query heads of KV head hk stream past, in order, head by head.
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_attn_bwd_dkv_kernel(const T* __restrict__ Q, const T* __restrict__ K, const T* __restrict__ V,
                          const T* __restrict__ dO, const float* __restrict__ LSE,
                          const float* __restrict__ DELTA, T* __restrict__ dK, T* __restrict__ dV,
                          int H, int Hkv, int D, long long qb, long long qt, long long qh,
                          long long kb, long long kt, long long kh, long long vb, long long vt,
                          long long vh, long long ob, long long ot, long long oh, Mask mask,
                          float scale) {
  extern __shared__ float smem[];
  float* Ks = smem;                   // (BWD_BK, LD), resident
  float* Vs = Ks + BWD_BK * LD;       // (BWD_BK, LD), resident
  float* Qs = Vs + BWD_BK * LD;       // (BQ, LD), scaled
  float* dOs = Qs + BQ * LD;          // (BQ, LD)
  float* Ps = dOs + BQ * LD;          // (BQ, BWD_BK + 1)
  float* dSs = Ps + BQ * (BWD_BK + 1);
  float* lse_s = dSs + BQ * (BWD_BK + 1);
  float* delta_s = lse_s + BQ;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int b = blockIdx.y / Hkv, hk = blockIdx.y % Hkv, g = H / Hkv;
  const int k0 = blockIdx.x * BWD_BK;

  load_tile(Ks, K + b * kb + hk * kh, kt, k0, BWD_BK, mask.tk, D, 1.f);
  load_tile(Vs, V + b * vb + hk * vh, vt, k0, BWD_BK, mask.tk, D, 1.f);
  float dk[4][DJ], dv[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk[i][j] = dv[i][j] = 0.f;

  const int lo = mask.query_lo(k0) / BQ * BQ, hi = mask.query_hi(k0, BWD_BK);
  for (int h = hk * g; h < hk * g + g; ++h) {
    for (int q0 = lo; q0 < hi; q0 += BQ) {
      __syncthreads();                // the last tile's readers are done
      load_tile(Qs, Q + b * qb + h * qh, qt, q0, BQ, mask.tq, D, scale);
      load_tile(dOs, dO + b * ob + h * oh, ot, q0, BQ, mask.tq, D, 1.f);
      load_rows(lse_s, delta_s, LSE, DELTA, b, h, H, q0, mask.tq);
      __syncthreads();
      BwdTile t;
      bwd_tile(t, Qs, dOs, Ks, Vs, lse_s, delta_s, q0, k0, D, mask);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          Ps[(ty + 16 * i) * (BWD_BK + 1) + tx + 16 * j] = t.p[i][j];
          dSs[(ty + 16 * i) * (BWD_BK + 1) + tx + 16 * j] = t.ds[i][j];
        }
      __syncthreads();
      // dV += P^T dO, dK += dS^T qs over the tile's query rows, in order
#pragma unroll 2
      for (int r = 0; r < BQ; ++r) {
        float pr[4], sr[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pr[i] = Ps[r * (BWD_BK + 1) + ty + 16 * i];
          sr[i] = dSs[r * (BWD_BK + 1) + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          const float o = dOs[r * LD + tx + 16 * j], qv = Qs[r * LD + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv[i][j] = fmaf(pr[i], o, dv[i][j]);
            dk[i][j] = fmaf(sr[i], qv, dk[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = k0 + ty + 16 * i;
    if (kp >= mask.tk) continue;
    const long long row = (((long long)b * mask.tk + kp) * Hkv + hk) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = tx + 16 * j;
      if (c < D) {
        dK[row + c] = from_f32<T>(dk[i][j]);
        dV[row + c] = from_f32<T>(dv[i][j]);
      }
    }
  }
}

constexpr int DQ_SMEM = (4 * 64 * LD + BQ * (BWD_BK + 1) + 2 * BQ) * 4;

// Sweep 2: one block per (query tile, b * H + h); the key tiles it can see
// stream past in order.
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_attn_bwd_dq_kernel(const T* __restrict__ Q, const T* __restrict__ K, const T* __restrict__ V,
                         const T* __restrict__ dO, const float* __restrict__ LSE,
                         const float* __restrict__ DELTA, T* __restrict__ dQ, int H, int Hkv,
                         int D, long long qb, long long qt, long long qh, long long kb,
                         long long kt, long long kh, long long vb, long long vt, long long vh,
                         long long ob, long long ot, long long oh, Mask mask, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                   // (BQ, LD), scaled, resident
  float* dOs = Qs + BQ * LD;          // (BQ, LD), resident
  float* Ks = dOs + BQ * LD;          // (BWD_BK, LD)
  float* Vs = Ks + BWD_BK * LD;       // (BWD_BK, LD)
  float* dSs = Vs + BWD_BK * LD;      // (BQ, BWD_BK + 1)
  float* lse_s = dSs + BQ * (BWD_BK + 1);
  float* delta_s = lse_s + BQ;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int b = blockIdx.y / H, h = blockIdx.y % H, hk = h / (H / Hkv);
  const int q0 = blockIdx.x * BQ;
  const T* k = K + b * kb + hk * kh;
  const T* v = V + b * vb + hk * vh;

  load_tile(Qs, Q + b * qb + h * qh, qt, q0, BQ, mask.tq, D, scale);
  load_tile(dOs, dO + b * ob + h * oh, ot, q0, BQ, mask.tq, D, 1.f);
  load_rows(lse_s, delta_s, LSE, DELTA, b, h, H, q0, mask.tq);
  float dq[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dq[i][j] = 0.f;

  const int hi = mask.key_hi(q0, BQ);
  for (int k0 = mask.key_lo(q0) / BWD_BK * BWD_BK; k0 < hi; k0 += BWD_BK) {
    __syncthreads();                  // the last tile's readers are done
    load_tile(Ks, k, kt, k0, BWD_BK, mask.tk, D, 1.f);
    load_tile(Vs, v, vt, k0, BWD_BK, mask.tk, D, 1.f);
    __syncthreads();
    BwdTile t;
    bwd_tile(t, Qs, dOs, Ks, Vs, lse_s, delta_s, q0, k0, D, mask);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dSs[(ty + 16 * i) * (BWD_BK + 1) + tx + 16 * j] = t.ds[i][j];
    __syncthreads();
    // dQ += dS K over the tile's keys, in order
#pragma unroll 2
    for (int c = 0; c < BWD_BK; ++c) {
      float kk[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kk[j] = Ks[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float s = dSs[(ty + 16 * i) * (BWD_BK + 1) + c];
#pragma unroll
        for (int j = 0; j < DJ; ++j) dq[i][j] = fmaf(s, kk[j], dq[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= mask.tq) continue;
    T* o = dQ + (((long long)b * mask.tq + qp) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = tx + 16 * j;
      if (c < D) o[c] = from_f32<T>(dq[i][j] * scale);
    }
  }
}

// Above 48 KB a block's shared memory must be asked for, once a kernel.
template <typename F>
cudaError_t allow_smem(F* kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

struct Strides {
  long long qb, qt, qh, kb, kt, kh, vb, vt, vh, ob, ot, oh;
};

template <typename T>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                       int H, int Hkv, int D, const Strides& st, Mask mask, float scale,
                       cudaStream_t s) {
  static const cudaError_t attr = allow_smem(flash_attn_fwd_kernel<T>, FWD_SMEM);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((mask.tq + BQ - 1) / BQ, B * H);
  flash_attn_fwd_kernel<T><<<grid, THREADS, FWD_SMEM, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, H, Hkv, D, st.qb, st.qt, st.qh, st.kb, st.kt, st.kh, st.vb,
      st.vt, st.vh, mask, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, void* dq, void* dk, void* dv, int B,
                       int H, int Hkv, int D, const Strides& st, Mask mask, float scale,
                       cudaStream_t s) {
  static const cudaError_t attr_dkv = allow_smem(flash_attn_bwd_dkv_kernel<T>, DKV_SMEM);
  static const cudaError_t attr_dq = allow_smem(flash_attn_bwd_dq_kernel<T>, DQ_SMEM);
  if (attr_dkv != cudaSuccess) return attr_dkv;
  if (attr_dq != cudaSuccess) return attr_dq;
  const T* Q = static_cast<const T*>(q);
  const T* K = static_cast<const T*>(k);
  const T* V = static_cast<const T*>(v);
  const T* dO = static_cast<const T*>(dout);
  const dim3 grid_kv((mask.tk + BWD_BK - 1) / BWD_BK, B * Hkv);
  flash_attn_bwd_dkv_kernel<T><<<grid_kv, THREADS, DKV_SMEM, s>>>(
      Q, K, V, dO, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), H, Hkv, D, st.qb, st.qt,
      st.qh, st.kb, st.kt, st.kh, st.vb, st.vt, st.vh, st.ob, st.ot, st.oh, mask, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_q((mask.tq + BQ - 1) / BQ, B * H);
  flash_attn_bwd_dq_kernel<T><<<grid_q, THREADS, DQ_SMEM, s>>>(
      Q, K, V, dO, lse, delta, static_cast<T*>(dq), H, Hkv, D, st.qb, st.qt, st.qh, st.kb, st.kt,
      st.kh, st.vb, st.vt, st.vh, st.ob, st.ot, st.oh, mask, scale);
  return cudaGetLastError();
}

}  // namespace

// window <= 0: no window. Strides are in elements.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* o,
                                     float* lse, int B, int H, int Hkv, int D, int Tq, int Tk,
                                     long long qb, long long qt, long long qh, long long kb,
                                     long long kt, long long kh, long long vb, long long vt,
                                     long long vh, int causal, int window, float scale, int bf16,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || Tq == 0) return static_cast<int>(cudaGetLastError());
  const Strides st{qb, qt, qh, kb, kt, kh, vb, vt, vh, 0, 0, 0};
  const Mask mask{Tq, Tk, causal, window};
  const cudaError_t err =
      bf16 ? launch_fwd<__nv_bfloat16>(q, k, v, o, lse, B, H, Hkv, D, st, mask, scale, s)
           : launch_fwd<float>(q, k, v, o, lse, B, H, Hkv, D, st, mask, scale, s);
  return static_cast<int>(err);
}

// Both sweeps, on one stream: dK/dV, then dQ.
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* dout, const float* lse, const float* delta,
                                         void* dq, void* dk, void* dv, int B, int H, int Hkv,
                                         int D, int Tq, int Tk, long long qb, long long qt,
                                         long long qh, long long kb, long long kt, long long kh,
                                         long long vb, long long vt, long long vh, long long ob,
                                         long long ot, long long oh, int causal, int window,
                                         float scale, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || Tq == 0 || Tk == 0) return static_cast<int>(cudaGetLastError());
  const Strides st{qb, qt, qh, kb, kt, kh, vb, vt, vh, ob, ot, oh};
  const Mask mask{Tq, Tk, causal, window};
  const cudaError_t err =
      bf16 ? launch_bwd<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Hkv, D, st,
                                       mask, scale, s)
           : launch_bwd<float>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Hkv, D, st, mask,
                               scale, s);
  return static_cast<int>(err);
}
