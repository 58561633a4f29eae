// Flash attention for training: the online-softmax forward with its
// logsumexp residual, and the two-sweep recompute backward.
//
// Replaces the Pallas kernels `flash_attention` (_flash_kernel) and
// `flash_attention_bwd` (_flash_bwd_dkv_kernel, _flash_bwd_dq_kernel) of
// src/repro/kernels/flash_attention.py. Query row i of query head h attends
// the keys j of KV head h / (H / Hkv) (GQA) with j <= i under `causal` and
// j > i - window under a window, at scale D^-0.5. Each output is rounded
// once to its type.
//
//   forward:  S = q K^T D^-0.5, online softmax over key tiles, O = P V / l,
//             lse = m + log(l) in scaled-logit units; a row that sees no
//             key (l == 0) gets O = 0 and lse = 1e30 (the Pallas
//             kernel's sentinel), so the backward's exp(S - lse) is 0.
//   backward: P = exp(S - lse), dV = P^T dO, dP = dO V^T,
//             dS = P (dP - delta), dK = dS^T qs, dQ = D^-0.5 dS K, with
//             delta = rowsum(dO * O) taken by the caller in PyTorch, as
//             the JAX package takes it in XLA.
//
// bf16 runs on the tensor cores, forward and backward (FlashAttention-2's
// shape): a block of 4 warps owns 64 query rows (forward, dQ sweep) or 64
// key rows (dK/dV sweep), the other operand's 64-row tiles stream through
// two cp.async buffers in shared memory, every product is an m16n8k16
// mma.sync with f32 accumulators, and P (and dS) go from an accumulator to
// the next product's A fragment in registers. D is zero-padded to the
// instance's width (64 or 128) in the tiles. They round in two places the
// f32 kernels and the JAX kernel (q scaled in f32, then an f32 dot) do not:
// the scale is applied to the f32 scores after the dot (and to dQ and dK
// after theirs), and P and dS enter their products as hi + lo, two bf16
// values with 16 significant bits between them, not as f32 (the forward's
// row sum l takes the f32 P). f32 runs on the FMA units from f32 tiles in
// shared memory, q scaled in f32 before the dot (the depth-2 f32 train step
// is held to the CPU at rtol 1e-4).
//
// Layouts: q/o/dO [B, Tq, H, D], k/v [B, Tk, Hkv, D] are read in place
// through their (batch, time, head) strides, with a contiguous head dim;
// there is no transposed or repeated copy of K/V for the GQA group. lse is
// [B, H, Tq] f32, delta [B, Tq, H] f32; o, dq, dk and dv are written
// contiguous. Ragged Tq and Tk are masked in the kernels, not padded. The
// bf16 forward loads 16 bytes at a time where q, k and v and their strides
// are 16-byte aligned, and element by element otherwise.
//
// Bound at the main path's shape (qwen3-0.6b training, B=4, T=512, 16
// query / 8 KV heads of 128, causal, bf16): the forward moves q, k, v, o
// once (25.3 MB, 7.5 us at 3.35 TB/s) and does 4.3 GFLOP of unmasked
// products (4.4 us at 989 TFLOP/s), so it is bound by its bytes; the
// tensor-core forward computes whole 64x64 tiles on the diagonal (4.8
// GFLOP) and reads each K/V tile once per query tile (from L2 after the
// first). The backward moves q, k, v, o, dO, dq, dk, dv (50.6 MB, 15 us)
// against 10.8 GFLOP (11 us): at the FMA units' 67 TFLOP/s it could not
// take less than 0.16 ms, so only the tensor cores bring it near its bound.
// Its two tensor-core sweeps run ten tile products a (query, key) tile
// pair against the forward's three: S and dP are recomputed in both
// sweeps, and hi + lo doubles the three products that take P or dS.
//
// What the design does about the TPU kernel's shape: Pallas walks the key
// tiles (forward, dQ sweep) or query tiles (dK/dV sweep) along a
// sequential grid dim and carries the accumulator in VMEM scratch between
// grid steps. Here a block owns one output tile and loops over the tiles
// it needs inside the block, skipping tiles wholly outside the causal and
// window masks (and testing the mask per element only on tiles that cross
// it), so nothing carries between blocks. The dK/dV sweep holds a (64, D)
// dK and dV accumulator in registers while the query tiles of all g query
// heads of its KV head stream past: the GQA group-sum happens in the
// kernel (Pallas writes per-query-head dK/dV and the caller sums them,
// because it cannot revisit an output block). There are no atomics: every
// sum runs in a fixed order, so an output has the same bits from run to
// run.

#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

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

// -- the bf16 forward on the tensor cores ------------------------------------
// One block of 4 warps per (b * H + h, 64-row query tile), the tiles with
// the most keys first. Each warp keeps its 16 query rows as ldmatrix
// fragments in registers; 64-key K/V tiles are double-buffered in shared
// memory by cp.async, the next one loading while this one is used. S = Q K^T
// by mma.sync into f32, scaled by D^-0.5 log2(e) and masked there; the
// online max and sum run on the fragments (each row's 4 owners meet by
// shuffles within their quad); P stays in registers, where its layout is
// already that of the A fragment of O += P V (V through ldmatrix.trans). P
// enters P V as two bf16 fragments, hi = bf16(p) and lo = bf16(p - hi), so
// each p keeps 16 significant bits and O an f32 sum's accuracy: one bf16
// P would cost up to 2^-9 of each term, which with cancelling terms comes
// to more than one rounding of O. The row sum l takes P in f32.
using repro::bf16;

constexpr int TC_BQ = 64, TC_BK = 64, TC_THREADS = 128;
constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;

// The A fragment of columns 16 kk .. 16 kk + 15 of a warp's 16-row f32
// accumulators, as hi = bf16(x) and lo = bf16(x - hi): 16 significant bits.
template <int N>
__device__ __forceinline__ void split_frag(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                           const float (&acc)[N][4], int kk) {
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    const float x0 = acc[2 * kk + (f >> 1)][(f & 1) * 2];
    const float x1 = acc[2 * kk + (f >> 1)][(f & 1) * 2 + 1];
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    hi[f] = *reinterpret_cast<const uint32_t*>(&h);
    lo[f] = repro::pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
  }
}

template <int DP>
constexpr int tc_fwd_smem() { return (TC_BQ + 4 * TC_BK) * repro::padded(DP) * 2; }

// DP: D rounded up to the instance's width (64 or 128); columns past D are
// zero in every tile.
template <int DP>
__global__ void __launch_bounds__(TC_THREADS)
flash_attn_fwd_mma_kernel(const bf16* __restrict__ Q, const bf16* __restrict__ K,
                          const bf16* __restrict__ V, bf16* __restrict__ O, float* __restrict__ LSE,
                          int H, int Hkv, int D, long long qb, long long qt, long long qh,
                          long long kb, long long kt, long long kh, long long vb, long long vt,
                          long long vh, Mask mask, float scale_log2, bool vec) {
  constexpr int LDS = repro::padded(DP), KD = DP / 16, NS = TC_BK / 8, ND = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [TC_BQ][LDS]
  bf16* Ks = Qs + TC_BQ * LDS;                   // 2 slots of [TC_BK][LDS]
  bf16* Vs = Ks + 2 * TC_BK * LDS;               // 2 slots of [TC_BK][LDS]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, g = lane / 4, t = lane % 4;
  const int b = blockIdx.x / H, h = blockIdx.x % H, hk = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TC_BQ;
  const bf16* q = Q + b * qb + h * qh;
  const bf16* k = K + b * kb + hk * kh;
  const bf16* v = V + b * vb + hk * vh;

  const int lo = mask.key_lo(q0) / TC_BK * TC_BK, hi = mask.key_hi(q0, TC_BQ);
  const int n_tiles = hi > lo ? (hi - lo + TC_BK - 1) / TC_BK : 0;
  auto load_kv = [&](int slot, int k0) {
    repro::load_tile<TC_BK, DP, TC_THREADS>(Ks + slot * TC_BK * LDS, k, kt, k0, mask.tk, 0, D,
                                            vec, tid);
    repro::load_tile<TC_BK, DP, TC_THREADS>(Vs + slot * TC_BK * LDS, v, vt, k0, mask.tk, 0, D,
                                            vec, tid);
  };
  repro::load_tile<TC_BQ, DP, TC_THREADS>(Qs, q, qt, q0, mask.tq, 0, D, vec, tid);
  if (n_tiles > 0) load_kv(0, lo);
  repro::cp_async_commit();
  repro::cp_async_wait<0>();
  __syncthreads();

  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
    repro::ldmatrix_x4(qf[kk], Qs + (warp * 16 + (lane & 15)) * LDS + kk * 16 + (lane >> 4) * 8);

  float o[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};  // log2 units; this lane's part of l
  const int row0 = q0 + warp * 16 + g;                        // rows row0 and row0 + 8

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = lo + it * TC_BK;
    if (it > 0) {
      repro::cp_async_wait<0>();
      __syncthreads();  // tile it is in for all; every warp is done with tile it - 1
    }
    if (it + 1 < n_tiles) load_kv((it + 1) & 1, k0 + TC_BK);
    repro::cp_async_commit();
    const bf16* ks = Ks + (it & 1) * TC_BK * LDS;
    const bf16* vs = Vs + (it & 1) * TC_BK * LDS;

    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int j = 0; j < NS / 2; ++j) {
        uint32_t r[4];
        repro::ldmatrix_x4(r, ks + (j * 16 + (lane & 7) + (lane >> 4) * 8) * LDS + kk * 16 +
                                  ((lane >> 3) & 1) * 8);
        repro::mma_bf16(s[2 * j], qf[kk], r[0], r[1]);
        repro::mma_bf16(s[2 * j + 1], qf[kk], r[2], r[3]);
      }

    // a tile wholly inside the masks needs no per-element test
    const bool edge = k0 + TC_BK > mask.tk || (mask.causal && k0 + TC_BK - 1 > q0) ||
                      (mask.window > 0 && k0 <= q0 + TC_BQ - 1 - mask.window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (edge && !mask(row0 + (e >> 1) * 8, k0 + j * 8 + 2 * t + (e & 1))) x = -INFINITY;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float base[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r]);
      base[r] = m_new == -INFINITY ? 0.f : m_new;  // a row with no key yet stays at 0
      alpha[r] = exp2f(m_r[r] - base[r]);
      m_r[r] = m_new;
      l_r[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - base[e >> 1]);
        l_r[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk) {
      uint32_t ph[4], pl[4];  // P as hi + lo: 16 significant bits of each p
      split_frag(ph, pl, s, kk);
#pragma unroll
      for (int j = 0; j < ND / 2; ++j) {
        uint32_t r[4];
        repro::ldmatrix_x4_trans(r, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS +
                                        j * 16 + (lane >> 4) * 8);
        repro::mma_bf16(o[2 * j], ph, r[0], r[1]);
        repro::mma_bf16(o[2 * j], pl, r[0], r[1]);
        repro::mma_bf16(o[2 * j + 1], ph, r[2], r[3]);
        repro::mma_bf16(o[2 * j + 1], pl, r[2], r[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    const int qp = row0 + 8 * r;
    if (qp >= mask.tq) continue;
    const float lsafe = l_r[r] > 0.f ? l_r[r] : 1.f;
    bf16* out = O + (((long long)b * mask.tq + qp) * H + h) * D;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int c = j * 8 + 2 * t;
      if (c >= D) continue;
      const bf16 o0 = __float2bfloat16_rn(o[j][2 * r] / lsafe);
      if (c + 1 < D) {
        const bf16 o1 = __float2bfloat16_rn(o[j][2 * r + 1] / lsafe);
        if (D % 2 == 0) {
          __nv_bfloat162 pair;
          pair.x = o0;
          pair.y = o1;
          *reinterpret_cast<__nv_bfloat162*>(out + c) = pair;
          continue;
        }
        out[c + 1] = o1;
      }
      out[c] = o0;
    }
    if (t == 0)
      LSE[((long long)b * H + h) * mask.tq + qp] =
          l_r[r] > 0.f ? m_r[r] * LN2 + logf(l_r[r]) : LSE_EMPTY;
  }
}

// -- the bf16 backward on the tensor cores -----------------------------------
// FlashAttention-2's backward in two sweeps, built from the forward's parts.
// Both recompute P = exp2(S D^-0.5 log2(e) - lse log2(e)) from the
// forward's lse (1e30 on a row that sees no key, so P = 0 there) and
// dS = P (dP - delta) on the f32 accumulators of mma.sync, and both mask per
// element only on tiles that cross a mask (or a ragged edge).
//   dK/dV: one block of 4 warps per (b * Hkv + hk, 64-key tile), the key
//   tiles that see the most queries first. K and V stay in shared memory;
//   the 64-query tiles of the g query heads of hk stream past, head by
//   head, Q, dO, lse and delta double-buffered by cp.async. Warp w owns
//   keys 16 w .. 16 w + 15 and takes 32 queries at a time: S^T = K Q^T and
//   dP^T = V dO^T, then dV += P^T dO and dK += dS^T Q, P^T and dS^T going
//   from the accumulators to A fragments in registers, dO and Q through
//   ldmatrix.trans. The GQA group sum is the loop over the g heads, in
//   order; dK is scaled by D^-0.5 at the end.
//   dQ: one block of 4 warps per (b * H + h, 64-query tile), the tiles with
//   the most keys first. Q and dO stay in shared memory, 64-key K/V tiles
//   are double-buffered; S = Q K^T, dP = dO V^T, dQ += dS K (K through
//   ldmatrix.trans), scaled by D^-0.5 at the end.
// P and dS enter their products as hi + lo bf16 fragments, as P does in the
// forward. K and V (Q and dO) are read by ldmatrix at every use, not kept
// as fragments: beside a warp's 16 x 128 dK and dV accumulators (128
// registers a thread) they would not fit in a thread's 255.

template <int DP>
constexpr int tc_bwd_smem() { return 6 * 64 * repro::padded(DP) * 2 + 4 * 64 * 4; }

// Row g + 8 r of a warp's 16 x DP accumulators times `mul` into `out`
// (D columns of bf16).
template <int ND>
__device__ __forceinline__ void store_row(bf16* __restrict__ out, const float (&acc)[ND][4],
                                          int r, int D, float mul) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    const int c = j * 8 + 2 * t;
    if (c >= D) continue;
    const bf16 o0 = __float2bfloat16_rn(acc[j][2 * r] * mul);
    if (c + 1 < D) {
      const bf16 o1 = __float2bfloat16_rn(acc[j][2 * r + 1] * mul);
      if (D % 2 == 0) {
        __nv_bfloat162 pair;
        pair.x = o0;
        pair.y = o1;
        *reinterpret_cast<__nv_bfloat162*>(out + c) = pair;
        continue;
      }
      out[c + 1] = o1;
    }
    out[c] = o0;
  }
}

template <int DP>
__global__ void __launch_bounds__(TC_THREADS)
flash_attn_bwd_dkv_mma_kernel(const bf16* __restrict__ Q, const bf16* __restrict__ K,
                              const bf16* __restrict__ V, const bf16* __restrict__ dO,
                              const float* __restrict__ LSE, const float* __restrict__ DELTA,
                              bf16* __restrict__ dK, bf16* __restrict__ dV, int H, int Hkv, int D,
                              long long qb, long long qt, long long qh, long long kb, long long kt,
                              long long kh, long long vb, long long vt, long long vh, long long ob,
                              long long ot, long long oh, Mask mask, float scale,
                              float scale_log2, bool vec) {
  constexpr int LDS = repro::padded(DP), KD = DP / 16, ND = DP / 8, T = 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);                // [T][LDS], resident
  bf16* Vs = Ks + T * LDS;                                     // [T][LDS], resident
  bf16* Qs = Vs + T * LDS;                                     // 2 slots of [T][LDS]
  bf16* dOs = Qs + 2 * T * LDS;                                // 2 slots of [T][LDS]
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * T * LDS);  // 2 slots of [T]
  float* delta_s = lse_s + 2 * T;                              // 2 slots of [T]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, g = lane / 4, t = lane % 4;
  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv, grp = H / Hkv;
  const int k0 = blockIdx.y * T, krow = warp * 16;
  const int qlo = mask.query_lo(k0) / T * T, qhi = mask.query_hi(k0, T);
  const int n_qt = qhi > qlo ? (qhi - qlo + T - 1) / T : 0, n_it = grp * n_qt;

  // query tile `it` (head hk * grp + it / n_qt) into slot `slot`
  auto load_q = [&](int slot, int it) {
    const int h = hk * grp + it / n_qt, q0 = qlo + it % n_qt * T;
    repro::load_tile<T, DP, TC_THREADS>(Qs + slot * T * LDS, Q + b * qb + h * qh, qt, q0,
                                        mask.tq, 0, D, vec, tid);
    repro::load_tile<T, DP, TC_THREADS>(dOs + slot * T * LDS, dO + b * ob + h * oh, ot, q0,
                                        mask.tq, 0, D, vec, tid);
    if (tid < T) {
      const int qp = q0 + tid, n = qp < mask.tq ? 4 : 0;
      repro::cp_async4(lse_s + slot * T + tid,
                       n ? LSE + ((long long)b * H + h) * mask.tq + qp : LSE, n);
      repro::cp_async4(delta_s + slot * T + tid,
                       n ? DELTA + ((long long)b * mask.tq + qp) * H + h : DELTA, n);
    }
  };
  repro::load_tile<T, DP, TC_THREADS>(Ks, K + b * kb + hk * kh, kt, k0, mask.tk, 0, D, vec, tid);
  repro::load_tile<T, DP, TC_THREADS>(Vs, V + b * vb + hk * vh, vt, k0, mask.tk, 0, D, vec, tid);
  if (n_it > 0) load_q(0, 0);
  repro::cp_async_commit();

  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    repro::cp_async_wait<0>();
    __syncthreads();  // tile it is in for all; every warp is done with tile it - 1
    if (it + 1 < n_it) load_q((it + 1) & 1, it + 1);
    repro::cp_async_commit();
    const int q0 = qlo + it % n_qt * T;
    const bf16* qs = Qs + (it & 1) * T * LDS;
    const bf16* dos = dOs + (it & 1) * T * LDS;
    const float* lse_r = lse_s + (it & 1) * T;
    const float* delta_r = delta_s + (it & 1) * T;
    // a tile wholly inside the masks and the edges needs no per-element test
    const bool edge = k0 + T > mask.tk || q0 + T > mask.tq ||
                      (mask.causal && k0 + T - 1 > q0) ||
                      (mask.window > 0 && k0 <= q0 + T - 1 - mask.window);
#pragma unroll 1
    for (int qq = 0; qq < T; qq += 32) {
      float st[4][4], dpt[4][4];  // 16 keys x 32 queries
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t ka[4], va[4];
        repro::ldmatrix_x4(ka, Ks + (krow + (lane & 15)) * LDS + kk * 16 + (lane >> 4) * 8);
        repro::ldmatrix_x4(va, Vs + (krow + (lane & 15)) * LDS + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int r = qq + j * 16 + (lane & 7) + (lane >> 4) * 8;
          const int c = kk * 16 + ((lane >> 3) & 1) * 8;
          uint32_t x[4];
          repro::ldmatrix_x4(x, qs + r * LDS + c);
          repro::mma_bf16(st[2 * j], ka, x[0], x[1]);
          repro::mma_bf16(st[2 * j + 1], ka, x[2], x[3]);
          repro::ldmatrix_x4(x, dos + r * LDS + c);
          repro::mma_bf16(dpt[2 * j], va, x[0], x[1]);
          repro::mma_bf16(dpt[2 * j + 1], va, x[2], x[3]);
        }
      }
      // element e of n-tile j: key krow + g + 8 (e >> 1), query qq + 8 j + 2 t + (e & 1)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = qq + j * 8 + 2 * t + (e & 1);
          float p = exp2f(st[j][e] * scale_log2 - lse_r[qi] * LOG2E);
          if (edge && !mask(q0 + qi, k0 + krow + g + (e >> 1) * 8)) p = 0.f;
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - delta_r[qi]);
        }
      // dV += P^T dO, dK += dS^T Q over the 32 queries, 16 at a time
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t ph[4], pl[4], sh[4], sl[4];
        split_frag(ph, pl, st, kk);
        split_frag(sh, sl, dpt, kk);
#pragma unroll
        for (int j = 0; j < ND / 2; ++j) {
          const int r = qq + kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
          const int c = j * 16 + (lane >> 4) * 8;
          uint32_t x[4];
          repro::ldmatrix_x4_trans(x, dos + r * LDS + c);
          repro::mma_bf16(dv[2 * j], ph, x[0], x[1]);
          repro::mma_bf16(dv[2 * j], pl, x[0], x[1]);
          repro::mma_bf16(dv[2 * j + 1], ph, x[2], x[3]);
          repro::mma_bf16(dv[2 * j + 1], pl, x[2], x[3]);
          repro::ldmatrix_x4_trans(x, qs + r * LDS + c);
          repro::mma_bf16(dk[2 * j], sh, x[0], x[1]);
          repro::mma_bf16(dk[2 * j], sl, x[0], x[1]);
          repro::mma_bf16(dk[2 * j + 1], sh, x[2], x[3]);
          repro::mma_bf16(dk[2 * j + 1], sl, x[2], x[3]);
        }
      }
    }
  }
  repro::cp_async_wait<0>();  // a tile no query sees still had K and V in flight

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kp = k0 + krow + g + 8 * r;
    if (kp >= mask.tk) continue;
    const long long row = (((long long)b * mask.tk + kp) * Hkv + hk) * D;
    store_row(dK + row, dk, r, D, scale);
    store_row(dV + row, dv, r, D, 1.f);
  }
}

template <int DP>
__global__ void __launch_bounds__(TC_THREADS)
flash_attn_bwd_dq_mma_kernel(const bf16* __restrict__ Q, const bf16* __restrict__ K,
                             const bf16* __restrict__ V, const bf16* __restrict__ dO,
                             const float* __restrict__ LSE, const float* __restrict__ DELTA,
                             bf16* __restrict__ dQ, int H, int Hkv, int D, long long qb,
                             long long qt, long long qh, long long kb, long long kt, long long kh,
                             long long vb, long long vt, long long vh, long long ob, long long ot,
                             long long oh, Mask mask, float scale, float scale_log2, bool vec) {
  constexpr int LDS = repro::padded(DP), KD = DP / 16, NS = TC_BK / 8, ND = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [TC_BQ][LDS], resident
  bf16* dOs = Qs + TC_BQ * LDS;                  // [TC_BQ][LDS], resident
  bf16* Ks = dOs + TC_BQ * LDS;                  // 2 slots of [TC_BK][LDS]
  bf16* Vs = Ks + 2 * TC_BK * LDS;               // 2 slots of [TC_BK][LDS]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, g = lane / 4, t = lane % 4;
  const int b = blockIdx.x / H, h = blockIdx.x % H, hk = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TC_BQ;
  const bf16* k = K + b * kb + hk * kh;
  const bf16* v = V + b * vb + hk * vh;

  const int lo = mask.key_lo(q0) / TC_BK * TC_BK, hi = mask.key_hi(q0, TC_BQ);
  const int n_tiles = hi > lo ? (hi - lo + TC_BK - 1) / TC_BK : 0;
  auto load_kv = [&](int slot, int k0) {
    repro::load_tile<TC_BK, DP, TC_THREADS>(Ks + slot * TC_BK * LDS, k, kt, k0, mask.tk, 0, D,
                                            vec, tid);
    repro::load_tile<TC_BK, DP, TC_THREADS>(Vs + slot * TC_BK * LDS, v, vt, k0, mask.tk, 0, D,
                                            vec, tid);
  };
  repro::load_tile<TC_BQ, DP, TC_THREADS>(Qs, Q + b * qb + h * qh, qt, q0, mask.tq, 0, D, vec,
                                          tid);
  repro::load_tile<TC_BQ, DP, TC_THREADS>(dOs, dO + b * ob + h * oh, ot, q0, mask.tq, 0, D, vec,
                                          tid);
  if (n_tiles > 0) load_kv(0, lo);
  repro::cp_async_commit();
  const int row0 = q0 + warp * 16 + g;  // rows row0 and row0 + 8
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = row0 + 8 * r;
    lse2[r] = qp < mask.tq ? LSE[((long long)b * H + h) * mask.tq + qp] * LOG2E : 0.f;
    dl[r] = qp < mask.tq ? DELTA[((long long)b * mask.tq + qp) * H + h] : 0.f;
  }
  repro::cp_async_wait<0>();
  __syncthreads();

  float dq[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = lo + it * TC_BK;
    if (it > 0) {
      repro::cp_async_wait<0>();
      __syncthreads();  // tile it is in for all; every warp is done with tile it - 1
    }
    if (it + 1 < n_tiles) load_kv((it + 1) & 1, k0 + TC_BK);
    repro::cp_async_commit();
    const bf16* ks = Ks + (it & 1) * TC_BK * LDS;
    const bf16* vs = Vs + (it & 1) * TC_BK * LDS;

    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qa[4], oa[4];
      repro::ldmatrix_x4(qa, Qs + (warp * 16 + (lane & 15)) * LDS + kk * 16 + (lane >> 4) * 8);
      repro::ldmatrix_x4(oa, dOs + (warp * 16 + (lane & 15)) * LDS + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < NS / 2; ++j) {
        const int r = j * 16 + (lane & 7) + (lane >> 4) * 8, c = kk * 16 + ((lane >> 3) & 1) * 8;
        uint32_t x[4];
        repro::ldmatrix_x4(x, ks + r * LDS + c);
        repro::mma_bf16(s[2 * j], qa, x[0], x[1]);
        repro::mma_bf16(s[2 * j + 1], qa, x[2], x[3]);
        repro::ldmatrix_x4(x, vs + r * LDS + c);
        repro::mma_bf16(dp[2 * j], oa, x[0], x[1]);
        repro::mma_bf16(dp[2 * j + 1], oa, x[2], x[3]);
      }
    }
    const bool edge = k0 + TC_BK > mask.tk || (mask.causal && k0 + TC_BK - 1 > q0) ||
                      (mask.window > 0 && k0 <= q0 + TC_BQ - 1 - mask.window);
    // dS, in place of S
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[j][e] * scale_log2 - lse2[e >> 1]);
        if (edge && !mask(row0 + (e >> 1) * 8, k0 + j * 8 + 2 * t + (e & 1))) p = 0.f;
        s[j][e] = p * (dp[j][e] - dl[e >> 1]);
      }
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk) {
      uint32_t sh[4], sl[4];
      split_frag(sh, sl, s, kk);
#pragma unroll
      for (int j = 0; j < ND / 2; ++j) {
        uint32_t x[4];
        repro::ldmatrix_x4_trans(x, ks + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS +
                                        j * 16 + (lane >> 4) * 8);
        repro::mma_bf16(dq[2 * j], sh, x[0], x[1]);
        repro::mma_bf16(dq[2 * j], sl, x[0], x[1]);
        repro::mma_bf16(dq[2 * j + 1], sh, x[2], x[3]);
        repro::mma_bf16(dq[2 * j + 1], sl, x[2], x[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = row0 + 8 * r;
    if (qp < mask.tq) store_row(dQ + (((long long)b * mask.tq + qp) * H + h) * D, dq, r, D, scale);
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

template <int DP>
cudaError_t launch_fwd_mma(const void* q, const void* k, const void* v, void* o, float* lse,
                           int B, int H, int Hkv, int D, const Strides& st, Mask mask, float scale,
                           cudaStream_t s) {
  constexpr int SMEM = tc_fwd_smem<DP>();
  static const cudaError_t attr = allow_smem(flash_attn_fwd_mma_kernel<DP>, SMEM);
  if (attr != cudaSuccess) return attr;
  // 16-byte cp.async where every base and stride allows it
  const bool vec = ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v)) % 16 == 0) &&
                   ((st.qb | st.qt | st.qh | st.kb | st.kt | st.kh | st.vb | st.vt | st.vh) % 8 == 0);
  const dim3 grid(B * H, (mask.tq + TC_BQ - 1) / TC_BQ);
  flash_attn_fwd_mma_kernel<DP><<<grid, TC_THREADS, SMEM, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, H, Hkv, D, st.qb, st.qt, st.qh, st.kb, st.kt, st.kh, st.vb,
      st.vt, st.vh, mask, scale * LOG2E, vec);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_bwd_mma(const void* q, const void* k, const void* v, const void* dout,
                           const float* lse, const float* delta, void* dq, void* dk, void* dv,
                           int B, int H, int Hkv, int D, const Strides& st, Mask mask, float scale,
                           cudaStream_t s) {
  constexpr int SMEM = tc_bwd_smem<DP>();
  static const cudaError_t attr_dkv = allow_smem(flash_attn_bwd_dkv_mma_kernel<DP>, SMEM);
  static const cudaError_t attr_dq = allow_smem(flash_attn_bwd_dq_mma_kernel<DP>, SMEM);
  if (attr_dkv != cudaSuccess) return attr_dkv;
  if (attr_dq != cudaSuccess) return attr_dq;
  const bool vec = ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)) % 16 == 0) &&
                   ((st.qb | st.qt | st.qh | st.kb | st.kt | st.kh | st.vb | st.vt | st.vh | st.ob |
                     st.ot | st.oh) % 8 == 0);
  const bf16* Q = static_cast<const bf16*>(q);
  const bf16* K = static_cast<const bf16*>(k);
  const bf16* V = static_cast<const bf16*>(v);
  const bf16* dO = static_cast<const bf16*>(dout);
  const dim3 grid_kv(B * Hkv, (mask.tk + 63) / 64);
  flash_attn_bwd_dkv_mma_kernel<DP><<<grid_kv, TC_THREADS, SMEM, s>>>(
      Q, K, V, dO, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, Hkv, D, st.qb,
      st.qt, st.qh, st.kb, st.kt, st.kh, st.vb, st.vt, st.vh, st.ob, st.ot, st.oh, mask, scale,
      scale * LOG2E, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_q(B * H, (mask.tq + TC_BQ - 1) / TC_BQ);
  flash_attn_bwd_dq_mma_kernel<DP><<<grid_q, TC_THREADS, SMEM, s>>>(
      Q, K, V, dO, lse, delta, static_cast<bf16*>(dq), H, Hkv, D, st.qb, st.qt, st.qh, st.kb,
      st.kt, st.kh, st.vb, st.vt, st.vh, st.ob, st.ot, st.oh, mask, scale, scale * LOG2E, vec);
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
  // bf16 on the tensor cores, f32 on the FMA kernel
  const cudaError_t err =
      !bf16 ? launch_fwd<float>(q, k, v, o, lse, B, H, Hkv, D, st, mask, scale, s)
      : D <= 64 ? launch_fwd_mma<64>(q, k, v, o, lse, B, H, Hkv, D, st, mask, scale, s)
                : launch_fwd_mma<128>(q, k, v, o, lse, B, H, Hkv, D, st, mask, scale, s);
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
  // bf16 on the tensor cores, f32 on the FMA kernels
  const cudaError_t err =
      !bf16 ? launch_bwd<float>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Hkv, D, st, mask,
                                scale, s)
      : D <= 64 ? launch_bwd_mma<64>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Hkv, D, st,
                                     mask, scale, s)
                : launch_bwd_mma<128>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Hkv, D, st,
                                      mask, scale, s);
  return static_cast<int>(err);
}
