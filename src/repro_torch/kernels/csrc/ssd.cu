// SSD (Mamba-2 state-space duality): the intra-chunk work of the chunked
// scan, in one launch, on the tensor cores.
//
// Replaces the Pallas kernel `ssd_intra_chunk` (_ssd_chunk_kernel) of
// src/repro/kernels/ssd.py. For a chunk of Q steps of head h, with its
// log-decays a, cs = cumsum(a), and B and C read from group h / (H / G):
//
//   y_diag[i] = sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) x_j     (Q, P)
//   state     = sum_j (B_j exp(cs_{Q-1} - cs_j))^T x_j            (N, P)
//
// The decay argument is masked to -inf where j > i *before* the exp, as
// the Pallas kernel masks it: the upper triangle of cs_i - cs_j is
// positive and overflows to inf for strong decays, and inf * 0 is NaN.
// x, B and C are float or bf16, a is float; y_diag and the states are f32.
//
// Layouts: x (B, L, H, P), a (B, L, H), B and C (B, L, G, N) are read in
// place through their (batch, time, head or group) strides, with a
// contiguous last dim: nothing is transposed into (B*H, nc, Q, .) and B
// and C are not repeated for each head of a group, where the JAX wrapper
// copies both. y_diag is written (B, L, H, P), the chunk states
// (B, H, nc, N, P), both contiguous. The inter-chunk recurrence and the
// state -> output term stay in PyTorch, as they stay in XLA.
//
// Bound at the main path's shape (mamba2-2.7b prefill, B = 1, L = 512,
// H = 80, P = 64, N = 128, Q = 256, f32, which models/ssm.py casts x dt,
// B and C to): 26.9 MB of inputs and outputs (8 us at 3.35 TB/s) against
// 2.69 GFLOP of unmasked products. On the route taken here, 3xTF32 on the
// tensor cores (three tf32 products for each f32 one, 495 / 3 = 165
// TFLOP/s dense), that is 16 us; on the FMA units (67 TFLOP/s) it was 40
// us. Bound by its operations either way.
//
// Design.
// - Products: every product, C B^T, S x and (B w)^T x, is an
//   mma.sync.m16n8k8 tf32 step with an f32 accumulator. An f32 operand
//   enters as hi + lo (split_tf32) and each step sums lo hi + hi lo + hi
//   hi, which keeps f32's agreement (one tf32 pass keeps ~3 digits). A
//   bf16 operand is exact in tf32 and has no lo: C B^T is one pass and
//   S x and (B w)^T x, whose f32 side is split, two.
// - No shuffles: the k index of an m16n8k8 step may be permuted, as long
//   as A and B agree. Taking k = t as column 2t and k = t + 4 as 2t + 1
//   makes the C fragment of S = C B^T, (g, 2t), (g, 2t + 1), ..., the A
//   fragment of S x as it stands in the registers; x is then read at
//   rows 2t and 2t + 1. The same permutation on C B^T reads C and B as
//   pairs (float2).
// - Shared tiles are padded so that every fragment read is free of bank
//   conflicts: a row stride of 8 (mod 32) words where a half-warp reads
//   float2 pairs of 4 rows, and 4 (mod 32) where a warp reads single
//   words of rows 2t, 2t + 1 (x, and B read transposed by a state job).
// - The instruction stream, which bounds the kernel (an H100 issues an
//   m16n8k8 tf32 step every ~6 cycles on each sub-partition; this kernel
//   spends ~3 instructions a step on fragment loads and splits, the split
//   being a mask and a subtraction): the hot loops have
//   no branch (a predicated mma.sync costs a warp sync, and a branch kept
//   ptxas from hoisting loads), and issue each split pass over all the
//   accumulators before the next, so that neighbouring steps are
//   independent (each accumulator still sums in one order).
// - Head pairs: C B^T depends on the group, not the head, so a block
//   serves two heads of one group (where the group's heads pair up and P
//   <= 64) and forms S = C B^T once a key step for both; each head then
//   takes its own decay and x. A state job shares its B tile the same way.
// - Staging: each 16-key step's B and x rows (and a row job's C tile) come
//   by 16-byte cp.async into a two-stage ring, issued right after the
//   step's one barrier, so that the next step loads while this one
//   computes; ragged rows and columns are zero-filled, and an operand
//   whose base or strides are not 16-byte aligned takes a plain copy (the
//   slow path).
// - Work: a unit is one (batch, head or head pair, chunk). Its jobs are
//   its 64-row tiles of y_diag (tile r walks keys [0, 64 (r + 1)): it
//   holds its C rows, and for each key step forms S = C B^T, scales it by
//   the masked decay and adds S x) and its 64-row tiles of the state (each
//   walks every key: (B w)^T x with w = exp(cs_{Q-1} - cs_j)). 4 warps a
//   block, 16 rows a warp; a warp skips a key step that lies wholly above
//   its rows. The grid is (units, jobs): blockIdx.y < ceil(Q / 64) is
//   that row tile, the rest are the state tiles in order. Three blocks an
//   SM (72 KB of shared memory at the main shape, registers capped at
//   170): more warps to hide each warp's latencies, which bound the
//   kernel, than 32-key steps at two blocks.
// - Same bits every run and at every batch: no atomics, no sum split
//   across blocks. Each output is summed by one warp, key steps and k8
//   steps ascending, and the jobs depend on (Q, N) only, never on B or H;
//   pairing heads changes no output's order of summation.
//
// Why not wgmma: it reads tf32 operands only K-major from shared memory,
// so each f32 operand needs hi and lo planes there. C B^T on wgmma
// (m64n16k8, 3 passes from swizzled planes) took longer than on mma.sync
// in this kernel's 16-key steps, and wider steps do not leave room for two
// blocks an SM. Why CUDA C++ and not Triton: Triton's tl.dot on f32 takes
// tf32 or "tf32x3" but chooses its own fragment layouts, so the S fragment
// would go through shared memory between the two products, and the jobs,
// the head pairs and the per-warp causal skips are plain control flow
// here.

#include <math_constants.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

using repro::to_f32;

constexpr int THREADS = 128;      // 4 warps; warp w owns rows 16 w .. 16 w + 15 of a tile
constexpr int RT = 64;            // rows of a tile: query rows (y_diag) or state rows (N)
constexpr int KT = 16;            // keys a pipeline stage
constexpr int NSTAGES = 2;        // stages in the cp.async ring
constexpr int MAX_SMEM = 232448;  // 227 KB, the most a block may ask for

struct Args {
  const float* a;
  float* y;
  float* states;
  int L, H, G, P, N, Q, nc, vec;
  long long xb, xl, xh, ab, al, ah, bb, bl, bg, cb, cl, cg;
};

// The row tiles of a unit's y_diag, then its state tiles: the grid's jobs.
__host__ __device__ constexpr int row_tiles(int Q) { return (Q + RT - 1) / RT; }

// Row length (elements of T) of a shared tile of `cols` columns: whole
// 16-byte chunks, and `rem` (mod 32) 32-bit words.
template <typename T>
__host__ __device__ constexpr int tile_ld(int cols, int rem) {
  constexpr int per_word = 4 / sizeof(T);
  int words = ((cols + per_word - 1) / per_word + 3) / 4 * 4;
  words += ((rem - words % 32) % 32 + 32) % 32;
  return words * per_word;
}

// The columns of P a warp holds, 8 PJ: the kernel instance for P.
__host__ __device__ constexpr int p_width(int P) { return P <= 32 ? 32 : P <= 64 ? 64 : 128; }

// Tile geometry: rows of Q rounded up to RT for the running sums, and the
// row strides of the C tile, of the B tiles and of the x tiles.
struct Layout {
  int n8, pw;          // the staged columns: N rounded up to 8, x's 8 PJ
  int ldc, ldb, lds, ldx;  // row strides (elements): C and B for a row job, B for a state job, x
  int qp, c_elems, b_elems, x_elems;
};

template <typename T>
__host__ __device__ Layout make_layout(int Q, int N, int P) {
  constexpr bool F32 = sizeof(T) == 4;
  Layout l;
  l.n8 = (N + 7) / 8 * 8;
  l.pw = p_width(P);
  // f32: float2 pairs for C and B (8 mod 32), words at rows 2t for x and
  // a state job's B (4 mod 32); bf16: every read is a word or a bf16 pair
  // of one word, at 4 (mod 32) for all
  l.ldc = tile_ld<T>(l.n8, F32 ? 8 : 4);
  l.ldb = l.ldc;
  l.lds = tile_ld<T>(RT, 4);
  l.ldx = tile_ld<T>(l.pw, 4);
  l.qp = (Q + RT - 1) / RT * RT;
  l.c_elems = RT * l.ldc;
  l.b_elems = KT * (l.ldb > l.lds ? l.ldb : l.lds);
  l.x_elems = KT * l.ldx;
  return l;
}

// A block serves HS heads of one group: HS running sums, a row job's C
// tile, then the ring (a stage: one B tile, HS x tiles).
template <typename T, int HS>
__host__ __device__ int smem_bytes(const Layout& l) {
  return HS * l.qp * 4 + (l.c_elems + NSTAGES * (l.b_elems + HS * l.x_elems)) * (int)sizeof(T);
}

// cs + hh qp, [0, Q) = the running sum of head hh's a over the chunk, for
// the HS heads of a block (head hh's a at a + hh ah, stride al), 0 in
// [Q, qp): every thread loads a share of each head's a (the loads in
// flight together), then warp hh scans head hh's: each lane sums a
// segment serially, then the lanes scan their segment totals. Called by
// every thread of the block; ends in a barrier.
template <int HS>
__device__ __forceinline__ void chunk_cumsum(float* cs, int qp, const float* a, long long ah,
                                             long long al, int Q) {
#pragma unroll
  for (int hh = 0; hh < HS; ++hh)
    for (int i = threadIdx.x; i < qp; i += THREADS)
      cs[hh * qp + i] = i < Q ? a[hh * ah + i * al] : 0.f;
  __syncthreads();
  const int hh = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (hh < HS) {
    float* c = cs + hh * qp;
    const int seg = (Q + 31) / 32;
    const int lo = min(Q, lane * seg), hi = min(Q, lo + seg);
    float run = 0.f;
    for (int i = lo; i < hi; ++i) {
      run += c[i];
      c[i] = run;
    }
    float incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.f;
    for (int i = lo; i < hi; ++i) c[i] += excl;
  }
  __syncthreads();
}

// Rows [r0, r0 + ROWS) x columns [c0, c0 + cols) of a (Q, ncols) slice
// (row stride ld) into a shared tile (row stride lds); cells past row Q or
// column ncols are 0. vec: 16-byte cp.async (the caller commits the
// group); otherwise a plain copy. cols is a multiple of 16 bytes.
template <typename T, int ROWS>
__device__ __forceinline__ void stage(T* tile, int lds, const T* __restrict__ src, long long ld,
                                      int r0, int Q, int c0, int cols, int ncols, bool vec) {
  constexpr int E = 16 / sizeof(T);
  const int cpr = cols / E;
  for (int idx = threadIdx.x; idx < ROWS * cpr; idx += THREADS) {
    const int r = idx / cpr, c = (idx - r * cpr) * E, gr = r0 + r, gc = c0 + c;
    const int valid = gr < Q ? min(E, max(0, ncols - gc)) : 0;
    T* dst = tile + r * lds + c;
    const T* from = src + (long long)gr * ld + gc;
    if (vec) {
      repro::cp_async16(dst, valid > 0 ? from : src, valid * (int)sizeof(T));
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) dst[e] = e < valid ? from[e] : repro::from_f32<T>(0.f);
    }
  }
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// An operand value as tf32 parts: f32 splits into hi + lo; a bf16 value
// (EXACT) is its own hi.
template <bool EXACT>
__device__ __forceinline__ void parts(float v, uint32_t& hi, uint32_t& lo) {
  if constexpr (EXACT) hi = __float_as_uint(v);
  else repro::split_tf32(v, hi, lo);
}

// For each of the NJ accumulator tiles j: big[j] += a b[j], lohi[j] += a_lo
// b_hi and hilo[j] += a_hi b_lo, the cross terms that split operands add
// (small first, so that the big term lands last, where the accumulators
// are one); a side that is EXACT has no lo. Pass by pass over the tiles,
// so that neighbouring mma steps are independent; each accumulator still
// sums in the same order. No branch inside: a predicated mma.sync costs a
// warp sync, and a branch stops ptxas from hoisting the next loads.
template <bool A_EXACT, bool B_EXACT, int NJ>
__device__ __forceinline__ void mma3(float (&big)[NJ][4], float (&lohi)[NJ][4],
                                     float (&hilo)[NJ][4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[NJ][2],
                                     const uint32_t (&bl)[NJ][2]) {
  if constexpr (!A_EXACT) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) repro::mma_tf32(lohi[j], al, bh[j][0], bh[j][1]);
  }
  if constexpr (!B_EXACT) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) repro::mma_tf32(hilo[j], ah, bl[j][0], bl[j][1]);
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) repro::mma_tf32(big[j], ah, bh[j][0], bh[j][1]);
}

// acc (16 rows x 8 PJ columns of the warp) += A X over the KT keys of a
// stage, A given by `a_of(j, v)`: the 4 values of the warp's A fragment
// for keys 8 j .. 8 j + 7 (permuted: k = t is key 2t, k = t + 4 key
// 2t + 1), f32 in any case, so split; x from the stage's rows 8 j + 2t and
// 8 j + 2t + 1. Every key and column of the stage is summed: A is 0 for a
// masked key or one past Q, x is 0 past Q and P, and the columns past
// the stage's are never stored (each output column reads its own x
// column only).
template <typename T, int PJ, typename AOf>
__device__ __forceinline__ void times_x(float (&acc)[PJ][4], const T* Xs, int ldx, int g, int t,
                                        AOf a_of) {
  constexpr bool EXACT = sizeof(T) == 2;
#pragma unroll
  for (int j = 0; j < KT / 8; ++j) {
    float v[4];
    a_of(j, v);
    uint32_t ah[4], al[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) repro::split_tf32(v[e], ah[e], al[e]);
    const T* x0 = Xs + (8 * j + 2 * t) * ldx + g;
    const T* x1 = x0 + ldx;
    uint32_t xh[PJ][2], xl[PJ][2];
#pragma unroll
    for (int pj = 0; pj < PJ; ++pj) {
      parts<EXACT>(to_f32(x0[8 * pj]), xh[pj][0], xl[pj][0]);
      parts<EXACT>(to_f32(x1[8 * pj]), xh[pj][1], xl[pj][1]);
    }
    mma3<false, EXACT, PJ>(acc, acc, acc, ah, al, xh, xl);
  }
}

// PJ: 8-column tiles of P a warp holds (P <= 8 PJ); HS: heads a block
// serves, of one group.
template <typename T, int PJ, int HS>
__global__ void __launch_bounds__(THREADS, 3)
ssd_chunk_kernel(const T* __restrict__ X, const T* __restrict__ Bm, const T* __restrict__ Cm,
                 Args args) {
  constexpr bool EXACT = sizeof(T) == 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Q = args.Q, N = args.N, P = args.P, H = args.H;
  const Layout lay = make_layout<T>(Q, N, P);
  float* cs = reinterpret_cast<float*>(smem_raw);  // head hh's at cs + hh qp
  T* Cs = reinterpret_cast<T*>(cs + HS * lay.qp);
  T* ring = Cs + lay.c_elems;  // stage s: B rows, then each head's x rows
  const int stage_elems = lay.b_elems + HS * lay.x_elems;

  // a unit: heads h0 .. h0 + HS - 1 (one group) of one chunk of one batch
  // element; a job: r >= 0, y_diag rows [64 r, 64 r + 64), or ~t, state
  // rows [64 t, 64 t + 64)
  const int nrow = row_tiles(Q), unit = blockIdx.x;
  const int job = (int)blockIdx.y < nrow ? (int)blockIdx.y : ~((int)blockIdx.y - nrow);
  const int chunk = unit % args.nc, bhs = unit / args.nc;
  const int b = bhs / (H / HS), h0 = bhs % (H / HS) * HS;
  const int grp = h0 / (H / args.G);
  const long long t0 = (long long)chunk * Q;
  const T* x = X + b * args.xb + h0 * args.xh + t0 * args.xl;  // head h0 + hh: + hh xh
  const T* bm = Bm + b * args.bb + grp * args.bg + t0 * args.bl;
  const T* cm = Cm + b * args.cb + grp * args.cg + t0 * args.cl;
  const bool rows_job = job >= 0;
  const int tile = rows_job ? job : ~job;
  const int kend = rows_job ? min(RT * (tile + 1), Q) : Q;
  const int nsteps = (kend + KT - 1) / KT;
  const int ldb = rows_job ? lay.ldb : lay.lds;
  const bool vec = args.vec;

  auto issue = [&](int s) {  // key step s into its stage
    T* Bs = ring + (s % NSTAGES) * stage_elems;
    const int k0 = s * KT;
    if (rows_job) stage<T, KT>(Bs, ldb, bm, args.bl, k0, Q, 0, lay.n8, N, vec);
    else stage<T, KT>(Bs, ldb, bm, args.bl, k0, Q, RT * tile, RT, N, vec);
#pragma unroll
    for (int hh = 0; hh < HS; ++hh)
      stage<T, KT>(Bs + lay.b_elems + hh * lay.x_elems, lay.ldx, x + hh * args.xh, args.xl, k0,
                   Q, 0, lay.pw, P, vec);
  };
  if (rows_job) stage<T, RT>(Cs, lay.ldc, cm, args.cl, RT * tile, Q, 0, lay.n8, N, vec);
#pragma unroll
  for (int s = 0; s < NSTAGES - 1; ++s) {  // the C tile goes with step 0
    if (s < nsteps) issue(s);
    repro::cp_async_commit();
  }

  chunk_cumsum<HS>(cs, lay.qp, args.a + b * args.ab + h0 * args.ah + t0 * args.al, args.ah,
                   args.al, Q);
  if (!rows_job) {  // a state job needs only w_j = exp(cs_{Q-1} - cs_j), 0 past Q
    float last[HS];
#pragma unroll
    for (int hh = 0; hh < HS; ++hh) last[hh] = cs[hh * lay.qp + Q - 1];
    __syncthreads();
#pragma unroll
    for (int hh = 0; hh < HS; ++hh)
      for (int i = threadIdx.x; i < Q; i += THREADS)
        cs[hh * lay.qp + i] = expf(last[hh] - cs[hh * lay.qp + i]);
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = RT * tile + 16 * warp;  // the warp's first row (query or state)
  float acc[HS][PJ][4];
#pragma unroll
  for (int hh = 0; hh < HS; ++hh)
#pragma unroll
    for (int pj = 0; pj < PJ; ++pj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[hh][pj][e] = 0.f;

  for (int s = 0; s < nsteps; ++s) {
    // step s's group has landed, and every warp is done with step s - 1,
    // whose stage step s + NSTAGES - 1 now loads into
    repro::cp_async_wait<NSTAGES - 2>();
    __syncthreads();
    if (s + NSTAGES - 1 < nsteps) issue(s + NSTAGES - 1);
    repro::cp_async_commit();
    const T* Bs = ring + (s % NSTAGES) * stage_elems;
    const T* Xs = Bs + lay.b_elems;  // head hh's: + hh x_elems
    const int k0 = s * KT;
    if (rows_job) {
      // the warp's rows [r0, r0 + 16) against keys [k0, k0 + KT): a step
      // past its last row (or a warp past Q) is all masked
      if (r0 < Q && k0 <= min(r0 + 15, Q - 1)) {
        float sb[KT / 8][4], sl[KT / 8][4], sr[KT / 8][4];  // S = C B^T: big, lo hi, hi lo
#pragma unroll
        for (int j = 0; j < KT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sb[j][e] = sl[j][e] = sr[j][e] = 0.f;
        const T* c0 = Cs + (16 * warp + g) * lay.ldc + 2 * t;
        const T* c1 = c0 + 8 * lay.ldc;
        const T* b0 = Bs + g * ldb + 2 * t;
#pragma unroll 2
        for (int kk = 0; kk < lay.n8; kk += 8) {
          const float2 u = load2(c0 + kk), v = load2(c1 + kk);
          const float cv[4] = {u.x, v.x, u.y, v.y};
          uint32_t ah[4], al[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) parts<EXACT>(cv[e], ah[e], al[e]);
          uint32_t bh[KT / 8][2], bl[KT / 8][2];
#pragma unroll
          for (int j = 0; j < KT / 8; ++j) {
            const float2 w = load2(b0 + 8 * j * ldb + kk);
            parts<EXACT>(w.x, bh[j][0], bl[j][0]);
            parts<EXACT>(w.y, bh[j][1], bl[j][1]);
          }
          mma3<EXACT, EXACT, KT / 8>(sb, sl, sr, ah, al, bh, bl);
        }
#pragma unroll
        for (int j = 0; j < KT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sb[j][e] += sl[j][e] + sr[j][e];
        // each head: its decay, masked in log space before the exp, then S x
        const int i0 = r0 + g, i1 = i0 + 8;
#pragma unroll
        for (int hh = 0; hh < HS; ++hh) {
          const float* c = cs + hh * lay.qp;
          const float cs0 = c[i0], cs1 = c[i1];
          float sh[KT / 8][4];
#pragma unroll
          for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = e < 2 ? i0 : i1, kj = k0 + 8 * j + 2 * t + (e & 1);
              const float arg = i < Q && kj <= i ? (e < 2 ? cs0 : cs1) - c[kj] : -CUDART_INF_F;
              sh[j][e] = sb[j][e] * expf(arg);
            }
          }
          times_x<T, PJ>(acc[hh], Xs + hh * lay.x_elems, lay.ldx, g, t,
                         [&](int j, float (&v)[4]) {
                           v[0] = sh[j][0];  // (g, key 2t)
                           v[1] = sh[j][2];  // (g + 8, key 2t)
                           v[2] = sh[j][1];  // (g, key 2t + 1)
                           v[3] = sh[j][3];  // (g + 8, key 2t + 1)
                         });
        }
      }
    } else if (r0 < N) {
      // state rows [r0, r0 + 16) (columns 16 warp.. of the staged B) over
      // keys [k0, k0 + KT): A = (B w)^T, read transposed
      const T* bt = Bs + 2 * t * ldb + 16 * warp + g;
#pragma unroll
      for (int hh = 0; hh < HS; ++hh) {
        const float* w = cs + hh * lay.qp + k0 + 2 * t;
        times_x<T, PJ>(acc[hh], Xs + hh * lay.x_elems, lay.ldx, g, t,
                       [&](int j, float (&v)[4]) {
                         const T* p = bt + 8 * j * ldb;
                         const float w0 = w[8 * j], w1 = w[8 * j + 1];
                         v[0] = to_f32(p[0]) * w0;        // (n g, key 2t)
                         v[1] = to_f32(p[8]) * w0;        // (n g + 8, key 2t)
                         v[2] = to_f32(p[ldb]) * w1;      // (n g, key 2t + 1)
                         v[3] = to_f32(p[ldb + 8]) * w1;  // (n g + 8, key 2t + 1)
                       });
      }
    }
  }
  repro::cp_async_wait<0>();

  // flush: lane (g, t) holds rows r0 + g and r0 + g + 8, columns 8 pj + 2t, + 1
#pragma unroll
  for (int hh = 0; hh < HS; ++hh) {
    const int h = h0 + hh;
    float* out;
    long long row_stride;
    int nrows;
    if (rows_job) {
      out = args.y + (((long long)b * args.L + t0) * H + h) * P;
      row_stride = (long long)H * P;
      nrows = Q;
    } else {
      out = args.states + (((long long)b * H + h) * args.nc + chunk) * N * P;
      row_stride = P;
      nrows = N;
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + g + 8 * half;
      if (r >= nrows) continue;
      float* o = out + r * row_stride;
#pragma unroll
      for (int pj = 0; pj < PJ; ++pj) {
        const int p = 8 * pj + 2 * t;
        if (p >= P) break;
        const float v0 = acc[hh][pj][2 * half], v1 = acc[hh][pj][2 * half + 1];
        if (P % 2 == 0) {
          *reinterpret_cast<float2*>(o + p) = make_float2(v0, v1);
        } else {
          o[p] = v0;
          if (p + 1 < P) o[p + 1] = v1;
        }
      }
    }
  }
}

template <typename T, int PJ, int HS>
cudaError_t launch(const void* x, const void* b, const void* c, const Args& args, int units,
                   cudaStream_t s) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_chunk_kernel<T, PJ, HS>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (attr != cudaSuccess) return attr;
  const int smem = smem_bytes<T, HS>(make_layout<T>(args.Q, args.N, args.P));
  if (smem > MAX_SMEM) return cudaErrorInvalidConfiguration;
  const dim3 grid(units / HS, row_tiles(args.Q) + (args.N + RT - 1) / RT);
  ssd_chunk_kernel<T, PJ, HS><<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(b), static_cast<const T*>(c), args);
  return cudaGetLastError();
}

// Heads in pairs where a group's heads pair up and x is at most 64 wide
// (two heads' accumulators fit the registers), else one by one.
template <typename T>
cudaError_t launch_p(const void* x, const void* b, const void* c, const Args& args, int units,
                     cudaStream_t s) {
  const bool pairs = args.H / args.G % 2 == 0;
  switch (p_width(args.P)) {
    case 32:
      return pairs ? launch<T, 4, 2>(x, b, c, args, units, s)
                   : launch<T, 4, 1>(x, b, c, args, units, s);
    case 64:
      return pairs ? launch<T, 8, 2>(x, b, c, args, units, s)
                   : launch<T, 8, 1>(x, b, c, args, units, s);
    default: return launch<T, 16, 1>(x, b, c, args, units, s);
  }
}

}  // namespace

// x, b, c: float (bf16 == 0) or bf16; a float. Strides are in elements.
// vec: x, b and c have 16-byte aligned bases and strides. P <= 128,
// N <= 256 and Q <= 2048 are checked by the wrapper.
extern "C" int repro_ssd_intra_chunk(const void* x, const float* a, const void* b, const void* c,
                                     float* y, float* states, int B, int L, int H, int G, int P,
                                     int N, int Q, long long xb, long long xl, long long xh,
                                     long long ab, long long al, long long ah, long long bb,
                                     long long bl, long long bg, long long cb, long long cl,
                                     long long cg, int vec, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || H == 0 || L == 0) return static_cast<int>(cudaGetLastError());
  Args args{a, y, states, L, H, G, P, N, Q, L / Q, vec,
            xb, xl, xh, ab, al, ah, bb, bl, bg, cb, cl, cg};
  const int units = B * H * (L / Q);
  const cudaError_t err = bf16 ? launch_p<__nv_bfloat16>(x, b, c, args, units, s)
                               : launch_p<float>(x, b, c, args, units, s);
  return static_cast<int>(err);
}
