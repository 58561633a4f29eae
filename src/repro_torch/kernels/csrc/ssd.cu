// SSD (Mamba-2 state-space duality): the intra-chunk work of the chunked
// scan, in one launch.
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
// All arithmetic is f32; x, B and C are float or bf16, a is float.
//
// Layouts: x (B, L, H, P), a (B, L, H), B and C (B, L, G, N) are read in
// place through their (batch, time, head or group) strides, with a
// contiguous last dim: nothing is transposed into (B*H, nc, Q, .) and B
// and C are not repeated for each head of a group, where the JAX wrapper
// copies both. y_diag is written (B, L, H, P) f32, the chunk states
// (B, H, nc, N, P) f32, both contiguous. The inter-chunk recurrence and
// the state -> output term stay in PyTorch, as they stay in XLA.
//
// Grid: (B * H, nc, ceil(Q / 64) + ceil(N / 64)). A block with z below
// ceil(Q / 64) owns 64 rows of y_diag; the rest each own 64 rows of the
// chunk state. Both roles first scan the chunk's a into a shared cumsum.
// An output block holds its 64 C rows and walks the 64-row key tiles at
// or below its last row: S = C B^T, scaled by the masked decay, then
// y += S x. Pallas keeps the whole (Q, Q) score matrix in VMEM; at
// Q = 256 that is 256 KB in f32, more than the 227 KB a block may hold,
// so the rows are tiled instead (~100 KB a block at N = 128, P = 64).
// A ragged Q (the edge tile of a chunk of 200, or a chunk of 2) is masked,
// not padded.
//
// Bound at the main path's shape (mamba2-2.7b prefill, B = 1, L = 512,
// H = 80, P = 64, N = 128, Q = 256, f32): x, y_diag and the states once
// (~27 MB with B, C and a, 8 us at 3.35 TB/s) against ~2.7 GFLOP of
// unmasked products (40 us at 67 TFLOP/s on the FMA units): bound by its
// operations. A first kernel, it runs its products on the FMA units from
// f32 tiles in shared memory (tf32 mma / wgmma and TMA are later work).
//
// Determinism: no atomics, and no sum split across blocks. Each output
// is summed by one thread in a fixed order (key tiles, then rows, in
// ascending order), so a prefill gives the same bits from run to run.

#include <math_constants.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using repro::to_f32;

constexpr int THREADS = 256;      // 16 x 16 threads: tx = tid % 16, ty = tid / 16
constexpr int BR = 64;            // rows of a tile: a thread owns rows ty + 16 i
constexpr int MAX_SMEM = 232448;  // 227 KB, the most a block may ask for

struct Args {
  const float* a;
  float* y;
  float* states;
  int L, H, G, P, N, Q, nc, row_tiles;
  long long xb, xl, xh, ab, al, ah, bb, bl, bg, cb, cl, cg;
};

// cs[0, Q) = the running sum of the chunk's a (stride al), by warp 0: each
// lane sums a segment serially, then the lanes scan their segment totals.
__device__ __forceinline__ void chunk_cumsum(float* cs, const float* a, long long al, int Q) {
  const int lane = threadIdx.x;
  if (lane >= 32) return;
  const int seg = (Q + 31) / 32;
  const int lo = min(Q, lane * seg), hi = min(Q, lo + seg);
  float run = 0.f;
  for (int i = lo; i < hi; ++i) {
    run += a[i * al];
    cs[i] = run;
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
  for (int i = lo; i < hi; ++i) cs[i] += excl;
}

// rows [r0, r0 + BR) of a (Q, cols) slice (row stride ld) into a (BR, ldt)
// f32 tile, columns [c0, c0 + width); rows past Q and columns past `cols`
// are 0. `scale(r)` multiplies row r.
template <typename T, typename F>
__device__ __forceinline__ void load_rows(float* tile, int ldt, const T* __restrict__ src,
                                          long long ld, int r0, int Q, int c0, int width,
                                          int cols, F scale) {
  for (int idx = threadIdx.x; idx < BR * width; idx += THREADS) {
    const int r = idx / width, c = idx % width;
    float v = 0.f;
    if (r0 + r < Q && c0 + c < cols) v = to_f32(src[(long long)(r0 + r) * ld + c0 + c]) * scale(r);
    tile[r * ldt + c] = v;
  }
}

struct One {
  __device__ __forceinline__ float operator()(int) const { return 1.f; }
};

// PJ: the P columns a thread owns, tx + 16 j (P <= 16 * PJ).
template <typename T, int PJ>
__global__ void __launch_bounds__(THREADS, 2)
ssd_chunk_kernel(const T* __restrict__ X, const T* __restrict__ Bm, const T* __restrict__ Cm,
                 Args args) {
  constexpr int PW = 16 * PJ;
  extern __shared__ float smem[];
  const int Q = args.Q, N = args.N, P = args.P, H = args.H;
  const int ldn = N + 1;
  float* cs = smem;                 // (Q)
  float* Bs = cs + Q;               // (BR, N + 1); a state block: (BR, BR)
  float* Xs = Bs + BR * max(ldn, BR);  // (BR, PW)
  float* Cs = Xs + BR * PW;         // (BR, N + 1)
  float* Ss = Cs + BR * ldn;        // (BR, BR + 1)

  const int bh = blockIdx.x, chunk = blockIdx.y, tile = blockIdx.z;
  const int b = bh / H, h = bh % H, g = h / (H / args.G);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long t0 = (long long)chunk * Q;
  const T* x = X + b * args.xb + h * args.xh + t0 * args.xl;
  const T* bm = Bm + b * args.bb + g * args.bg + t0 * args.bl;
  const T* cm = Cm + b * args.cb + g * args.cg + t0 * args.cl;

  chunk_cumsum(cs, args.a + b * args.ab + h * args.ah + t0 * args.al, args.al, Q);
  __syncthreads();

  float acc[4][PJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < PJ; ++j) acc[i][j] = 0.f;

  if (tile < args.row_tiles) {
    // ---- y_diag rows [r0, r0 + BR) of the chunk ----
    const int r0 = tile * BR;
    const int r_end = min(Q, r0 + BR);
    load_rows(Cs, ldn, cm, args.cl, r0, Q, 0, N, N, One());
    for (int k0 = 0; k0 < r_end; k0 += BR) {
      __syncthreads();                // the last tile's readers are done
      load_rows(Bs, ldn, bm, args.bl, k0, Q, 0, N, N, One());
      load_rows(Xs, PW, x, args.xl, k0, Q, 0, PW, P, One());
      __syncthreads();

      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float bb[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) bb[j] = Bs[(tx + 16 * j) * ldn + n];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float cc = Cs[(ty + 16 * i) * ldn + n];
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(cc, bb[j], s[i][j]);
        }
      }
      // the decay, masked in log space before the exp
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = r0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kj = k0 + tx + 16 * j;
          const float arg = (qi < Q && kj <= qi) ? cs[qi] - cs[kj] : -CUDART_INF_F;
          Ss[(ty + 16 * i) * (BR + 1) + tx + 16 * j] = s[i][j] * expf(arg);
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int kk = 0; kk < BR; ++kk) {
        float xv[PJ];
#pragma unroll
        for (int j = 0; j < PJ; ++j) xv[j] = Xs[kk * PW + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float sv = Ss[(ty + 16 * i) * (BR + 1) + kk];
#pragma unroll
          for (int j = 0; j < PJ; ++j) acc[i][j] = fmaf(sv, xv[j], acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = r0 + ty + 16 * i;
      if (qi >= Q) continue;
      float* y = args.y + (((long long)b * args.L + t0 + qi) * H + h) * P;
#pragma unroll
      for (int j = 0; j < PJ; ++j) {
        const int p = tx + 16 * j;
        if (p < P) y[p] = acc[i][j];
      }
    }
  } else {
    // ---- state rows [n0, n0 + BR) of the chunk: sum over all Q steps ----
    const int n0 = (tile - args.row_tiles) * BR;
    const float cs_last = cs[Q - 1];
    for (int k0 = 0; k0 < Q; k0 += BR) {
      __syncthreads();
      load_rows(Bs, BR, bm, args.bl, k0, Q, n0, BR, N,
                [&](int r) { return k0 + r < Q ? expf(cs_last - cs[k0 + r]) : 0.f; });
      load_rows(Xs, PW, x, args.xl, k0, Q, 0, PW, P, One());
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < BR; ++kk) {
        float xv[PJ];
#pragma unroll
        for (int j = 0; j < PJ; ++j) xv[j] = Xs[kk * PW + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float bv = Bs[kk * BR + ty + 16 * i];
#pragma unroll
          for (int j = 0; j < PJ; ++j) acc[i][j] = fmaf(bv, xv[j], acc[i][j]);
        }
      }
    }
    float* st = args.states + ((long long)bh * args.nc + chunk) * N * P;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = n0 + ty + 16 * i;
      if (n >= N) continue;
#pragma unroll
      for (int j = 0; j < PJ; ++j) {
        const int p = tx + 16 * j;
        if (p < P) st[(long long)n * P + p] = acc[i][j];
      }
    }
  }
}

template <typename T, int PJ>
cudaError_t launch(const void* x, const void* b, const void* c, const Args& args, int BH,
                   cudaStream_t s) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_chunk_kernel<T, PJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (attr != cudaSuccess) return attr;
  const int ldn = args.N + 1;
  const int bs_rows = ldn > BR ? ldn : BR;
  const int smem = (args.Q + BR * bs_rows + BR * 16 * PJ + BR * ldn + BR * (BR + 1)) * 4;
  if (smem > MAX_SMEM) return cudaErrorInvalidConfiguration;
  const dim3 grid(BH, args.nc, args.row_tiles + (args.N + BR - 1) / BR);
  ssd_chunk_kernel<T, PJ><<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(b), static_cast<const T*>(c), args);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_p(const void* x, const void* b, const void* c, const Args& args, int BH,
                     cudaStream_t s) {
  return args.P <= 64 ? launch<T, 4>(x, b, c, args, BH, s) : launch<T, 8>(x, b, c, args, BH, s);
}

}  // namespace

// x, b, c: float (bf16 == 0) or bf16; a float. Strides are in elements.
// P <= 128, N <= 256 and Q <= 2048 are checked by the wrapper.
extern "C" int repro_ssd_intra_chunk(const void* x, const float* a, const void* b, const void* c,
                                     float* y, float* states, int B, int L, int H, int G, int P,
                                     int N, int Q, long long xb, long long xl, long long xh,
                                     long long ab, long long al, long long ah, long long bb,
                                     long long bl, long long bg, long long cb, long long cl,
                                     long long cg, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || H == 0 || L == 0) return static_cast<int>(cudaGetLastError());
  const Args args{a, y, states, L, H, G, P, N, Q, L / Q, (Q + BR - 1) / BR,
                  xb, xl, xh, ab, al, ah, bb, bl, bg, cb, cl, cg};
  const cudaError_t err = bf16 ? launch_p<__nv_bfloat16>(x, b, c, args, B * H, s)
                               : launch_p<float>(x, b, c, args, B * H, s);
  return static_cast<int>(err);
}
