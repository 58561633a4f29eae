// Cycles an mma.sync step takes on one SM sub-partition of the card: one
// block an SM (132 blocks), W warps a block, each warp issuing `iters`
// rounds of NACC steps on NACC independent accumulators (NACC = 1: each
// step waits for the last, which gives the latency). The tf32 m16n8k8 and
// bf16 m16n8k16 steps of kernels/csrc/mma.cuh, timed by clock64().
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -I src/repro_torch/kernels/csrc -o build/mma_rate experiments/mma_rate.cu
//   build/mma_rate
#include <cstdint>
#include <cstdio>

#include <cuda_runtime.h>

#include "mma.cuh"

template <int KIND, int NACC>
__global__ void steps(float* out, long long* cycles, int iters) {
  float acc[NACC][4] = {};
  const uint32_t a[4] = {threadIdx.x, 2u, 3u, 4u};
  const uint32_t b0 = 0x3f800000u ^ threadIdx.x, b1 = 0x3f800000u;
  __syncthreads();
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < NACC; ++j) {
      if (KIND == 0) repro::mma_tf32(acc[j], a, b0, b1);
      else repro::mma_bf16(acc[j], a, b0, b1);
    }
  }
  __syncthreads();
  const long long t1 = clock64();
  float s = 0.f;
  for (int j = 0; j < NACC; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;  // keeps the steps
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}

template <int KIND, int NACC>
void run(int warps, float* out, long long* cycles) {
  const int iters = 2000, blocks = 132;
  steps<KIND, NACC><<<blocks, warps * 32>>>(out, cycles, iters);
  cudaDeviceSynchronize();
  long long h[blocks];
  cudaMemcpy(h, cycles, sizeof(h), cudaMemcpyDeviceToHost);
  double c = 0;
  for (int i = 0; i < blocks; ++i) c += h[i];
  c /= blocks;
  const double per_subpartition = (double)iters * NACC * warps / 4;
  printf("%s accumulators %d, warps an SM %2d: %.2f cycles a step a sub-partition\n",
         KIND == 0 ? "tf32 m16n8k8 " : "bf16 m16n8k16", NACC, warps, c / per_subpartition);
}

int main() {
  float* out;
  long long* cycles;
  cudaMalloc(&out, 132 * 1024 * sizeof(float));
  cudaMalloc(&cycles, 132 * sizeof(long long));
  for (int w : {4, 8, 16}) {
    run<0, 8>(w, out, cycles);
    run<0, 1>(w, out, cycles);
    run<1, 8>(w, out, cycles);
  }
  const cudaError_t err = cudaGetLastError();
  printf("%s\n", cudaGetErrorString(err));
  return err == cudaSuccess ? 0 : 1;
}
