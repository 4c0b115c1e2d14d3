// Tensor-core rate probe for Hopper (sm_90a): the binary product against int8.
//
// NVIDIA's data sheet gives no rate for the binary mma
// (mma.sync.m16n8k256.row.col.s32.b1.b1.s32.and.popc) that
// symmer_torch/csrc/anticommutes.cu runs in its square regime.  Each warp
// issues `iters` rounds of kChains independent products on register
// operands, so the tensor pipe's rate is timed with no memory traffic:
// m16n8k256 .b1 against m16n8k32 .s8, the int8 mma.sync.  Built and timed
// by tools/mma_rate.py; no code of the port calls it.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kChains = 8;

__device__ __forceinline__ void mma_b1(int (&c)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads) mma_rate(int binary, int64_t iters,
                                                     int* __restrict__ sink) {
  const unsigned seed = blockIdx.x * kThreads + threadIdx.x;
  const unsigned a[4] = {seed, seed * 3u, seed ^ 0x5555u, ~seed};
  const unsigned b0 = seed * 7u, b1 = ~b0;
  int c[kChains][4] = {};
  for (int64_t it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < kChains; ++k) {
      if (binary) mma_b1(c[k], a, b0, b1);
      else mma_s8(c[k], a, b0, b1);
    }
  }
  int sum = 0;
#pragma unroll
  for (int k = 0; k < kChains; ++k) sum += c[k][0] + c[k][1] + c[k][2] + c[k][3];
  if (sum == 0x7fffffff) sink[0] = sum;  // keeps the products live
}

}  // namespace

extern "C" int mma_rate_launch(int binary, int64_t iters, int64_t blocks, void* sink,
                               void* stream) {
  mma_rate<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      binary, iters, static_cast<int*>(sink));
  return (int)cudaGetLastError();
}
