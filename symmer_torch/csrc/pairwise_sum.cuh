// Pairwise sums of float64 values across a block of 256 threads, in the
// order of kernels/torch_lanczos.py:pairwise_sum: the tree of adjacent pairs
// over the index, ((x0 + x1) + (x2 + x3)) + ...  Every add is an explicit
// round-to-nearest intrinsic, so a kernel that adds its values this way is
// bit for bit the plain version's pairwise_sum.  Shared by
// csrc/lanczos_step.cu, csrc/pauli_overlaps.cu and csrc/vqe_rotate.cu.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace symmer_pairwise {

constexpr int kThreads = 256;  // threads of a block that sums
constexpr int kWarps = kThreads / 32;

// the pairwise sum of p[0 .. K), K a power of two, streamed with a stack of
// partial sums (one per tree level)
__device__ __forceinline__ double seq_pairwise(const double* p, int64_t K) {
  double stack[40];
  for (int64_t i = 0; i < K; ++i) {
    double v = p[i];
    int lvl = 0;
    while ((i >> lvl) & 1) {
      v = __dadd_rn(stack[lvl], v);
      ++lvl;
    }
    stack[lvl] = v;
  }
  int top = 0;
  while ((int64_t(1) << top) < K) ++top;
  return stack[top];
}

// every thread receives the pairwise sum of the values of threads
// 0 .. active - 1 (active a power of two up to kThreads); sh: kWarps doubles
__device__ __forceinline__ double block_pairwise(double v, int active, double* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int width = active < 32 ? active : 32;
  for (int m = 1; m < width; m <<= 1) v = __dadd_rn(v, __shfl_xor_sync(0xffffffffu, v, m));
  const int nw = active > 32 ? active >> 5 : 1;
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  double s[kWarps];
  for (int i = 0; i < nw; ++i) s[i] = sh[i];
  for (int h = 1; h < nw; h <<= 1)
    for (int i = 0; i < nw; i += 2 * h) s[i] = __dadd_rn(s[i], s[i + h]);
  const double r = s[0];
  __syncthreads();  // sh is free again
  return r;
}

// the pairwise sum of the P chunk sums part[0 .. P) (P a power of two), in
// every thread of the block
__device__ __forceinline__ double total_pairwise(const double* part, int64_t P, double* sh) {
  double v = 0.0;
  int active;
  if (P > kThreads) {
    const int64_t K = P / kThreads;
    v = seq_pairwise(part + threadIdx.x * K, K);
    active = kThreads;
  } else {
    active = (int)P;
    if (threadIdx.x < P) v = part[threadIdx.x];
  }
  return block_pairwise(v, active, sh);
}

// ph (re + i im) as (re, im): (phr re - phi im, phr im + phi re), the
// order of kernels/torch_vqe.py:_times_ph
__device__ __forceinline__ double2 times_phase(double re, double im, double2 ph) {
  return make_double2(__dsub_rn(__dmul_rn(re, ph.x), __dmul_rn(im, ph.y)),
                      __dadd_rn(__dmul_rn(im, ph.x), __dmul_rn(re, ph.y)));
}

}  // namespace symmer_pairwise
