// The cleanup's 128-bit row signature: the lane constants and the mix of one
// 32-bit half-word, shared by row_signature.cu (K2, the signature of stored
// rows), pair_products.cu (K4, the signature of product rows that are never
// stored), rotation_rows.cu (K6), project_rows.cu (K7) and merge_small.cu's
// fused route (a small cleanup's or product's slots), so all compute the
// bits of torch_core.row_signature from one source.
//
// Half-word j of a row (x's words, then z's, each word low half first) adds
// mix(h_j, position(j, l), l) to lane l, modulo 2^32; ka = (lane_0 ^ 2^31)
// << 32 | lane_1 and kb = (lane_2 ^ 2^31) << 32 | lane_3 (signature_keys).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t lane_mult(int l) {
  return l == 0 ? 0x1E3779B1u : l == 1 ? 0x045D9F3Bu : l == 2 ? 0x2C1B3C6Du : 0x297A2D39u;
}

__device__ __forceinline__ uint32_t lane_init(int l) {
  return l == 0 ? 0x811C9DC5u : l == 1 ? 0xDEADBEEFu : l == 2 ? 0x1B873593u : 0x165667B1u;
}

// the position constant of half-word j in lane l
__device__ __forceinline__ uint32_t position(uint32_t j, int l) {
  const uint32_t p = (j + lane_init(l)) * 0x9E3779B9u;
  return p ^ (p >> 16);
}

__device__ __forceinline__ uint32_t mix(uint32_t h, uint32_t p, int l) {
  uint32_t v = (h ^ p) * lane_mult(l);
  v = (v ^ (v >> 15)) * 0x7FEB352Du;
  v = (v ^ (v >> 13)) * 0x6C8E9CF5u;
  return v ^ (v >> 16);
}

// the four lanes' position constants of half-word j
__device__ __forceinline__ uint4 positions(uint32_t j) {
  return make_uint4(position(j, 0), position(j, 1), position(j, 2), position(j, 3));
}

// one 64-bit word into the four lane sums: its low half at positions lo, its
// high half at hi
__device__ __forceinline__ void hash_word(uint32_t (&acc)[4], uint64_t w, const uint4& lo,
                                          const uint4& hi) {
  const uint32_t h0 = (uint32_t)w, h1 = (uint32_t)(w >> 32);
  acc[0] += mix(h0, lo.x, 0) + mix(h1, hi.x, 0);
  acc[1] += mix(h0, lo.y, 1) + mix(h1, hi.y, 1);
  acc[2] += mix(h0, lo.z, 2) + mix(h1, hi.z, 2);
  acc[3] += mix(h0, lo.w, 3) + mix(h1, hi.w, 3);
}

// the two int64 sort keys of a row's four lane sums
__device__ __forceinline__ void signature_keys(const uint32_t (&acc)[4], int64_t* ka,
                                               int64_t* kb) {
  *ka = (int64_t)(((uint64_t)(acc[0] ^ 0x80000000u) << 32) | acc[1]);
  *kb = (int64_t)(((uint64_t)(acc[2] ^ 0x80000000u) << 32) | acc[3]);
}

// The blocks of one wave of `kernel` (no dynamic shared memory) on the
// current device, cached per device in `cached` (a card's SMs and occupancy
// do not change): the row kernels' grids stride over the rows, so a lane
// computes its position constants once.
template <typename Kernel>
cudaError_t wave_blocks(Kernel kernel, int threads, int (&cached)[64], int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
    if (err != cudaSuccess) return err;
    cached[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  *blocks = cached[dev];
  return cudaSuccess;
}

// lanes a row for `units` loads of a row: the power of two at or above, at most 32
__host__ __device__ inline int log2_lanes_for(int units) {
  int l = 0;
  while ((1 << l) < units && l < 5) ++l;
  return l;
}

// V consecutive words at p: one 16-byte load where V = 2 (p 16-byte aligned)
template <int V>
__device__ __forceinline__ void load_words(const int64_t* __restrict__ p, uint64_t (&w)[V]) {
  if constexpr (V == 2) {
    const longlong2 v = __ldg(reinterpret_cast<const longlong2*>(p));
    w[0] = (uint64_t)v.x;
    w[1] = (uint64_t)v.y;
  } else {
    w[0] = (uint64_t)__ldg(p);
  }
}

// The position constants of words q0 .. q0 + V - 1 of a row of W words: x's
// low and high halves in px[e][0], px[e][1], z's in pz[e][0], pz[e][1].
template <int V>
__device__ __forceinline__ void word_positions(int q0, int W, uint4 (&px)[V][2],
                                               uint4 (&pz)[V][2]) {
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const uint32_t jx = 2u * (uint32_t)(q0 + e), jz = 2u * (uint32_t)(W + q0 + e);
    px[e][0] = positions(jx);
    px[e][1] = positions(jx + 1);
    pz[e][0] = positions(jz);
    pz[e][1] = positions(jz + 1);
  }
}

// a group of L = 1 << log2_lanes lanes adds its values with xor shuffles
__device__ __forceinline__ uint32_t group_sum(uint32_t v, int log2_lanes) {
  for (int o = (1 << log2_lanes) >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace
