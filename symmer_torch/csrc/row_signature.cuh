// The cleanup's 128-bit row signature: the lane constants and the mix of one
// 32-bit half-word, shared by row_signature.cu (K2, the signature of stored
// rows) and pair_products.cu (K4, the signature of product rows that are
// never stored), so both compute the bits of torch_core.row_signature from
// one source.
//
// Half-word j of a row (x's words, then z's, each word low half first) adds
// mix(h_j, position(j, l), l) to lane l, modulo 2^32; ka = (lane_0 ^ 2^31)
// << 32 | lane_1 and kb = (lane_2 ^ 2^31) << 32 | lane_3 (signature_keys).
#pragma once

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

// the two int64 sort keys of a row's four lane sums
__device__ __forceinline__ void signature_keys(const uint32_t (&acc)[4], int64_t* ka,
                                               int64_t* kb) {
  *ka = (int64_t)(((uint64_t)(acc[0] ^ 0x80000000u) << 32) | acc[1]);
  *kb = (int64_t)(((uint64_t)(acc[2] ^ 0x80000000u) << 32) | acc[3]);
}

}  // namespace
