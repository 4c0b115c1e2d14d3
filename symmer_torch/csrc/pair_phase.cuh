// The coefficient of one product pair of Pauli rows, shared by
// pair_products.cu (K4, every pair of a product) and merge_small.cu (the
// fused route, the pairs of a small product signed in K3's one block), so
// both compute the bits of torch_core.pair_products from one source.
//
// For operand 1's row (x1, z1) with coefficient a + i b and operand 2's row
// (x2, z2) with c + i d, the product's coefficient is
// (a + i b)(c + i d) (-1)^popc(x1 & z2) i^(3 (y1 + y2) + y_out), y =
// popc(x & z) summed over a row's words: pair_word adds one word's share of
// the power of i (mod 2^32: only its value mod 4 is used) and of the sign's
// popcount, pair_coefficient applies them.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// one word of the two rows (x1, z1 = a, b; x2, z2 = c, d) into the power of
// i and the sign's popcount
__device__ __forceinline__ void pair_word(uint64_t a, uint64_t b, uint64_t c, uint64_t d,
                                          uint32_t& ipow, uint32_t& par) {
  const uint64_t xo = a ^ c, zo = b ^ d;
  ipow += 3u * (uint32_t)(__popcll(a & b) + __popcll(c & d)) + (uint32_t)__popcll(xo & zo);
  par += (uint32_t)__popcll(a & d);
}

// (a + i b)(c + i d) times the sign and the power of i, bit for bit the
// plain version: each product and the sum or difference rounded apart
// (__dmul_rn, __dadd_rn: no contraction into an FMA), the sign a negation
// and the power of i apply_i_pow's table of swaps and negations
__device__ __forceinline__ double2 pair_coefficient(double a, double b, double c, double d,
                                                    uint32_t ipow, uint32_t par) {
  double re = __dsub_rn(__dmul_rn(a, c), __dmul_rn(b, d));
  double im = __dadd_rn(__dmul_rn(a, d), __dmul_rn(b, c));
  if (par & 1u) {  // the sign: a product by -1.0 is a negation
    re = -re;
    im = -im;
  }
  switch (ipow & 3u) {  // times i^k: apply_i_pow's table
    case 0: return make_double2(re, im);
    case 1: return make_double2(-im, re);
    case 2: return make_double2(-re, -im);
    default: return make_double2(im, -re);
  }
}

}  // namespace
