// What the cleanup's merge (K3) shares between its two routes: the survival
// rule of a group's sum (group_survives) and the row sources, where a
// survivor's row comes from.  merge_groups.cu's pass B and merge_small.cu
// (the one-block route) test each group with group_survives and copy each
// survivor's row with copy_row.
//
// A row source of T rows (source: kPlanes, kPairs, kRotation, kMasked):
//   - planes: x, z: int64[T, W], row r = x[r] (x2 = z2 = null);
//   - pairs: a product's operands x1, z1: int64[M1, W] (x, z) and x2, z2:
//     int64[M2, W], M1 M2 = T, row r = x1[r / M2] ^ x2[r % M2] (K4's rows,
//     pair_products.cu);
//   - rotation: x, z: int64[M2, W], M2 = T / 2, and Q's xr, zr: int64[W]
//     (x2, z2), row r = x[r mod M2] ^ (r >= M2 ? xr : 0) (K6's slots,
//     rotation_rows.cu);
//   - masked: x, z: int64[T, W] and col_keep: int64[W] (x2 = z2), row r =
//     x[r] & col_keep (K7's slots, project_rows.cu).
#pragma once

#include <cstdint>

namespace {

// Whether a group whose coefficients sum to (re, im) survives:
// hypot(re, im) > threshold, always without a threshold.
__device__ __forceinline__ bool group_survives(double re, double im, int has_threshold,
                                               double threshold) {
  return !has_threshold || hypot(re, im) > threshold;
}

constexpr int kPlanes = 0, kPairs = 1, kRotation = 2, kMasked = 3;

struct RowSource {
  int kind;
  int W;
  int64_t M2;  // pairs: operand 2's rows; rotation: the input rows (T / 2)
  const int64_t* x;
  const int64_t* z;
  const int64_t* x2;
  const int64_t* z2;
};

// log2 of the lanes that copy one row, a word of x and of z a lane: the
// power of two at or above W, at most 32.
__host__ __device__ inline int row_lanes_log2(int64_t W) {
  int log2_lanes = 0;
  while ((1 << log2_lanes) < W && log2_lanes < 5) ++log2_lanes;
  return log2_lanes;
}

// Where row `row` of the source lies: its row a of x, z, its row b of x2,
// z2 (pairs), and whether Q multiplies it (rotation's twins).
struct SourcePlace {
  int64_t a, b;
  bool twin;
};

__device__ __forceinline__ SourcePlace source_place(const RowSource& s, int64_t row) {
  SourcePlace at{row, 0, false};
  if (s.kind == kPairs) {
    at.a = row / s.M2;
    at.b = row - at.a * s.M2;
  }
  at.twin = s.kind == kRotation && row >= s.M2;
  if (at.twin) at.a = row - s.M2;
  return at;
}

// Word u of x and of z of the row at `at`.
__device__ __forceinline__ void source_word(const RowSource& s, const SourcePlace& at, int u,
                                            int64_t& xw, int64_t& zw) {
  const int W = s.W;
  xw = __ldg(s.x + at.a * W + u);
  zw = __ldg(s.z + at.a * W + u);
  if (s.kind == kPairs) {
    xw ^= __ldg(s.x2 + at.b * W + u);
    zw ^= __ldg(s.z2 + at.b * W + u);
  } else if (at.twin) {
    xw ^= __ldg(s.x2 + u);
    zw ^= __ldg(s.z2 + u);
  } else if (s.kind == kMasked) {
    xw &= __ldg(s.x2 + u);
    zw &= __ldg(s.z2 + u);
  }
}

// Words first, first + step, ... of row `row` of the source, written to row
// d of ox, oz (int64[*, W]).
__device__ __forceinline__ void copy_row(const RowSource& s, int64_t row, int64_t d, int first,
                                         int step, int64_t* __restrict__ ox,
                                         int64_t* __restrict__ oz) {
  const SourcePlace at = source_place(s, row);
  for (int u = first; u < s.W; u += step) {
    int64_t xw, zw;
    source_word(s, at, u, xw, zw);
    ox[d * s.W + u] = xw;
    oz[d * s.W + u] = zw;
  }
}

}  // namespace
