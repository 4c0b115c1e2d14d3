// The all-pairs product of two Pauli operators (K4), for Hopper (sm_90a):
// each product row's signature and coefficient, without the product rows.
//
// Replaces the product half of symmer_tpu/kernels/jx_core.py:mul_pairs_cleanup
// (:531-559; jx_core.mul_pairs, :171): XLA hashes the XOR broadcast on the
// fly and keeps only the signature lanes and coefficients, and the cleanup
// rebuilds the survivors' rows from their pair index.  For the pair r = i M2
// + j of operand 1's row i (x1, z1: int64[M1, W], cr1, ci1: float64[M1]) and
// operand 2's row j, with xo = x1[i] ^ x2[j] and zo = z1[i] ^ z2[j]:
//
//   ka[r], kb[r]  the row signature of (xo, zo), bit for bit
//                 torch_core.row_signature of the product rows (the lane
//                 constants and the mix: row_signature.cuh, shared with K2);
//   pr[r], pi[r]  (cr1 + i ci1)(cr2 + i ci2) (-1)^popc(x1 & z2)
//                 i^(3 (y1 + y2) + y_out), y = popc(x & z) summed over a
//                 row's words, bit for bit torch_core.pair_products
//                 (pair_phase.cuh, shared with merge_small.cu's fused
//                 route: each product and the sum or difference rounded
//                 apart, the sign and the power of i exact negations and
//                 swaps in the plain version's order).
//
// What bounds it: operations.  The signature costs 11 32-bit integer
// operations a half-word and lane (4 W half-words, 4 lanes a pair), the
// phase two popcounts of 64-bit words a word, against 32 bytes written a
// pair (chip_smoke.py's pair_bound).  The design:
//   - a block of 256 threads takes a tile of ti x tj = 1,024 pairs (four a
//     thread), tj = 32 operand-2 rows (fewer where M2 is smaller, more where
//     M1 is), so a warp's lanes take consecutive pairs of one operand-1 row;
//   - the tile's rows go through shared memory a chunk of words at a time
//     (word-major, so the lanes' reads of their operand-2 words fall in
//     separate banks and an operand-1 word is a broadcast), with the
//     chunk's position constants, computed once a block;
//   - each thread keeps its pairs' four lane sums, the power of i (mod 2^32:
//     only its value mod 4 is used) and the sign's popcount in registers.
// One launch; no atomics, no scratch.  Pair indices are int64.
#include <cuda_runtime.h>

#include <cstdint>

#include "pair_phase.cuh"
#include "row_signature.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPairs = 4;                     // pairs a thread
constexpr int kLog2Tile = 10;                 // a tile of 1,024 pairs
constexpr int kSharedBytes = 32 * 1024;       // a chunk's rows and constants at most

__global__ void __launch_bounds__(kThreads)
pair_products_kernel(const int64_t* __restrict__ x1, const int64_t* __restrict__ z1,
                     const double* __restrict__ cr1, const double* __restrict__ ci1, int64_t M1,
                     const int64_t* __restrict__ x2, const int64_t* __restrict__ z2,
                     const double* __restrict__ cr2, const double* __restrict__ ci2, int64_t M2,
                     int W, int log2_ti, int log2_tj, int qc, int64_t tiles_j,
                     int64_t* __restrict__ ka, int64_t* __restrict__ kb,
                     double* __restrict__ pr, double* __restrict__ pi) {
  extern __shared__ int64_t smem[];
  const int ti = 1 << log2_ti, tj = 1 << log2_tj;
  int64_t* s1x = smem;               // [qc][ti]: operand 1's words of the chunk
  int64_t* s1z = s1x + qc * ti;
  int64_t* s2x = s1z + qc * ti;      // [qc][tj]
  int64_t* s2z = s2x + qc * tj;
  // [qc][4]: the four lanes' position constants of each half-word of the
  // chunk's words: x's low and high half, z's low and high half
  uint4* spos = reinterpret_cast<uint4*>(s2z + qc * tj);
  const int t = threadIdx.x;
  const int64_t tile = blockIdx.x;
  const int64_t i0 = (tile / tiles_j) << log2_ti, j0 = (tile % tiles_j) << log2_tj;
  int ii[kPairs], jj[kPairs];
  bool live[kPairs];
#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    const int p = t + kThreads * k;  // the pair's place in the tile, j fastest
    live[k] = p < ti * tj;
    ii[k] = live[k] ? p >> log2_tj : 0;
    jj[k] = p & (tj - 1);
  }
  uint32_t acc[kPairs][4], ipow[kPairs], par[kPairs];
#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    acc[k][0] = acc[k][1] = acc[k][2] = acc[k][3] = 0u;
    ipow[k] = par[k] = 0u;
  }
  for (int q0 = 0; q0 < W; q0 += qc) {
    const int nq = W - q0 < qc ? W - q0 : qc;
    __syncthreads();  // every thread is done with the last chunk
    for (int e = t; e < ti * nq; e += kThreads) {  // a row's words on neighbouring threads
      const int r = e / nq, q = e - r * nq;
      const int64_t i = i0 + r;
      const bool in = i < M1;
      s1x[q * ti + r] = in ? __ldg(x1 + i * W + q0 + q) : 0;
      s1z[q * ti + r] = in ? __ldg(z1 + i * W + q0 + q) : 0;
    }
    for (int e = t; e < tj * nq; e += kThreads) {
      const int r = e / nq, q = e - r * nq;
      const int64_t j = j0 + r;
      const bool in = j < M2;
      s2x[q * tj + r] = in ? __ldg(x2 + j * W + q0 + q) : 0;
      s2z[q * tj + r] = in ? __ldg(z2 + j * W + q0 + q) : 0;
    }
    for (int e = t; e < 4 * nq; e += kThreads) {
      const int q = e >> 2, h = e & 3;
      const uint32_t j = h < 2 ? 2u * (uint32_t)(q0 + q) + h : 2u * (uint32_t)(W + q0 + q) + h - 2;
      spos[e] = positions(j);
    }
    __syncthreads();
    for (int q = 0; q < nq; ++q) {
      const uint4 xl = spos[4 * q], xh = spos[4 * q + 1], zl = spos[4 * q + 2],
                  zh = spos[4 * q + 3];
#pragma unroll
      for (int k = 0; k < kPairs; ++k) {
        if (!live[k]) continue;
        const uint64_t a = s1x[q * ti + ii[k]], b = s1z[q * ti + ii[k]];
        const uint64_t c = s2x[q * tj + jj[k]], d = s2z[q * tj + jj[k]];
        pair_word(a, b, c, d, ipow[k], par[k]);
        hash_word(acc[k], a ^ c, xl, xh);
        hash_word(acc[k], b ^ d, zl, zh);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    const int64_t i = i0 + ii[k], j = j0 + jj[k];
    if (!live[k] || i >= M1 || j >= M2) continue;
    const double2 p = pair_coefficient(__ldg(cr1 + i), __ldg(ci1 + i), __ldg(cr2 + j),
                                       __ldg(ci2 + j), ipow[k], par[k]);
    const int64_t r = i * M2 + j;
    signature_keys(acc[k], ka + r, kb + r);
    pr[r] = p.x;
    pi[r] = p.y;
  }
}

int ceil_log2(int64_t n, int cap) {
  int l = 0;
  while ((int64_t(1) << l) < n && l < cap) ++l;
  return l;
}

}  // namespace

// x1, z1: int64[M1, W]; cr1, ci1: float64[M1]; x2, z2: int64[M2, W]; cr2,
// ci2: float64[M2] (contiguous, M1, M2 >= 1); ka, kb: int64[M1 M2]; pr, pi:
// float64[M1 M2].  One launch.
extern "C" int symmer_pair_products(const void* x1, const void* z1, const void* cr1,
                                    const void* ci1, int64_t M1, const void* x2, const void* z2,
                                    const void* cr2, const void* ci2, int64_t M2, int64_t W,
                                    void* ka, void* kb, void* pr, void* pi, void* stream) {
  if (M1 < 1 || M2 < 1 || W < 0 || W > (1 << 26)) return (int)cudaErrorInvalidValue;
  // tj = 32 operand-2 rows, or fewer where M2 is smaller; ti the rest of the
  // 1,024, or fewer where M1 is smaller, and then tj up to the rest
  int log2_tj = ceil_log2(M2, 5);
  int log2_ti = kLog2Tile - log2_tj;
  const int log2_m1 = ceil_log2(M1, kLog2Tile);
  if (log2_ti > log2_m1) {
    log2_ti = log2_m1;
    log2_tj = ceil_log2(M2, kLog2Tile - log2_ti);
  }
  const int64_t ti = int64_t(1) << log2_ti, tj = int64_t(1) << log2_tj;
  const int64_t per_word = 16 * (ti + tj) + 4 * (int64_t)sizeof(uint4);
  int64_t qc = kSharedBytes / per_word;
  if (qc > W) qc = W;
  if (qc < 1) qc = 1;
  const int64_t tiles_j = (M2 + tj - 1) / tj, tiles = (M1 + ti - 1) / ti * tiles_j;
  if (tiles >= (int64_t(1) << 31)) return (int)cudaErrorInvalidValue;
  auto i64 = [](const void* p) { return static_cast<const int64_t*>(p); };
  auto f64 = [](const void* p) { return static_cast<const double*>(p); };
  pair_products_kernel<<<(unsigned)tiles, kThreads, (size_t)(qc * per_word),
                         static_cast<cudaStream_t>(stream)>>>(
      i64(x1), i64(z1), f64(cr1), f64(ci1), M1, i64(x2), i64(z2), f64(cr2), f64(ci2), M2,
      (int)W, log2_ti, log2_tj, (int)qc, tiles_j, static_cast<int64_t*>(ka),
      static_cast<int64_t*>(kb), static_cast<double*>(pr), static_cast<double*>(pi));
  return (int)cudaGetLastError();
}
