// The rows of a non-Clifford rotation (K6), for Hopper (sm_90a): each term's
// signature and coefficient and its P Q row's, without writing the rotated
// rows.
//
// Replaces the rotation half of
// symmer_tpu/kernels/jx_core.py:rotate_nonclifford_cleanup (:682-727): XLA
// hashes the T input rows and their rotated twins in two fused passes
// (h_first, h_second) and the cleanup rebuilds the survivors' rows from their
// index (row_source).  For row r of x, z: int64[T, W] with coefficient (cr,
// ci): float64[T], the rotation's Pauli Q = (xr, zr): int64[W] and ac =
// parity(popc(x & zr) + popc(z & xr)) (the term anticommutes with Q), it
// writes two of 2 T slots of (ka, kb, pr, pi, live):
//
//   slot r      the row signature of (x[r], z[r]); the coefficient (cr cos_t,
//               ci cos_t) where ac, else (cr, ci); live;
//   slot T + r  the row signature of (x[r] ^ xr, z[r] ^ zr); mul_single's
//               coefficient (m_r, m_i) = (cr, ci) s i^(3 (y + y_Q) + y_out),
//               s = (-1)^popc(x & zr), y = popc(x & z) summed over a row's
//               words, then times -i sin_t: (m_i sin_t, -m_r sin_t); live
//               where ac.
//
// Bit for bit torch_core.rotation_rows: the signatures from
// row_signature.cuh, the sign a product by +-1.0 and the power of i
// apply_i_pow's negations and swaps in the plain chain's order, every
// product rounded apart (__dmul_rn: no contraction into an FMA), the power
// of i summed in uint32 (only its value mod 4 is used).  The live slots, in
// slot order, are the parent composition's rows [x; x[ia] ^ xr] (ia the
// anticommuting rows, ascending), so the cleanup after it (K3 with live
// flags, merge_groups.cu) gives that composition's bits.
//
// What bounds it: operations.  Two signatures a row, 11 32-bit integer
// operations for each of 4 W half-words in each of 4 lanes (chip_smoke.py's
// rotation_bound), against 16 W + 16 bytes read and 66 written a row.  The
// design, K2's (row_signature.cu):
//   - a group of L lanes takes one row, L the power of two at or above the
//     row's units (a unit: V words of x and the same V of z, V = 2 where W
//     is even and the planes 16-byte aligned, else 1), at most 32;
//   - the grid is one wave of blocks that stride over the rows, so a lane
//     that holds one unit of each row keeps its position constants and its
//     words of Q in registers;
//   - each lane keeps both rows' lane sums and four popcount sums in
//     registers, the group adds them with xor shuffles, and the group's
//     first lane computes the two coefficients and writes both slots.
// One launch; no atomics, no shared memory, no scratch.
#include <cuda_runtime.h>

#include <cstdint>

#include "row_signature.cuh"

namespace {

constexpr int kThreads = 256;

template <int V>
__global__ void __launch_bounds__(kThreads)
rotation_rows_kernel(const int64_t* __restrict__ x, const int64_t* __restrict__ z,
                     const double* __restrict__ cr, const double* __restrict__ ci, int64_t T,
                     int W, const int64_t* __restrict__ xr, const int64_t* __restrict__ zr,
                     double cos_t, double sin_t, int log2_lanes, int64_t* __restrict__ ka,
                     int64_t* __restrict__ kb, double* __restrict__ pr, double* __restrict__ pi,
                     bool* __restrict__ live) {
  const int L = 1 << log2_lanes;
  const int lane = threadIdx.x & 31;
  const int li = lane & (L - 1);  // this lane's place in its row's group
  const int rows_per_warp = 32 >> log2_lanes;
  const int units = W / V;
  const int64_t warp = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int64_t stride = (int64_t)gridDim.x * (kThreads / 32) * rows_per_warp;
  // one unit a lane: its position constants and Q's words for every row it visits
  const bool one = units <= L;
  uint4 px[V][2], pz[V][2];
  uint64_t qx[V], qz[V];
  auto setup = [&](int u) {
    word_positions<V>(u * V, W, px, pz);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      qx[e] = (uint64_t)__ldg(xr + u * V + e);
      qz[e] = (uint64_t)__ldg(zr + u * V + e);
    }
  };
  if (one && li < units) setup(li);
  // every lane of a warp runs the same iterations (the shuffles take the whole warp)
  for (int64_t base = warp * rows_per_warp; base < T; base += stride) {
    const int64_t row = base + (lane >> log2_lanes);
    uint32_t s0[4] = {0u, 0u, 0u, 0u}, s1[4] = {0u, 0u, 0u, 0u};  // the row's, its twin's
    uint32_t n_zr = 0u, n_xr = 0u, y = 0u, y_out = 0u;  // popc(x & zr), popc(z & xr), y + y_Q
    if (row < T) {
      for (int u = li; u < units; u += L) {
        if (!one) setup(u);
        uint64_t a[V], b[V];
        load_words<V>(x + row * W + u * V, a);
        load_words<V>(z + row * W + u * V, b);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const uint64_t c = qx[e], d = qz[e];
          hash_word(s0, a[e], px[e][0], px[e][1]);
          hash_word(s0, b[e], pz[e][0], pz[e][1]);
          hash_word(s1, a[e] ^ c, px[e][0], px[e][1]);
          hash_word(s1, b[e] ^ d, pz[e][0], pz[e][1]);
          n_zr += (uint32_t)__popcll(a[e] & d);
          n_xr += (uint32_t)__popcll(b[e] & c);
          y += (uint32_t)(__popcll(a[e] & b[e]) + __popcll(c & d));
          y_out += (uint32_t)__popcll((a[e] ^ c) & (b[e] ^ d));
        }
      }
    }
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      s0[l] = group_sum(s0[l], log2_lanes);
      s1[l] = group_sum(s1[l], log2_lanes);
    }
    n_zr = group_sum(n_zr, log2_lanes);
    n_xr = group_sum(n_xr, log2_lanes);
    y = group_sum(y, log2_lanes);
    y_out = group_sum(y_out, log2_lanes);
    if (row < T && li == 0) {
      const bool ac = (n_zr + n_xr) & 1u;
      const double re = __ldg(cr + row), im = __ldg(ci + row);
      signature_keys(s0, ka + row, kb + row);
      signature_keys(s1, ka + T + row, kb + T + row);
      pr[row] = ac ? __dmul_rn(re, cos_t) : re;
      pi[row] = ac ? __dmul_rn(im, cos_t) : im;
      const double s = (n_zr & 1u) ? -1.0 : 1.0;
      const double sr = __dmul_rn(re, s), si = __dmul_rn(im, s);
      double mr, mi;  // times i^k: apply_i_pow's table
      switch ((3u * y + y_out) & 3u) {
        case 0: mr = sr; mi = si; break;
        case 1: mr = -si; mi = sr; break;
        case 2: mr = -sr; mi = -si; break;
        default: mr = si; mi = -sr; break;
      }
      pr[T + row] = __dmul_rn(mi, sin_t);
      pi[T + row] = __dmul_rn(-mr, sin_t);
      live[row] = true;
      live[T + row] = ac;
    }
  }
}

template <int V>
int launch(const int64_t* x, const int64_t* z, const double* cr, const double* ci, int64_t T,
           int W, const int64_t* xr, const int64_t* zr, double cos_t, double sin_t, int64_t* ka,
           int64_t* kb, double* pr, double* pi, bool* live, cudaStream_t st) {
  static int cached[64] = {0};
  int wave = 0;
  const cudaError_t err = wave_blocks(rotation_rows_kernel<V>, kThreads, cached, &wave);
  if (err != cudaSuccess) return (int)err;
  const int log2_lanes = log2_lanes_for(W / V);
  const int64_t rows_per_block = (int64_t)(kThreads / 32) * (32 >> log2_lanes);
  const int64_t need = (T + rows_per_block - 1) / rows_per_block;
  const unsigned blocks = (unsigned)(need < wave ? need : wave);
  rotation_rows_kernel<V><<<blocks, kThreads, 0, st>>>(x, z, cr, ci, T, W, xr, zr, cos_t, sin_t,
                                                       log2_lanes, ka, kb, pr, pi, live);
  return (int)cudaGetLastError();
}

}  // namespace

// x, z: int64[T, W]; cr, ci: float64[T]; xr, zr: int64[W] (contiguous, T >=
// 1); ka, kb: int64[2 T]; pr, pi: float64[2 T]; live: bool[2 T].  One
// launch.
extern "C" int symmer_rotation_rows(const void* x, const void* z, const void* cr, const void* ci,
                                    int64_t T, int64_t W, const void* xr, const void* zr,
                                    double cos_t, double sin_t, void* ka, void* kb, void* pr,
                                    void* pi, void* live, void* stream) {
  if (T < 1 || T >= (int64_t(1) << 40) || W < 0 || W > (1 << 26))
    return (int)cudaErrorInvalidValue;
  const auto* x64 = static_cast<const int64_t*>(x);
  const auto* z64 = static_cast<const int64_t*>(z);
  const auto* c_r = static_cast<const double*>(cr);
  const auto* c_i = static_cast<const double*>(ci);
  const auto* q_x = static_cast<const int64_t*>(xr);
  const auto* q_z = static_cast<const int64_t*>(zr);
  auto* a = static_cast<int64_t*>(ka);
  auto* b = static_cast<int64_t*>(kb);
  auto* p_r = static_cast<double*>(pr);
  auto* p_i = static_cast<double*>(pi);
  auto* l = static_cast<bool*>(live);
  auto st = static_cast<cudaStream_t>(stream);
  const bool vec = W % 2 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(z) % 16 == 0;
  return vec ? launch<2>(x64, z64, c_r, c_i, T, (int)W, q_x, q_z, cos_t, sin_t, a, b, p_r, p_i, l,
                         st)
             : launch<1>(x64, z64, c_r, c_i, T, (int)W, q_x, q_z, cos_t, sin_t, a, b, p_r, p_i, l,
                         st);
}
