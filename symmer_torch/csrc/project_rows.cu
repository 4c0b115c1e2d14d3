// The rows of a stabilizer-subspace projection (K7), for Hopper (sm_90a):
// each term's signature and coefficient after the projection, and whether it
// survives the stabilizer filter, without the filtered copy of the rows.
//
// Replaces the projection half of
// symmer_tpu/kernels/jx_core.py:clifford_project_cleanup (:728-786, after
// the Clifford scan and the anticommutation test): XLA flips the signs,
// masks the stabilized columns, hashes the masked rows and flags the dropped
// terms dead (live), and the cleanup gathers the survivors' masked rows.  It
// runs after K5 (the scan) and K1 (csrc/anticommutes.cu, ac: bool[T, S], a
// term against each rotated single-qubit stabilizer).  For row r of x, z:
// int64[T, W] with coefficient (cr, ci): float64[T], the masks neg_x, neg_z
// (the stabilizers of eigenvalue -1) and col_keep (the free columns):
// int64[W], it writes slot r of (ka, kb, pr, pi, live):
//
//   live    no entry of ac's row r is set;
//   ka, kb  the row signature of (x[r] & col_keep, z[r] & col_keep);
//   pr, pi  (cr, ci) times f = +-1.0, f = -1 where popc(x & neg_x) +
//           popc(z & neg_z) is odd: a product (__dmul_rn), as the plain
//           chain does it, so a zero keeps or changes its sign as there.
//
// Bit for bit torch_core.project_rows.  The live slots are the parent
// composition's filtered rows in their order, so the cleanup after it (K3
// with live flags and the masked row source, merge_groups.cu) gives that
// composition's bits.
//
// What bounds it: operations.  One signature a row, 11 32-bit integer
// operations for each of 4 W half-words in each of 4 lanes (chip_smoke.py's
// project_bound), against 16 W + 16 + S bytes read and 33 written a row.
// The design, K2's (row_signature.cu): a group of L lanes a row (a unit: V
// words of x and the same V of z), one wave of blocks striding over the
// rows so a lane keeps its position constants and its words of the three
// masks in registers; a lane also reads every L-th byte of the row's ac; the
// group adds its lane sums, flip counts and hits with xor shuffles and its
// first lane writes the slot.  One launch; no atomics, no shared memory, no
// scratch.
#include <cuda_runtime.h>

#include <cstdint>

#include "row_signature.cuh"

namespace {

constexpr int kThreads = 256;

template <int V>
__global__ void __launch_bounds__(kThreads)
project_rows_kernel(const int64_t* __restrict__ x, const int64_t* __restrict__ z,
                    const double* __restrict__ cr, const double* __restrict__ ci, int64_t T, int W,
                    const uint8_t* __restrict__ ac, int S, const int64_t* __restrict__ neg_x,
                    const int64_t* __restrict__ neg_z, const int64_t* __restrict__ col_keep,
                    int log2_lanes, int64_t* __restrict__ ka, int64_t* __restrict__ kb,
                    double* __restrict__ pr, double* __restrict__ pi, bool* __restrict__ live) {
  const int L = 1 << log2_lanes;
  const int lane = threadIdx.x & 31;
  const int li = lane & (L - 1);  // this lane's place in its row's group
  const int rows_per_warp = 32 >> log2_lanes;
  const int units = W / V;
  const int64_t warp = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int64_t stride = (int64_t)gridDim.x * (kThreads / 32) * rows_per_warp;
  // one unit a lane: its position constants and mask words for every row it visits
  const bool one = units <= L;
  uint4 px[V][2], pz[V][2];
  uint64_t nx[V], nz[V], keep[V];
  auto setup = [&](int u) {
    word_positions<V>(u * V, W, px, pz);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      nx[e] = (uint64_t)__ldg(neg_x + u * V + e);
      nz[e] = (uint64_t)__ldg(neg_z + u * V + e);
      keep[e] = (uint64_t)__ldg(col_keep + u * V + e);
    }
  };
  if (one && li < units) setup(li);
  // every lane of a warp runs the same iterations (the shuffles take the whole warp)
  for (int64_t base = warp * rows_per_warp; base < T; base += stride) {
    const int64_t row = base + (lane >> log2_lanes);
    uint32_t s[4] = {0u, 0u, 0u, 0u};
    uint32_t flips = 0u, hits = 0u;  // popc(x & neg_x) + popc(z & neg_z); set entries of ac
    if (row < T) {
      for (int u = li; u < units; u += L) {
        if (!one) setup(u);
        uint64_t a[V], b[V];
        load_words<V>(x + row * W + u * V, a);
        load_words<V>(z + row * W + u * V, b);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          hash_word(s, a[e] & keep[e], px[e][0], px[e][1]);
          hash_word(s, b[e] & keep[e], pz[e][0], pz[e][1]);
          flips += (uint32_t)(__popcll(a[e] & nx[e]) + __popcll(b[e] & nz[e]));
        }
      }
      for (int k = li; k < S; k += L) hits += __ldg(ac + row * S + k) != 0;
    }
#pragma unroll
    for (int l = 0; l < 4; ++l) s[l] = group_sum(s[l], log2_lanes);
    flips = group_sum(flips, log2_lanes);
    hits = group_sum(hits, log2_lanes);
    if (row < T && li == 0) {
      const double f = (flips & 1u) ? -1.0 : 1.0;
      signature_keys(s, ka + row, kb + row);
      pr[row] = __dmul_rn(__ldg(cr + row), f);
      pi[row] = __dmul_rn(__ldg(ci + row), f);
      live[row] = hits == 0u;
    }
  }
}

template <int V>
int launch(const int64_t* x, const int64_t* z, const double* cr, const double* ci, int64_t T,
           int W, const uint8_t* ac, int S, const int64_t* neg_x, const int64_t* neg_z,
           const int64_t* col_keep, int64_t* ka, int64_t* kb, double* pr, double* pi, bool* live,
           cudaStream_t st) {
  static int cached[64] = {0};
  int wave = 0;
  const cudaError_t err = wave_blocks(project_rows_kernel<V>, kThreads, cached, &wave);
  if (err != cudaSuccess) return (int)err;
  const int log2_lanes = log2_lanes_for(W / V);
  const int64_t rows_per_block = (int64_t)(kThreads / 32) * (32 >> log2_lanes);
  const int64_t need = (T + rows_per_block - 1) / rows_per_block;
  const unsigned blocks = (unsigned)(need < wave ? need : wave);
  project_rows_kernel<V><<<blocks, kThreads, 0, st>>>(x, z, cr, ci, T, W, ac, S, neg_x, neg_z,
                                                      col_keep, log2_lanes, ka, kb, pr, pi, live);
  return (int)cudaGetLastError();
}

}  // namespace

// x, z: int64[T, W]; cr, ci: float64[T]; ac: bool[T, S] (K1's output, S >=
// 0); neg_x, neg_z, col_keep: int64[W] (contiguous, T >= 1); ka, kb:
// int64[T]; pr, pi: float64[T]; live: bool[T].  One launch.
extern "C" int symmer_project_rows(const void* x, const void* z, const void* cr, const void* ci,
                                   int64_t T, int64_t W, const void* ac, int64_t S,
                                   const void* neg_x, const void* neg_z, const void* col_keep,
                                   void* ka, void* kb, void* pr, void* pi, void* live,
                                   void* stream) {
  if (T < 1 || T >= (int64_t(1) << 40) || W < 0 || W > (1 << 26) || S < 0 || S > (1 << 26))
    return (int)cudaErrorInvalidValue;
  auto i64 = [](const void* p) { return static_cast<const int64_t*>(p); };
  auto f64 = [](const void* p) { return static_cast<const double*>(p); };
  auto st = static_cast<cudaStream_t>(stream);
  const auto* flags = static_cast<const uint8_t*>(ac);
  auto* a = static_cast<int64_t*>(ka);
  auto* b = static_cast<int64_t*>(kb);
  auto* p_r = static_cast<double*>(pr);
  auto* p_i = static_cast<double*>(pi);
  auto* l = static_cast<bool*>(live);
  const bool vec = W % 2 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(z) % 16 == 0;
  return vec ? launch<2>(i64(x), i64(z), f64(cr), f64(ci), T, (int)W, flags, (int)S, i64(neg_x),
                         i64(neg_z), i64(col_keep), a, b, p_r, p_i, l, st)
             : launch<1>(i64(x), i64(z), f64(cr), f64(ci), T, (int)W, flags, (int)S, i64(neg_x),
                         i64(neg_z), i64(col_keep), a, b, p_r, p_i, l, st);
}
