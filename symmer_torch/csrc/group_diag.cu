// The group-diagonal table of the Lanczos matvec, built on Hopper (sm_90a).
//
// Replaces symmer_tpu/kernels/jx_lanczos.py:_build_D_fn (a scatter of the
// term phases into a zeroed (rows, 2^n) table, then one jitted
// Walsh-Hadamard butterfly pass per h = 1, 2, 4, ...) and the host build
// dense.group_diagonals / fwht_rows:
//     D[g, r] = sum_{t in g} ph_t (-1)^{popcount(r & z_t)},
// ph_t = (-i)^{|Y_t|} c_t, the transform along r of the table S with
// S[g_t, z_t] = ph_t (unique (g, z) pairs: the scatter is exact).
//
// What bounds it: writing the table, G 2^n complex128 (tapered N2: 198 MB,
// 59 us at 3.35 TB/s); the T-term inputs are a few KB.  The transform's
// float64 adds (n G 2^n complex adds) take less at the card's FP64 rate.
//
// The design (first cut): the transform runs in passes over index bits of
// a row (kernels/torch_lanczos.py:fwht_passes, which the wrapper follows).
//   - Pass 0 takes bits 0..11: a block holds a tile of 2^12 contiguous
//     points of one row (64 KB of shared memory), zeroes it, adds the
//     phases of the terms that fall in it (the wrapper sorts the terms by
//     table position; the block finds its range by binary search), runs
//     stages h = 1 .. 2^11 in shared memory and writes the tile once.  The
//     table is never zeroed in device memory.
//   - Each later pass takes up to 9 more bits: a block holds 2^kb points
//     strided 2^s apart for 2^(12 - kb) neighbouring columns (contiguous
//     runs of at least 128 bytes), runs stages h = 2^s .. 2^(s + kb - 1),
//     and writes them back.  Tapered N2 (n = 15) takes two passes: the
//     table is written twice and read once.
//   - Stages go in the order h = 1, 2, 4, ... and each butterfly is
//     (a + b, a - b) on the re and im parts, so the table is bit for bit
//     dense.fwht_rows's (tests/test_torch_kernel_math.py models the pass
//     order).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTileBits = 12;
constexpr int kThreads = 256;
constexpr int kTileBytes = (1 << kTileBits) * 16;

__device__ __forceinline__ int64_t lower_bound(const int64_t* keys, int64_t n, int64_t key) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (__ldg(keys + mid) < key)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// one pass: stages h = 2^s .. 2^(s + kb - 1) on tiles of 2^kb points times
// 2^logc neighbouring columns; scatter: the pass that adds the phases
__global__ void __launch_bounds__(kThreads)
    group_diag_pass(double2* __restrict__ S, int n, int s, int kb, int logc,
                    const int64_t* __restrict__ keys, const double2* __restrict__ ph,
                    int64_t T, int scatter) {
  extern __shared__ double2 tile[];
  __shared__ int64_t range[2];
  const int64_t dim = int64_t(1) << n;
  const int64_t C = int64_t(1) << logc;
  const int64_t n_loc = (int64_t(1) << s) >> logc;      // column chunks
  const int64_t n_hi = int64_t(1) << (n - s - kb);      // values of the bits above
  int64_t blk = blockIdx.x;
  const int64_t loc = blk % n_loc;
  blk /= n_loc;
  const int64_t hi = blk % n_hi;
  const int64_t g = blk / n_hi;
  const int64_t base = g * dim + (hi << (s + kb)) + loc * C;
  const int E = 1 << (kb + logc);

  if (scatter) {  // s == 0, C == 1: the tile is [base, base + 2^kb) of the table
    for (int e = threadIdx.x; e < E; e += kThreads) tile[e] = make_double2(0.0, 0.0);
    if (threadIdx.x == 0) range[0] = lower_bound(keys, T, base);
    if (threadIdx.x == 32) range[1] = lower_bound(keys, T, base + E);
    __syncthreads();
    for (int64_t i = range[0] + threadIdx.x; i < range[1]; i += kThreads) {
      const int e = (int)(__ldg(keys + i) - base);
      const double2 p = __ldg(ph + i);
      tile[e].x += p.x;
      tile[e].y += p.y;
    }
  } else {
    for (int e = threadIdx.x; e < E; e += kThreads)
      tile[e] = S[base + ((int64_t)(e >> logc) << s) + (e & (C - 1))];
  }
  __syncthreads();

  const int half = E >> 1;
  for (int t = 0; t < kb; ++t) {
    for (int u = threadIdx.x; u < half; u += kThreads) {
      const int c = u & (int)(C - 1);
      const int jj = u >> logc;
      const int j = ((jj >> t) << (t + 1)) | (jj & ((1 << t) - 1));
      const int ia = (j << logc) | c;
      const int ib = ((j | (1 << t)) << logc) | c;
      const double2 a = tile[ia], b = tile[ib];
      tile[ia] = make_double2(a.x + b.x, a.y + b.y);
      tile[ib] = make_double2(a.x - b.x, a.y - b.y);
    }
    __syncthreads();
  }

  for (int e = threadIdx.x; e < E; e += kThreads)
    S[base + ((int64_t)(e >> logc) << s) + (e & (C - 1))] = tile[e];
}

}  // namespace

// One pass of the build over the (G, 2^n) table S (see fwht_passes);
// keys (sorted g * 2^n + z) and ph are read by the scatter pass only.
// Returns a cudaError_t.
extern "C" int symmer_group_diag_pass(void* S, int64_t G, int64_t n, int64_t s, int64_t kb,
                                      const void* keys, const void* ph, int64_t T,
                                      int64_t scatter, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (G < 1 || n < 0 || n > 31 || s < 0 || kb < 0 || s + kb > n || kb > kTileBits ||
      (scatter && s != 0))
    return (int)cudaErrorInvalidValue;
  // neighbouring columns per tile: 2^(12 - kb), at most the 2^s there are
  const int logc = (int)(s < kTileBits - kb ? s : kTileBits - kb);
  const int64_t blocks = (G << n) >> (kb + logc);
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidConfiguration;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        group_diag_pass, cudaFuncAttributeMaxDynamicSharedMemorySize, kTileBytes);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const size_t smem = size_t(16) << (kb + logc);
  group_diag_pass<<<(unsigned)blocks, kThreads, smem, st>>>(
      static_cast<double2*>(S), (int)n, (int)s, (int)kb, logc,
      static_cast<const int64_t*>(keys), static_cast<const double2*>(ph), T, (int)scatter);
  return (int)cudaGetLastError();
}
