// GF(2) row reduction of packed rows, in place, for Hopper (sm_90a): K11.
//
// Replaces symmer_tpu/kernels/jx_gf2.py:rref_packed_device (:21-37), an
// XLA fori_loop of R full-matrix masked XORs.  For int64[R, W] rows (bit q
// at bit q % 64 of word q // 64), in row order: a row that is zero is
// skipped; a nonzero row p pivots on its lowest set bit (word pw, bit
// pbit), and every other row holding that bit gets row p XORed in (above
// and below).  Plain version: kernels/torch_gf2.py:rref, bit for bit (the
// reduced rows are unique given the order, whatever the order of work).
//
// What bounds it: the matrix read and written once is the least (16 R W
// bytes), but the work depends on the data: each pivot reads one word of
// every row and rewrites the rows that hold its bit.  The rank is at most
// the bit count (2,000 at 1,000 qubits), so most of the R rows of a large
// stack are zero when their turn comes.
//
// The design: one cooperative launch.  Every block walks the rows in the
// same order, reading a window of rows after each pivot (groups of L lanes a
// row, L the power of two >= W up to 32) to find the next nonzero row; a
// zero row needs no barrier, since nothing writes between pivots.  At a
// pivot every block takes its share of the rows (a group a row; lane 0
// reads the pivot word and hands it to the group, which XORs the row's
// words), then one grid-wide barrier.  So the launch makes rank passes over
// the rows, not R.  All reads of M bypass L1 (__ldcg): other blocks write
// it.  A block that has found the pivot may start writing while another
// still scans the window: it writes only rows that hold the pivot bit,
// which excludes the zero rows before the pivot and the pivot itself, so
// the other block finds the same pivot.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerGroup = 8;  // rows a group checks in one window

using u64 = unsigned long long;

__global__ void __launch_bounds__(kThreads)
    gf2_rref_kernel(u64* M, int64_t R, int64_t W, int L) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int s_first;
  const int lane = threadIdx.x & (L - 1);
  const int group = threadIdx.x / L;
  const int groups = kThreads / L;
  const int64_t window = (int64_t)groups * kRowsPerGroup;
  const int64_t gstride = (int64_t)gridDim.x * groups;
  int64_t i = 0;
  while (i < R) {
    // the first nonzero row in [i, i + window)
    if (threadIdx.x == 0) s_first = INT_MAX;
    __syncthreads();
    for (int k = 0; k < kRowsPerGroup; ++k) {
      const int off = group * kRowsPerGroup + k;
      const int64_t j = i + off;
      u64 acc = 0;
      if (j < R)
        for (int64_t w = lane; w < W; w += L) acc |= __ldcg(&M[j * W + w]);
      for (int m = 1; m < L; m <<= 1) acc |= __shfl_xor_sync(0xffffffffu, acc, m, L);
      if (acc != 0 && lane == 0) atomicMin(&s_first, off);
    }
    __syncthreads();
    const int first = s_first;
    __syncthreads();  // every thread has read s_first before the next reset
    if (first == INT_MAX) {
      i += window;
      continue;
    }
    const int64_t p = i + first;
    // the pivot: row p's first nonzero word and its lowest set bit (every
    // warp finds the same)
    int64_t pw = 0;
    u64 pbit = 0;
    for (int64_t base = 0; base < W; base += 32) {
      const int64_t w = base + (threadIdx.x & 31);
      u64 v = w < W ? __ldcg(&M[p * W + w]) : 0;
      const unsigned ballot = __ballot_sync(0xffffffffu, v != 0);
      if (ballot) {
        const int src = __ffs(ballot) - 1;
        v = __shfl_sync(0xffffffffu, v, src);
        pw = base + src;
        pbit = v & (~v + 1);
        break;
      }
    }
    // every other row holding the pivot bit gets row p XORed in; all groups
    // of a block run the same number of iterations (full-warp shuffles)
    for (int64_t jb = (int64_t)blockIdx.x * groups; jb < R; jb += gstride) {
      const int64_t j = jb + group;
      u64 hw = 0;
      if (lane == 0 && j < R) hw = __ldcg(&M[j * W + pw]);
      hw = __shfl_sync(0xffffffffu, hw, 0, L);
      if (j != p && (hw & pbit))
        for (int64_t w = lane; w < W; w += L) M[j * W + w] = __ldcg(&M[j * W + w]) ^ __ldcg(&M[p * W + w]);
    }
    grid.sync();
    i = p + 1;
  }
}

int g_grid_cap = 0;  // blocks of gf2_rref_kernel the card holds at once

}  // namespace

// RREF of M (int64[R, W], row-major) in place (see above).  Returns a
// cudaError_t.
extern "C" int symmer_gf2_rref(void* M, int64_t R, int64_t W, void* stream) {
  if (R < 1 || W < 1) return (int)cudaErrorInvalidValue;
  if (g_grid_cap == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gf2_rref_kernel, kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    if (sms * per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    g_grid_cap = sms * per_sm;
  }
  int L = 1;
  while (L < 32 && L < W) L <<= 1;
  const int64_t groups = kThreads / L;
  const int64_t want = (R + groups - 1) / groups;
  const unsigned grid = (unsigned)(want < g_grid_cap ? want : g_grid_cap);
  auto mp = static_cast<u64*>(M);
  void* args[] = {&mp, &R, &W, &L};
  return (int)cudaLaunchCooperativeKernel((const void*)gf2_rref_kernel, dim3(grid),
                                          dim3(kThreads), args, 0,
                                          static_cast<cudaStream_t>(stream));
}
