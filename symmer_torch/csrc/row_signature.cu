// The 128-bit row signature of the cleanup (K2), for Hopper (sm_90a).
//
// Replaces symmer_tpu/kernels/jx_core.py:row_hashes (XLA: one elementwise
// pass over the rows' 32-bit half-words and a row reduction), which every
// cleanup sorts by.  Bit for bit torch_core.row_signature: for packed rows
// x, z: int64[T, W], the 4W half-words of row t (x's words, then z's, each
// word low half first) go through four lanes l of a tabulation-style hash,
//
//     p_j = (j + INIT_l) * 0x9E3779B9;  p_j ^= p_j >> 16
//     v   = (h_j ^ p_j) * MULT_l;  v = (v ^ v >> 15) * MIX1;
//     v   = (v ^ v >> 13) * MIX2;  v ^= v >> 16
//     lane_l = sum over j of v  (mod 2^32)
//
// all in uint32 arithmetic (the plain version's int64 products masked to 32
// bits are the same numbers), and ka = (lane_0 ^ 2^31) << 32 | lane_1, kb =
// (lane_2 ^ 2^31) << 32 | lane_3 as int64 bit patterns (the plain version's
// (lane - 2^31) * 2^32 + lane').  A sum mod 2^32 does not depend on the order
// of its terms, so any reduction order gives the same bits.
//
// What bounds it: operations.  11 integer operations a half-word and lane
// (3 xor-shifts, 3 multiplies, 4 xors, 1 add; chip_smoke.py's
// signature_bound) against 16 W + 16 bytes a row: at W = 16 the work takes
// about twice as long as the bytes.  The design:
//   - a group of L lanes takes one row, L the power of two at or above the
//     row's units (a unit: one 16-byte load of two words where W is even and
//     the planes 16-byte aligned, else one word), at most 32; at W = 16 a
//     warp reads two rows' 512 bytes in one coalesced load a lane, at W = 1
//     or 2 it takes 16 or 8 rows, so no lane idles;
//   - the grid is one wave of blocks that stride over the rows, so a lane
//     that holds one unit of each row it visits computes its position
//     constants once, in registers (no table, nothing copied from the
//     host); wider rows compute them per unit;
//   - each lane keeps its four sums in registers, the row's group adds them
//     with xor shuffles, and the group's first lane writes ka and kb.
// One launch; no atomics, no shared memory, no scratch.  The lane constants
// and the mix are in row_signature.cuh, shared with pair_products.cu (K4).
#include <cuda_runtime.h>

#include <cstdint>

#include "row_signature.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// unit u (V words) of row `row`: its 2V half-words, low half first
template <int V>
__device__ __forceinline__ void load_unit(const int64_t* __restrict__ x,
                                          const int64_t* __restrict__ z, int64_t row, int W,
                                          int u, uint32_t (&h)[2 * V]) {
  const int q = u * V;  // the unit's first word of the row's 2W
  const int64_t* p = q < W ? x + row * W + q : z + row * W + (q - W);
  if constexpr (V == 2) {
    const longlong2 w = __ldg(reinterpret_cast<const longlong2*>(p));
    h[0] = (uint32_t)w.x;
    h[1] = (uint32_t)((uint64_t)w.x >> 32);
    h[2] = (uint32_t)w.y;
    h[3] = (uint32_t)((uint64_t)w.y >> 32);
  } else {
    const int64_t w = __ldg(p);
    h[0] = (uint32_t)w;
    h[1] = (uint32_t)((uint64_t)w >> 32);
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads)
row_signature_kernel(const int64_t* __restrict__ x, const int64_t* __restrict__ z, int64_t T,
                     int W, int log2_lanes, int64_t* __restrict__ ka, int64_t* __restrict__ kb) {
  const int L = 1 << log2_lanes;
  const int lane = threadIdx.x & 31;
  const int li = lane & (L - 1);           // this lane's place in its row's group
  const int rows_per_warp = 32 >> log2_lanes;
  const int units = 2 * W / V;
  const int64_t warp = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int64_t stride = (int64_t)gridDim.x * (kThreads / 32) * rows_per_warp;
  // one unit a lane: its position constants for every row it visits
  const bool one = units <= L;
  uint32_t pc[4][2 * V];
  if (one && li < units) {
#pragma unroll
    for (int l = 0; l < 4; ++l)
#pragma unroll
      for (int e = 0; e < 2 * V; ++e) pc[l][e] = position((uint32_t)(li * 2 * V + e), l);
  }
  // every lane of a warp runs the same iterations (the shuffles take the whole warp)
  for (int64_t base = warp * rows_per_warp; base < T; base += stride) {
    const int64_t row = base + (lane >> log2_lanes);
    uint32_t acc[4] = {0u, 0u, 0u, 0u};
    if (row < T) {
      if (one) {
        if (li < units) {
          uint32_t h[2 * V];
          load_unit<V>(x, z, row, W, li, h);
#pragma unroll
          for (int l = 0; l < 4; ++l)
#pragma unroll
            for (int e = 0; e < 2 * V; ++e) acc[l] += mix(h[e], pc[l][e], l);
        }
      } else {
        for (int u = li; u < units; u += L) {
          uint32_t h[2 * V];
          load_unit<V>(x, z, row, W, u, h);
#pragma unroll
          for (int l = 0; l < 4; ++l)
#pragma unroll
            for (int e = 0; e < 2 * V; ++e)
              acc[l] += mix(h[e], position((uint32_t)(u * 2 * V + e), l), l);
        }
      }
    }
    for (int o = L >> 1; o > 0; o >>= 1)
#pragma unroll
      for (int l = 0; l < 4; ++l) acc[l] += __shfl_xor_sync(kFull, acc[l], o);
    if (row < T && li == 0) signature_keys(acc, ka + row, kb + row);
  }
}

template <int V>
int launch(const int64_t* x, const int64_t* z, int64_t T, int W, int64_t* ka, int64_t* kb,
           cudaStream_t st) {
  static int cached[64] = {0};
  int wave = 0;
  const cudaError_t err = wave_blocks(row_signature_kernel<V>, kThreads, cached, &wave);
  if (err != cudaSuccess) return (int)err;
  const int log2_lanes = log2_lanes_for(2 * W / V);
  const int64_t rows_per_block = (int64_t)(kThreads / 32) * (32 >> log2_lanes);
  const int64_t need = (T + rows_per_block - 1) / rows_per_block;
  const unsigned blocks = (unsigned)(need < wave ? need : wave);
  row_signature_kernel<V><<<blocks, kThreads, 0, st>>>(x, z, T, W, log2_lanes, ka, kb);
  return (int)cudaGetLastError();
}

}  // namespace

// x, z: int64[T, W] (contiguous); ka, kb: int64[T].  One launch; T >= 1.
extern "C" int symmer_row_signature(const void* x, const void* z, int64_t T, int64_t W,
                                    void* ka, void* kb, void* stream) {
  if (T < 1 || W < 0 || W > (1 << 28)) return (int)cudaErrorInvalidValue;
  const auto* x64 = static_cast<const int64_t*>(x);
  const auto* z64 = static_cast<const int64_t*>(z);
  auto* a = static_cast<int64_t*>(ka);
  auto* b = static_cast<int64_t*>(kb);
  auto st = static_cast<cudaStream_t>(stream);
  const bool vec = W % 2 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(z) % 16 == 0;
  return vec ? launch<2>(x64, z64, T, (int)W, a, b, st) : launch<1>(x64, z64, T, (int)W, a, b, st);
}
