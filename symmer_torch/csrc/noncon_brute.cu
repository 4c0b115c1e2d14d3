// Brute-force minimum of the noncontextual energy over all 2^n_free
// assignments of the free symmetry generators, for Hopper (sm_90a).
//
// Replaces symmer_tpu/kernels/jx_noncon.py:_chunk_min / _scan_slice /
// _fold_min (an iota of assignment indices, a float parity matmul at HIGHEST
// precision, dense contractions and a running (min, argmin) in a
// lax.fori_loop).  For assignment index k and term m (kernels/torch_noncon.py):
//     kk       = (~k & (2^n_free - 1)) | 2^31
//     parity_m = popc(kk & gmask_m) & 1      (bit 31 of gmask: fixed parity)
//     v_m      = (-1)^parity_m * base_m
//     E(k)     = sum_{m in S0} v_m - sqrt(sum_i (sum_{m in clique i} v_m)^2)
// The terms come ordered by segment (S0, clique 0, clique 1, ...), so the
// sums are one running accumulator per segment, and the popcount makes the
// parity exact.  The result is (min E, argmin k), ties to the smaller k.
//
// What bounds it: operations; the inputs are a few KB.  The function's
// least work is far below this design's: each segment's sums over all
// assignments are one Walsh-Hadamard transform of the terms' bases bucketed
// by free mask, n_free * 2^n_free adds where the direct sum takes
// M * 2^n_free (chip_smoke.py's brute_bound), so at M = 2,048 and n_free =
// 24 this kernel runs at well under 1% of the bound (PERF.md).  It does
// the direct sum: each (k, m) pair is one AND, one popcount (the narrowest
// pipe, 16 per clock per SM), a sign flip of the float64 (an integer XOR of
// its top bit) and one float64 add.  The design:
//   - the terms (gmask as uint32, base as float64) live in shared memory,
//     in tiles of up to 4096 terms (48 KB) reloaded per pass if M is larger;
//     every thread reads the same term at the same time (a broadcast);
//   - each thread evaluates 4 consecutive assignments per pass, so one term
//     load feeds 4 independent popcount / add chains;
//   - each thread keeps a running (min, argmin); a fixed tree per block
//     writes one pair per block, and a second launch folds the block pairs
//     in order (no atomics: the same result on every run).
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kMaxTile = 4096;
constexpr int kFinalThreads = 256;

__device__ __forceinline__ bool better(double e2, int64_t k2, double e1, int64_t k1) {
  return e2 < e1 || (e2 == e1 && k2 < k1);
}

// fixed-order tree fold of one (e, k) pair per thread; thread 0 gets the best
template <int N>
__device__ __forceinline__ void block_fold(double* red_e, int64_t* red_k, double& e,
                                           int64_t& k) {
  red_e[threadIdx.x] = e;
  red_k[threadIdx.x] = k;
  __syncthreads();
#pragma unroll
  for (int off = N / 2; off > 0; off >>= 1) {
    if ((int)threadIdx.x < off) {
      const double e2 = red_e[threadIdx.x + off];
      const int64_t k2 = red_k[threadIdx.x + off];
      if (better(e2, k2, red_e[threadIdx.x], red_k[threadIdx.x])) {
        red_e[threadIdx.x] = e2;
        red_k[threadIdx.x] = k2;
      }
    }
    __syncthreads();
  }
  e = red_e[0];
  k = red_k[0];
}

__global__ void __launch_bounds__(kThreads)
brute_force_blocks(const int64_t* __restrict__ gmask, const double* __restrict__ base,
                   const int64_t* __restrict__ seg_off, int64_t M, int n_segs, int n_free,
                   int tile, double* __restrict__ part_e, int64_t* __restrict__ part_k) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double red_e[kThreads];
  __shared__ int64_t red_k[kThreads];
  double* sb = reinterpret_cast<double*>(smem);
  uint32_t* sg = reinterpret_cast<uint32_t*>(sb + tile);
  const int64_t N = (int64_t)1 << n_free;
  const uint32_t full = (uint32_t)(((uint64_t)1 << n_free) - 1);
  const bool resident = M <= tile;
  int64_t t0 = 0, t1 = 0;  // terms [t0, t1) are in shared memory
  if (resident) {
    for (int64_t i = threadIdx.x; i < M; i += kThreads) {
      sb[i] = base[i];
      sg[i] = (uint32_t)gmask[i];
    }
    t1 = M;
    __syncthreads();
  }
  double best_e = INFINITY;
  int64_t best_k = INT64_MAX;
  const int64_t per_block = (int64_t)kThreads * kPerThread;
  // the pass loop and the term loops are the same for every thread of a
  // block, so the tile reloads' barriers are reached by all
  for (int64_t first = (int64_t)blockIdx.x * per_block; first < N;
       first += (int64_t)gridDim.x * per_block) {
    const int64_t k0 = first + (int64_t)threadIdx.x * kPerThread;
    uint32_t kk[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) kk[j] = (~(uint32_t)(k0 + j) & full) | 0x80000000u;
    double s0[kPerThread], sq[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) s0[j] = sq[j] = 0.0;
    for (int seg = 0; seg < n_segs; ++seg) {
      const int64_t m0 = seg_off[seg], m1 = seg_off[seg + 1];
      double acc[kPerThread];
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) acc[j] = 0.0;
      for (int64_t m = m0; m < m1; ++m) {
        if (m < t0 || m >= t1) {  // only when the terms do not fit
          __syncthreads();
          t0 = m;
          t1 = m + tile < M ? m + tile : M;
          for (int64_t i = threadIdx.x; i < t1 - t0; i += kThreads) {
            sb[i] = base[t0 + i];
            sg[i] = (uint32_t)gmask[t0 + i];
          }
          __syncthreads();
        }
        const uint32_t g = sg[m - t0];
        const unsigned long long bb = (unsigned long long)__double_as_longlong(sb[m - t0]);
#pragma unroll
        for (int j = 0; j < kPerThread; ++j) {
          const unsigned long long flip = (unsigned long long)(__popc(kk[j] & g) & 1) << 63;
          acc[j] += __longlong_as_double((long long)(bb ^ flip));
        }
      }
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        if (seg == 0) s0[j] += acc[j];
        else sq[j] += acc[j] * acc[j];
      }
    }
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int64_t k = k0 + j;
      const double e = s0[j] - sqrt(sq[j]);
      if (k < N && better(e, k, best_e, best_k)) {
        best_e = e;
        best_k = k;
      }
    }
    if (!resident) t0 = t1 = 0;  // the next pass starts again at term 0
  }
  block_fold<kThreads>(red_e, red_k, best_e, best_k);
  if (threadIdx.x == 0) {
    part_e[blockIdx.x] = best_e;
    part_k[blockIdx.x] = best_k;
  }
}

__global__ void __launch_bounds__(kFinalThreads)
brute_force_final(const double* __restrict__ part_e, const int64_t* __restrict__ part_k,
                  int n, double* __restrict__ out_e, int64_t* __restrict__ out_k) {
  __shared__ double red_e[kFinalThreads];
  __shared__ int64_t red_k[kFinalThreads];
  double e = INFINITY;
  int64_t k = INT64_MAX;
  for (int i = threadIdx.x; i < n; i += kFinalThreads)
    if (better(part_e[i], part_k[i], e, k)) {
      e = part_e[i];
      k = part_k[i];
    }
  block_fold<kFinalThreads>(red_e, red_k, e, k);
  if (threadIdx.x == 0) {
    out_e[0] = e;
    out_k[0] = k;
  }
}

}  // namespace

// gmask: int64[M] (32 bits used), base: float64[M], seg_off: int64[n_segs + 1]
// (host-checked: 0 = seg_off[0] <= ... <= seg_off[n_segs] = M), 1 <= n_free
// <= 31; part_e / part_k: scratch of max_blocks entries; out_e: float64[1],
// out_k: int64[1].
extern "C" int symmer_noncon_brute(const void* gmask, const void* base, const void* seg_off,
                                   int64_t M, int64_t n_segs, int64_t n_free, void* part_e,
                                   void* part_k, int64_t max_blocks, void* out_e,
                                   void* out_k, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (M < 0 || n_segs < 1 || n_free < 1 || n_free > 31 || max_blocks < 1)
    return (int)cudaErrorInvalidValue;
  const int tile = (int)(M < 1 ? 1 : (M < kMaxTile ? M : kMaxTile));
  const size_t smem = (size_t)tile * (sizeof(double) + sizeof(uint32_t));
  cudaError_t err = cudaFuncSetAttribute(
      brute_force_blocks, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, brute_force_blocks, kThreads,
                                                        smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int64_t per_block = (int64_t)kThreads * kPerThread;
  int64_t blocks = (((int64_t)1 << n_free) + per_block - 1) / per_block;
  if (blocks > (int64_t)sms * per_sm) blocks = (int64_t)sms * per_sm;
  if (blocks > max_blocks) blocks = max_blocks;
  brute_force_blocks<<<(unsigned)blocks, kThreads, smem, st>>>(
      static_cast<const int64_t*>(gmask), static_cast<const double*>(base),
      static_cast<const int64_t*>(seg_off), M, (int)n_segs, (int)n_free, tile,
      static_cast<double*>(part_e), static_cast<int64_t*>(part_k));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  brute_force_final<<<1, kFinalThreads, 0, st>>>(
      static_cast<const double*>(part_e), static_cast<const int64_t*>(part_k), (int)blocks,
      static_cast<double*>(out_e), static_cast<int64_t*>(out_k));
  return (int)cudaGetLastError();
}
