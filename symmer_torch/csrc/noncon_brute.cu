// Brute-force minimum of the noncontextual energy over all 2^n_free
// assignments of the free symmetry generators, for Hopper (sm_90a).
//
// Replaces symmer_tpu/kernels/jx_noncon.py:_chunk_min / _scan_slice /
// _fold_min (an iota of assignment indices, a float parity matmul at HIGHEST
// precision, dense contractions and a running (min, argmin) in a
// lax.fori_loop).  For assignment index k (kernels/torch_noncon.py):
//     E(k) = s_0(k) - sqrt(sum_{i >= 1} s_i(k)^2),
//     s(k) = sum_{m in the segment} b'_m (-1)^popc(F_m & k)
// where F_m is term m's free-generator mask and b'_m its base with the
// fixed parity and the ~k relabelling folded into the sign once: with kk =
// (~k & (2^n_free - 1)) | 2^31, popc(kk & gmask_m) = bit31_m + popc(F_m) -
// popc(k & F_m), so b'_m = (-1)^{bit31_m + popc(F_m)} base_m.  Each
// segment's sums over all k are one Walsh-Hadamard transform of the b'_m
// bucketed by F_m.  The result is (min E, argmin k), ties to the smaller k.
//
// What bounds it: float64 adds; the inputs are a few KB.  chip_smoke.py's
// brute_bound counts, per segment, the least of the direct sum (M_s adds an
// assignment), the full transform (n_free) and the split one (n_lo +
// M_s / 2^n_lo), plus the energy.  The design is the split transform:
//   - k = (k_hi, k_lo) with n_lo = min(n_free, 11) low bits (the widest
//     split measured fastest); a block takes one k_hi at a time
//     (persistent blocks), so nothing of size 2^n_free is ever stored;
//   - a one-block prologue folds the signs and sorts the terms by
//     (segment, F_lo) with a stable counting sort (integer atomics count
//     the buckets, a scan, one warp scatters the terms in order); then per
//     segment the block buckets the terms by F's low bits with the signs
//     (-1)^popc(F_hi & k_hi), every bucket a contiguous sum in a fixed
//     order, one thread per bucket;
//   - the 2^n_lo-point butterfly then runs in place: 8 points a thread in
//     registers (the low 3 bits), warp shuffles for the next 5 bits, and
//     for the bits above 8 one transpose through shared memory that makes
//     them register bits again (so shared memory is written and read once
//     a segment, not once a stage);
//   - a segment of at most n_lo / 4 terms (an empty one included) is summed
//     term by term instead;
//   - each thread folds its assignments' energies into a running (min,
//     argmin); a fixed tree per block writes one pair per block, and the
//     last block to finish (an integer atomic counts them) folds the block
//     pairs in order.  No float atomics, and fixed butterfly and fold
//     orders: the same result on every run;
//   - a launch may search a range [k0, k1) of the assignments (a shard of a
//     mesh's split, symmer_tpu/kernels/jx_noncon.py:164-178): it takes the
//     k_hi that the range touches and folds only the k inside it.  Every
//     assignment's energy is computed as in a full search, so the ranges'
//     minima, the smallest index among ties, give the full search's result
//     bit for bit.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

// the launch shape of a split of n_lo = NLO bits: T threads, E points each
template <int NLO>
struct Split {
  static constexpr int L = 1 << NLO;
  static constexpr int LOGE = NLO >= 8 ? 3 : (NLO > 5 ? NLO - 5 : 0);
  static constexpr int E = 1 << LOGE;
  static constexpr int T = NLO >= 8 ? L / 8 : 32;
  static constexpr int SHFL = NLO >= 8 ? 5 : NLO - LOGE;  // lane bits
  static constexpr int HIGH = NLO > 8 ? NLO - 8 : 0;      // bits above 8
};

__device__ __forceinline__ bool better(double e2, int64_t k2, double e1, int64_t k1) {
  return e2 < e1 || (e2 == e1 && k2 < k1);
}

// (-1)^par * b as an XOR of the float64's top bit
__device__ __forceinline__ double flip(double b, int par) {
  return __longlong_as_double(__double_as_longlong(b) ^
                              (long long)((unsigned long long)(par & 1) << 63));
}

__device__ __forceinline__ void butterfly(double& a, double& c) {
  const double s = a + c, d = a - c;
  a = s;
  c = d;
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

// the k_lo that register j of thread t holds at the end of a segment: the
// transposed layout when there are bits above 8, else t * E + j
template <int NLO>
__device__ __forceinline__ int point(int t, int j) {
  using S = Split<NLO>;
  return S::HIGH ? ((j << (NLO - 3)) | t) : (t * S::E + j);
}

template <int NLO>
__global__ void __launch_bounds__(Split<NLO>::T)
brute_force_split(const uint32_t* __restrict__ fmask, const double* __restrict__ bsig,
                  const int32_t* __restrict__ bucket, const int64_t* __restrict__ seg_off,
                  int n_segs, int64_t k0, int64_t k1, double* __restrict__ part_e,
                  int64_t* __restrict__ part_k, uint32_t* __restrict__ counter,
                  double* __restrict__ out_e, int64_t* __restrict__ out_k) {
  using S = Split<NLO>;
  constexpr int L = S::L, E = S::E, T = S::T;
  __shared__ double sh[S::HIGH ? L : 1];
  __shared__ double red_e[T];
  __shared__ int64_t red_k[T];
  const int t = threadIdx.x;
  const int64_t hi_end = ((k1 - 1) >> NLO) + 1;
  double best_e = INFINITY;
  int64_t best_k = INT64_MAX;
  for (int64_t khi = (k0 >> NLO) + blockIdx.x; khi < hi_end; khi += gridDim.x) {
    const uint32_t kh = (uint32_t)khi;
    double s0[E], sq[E];
#pragma unroll
    for (int j = 0; j < E; ++j) s0[j] = sq[j] = 0.0;
    for (int seg = 0; seg < n_segs; ++seg) {
      const int64_t m0 = __ldg(seg_off + seg), m1 = __ldg(seg_off + seg + 1);
      double v[E];
      if (4 * (m1 - m0) <= NLO) {  // torch_noncon.direct_segment: term by term
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const uint32_t k = (kh << NLO) | (uint32_t)point<NLO>(t, j);
          double a = 0.0;
          for (int64_t m = m0; m < m1; ++m)
            a += flip(__ldg(bsig + m), __popc(__ldg(fmask + m) & k));
          v[j] = a;
        }
      } else {
        // 1. this thread's buckets k_lo = t * E + j, signed by k_hi
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const int i = t * E + j;
          double a = 0.0;
          if (i < L) {
            const int32_t* bk = bucket + (int64_t)seg * L + i;
            const int32_t b1 = __ldg(bk + 1);
            for (int32_t m = __ldg(bk); m < b1; ++m)
              a += flip(__ldg(bsig + m), __popc((__ldg(fmask + m) >> NLO) & kh));
          }
          v[j] = a;
        }
        // 2. the low LOGE bits, in registers
#pragma unroll
        for (int b = 0; b < S::LOGE; ++b)
#pragma unroll
          for (int j = 0; j < E; ++j)
            if (!((j >> b) & 1)) butterfly(v[j], v[j | (1 << b)]);
        // 3. the lane bits, by shuffles: the lower partner keeps a + c, the
        // upper a - c
#pragma unroll
        for (int b = 0; b < S::SHFL; ++b) {
          const bool upper = (t >> b) & 1;
#pragma unroll
          for (int j = 0; j < E; ++j) {
            const double o = __shfl_xor_sync(0xffffffffu, v[j], 1 << b);
            v[j] = upper ? o - v[j] : v[j] + o;
          }
        }
        // 4. the bits above 8: transpose through shared memory so that they
        // are register bits (k_lo = j << (NLO - 3) | t), then butterflies
        if constexpr (S::HIGH > 0) {
#pragma unroll
          for (int j = 0; j < E; ++j) sh[t * E + j] = v[j];
          __syncthreads();
#pragma unroll
          for (int j = 0; j < E; ++j) v[j] = sh[(j << (NLO - 3)) | t];
#pragma unroll
          for (int b = 8; b < NLO; ++b) {
            const int jb = b - (NLO - 3);
#pragma unroll
            for (int j = 0; j < E; ++j)
              if (!((j >> jb) & 1)) butterfly(v[j], v[j | (1 << jb)]);
          }
          __syncthreads();  // the next segment writes sh again
        }
      }
#pragma unroll
      for (int j = 0; j < E; ++j) {
        if (seg == 0) s0[j] += v[j];
        else sq[j] += v[j] * v[j];
      }
    }
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const int i = point<NLO>(t, j);
      const int64_t k = (khi << NLO) | i;
      if (i < L && k >= k0 && k < k1) {
        const double e = s0[j] - sqrt(sq[j]);
        if (better(e, k, best_e, best_k)) {
          best_e = e;
          best_k = k;
        }
      }
    }
  }
  block_fold<T>(red_e, red_k, best_e, best_k);
  // the last block to finish folds the block pairs in block order
  __shared__ bool last;
  if (t == 0) {
    part_e[blockIdx.x] = best_e;
    part_k[blockIdx.x] = best_k;
    __threadfence();
    last = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  best_e = INFINITY;
  best_k = INT64_MAX;
  for (int i = t; i < (int)gridDim.x; i += T) {
    const double e = __ldcg(part_e + i);
    const int64_t k = __ldcg(part_k + i);
    if (better(e, k, best_e, best_k)) {
      best_e = e;
      best_k = k;
    }
  }
  block_fold<T>(red_e, red_k, best_e, best_k);
  if (t == 0) {
    out_e[0] = best_e;
    out_k[0] = best_k;
  }
}

constexpr int kScanThreads = 1024;

// the segment of term m: the last s with seg_off[s] <= m
__device__ __forceinline__ int segment_of(const int64_t* seg_off, int n_segs, int64_t m) {
  int lo = 0, hi = n_segs - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(seg_off + mid) <= m) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ int bucket_key(const int64_t* gmask, const int64_t* seg_off,
                                          int n_segs, int n_free, int n_lo, int64_t m) {
  const uint32_t F = (uint32_t)__ldg(gmask + m) & (uint32_t)(((uint64_t)1 << n_free) - 1);
  return (segment_of(seg_off, n_segs, m) << n_lo) | (int)(F & ((1u << n_lo) - 1));
}

// one block, the whole prologue in one launch: count the terms of each
// bucket (key = segment 2^n_lo + F_lo; integer atomics), scan the counts
// a tile of kScanThreads at a time (warp shuffles) into bucket[k], the
// first sorted position of bucket k (bucket[K] = M), then one warp
// scatters the terms in order, 32 at a time: each term goes to its
// bucket's cursor plus its rank among the warp's terms of that bucket (a
// stable sort), with F and the folded base b'.  The search's block counter
// is zeroed.
__global__ void __launch_bounds__(kScanThreads)
sort_terms(const int64_t* __restrict__ gmask, const double* __restrict__ base,
           const int64_t* __restrict__ seg_off, int64_t M, int n_segs, int n_free, int n_lo,
           int32_t* __restrict__ cursor, int32_t* __restrict__ bucket,
           uint32_t* __restrict__ counter, uint32_t* __restrict__ fmask,
           double* __restrict__ bsig) {
  __shared__ int32_t warp_sum[kScanThreads / 32];
  __shared__ int32_t carry;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t K = (int64_t)n_segs << n_lo;
  for (int64_t i = threadIdx.x; i < K; i += kScanThreads) cursor[i] = 0;
  if (threadIdx.x == 0) {
    counter[0] = 0;
    carry = 0;
  }
  __syncthreads();
  for (int64_t m = threadIdx.x; m < M; m += kScanThreads)
    atomicAdd(cursor + bucket_key(gmask, seg_off, n_segs, n_free, n_lo, m), 1);
  __syncthreads();
  for (int64_t tile = 0; tile < K; tile += kScanThreads) {
    const int64_t i = tile + threadIdx.x;
    const int32_t c = i < K ? cursor[i] : 0;
    int32_t v = c;  // inclusive scan within the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t n = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += n;
    }
    if (lane == 31) warp_sum[warp] = v;
    __syncthreads();
    if (warp == 0) {  // inclusive scan of the warps' totals
      int32_t w = warp_sum[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int32_t n = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += n;
      }
      warp_sum[lane] = w;
    }
    __syncthreads();
    if (i < K) {
      const int32_t at = carry + (warp ? warp_sum[warp - 1] : 0) + v - c;
      bucket[i] = at;
      cursor[i] = at;
    }
    __syncthreads();
    if (threadIdx.x == 0) carry += warp_sum[kScanThreads / 32 - 1];
    __syncthreads();
  }
  if (threadIdx.x == 0) bucket[K] = carry;
  if (warp != 0) return;
  const uint32_t full = (uint32_t)(((uint64_t)1 << n_free) - 1);
  for (int64_t m0 = 0; m0 < M; m0 += 32) {
    const int64_t m = m0 + lane;
    const bool valid = m < M;
    const int key = valid ? bucket_key(gmask, seg_off, n_segs, n_free, n_lo, m) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    const int rank = __popc(peers & ((1u << lane) - 1));
    const int32_t at = valid ? cursor[key] : 0;
    __syncwarp();
    if (valid) {
      const uint64_t g = (uint64_t)__ldg(gmask + m);
      const uint32_t F = (uint32_t)g & full;
      const int fold = __popcll(g & (full | 0x80000000ull)) & 1;
      fmask[at + rank] = F;
      bsig[at + rank] = flip(__ldg(base + m), fold);
      if (rank == 0) cursor[key] = at + __popc(peers);
    }
    __syncwarp();
  }
}

template <int NLO>
cudaError_t launch_split(const uint32_t* fmask, const double* bsig, const int32_t* bucket,
                         const int64_t* seg_off, int n_segs, int64_t k0, int64_t k1,
                         double* part_e,
                         int64_t* part_k, uint32_t* counter, int64_t max_blocks,
                         double* out_e, int64_t* out_k, cudaStream_t st) {
  using S = Split<NLO>;
  static int64_t resident[64] = {0};  // per device, queried once
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, brute_force_split<NLO>,
                                                          S::T, 0);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    resident[dev] = (int64_t)sms * per_sm;
  }
  int64_t blocks = ((k1 - 1) >> NLO) - (k0 >> NLO) + 1;
  if (blocks > resident[dev]) blocks = resident[dev];
  if (blocks > max_blocks) blocks = max_blocks;
  brute_force_split<NLO><<<(unsigned)blocks, S::T, 0, st>>>(
      fmask, bsig, bucket, seg_off, n_segs, k0, k1, part_e, part_k, counter, out_e, out_k);
  return cudaGetLastError();
}

}  // namespace

// gmask: int64[M] (32 bits used), base: float64[M], seg_off: int64[n_segs +
// 1] (host-checked: 0 = seg_off[0] <= ... <= seg_off[n_segs] = M), as
// torch_noncon.kernel_inputs builds them; 1 <= n_lo <= min(n_free, 11),
// n_free <= 31; the assignments searched: [k0, k1), 0 <= k0 < k1 <=
// 2^n_free; iscratch: int32[M + 2 (n_segs 2^n_lo + 1) + 1], fscratch:
// float64[M], part_e / part_k: scratch of max_blocks entries; out_e:
// float64[1], out_k: int64[1].
extern "C" int symmer_noncon_brute(const void* gmask, const void* base, const void* seg_off,
                                   int64_t M, int64_t n_segs, int64_t n_free, int64_t n_lo,
                                   int64_t k0, int64_t k1, void* iscratch, void* fscratch,
                                   void* part_e,
                                   void* part_k, int64_t max_blocks, void* out_e,
                                   void* out_k, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (M < 0 || M > 0x3FFFFFFF || n_segs < 1 || n_free < 1 || n_free > 31 || n_lo < 1 ||
      n_lo > 11 || n_lo > n_free || max_blocks < 1 || (n_segs << n_lo) > 0x3FFFFFFF ||
      k0 < 0 || k1 <= k0 || k1 > ((int64_t)1 << n_free))
    return (int)cudaErrorInvalidValue;
  const int64_t K = n_segs << n_lo;
  // int32 scratch: fmask [M], bucket [K + 1], cursor [K + 1], counter [1]
  auto* fmask = static_cast<uint32_t*>(iscratch);
  auto* bucket = reinterpret_cast<int32_t*>(fmask + M);
  int32_t* cursor = bucket + K + 1;
  auto* counter = reinterpret_cast<uint32_t*>(cursor + K + 1);
  auto* bsig = static_cast<double*>(fscratch);
  const auto* g64 = static_cast<const int64_t*>(gmask);
  const auto* off = static_cast<const int64_t*>(seg_off);
  sort_terms<<<1, kScanThreads, 0, st>>>(g64, static_cast<const double*>(base), off, M,
                                         (int)n_segs, (int)n_free, (int)n_lo, cursor, bucket,
                                         counter, fmask, bsig);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaErrorInvalidValue;
  auto* pe = static_cast<double*>(part_e);
  auto* pk = static_cast<int64_t*>(part_k);
  auto* oe = static_cast<double*>(out_e);
  auto* ok = static_cast<int64_t*>(out_k);
  switch (n_lo) {
#define SYMMER_SPLIT(n)                                                                      \
  case n:                                                                                    \
    err = launch_split<n>(fmask, bsig, bucket, off, (int)n_segs, k0, k1, pe, pk, counter,     \
                          max_blocks, oe, ok, st);                                           \
    break;
    SYMMER_SPLIT(1) SYMMER_SPLIT(2) SYMMER_SPLIT(3) SYMMER_SPLIT(4) SYMMER_SPLIT(5)
    SYMMER_SPLIT(6) SYMMER_SPLIT(7) SYMMER_SPLIT(8) SYMMER_SPLIT(9) SYMMER_SPLIT(10)
    SYMMER_SPLIT(11)
#undef SYMMER_SPLIT
    default: break;
  }
  return (int)err;
}
