// Expectation value <psi|O|psi> of a Pauli sum in a sparse basis state, for
// Hopper (sm_90a).
//
// Replaces symmer_tpu/kernels/jx_state.py:expval (and the dispatch wrapper
// _jitted_expval that feeds it a deduplicated state).  For a deduplicated
// state with rows s_b and amplitudes a_b:
//     <psi|O|psi> = sum_{t,b} c_t (-i)^{|Y_t|} (-1)^{popc((s_b ^ x_t) & z_t)}
//                   a_b conj(a_b')   over the pairs where s_b' = s_b ^ x_t.
// The TPU program found b' through three 32-bit row hashes, a windowed
// one-hot MXU fetch and 16-bit float hash halves.  Here the wrapper sorts
// the state rows once (lexicographically, word 0 first, words compared as
// signed int64) and every (t, b) pair finds b' by a binary search with
// whole-row compares: a match is exact, never missed and never false.
//
// What bounds it: the function needs one O(1) hash probe per (term, row)
// pair or per unordered pair of rows, whichever is fewer, and a parity and
// a complex product only for the pairs that match (chip_smoke.py's
// expval_bound).  At N2's 2,239 terms x 65,536 rows that is operations; at
// the flagship's 200,000 terms x 1,024 rows the row pairs are 390 times
// fewer and reading the operator bounds it.  This design does more: every
// (term, row) pair, with its full parity and ceil(log2(B+1)) row compares
// of a search, so it runs at about 1% of the bound or less (PERF.md).
// The design:
//   - the sorted state rows and amplitudes are staged once per block in
//     shared memory when they fit (160 KB), else the search reads them from
//     device memory (they stay in the 50 MB L2);
//   - persistent blocks of 1024 threads walk over the flattened pairs
//     p = t*B + b; consecutive threads take consecutive b of one term, so
//     the term's words are one broadcast load;
//   - the target row is never stored: each compare forms its words from
//     s_b ^ x_t on the fly;
//   - the sum is float64, per thread, then a fixed tree per block into one
//     partial per block, then a second launch sums the partials in order
//     (no atomics: the result is the same on every run).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kFinalThreads = 256;
constexpr size_t kSmemBudget = 160 * 1024;

// (re, im) *= i^k for k in 0..3
__device__ __forceinline__ void apply_i_pow(int k, double& re, double& im) {
  const double r = re, i = im;
  switch (k & 3) {
    case 1: re = -i; im = r; break;
    case 2: re = -r; im = -i; break;
    case 3: re = i; im = -r; break;
    default: break;
  }
}

// row r before the target row (s_b ^ x_t)?
__device__ __forceinline__ bool before_target(const int64_t* r, const int64_t* sb,
                                              const int64_t* xt, int W) {
  for (int w = 0; w < W; ++w) {
    const int64_t t = sb[w] ^ __ldg(xt + w);
    if (r[w] != t) return r[w] < t;
  }
  return false;
}

__device__ __forceinline__ bool equals_target(const int64_t* r, const int64_t* sb,
                                              const int64_t* xt, int W) {
  for (int w = 0; w < W; ++w)
    if (r[w] != (sb[w] ^ __ldg(xt + w))) return false;
  return true;
}

// fixed-order tree sum of one value pair per thread; thread 0 gets the total
template <int N>
__device__ __forceinline__ void block_sum(double* red_r, double* red_i, double& re,
                                          double& im) {
  red_r[threadIdx.x] = re;
  red_i[threadIdx.x] = im;
  __syncthreads();
#pragma unroll
  for (int off = N / 2; off > 0; off >>= 1) {
    if ((int)threadIdx.x < off) {
      red_r[threadIdx.x] += red_r[threadIdx.x + off];
      red_i[threadIdx.x] += red_i[threadIdx.x + off];
    }
    __syncthreads();
  }
  re = red_r[0];
  im = red_i[0];
}

__global__ void __launch_bounds__(kThreads, 1)
expval_pairs(const int64_t* __restrict__ x, const int64_t* __restrict__ z,
             const double* __restrict__ cr, const double* __restrict__ ci,
             const int64_t* __restrict__ s, const double* __restrict__ ar,
             const double* __restrict__ ai, int64_t T, int64_t B, int W, int staged,
             double* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double red_r[kThreads], red_i[kThreads];
  const int64_t* S = s;
  const double* AR = ar;
  const double* AI = ai;
  if (staged) {
    int64_t* ss = reinterpret_cast<int64_t*>(smem);
    double* sr = reinterpret_cast<double*>(ss + B * W);
    double* si = sr + B;
    for (int64_t i = threadIdx.x; i < B * W; i += kThreads) ss[i] = s[i];
    for (int64_t i = threadIdx.x; i < B; i += kThreads) {
      sr[i] = ar[i];
      si[i] = ai[i];
    }
    __syncthreads();
    S = ss;
    AR = sr;
    AI = si;
  }
  double re = 0.0, im = 0.0;
  const int64_t n_pairs = T * B;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  int64_t p = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (p < n_pairs) {
    int64_t t = p / B, b = p - t * B;
    const int64_t dt = stride / B, db = stride - dt * B;
    for (; p < n_pairs; p += stride) {
      const int64_t* xt = x + t * W;
      const int64_t* zt = z + t * W;
      const int64_t* sb = S + b * W;
      int par = 0, y = 0;
      for (int w = 0; w < W; ++w) {
        const int64_t xw = __ldg(xt + w), zw = __ldg(zt + w);
        par += __popcll((unsigned long long)((sb[w] ^ xw) & zw));
        y += __popcll((unsigned long long)(xw & zw));
      }
      int64_t lo = 0, hi = B;
      while (lo < hi) {
        const int64_t mid = (lo + hi) >> 1;
        if (before_target(S + mid * W, sb, xt, W)) lo = mid + 1;
        else hi = mid;
      }
      if (lo < B && equals_target(S + lo * W, sb, xt, W)) {
        // a_b conj(a_b'), then c_t (-i)^y, then the sign: the plain
        // version's arithmetic, pair by pair
        const double abr = AR[b], abi = AI[b], apr = AR[lo], api = AI[lo];
        const double mr = abr * apr + abi * api;
        const double mi = abi * apr - abr * api;
        double c_r = __ldg(cr + t), c_i = __ldg(ci + t);
        apply_i_pow(4 - (y & 3), c_r, c_i);
        double vr = c_r * mr - c_i * mi;
        double vi = c_r * mi + c_i * mr;
        if (par & 1) {
          vr = -vr;
          vi = -vi;
        }
        re += vr;
        im += vi;
      }
      b += db;
      t += dt;
      if (b >= B) {
        b -= B;
        ++t;
      }
    }
  }
  block_sum<kThreads>(red_r, red_i, re, im);
  if (threadIdx.x == 0) {
    partial[2 * blockIdx.x] = re;
    partial[2 * blockIdx.x + 1] = im;
  }
}

__global__ void __launch_bounds__(kFinalThreads)
expval_final(const double* __restrict__ partial, int n, double* __restrict__ out) {
  __shared__ double red_r[kFinalThreads], red_i[kFinalThreads];
  double re = 0.0, im = 0.0;
  for (int i = threadIdx.x; i < n; i += kFinalThreads) {
    re += partial[2 * i];
    im += partial[2 * i + 1];
  }
  block_sum<kFinalThreads>(red_r, red_i, re, im);
  if (threadIdx.x == 0) {
    out[0] = re;
    out[1] = im;
  }
}

}  // namespace

// x, z: int64[T, W]; cr, ci: float64[T]; s: int64[B, W] deduplicated and
// sorted (see above); ar, ai: float64[B] in the same order; partial:
// float64[2 * max_blocks] scratch; out: float64[2] = (re, im).  T, B >= 1.
extern "C" int symmer_state_expval(const void* x, const void* z, const void* cr,
                                   const void* ci, int64_t T, int64_t W, const void* s,
                                   const void* ar, const void* ai, int64_t B,
                                   void* partial, int64_t max_blocks, void* out,
                                   void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (T < 1 || B < 1 || W < 1 || W > 0x7FFFFFFF || max_blocks < 1)
    return (int)cudaErrorInvalidValue;
  const size_t staged_bytes = (size_t)B * (size_t)W * 8 + (size_t)B * 16;
  const int staged = staged_bytes <= kSmemBudget;
  const size_t smem = staged ? staged_bytes : 0;
  cudaError_t err = cudaSuccess;
  if (staged)
    err = cudaFuncSetAttribute(expval_pairs, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, expval_pairs, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  int64_t blocks = (T * B + kThreads - 1) / kThreads;
  if (blocks > (int64_t)sms * per_sm) blocks = (int64_t)sms * per_sm;
  if (blocks > max_blocks) blocks = max_blocks;
  expval_pairs<<<(unsigned)blocks, kThreads, smem, st>>>(
      static_cast<const int64_t*>(x), static_cast<const int64_t*>(z),
      static_cast<const double*>(cr), static_cast<const double*>(ci),
      static_cast<const int64_t*>(s), static_cast<const double*>(ar),
      static_cast<const double*>(ai), T, B, (int)W, staged, static_cast<double*>(partial));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  expval_final<<<1, kFinalThreads, 0, st>>>(static_cast<const double*>(partial), (int)blocks,
                                            static_cast<double*>(out));
  return (int)cudaGetLastError();
}
