// Expectation value <psi|O|psi> of a Pauli sum in a sparse basis state, for
// Hopper (sm_90a).
//
// Replaces symmer_tpu/kernels/jx_state.py:expval (and the dispatch wrapper
// _jitted_expval that feeds it a deduplicated state).  For a deduplicated
// state with rows s_b and amplitudes a_b, and the terms grouped by X part
// (groups x_g, phases c'_t = c_t (-i)^{|Y_t|}):
//     <psi|O|psi> = sum_{g,b} a_b conj(a_b') sum_{t in g} c'_t (-1)^{popc(s_b' & z_t)}
// over the pairs where s_b' = s_b ^ x_g is a row of the state.  The TPU
// program found b' through three 32-bit row hashes, a windowed one-hot MXU
// fetch and 16-bit float hash halves.
//
// What bounds it (chip_smoke.py's expval_bound): finding the pairs takes
// one hash probe per (X group, row) pair or per unordered pair of rows,
// whichever is fewer; then a complex product per matched (group, row) pair
// and a popcount and two adds per matched (term, row) pair.  At N2's 378 X
// groups x 65,536 rows that is operations; at the flagship's 200,000 terms
// x 1,024 rows reading the operator bounds it.  The design:
//   - a GF(2)-linear hash h(v) = A v over a random 32 x 64W bit matrix
//     (columns from a fixed seed, torch_state.hash_columns), so
//     h(s_b ^ x_g) = h(s_b) ^ h(x_g): a probe is an XOR, table loads and an
//     exact whole-row compare (a match is never missed and never false; a
//     collision costs a further probe);
//   - the grouping needs no host round trip: the wrapper sorts the terms'
//     X hashes (symmer_state_hash, then torch.sort), a prep kernel gathers
//     z and the phases c'_t in that order and flags where the X part
//     changes, one block numbers the groups, and the number of groups U
//     stays on the card, where every later kernel reads it;
//   - the table: open addressing, linear probing, at most a quarter full,
//     built with a 64-bit atomicCAS per key; a slot holds the key's hash
//     and index, and a probe reads 4 slots (one 32-byte sector) at a time,
//     so a chain is mostly one random load, and the key's row is read only
//     when the hash matches;
//   - the route is chosen on the card from U: "groups" when U B <=
//     B (B + 1) / 2, where the table holds the state rows and one thread
//     per (group, row) pair probes s_b ^ x_g, then on a hit forms
//     a_b conj(a_b') once and sums its group's +-c'_t with one parity
//     each; "pairs" otherwise, where the table holds the X parts and one
//     thread per unordered row pair {b, b2} (b2 = b + d mod B, d = 0 ..
//     B / 2) probes s_b ^ s_b2, a hit adding both orientations and the
//     diagonal pairs (d = 0) meeting the X = 0 group.  Two X parts of
//     equal hash may leave one X part in two groups; the pairs probe sums
//     every exact match, so nothing is lost or counted twice;
//   - the groups route stages the table, the row hashes and the
//     amplitudes in shared memory when they fit (160 KB), else they stay
//     in L2; consecutive threads take consecutive rows of one group (or
//     one offset d), so a group's X part, hash and terms are broadcast;
//   - float64 sums per thread, a fixed tree per block into one partial per
//     block, and the last block to finish (an integer atomic counts them)
//     sums the partials in block order: no float atomics, the same result
//     on every run (the table's slot order may vary, a probe's answer
//     cannot);
//   - five launches in all (the X hashes, then after the sort: prep,
//     numbering, table, probes), with the card's attributes queried once.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kHashThreads = 256;
constexpr int kScanThreads = 1024;
constexpr size_t kSmemBudget = 160 * 1024;

unsigned grid_for(int64_t n, int threads, int64_t cap) {
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > cap) blocks = cap;
  return (unsigned)(blocks < 1 ? 1 : blocks);
}

__device__ __forceinline__ uint32_t row_hash(const int64_t* __restrict__ row, int W,
                                             const uint32_t* __restrict__ cols) {
  uint32_t h = 0;
  for (int w = 0; w < W; ++w) {
    unsigned long long v = (unsigned long long)__ldg(row + w);
    while (v) {
      h ^= __ldg(cols + 64 * w + (__ffsll((long long)v) - 1));
      v &= v - 1;
    }
  }
  return h;
}

constexpr unsigned long long kEmpty = ~0ull;  // no index is 2^32 - 1

// h(v) = XOR of column i over the set bits i of the row
__global__ void __launch_bounds__(kHashThreads)
hash_rows(const int64_t* __restrict__ rows, int64_t n, int W, const uint32_t* __restrict__ cols,
          uint32_t* __restrict__ out) {
  for (int64_t i = (int64_t)blockIdx.x * kHashThreads + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * kHashThreads)
    out[i] = row_hash(rows + i * W, W, cols);
}

// one launch for everything that needs no group numbers: the state rows'
// hashes, the table emptied, the probe's block counter zeroed, and per
// sorted position i (term t = order[i]) z and the phase c'_t in sorted
// order and whether a new X part starts at i
__global__ void __launch_bounds__(kHashThreads)
prep(const int64_t* __restrict__ s, int64_t B, const uint32_t* __restrict__ cols,
     uint32_t* __restrict__ hs, unsigned long long* __restrict__ table, int64_t capacity,
     uint32_t* __restrict__ counter, const int64_t* __restrict__ x,
     const int64_t* __restrict__ z, const double* __restrict__ cr,
     const double* __restrict__ ci, const int64_t* __restrict__ order,
     const uint32_t* __restrict__ keys, int64_t T, int W, int64_t* __restrict__ zs,
     double* __restrict__ pr, double* __restrict__ pi, int32_t* __restrict__ flag) {
  const int64_t first = (int64_t)blockIdx.x * kHashThreads + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * kHashThreads;
  if (first == 0) counter[0] = 0;
  for (int64_t i = first; i < B; i += stride) hs[i] = row_hash(s + i * W, W, cols);
  for (int64_t i = first; i < capacity; i += stride) table[i] = kEmpty;
  for (int64_t i = first; i < T; i += stride) {
    const int64_t t = __ldg(order + i);
    const int64_t* xt = x + t * W;
    int y = 0;
    for (int w = 0; w < W; ++w) {
      const int64_t zw = __ldg(z + t * W + w);
      zs[i * W + w] = zw;
      y += __popcll((unsigned long long)(__ldg(xt + w) & zw));
    }
    // c_t (-i)^y = c_t i^(4 - y mod 4)
    const double r = __ldg(cr + t), m = __ldg(ci + t);
    double vr = r, vi = m;
    switch ((4 - (y & 3)) & 3) {
      case 1: vr = -m; vi = r; break;
      case 2: vr = -r; vi = -m; break;
      case 3: vr = m; vi = -r; break;
      default: break;
    }
    pr[i] = vr;
    pi[i] = vi;
    int start = i == 0 || __ldg(keys + i) != __ldg(keys + i - 1);
    if (!start) {
      const int64_t* xp = x + __ldg(order + i - 1) * W;
      for (int w = 0; w < W && !start; ++w) start = __ldg(xt + w) != __ldg(xp + w);
    }
    flag[i] = start;
  }
}

// one block: number the groups in order, a tile of kScanThreads flags at a
// time (a warp-shuffle scan, then one over the warps' totals); goff[g] =
// first sorted position of group g (goff[U] = T), gkey[g] its X hash,
// grow[g] a term carrying its X part, u[0] = U
__global__ void __launch_bounds__(kScanThreads)
number_groups(const int32_t* __restrict__ flag, const uint32_t* __restrict__ keys,
              const int64_t* __restrict__ order, int64_t T, int32_t* __restrict__ goff,
              uint32_t* __restrict__ gkey, int32_t* __restrict__ grow, int32_t* __restrict__ u) {
  __shared__ int32_t warp_sum[kScanThreads / 32];
  __shared__ int32_t carry;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int64_t base = 0; base < T; base += kScanThreads) {
    const int64_t i = base + threadIdx.x;
    const int32_t f = i < T ? flag[i] : 0;
    int32_t v = f;  // inclusive scan within the warp
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
    if (f) {
      const int32_t g = carry + (warp ? warp_sum[warp - 1] : 0) + v - 1;
      goff[g] = (int32_t)i;
      gkey[g] = keys[i];
      grow[g] = (int32_t)order[i];
    }
    __syncthreads();
    if (threadIdx.x == 0) carry += warp_sum[kScanThreads / 32 - 1];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    goff[carry] = (int32_t)T;
    u[0] = carry;
  }
}

__device__ __forceinline__ bool route_groups(int64_t U, int64_t B) {
  return U * B <= B * (B + 1) / 2;
}

// a slot: the key's hash above its index
__device__ __forceinline__ unsigned long long slot_of(uint32_t h, int64_t i) {
  return ((unsigned long long)h << 32) | (uint32_t)i;
}

// linear probing from h & mask, reading the slots 4 at a time (one 32-byte
// sector, capacity >= 4): match(index) of every key whose hash is h until
// match returns true or an empty slot ends the chain
template <class Match>
__device__ __forceinline__ void probe_chain(const unsigned long long* tb, uint32_t mask,
                                            uint32_t h, Match match) {
  for (uint32_t slot = h & mask;; slot = ((slot | 3u) + 1) & mask) {
    const uint32_t base = slot & ~3u;
    unsigned long long v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = tb[base + k];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (base + k < slot) continue;
      if (v[k] == kEmpty) return;
      if ((uint32_t)(v[k] >> 32) == h && match((int64_t)(uint32_t)v[k])) return;
    }
  }
}

// insert the keys of the route (state rows, or X groups) at the first free
// slot from their hash (an X part split over two groups by a hash
// collision is two entries)
__global__ void __launch_bounds__(kHashThreads)
build_table(const uint32_t* __restrict__ hs, int64_t B, const uint32_t* __restrict__ gkey,
            const int32_t* __restrict__ u, unsigned long long* __restrict__ table,
            uint32_t mask) {
  const int64_t U = u[0];
  const bool groups = route_groups(U, B);
  const uint32_t* hash = groups ? hs : gkey;
  const int64_t n = groups ? B : U;
  for (int64_t i = (int64_t)blockIdx.x * kHashThreads + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * kHashThreads) {
    const unsigned long long v = slot_of(hash[i], i);
    uint32_t slot = hash[i] & mask;
    while (atomicCAS(table + slot, kEmpty, v) != kEmpty) slot = (slot + 1) & mask;
  }
}

__device__ __forceinline__ bool row_is_xor(const int64_t* r, const int64_t* a, const int64_t* b,
                                           int W) {
  for (int w = 0; w < W; ++w)
    if (__ldg(r + w) != (__ldg(a + w) ^ __ldg(b + w))) return false;
  return true;
}

// sum over a group's terms of c'_t (-1)^{popc(row & z_t)}
__device__ __forceinline__ void group_sum(const int64_t* __restrict__ zs,
                                          const double* __restrict__ pr,
                                          const double* __restrict__ pi, int64_t t0,
                                          int64_t t1, const int64_t* row, int W, double& sr,
                                          double& si) {
  sr = si = 0.0;
#pragma unroll 4
  for (int64_t t = t0; t < t1; ++t) {
    int par = 0;
    for (int w = 0; w < W; ++w)
      par += __popcll((unsigned long long)(__ldg(row + w) & __ldg(zs + t * W + w)));
    const double r = __ldg(pr + t), i = __ldg(pi + t);
    sr += (par & 1) ? -r : r;
    si += (par & 1) ? -i : i;
  }
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

struct Operands {
  const int64_t* s;      // [B, W] state rows
  const double* ar;      // [B]
  const double* ai;
  const uint32_t* hs;    // [B] row hashes
  const int64_t* x;      // [T, W] the terms' X parts (original order)
  const int32_t* goff;   // [U + 1] groups in sorted positions
  const uint32_t* gkey;  // [U] X hash of each group
  const int32_t* grow;   // [U] a term carrying the group's X part
  const int32_t* u;      // [1] U
  const int64_t* zs;     // [T, W] in sorted order
  const double* pr;      // [T] phases c'_t in sorted order
  const double* pi;
  const unsigned long long* table;  // [mask + 1] slots
  uint32_t* counter;                // [1] blocks done
  uint32_t mask;
  int64_t B;
  int W;
};

// both routes; the route and U are read from the card.  Groups: flat
// p = g * B + b.  Pairs: flat p = d * B + b over d = 0 .. B / 2,
// b2 = (b + d) mod B (for even B the last offset takes b < B / 2 only,
// which p < B (B + 1) / 2 cuts off)
__global__ void __launch_bounds__(kThreads, 1)
expval_probe(Operands op, int staged, double* __restrict__ partial,
             double* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double red_r[kThreads], red_i[kThreads];
  const int64_t B = op.B;
  const int W = op.W;
  const int64_t U = op.u[0];
  const bool groups = route_groups(U, B);
  const double* AR = op.ar;
  const double* AI = op.ai;
  const uint32_t* HS = op.hs;
  const unsigned long long* TB = op.table;
  if (groups && staged) {
    auto* st = reinterpret_cast<unsigned long long*>(smem);
    double* sr = reinterpret_cast<double*>(st + op.mask + 1);
    double* si = sr + B;
    uint32_t* sh = reinterpret_cast<uint32_t*>(si + B);
    for (int64_t i = threadIdx.x; i < B; i += kThreads) {
      sr[i] = op.ar[i];
      si[i] = op.ai[i];
      sh[i] = op.hs[i];
    }
    for (int64_t i = threadIdx.x; i <= (int64_t)op.mask; i += kThreads) st[i] = op.table[i];
    __syncthreads();
    AR = sr;
    AI = si;
    HS = sh;
    TB = st;
  }
  double re = 0.0, im = 0.0;
  const int64_t n = groups ? U * B : B * (B + 1) / 2;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  int64_t p = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (p < n) {
    int64_t hi = p / B, b = p - hi * B;  // hi: the group g, or the offset d
    const int64_t dh = stride / B, db = stride - dh * B;
    for (; p < n; p += stride) {
      const int64_t* sb = op.s + b * W;
      if (groups) {
        const int64_t* xg = op.x + (int64_t)__ldg(op.grow + hi) * W;
        probe_chain(TB, op.mask, HS[b] ^ __ldg(op.gkey + hi), [&](int64_t e) {
          if (!row_is_xor(op.s + e * W, sb, xg, W)) return false;
          double cr, ci;
          group_sum(op.zs, op.pr, op.pi, __ldg(op.goff + hi), __ldg(op.goff + hi + 1),
                    op.s + e * W, W, cr, ci);
          // a_b conj(a_b')
          const double abr = AR[b], abi = AI[b], apr = AR[e], api = AI[e];
          const double mr = abr * apr + abi * api;
          const double mi = abi * apr - abr * api;
          re += cr * mr - ci * mi;
          im += cr * mi + ci * mr;
          return true;  // the state rows are distinct
        });
      } else {
        int64_t b2 = b + hi;
        if (b2 >= B) b2 -= B;
        const int64_t* sb2 = op.s + b2 * W;
        const bool diagonal = hi == 0;
        probe_chain(op.table, op.mask, __ldg(op.hs + b) ^ __ldg(op.hs + b2), [&](int64_t g) {
          if (!row_is_xor(op.x + (int64_t)__ldg(op.grow + g) * W, sb, sb2, W)) return false;
          const int64_t t0 = __ldg(op.goff + g), t1 = __ldg(op.goff + g + 1);
          const double abr = __ldg(op.ar + b), abi = __ldg(op.ai + b);
          const double apr = __ldg(op.ar + b2), api = __ldg(op.ai + b2);
          // b -> b2: target s_b2, a_b conj(a_b2)
          double cr, ci;
          group_sum(op.zs, op.pr, op.pi, t0, t1, sb2, W, cr, ci);
          const double mr = abr * apr + abi * api;
          const double mi = abi * apr - abr * api;
          re += cr * mr - ci * mi;
          im += cr * mi + ci * mr;
          if (!diagonal) {  // b2 -> b: target s_b, a_b2 conj(a_b) = conj(m)
            group_sum(op.zs, op.pr, op.pi, t0, t1, sb, W, cr, ci);
            re += cr * mr + ci * mi;
            im += ci * mr - cr * mi;
          }
          return false;  // an X part split over two groups matches twice
        });
      }
      b += db;
      hi += dh;
      if (b >= B) {
        b -= B;
        ++hi;
      }
    }
  }
  block_sum<kThreads>(red_r, red_i, re, im);
  // the last block to finish sums the block partials in block order
  __shared__ bool last;
  if (threadIdx.x == 0) {
    partial[2 * blockIdx.x] = re;
    partial[2 * blockIdx.x + 1] = im;
    __threadfence();
    last = atomicAdd(op.counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  re = im = 0.0;
  for (int i = threadIdx.x; i < (int)gridDim.x; i += kThreads) {
    re += __ldcg(partial + 2 * i);
    im += __ldcg(partial + 2 * i + 1);
  }
  block_sum<kThreads>(red_r, red_i, re, im);
  if (threadIdx.x == 0) {
    out[0] = re;
    out[1] = im;
  }
}

// the card's resident probe blocks (queried once per device)
cudaError_t resident_blocks(int64_t* out) {
  static int64_t cache[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (cache[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(expval_probe, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmemBudget);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, expval_probe, kThreads,
                                                          kSmemBudget);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cache[dev] = (int64_t)sms * per_sm;
  }
  *out = cache[dev];
  return cudaSuccess;
}

}  // namespace

// rows: int64[n, W]; cols: int32[64 W] hash columns; out: int32[n] = h(row).
extern "C" int symmer_state_hash(const void* rows, int64_t n, int64_t W, const void* cols,
                                 void* out, void* stream) {
  if (n < 1 || W < 1 || W > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  int64_t resident = 0;
  cudaError_t err = resident_blocks(&resident);
  if (err != cudaSuccess) return (int)err;
  hash_rows<<<grid_for(n, kHashThreads, 8 * resident), kHashThreads, 0,
              static_cast<cudaStream_t>(stream)>>>(static_cast<const int64_t*>(rows), n, (int)W,
                                                   static_cast<const uint32_t*>(cols),
                                                   static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}

// Bytes of symmer_state_expval's scratch: int64 zs [T, W] and table
// [capacity], float64 pr, pi [T] and partial [2 max_blocks], int32 hs [B],
// flag [T], goff [T + 1], gkey [T], grow [T], u [1] and counter [1], in
// that order.
extern "C" int64_t symmer_state_expval_scratch(int64_t B, int64_t W, int64_t T,
                                               int64_t capacity, int64_t max_blocks) {
  return 8 * (T * W + capacity + 2 * T + 2 * max_blocks) + 4 * (B + 4 * T + 3);
}

// s: int64[B, W] deduplicated state rows; ar, ai: float64[B]; x, z:
// int64[T, W]; cr, ci: float64[T]; order: int64[T] and keys: int32[T], the
// terms' X hashes sorted (keys) and where they came from (order); cols:
// int32[64 W]; capacity: the table's slots, a power of two >= 4 max(B, T);
// scratch: symmer_state_expval_scratch bytes, 8-byte aligned; out:
// float64[2] = (re, im).  B, T, W >= 1.
extern "C" int symmer_state_expval(const void* s, const void* ar, const void* ai, int64_t B,
                                   int64_t W, const void* x, const void* z, const void* cr,
                                   const void* ci, int64_t T, const void* order,
                                   const void* keys, const void* cols, void* scratch,
                                   int64_t capacity, int64_t max_blocks, void* out,
                                   void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const int64_t most = B > T ? B : T;
  if (B < 1 || T < 1 || W < 1 || W > 0x7FFFFFFF || max_blocks < 1 || capacity < 4 * most ||
      capacity > ((int64_t)1 << 31) || (capacity & (capacity - 1)) != 0 ||
      most > 0x3FFFFFFF)
    return (int)cudaErrorInvalidValue;
  int64_t resident = 0;
  cudaError_t err = resident_blocks(&resident);
  if (err != cudaSuccess) return (int)err;
  auto* zs = static_cast<int64_t*>(scratch);
  auto* table = reinterpret_cast<unsigned long long*>(zs + T * W);
  auto* pr = reinterpret_cast<double*>(table + capacity);
  double* pi = pr + T;
  double* partial = pi + T;
  auto* hs = reinterpret_cast<uint32_t*>(partial + 2 * max_blocks);
  auto* flag = reinterpret_cast<int32_t*>(hs + B);
  int32_t* goff = flag + T;
  auto* gkey = reinterpret_cast<uint32_t*>(goff + T + 1);
  auto* grow = reinterpret_cast<int32_t*>(gkey + T);
  int32_t* u = grow + T;
  auto* counter = reinterpret_cast<uint32_t*>(u + 1);
  const auto* k32 = static_cast<const uint32_t*>(keys);
  const auto* ord = static_cast<const int64_t*>(order);
  const int64_t spread = 8 * resident;

  prep<<<grid_for(most > capacity ? most : capacity, kHashThreads, spread), kHashThreads, 0,
         st>>>(static_cast<const int64_t*>(s), B, static_cast<const uint32_t*>(cols), hs, table,
               capacity, counter, static_cast<const int64_t*>(x),
               static_cast<const int64_t*>(z), static_cast<const double*>(cr),
               static_cast<const double*>(ci), ord, k32, T, (int)W, zs, pr, pi, flag);
  number_groups<<<1, kScanThreads, 0, st>>>(flag, k32, ord, T, goff, gkey, grow, u);
  const uint32_t mask = (uint32_t)(capacity - 1);
  build_table<<<grid_for(most, kHashThreads, spread), kHashThreads, 0, st>>>(hs, B, gkey, u,
                                                                           table, mask);
  Operands op{static_cast<const int64_t*>(s), static_cast<const double*>(ar),
              static_cast<const double*>(ai), hs, static_cast<const int64_t*>(x), goff, gkey,
              grow, u, zs, pr, pi, table, counter, mask, B, (int)W};
  // the groups route's table, hashes and amplitudes in shared memory where
  // they fit (the route itself is chosen on the card)
  const size_t staged_bytes = (size_t)B * 20 + (size_t)capacity * 8;
  const int staged = staged_bytes <= kSmemBudget;
  if (resident > max_blocks) resident = max_blocks;
  // enough blocks for the larger of the two routes' pair counts
  const int64_t pairs = B * (B + 1) / 2;
  const unsigned blocks = grid_for(T * B > pairs ? T * B : pairs, kThreads, resident);
  expval_probe<<<blocks, kThreads, staged ? staged_bytes : 0, st>>>(
      op, staged, partial, static_cast<double*>(out));
  return (int)cudaGetLastError();
}
