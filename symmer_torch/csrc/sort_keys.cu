// The cleanup's sort (K17), for Hopper (sm_90a): a stable ascending argsort
// of int64 keys in signed order, with the sorted keys.
//
// Replaces the sorts of symmer_tpu/kernels/jx_core.py:cleanup_sorted (the
// jnp.lexsort at :303, the lax.sort calls at :448-517) and of the port's
// plain composition (torch_core._lexsort: two torch.argsort(stable=True)
// and two gathers).  The cleanups sort by the first signature key ka alone
// (torch_core._merge_sorted): K3 (merge_groups.cu) needs only that equal
// signatures end up adjacent and keep their input order, and it reports the
// one case where a sort by ka alone does not give that (two signatures that
// share ka, a 64-bit collision); that case sorts by kb, then stably by ka,
// with this kernel twice.  Input: keys: int64[T], 1 <= T < 2^31.  Outputs:
// perm: int32[T], bit for bit torch.argsort(keys, stable=True), and the
// sorted keys keys[perm] (torch_core.sort_keys, the plain version).
//
// What bounds it: latency, then bytes.  The function moves 20 bytes a key
// (a key read, its index and sorted key written: chip_smoke.py's
// sort_bound); an LSD radix sort moves a key and its index once a digit
// pass, and on this card each pass is a chain of dependent steps per tile
// (load, rank, look back, scatter) that costs about the same at any size
// up to a wave, so eight passes cost eight chains.  This design makes three
// launches (and a memset) whatever the keys, and moves each key and index
// twice: the histograms read the keys (8 bytes a key), the partition writes
// the keys and indices (8 + 12), the buckets read and write them (24).
// The keys it is built for are hashes (row_signature.cuh's mixed lanes),
// spread evenly over int64, so the top 8 bits split them into 256 buckets
// of about T / 256 keys that each fit one block's shared memory.  Digits
// are of u = key ^ 2^63 (the sign bit flipped: unsigned order of u is
// signed order of the key).
//   1. Histograms (sort_histogram_kernel): one read of the keys counts the
//      bins of all eight 8-bit digits (each block in shared memory, then
//      one global atomic a bin) and zeroes the partition's status words.
//   2. Partition (sort_partition_kernel): a stable onesweep pass on the
//      split digit d*, the highest digit on which the keys differ, which
//      every block reads from the histograms on the card (digit p is
//      constant iff the bin of key 0's digit p holds all T keys).  A block
//      takes its tile (kThreads x kItems keys in input order) by a ticket,
//      ranks its keys stably in shared memory (a warp ranks 32 keys at a
//      time, the lanes of one digit found by one ballot a digit bit, a
//      counter a warp and digit), publishes its digits' counts, looks back
//      over its predecessors' status words kWindow tiles at a time
//      (look_back.cuh's words), and scatters the keys and their indices to
//      the outputs (a bucket that step 3 sorts through global memory to the
//      scratch).  Hash keys split on the top digit; small integers on a
//      low one; if no digit varies, this is the identity.
//   3. Buckets (sort_bucket_kernel): block b takes bucket b of d* (its
//      place: the exclusive scan of d*'s histogram) and sorts it by the
//      bits below d* into that place in the outputs.  Nothing to do where
//      d* is the lowest varying digit (the partition sorted every key), for
//      buckets of one key, and for on-chip buckets of equal keys.  Routes,
//      chosen by the block
//      from the bucket's size and keys:
//      - on chip (at most kThreads x kN keys, kN from T so that hash keys'
//        largest bucket fits): the bucket goes to shared memory; a range's
//        varying bits are the OR of its keys' XOR with its first key.  A
//        range of equal keys is in place already; a range of at most
//        kCompare keys is ranked by comparison, each key's place the count
//        of smaller keys plus equal keys before it (exact and stable);
//        a larger one takes one stable radix step on its top 8 varying bits
//        (the same warp ranking as the partition), after which each
//        sub-range of at most kCompare keys is ranked by comparison and each
//        larger one is pushed on a stack of ranges to be refined the same
//        way.  Each step leaves its sub-ranges fewer varying bits, so a key
//        takes at most eight steps; at 200,000 hash keys a bucket of ~781
//        keys takes one step and sub-ranges of ~3 keys.
//      - through global memory (a bucket larger than that: skewed keys,
//        or more than ~1.4 million hash keys): an LSD sort of the bucket by
//        one block, one pass for each window of up to 8 varying bits (the
//        lowest varying bit first; only the bucket's varying bits), each a
//        walk over tiles of kThreads x kN keys with running bin bases.  The
//        partition puts such a bucket in the scratch (it reads the bucket
//        sizes from the histogram too), so an odd number of passes ends in
//        the outputs with no copy.  One sweep finds the varying bits, one
//        counts the first window's bins, and each pass counts the next
//        window's bins as it writes its keys.  Bounded (at most eight
//        passes), but one block's work: a bucket of 80,000 keys takes about
//        0.15 ms, so skew far from the hash keys it is built for costs time,
//        not bits (PERF.md).
//   Up to kSmallKeys keys, one launch of one block runs step 3's on-chip
//   route on all keys (no histogram, no partition).
// Latency is what the code is shaped by: every loop over a tile or a bucket
// issues all its loads (kItems, kN or kStream a thread) before it uses any,
// which halved a through-memory tile's time on the card.
// The ranks and places are exact integers: the output is the same on every
// run, whichever block draws which ticket and in whatever order a block's
// stack is filled.  No allocation and no host synchronisation: the wrapper
// (kernels/cuda.py) allocates the outputs and the scratch; the one memset
// zeroes the histograms and the ticket.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "look_back.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint64_t kSign = 1ull << 63;
constexpr int kBits = 8;  // a digit: the histograms' and the partition's, and a radix step's most
constexpr int kBins = 1 << kBits;
constexpr int kDigits = 64 / kBits;
constexpr int kItems = 8;  // keys a thread holds in a partition tile
constexpr int kTile = kThreads * kItems;
constexpr int kWindow = 16;      // status words of one bin a look-back step reads
constexpr int kSmallItems = 16;  // keys a thread holds in the one-block route
constexpr int64_t kSmallKeys = (int64_t)kThreads * kSmallItems;
constexpr int kCompare = 64;  // a range of at most this many keys is ranked by comparison
constexpr int kStream = 16;   // keys a thread loads at once in a sweep over a bucket
static_assert(kBins == kThreads, "a thread owns one bin");

__device__ __forceinline__ int digit_of(uint64_t u, int shift, int width) {
  return (int)((u >> shift) & ((1ull << width) - 1ull));
}

// Shared memory of a block that holds n keys: the keys and their indices,
// the stack of ranges still to refine (disjoint, each of more than kCompare
// keys, so at most n / (kCompare + 1) of them), the warps' counters (uint16,
// a warp and bin), the exclusive bin starts of a ranked tile (and the tile's
// size after them), the bins' bases, the next window's bin counts, the block
// reductions' warp words, the stack's top.
struct Smem {
  __host__ __device__ static int slots(int n) { return n / (kCompare + 1) + 1; }
  static size_t bytes(int n) {
    return (size_t)n * 12 + (size_t)slots(n) * 8 + (size_t)kWarps * 8 + (size_t)kWarps * kBins * 2 +
           (3 * (size_t)kBins + 1) * 4 + (size_t)kWarps * 4 + 4;
  }
  uint64_t* key;
  unsigned long long* warp_or;
  int2* stack;
  int* val;
  uint16_t* cnt;
  int* start;
  int* base;
  int* next;
  int* warp_sum;
  int* top;
  __device__ Smem(unsigned char* p, int n) {
    key = reinterpret_cast<uint64_t*>(p);  // 8-byte words first
    warp_or = reinterpret_cast<unsigned long long*>(key + n);
    stack = reinterpret_cast<int2*>(warp_or + kWarps);
    val = reinterpret_cast<int*>(stack + slots(n));
    cnt = reinterpret_cast<uint16_t*>(val + n);
    start = reinterpret_cast<int*>(cnt + kWarps * kBins);
    base = start + kBins + 1;
    next = base + kBins;
    warp_sum = next + kBins;
    top = warp_sum + kWarps;
  }
};

// Exclusive sum over the block of one int a thread.
__device__ __forceinline__ int block_exclusive_sum(int v, int* warp_sum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += n;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  int before = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) before += w < warp ? warp_sum[w] : 0;
  __syncthreads();  // warp_sum is free again
  return before + incl - v;
}

// OR over the block of one word a thread.
__device__ __forceinline__ uint64_t block_or(uint64_t v, Smem& s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v |= __shfl_xor_sync(kFull, v, o);
  if ((threadIdx.x & 31) == 0) s.warp_or[threadIdx.x >> 5] = v;
  __syncthreads();
  uint64_t r = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) r |= s.warp_or[w];
  __syncthreads();
  return r;
}

// Ranks a tile's keys by the digit (shift, width), stably.  Key r < rounds
// of lane l of warp w is the tile's key w * 32 * rounds + r * 32 + l (ok
// bit r: it exists).  On return rank[r] is the key's place among its warp's
// keys of its digit, and s.cnt[w][d] holds warp w's count of digit d.
template <int kN>
__device__ __forceinline__ void warp_rank(const uint64_t (&u)[kN], unsigned ok, int rounds,
                                          int shift, int width, Smem& s, int (&rank)[kN]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  uint16_t* cnt = s.cnt + warp * kBins;
#pragma unroll
  for (int r = 0; r < kN; ++r) {
    if (r >= rounds) break;
    const bool valid = (ok >> r) & 1u;
    const int d = digit_of(u[r], shift, width);
    unsigned peers = __ballot_sync(kFull, valid);  // the lanes of this key's digit
    for (int b = 0; b < width; ++b) {
      const bool bit = (d >> b) & 1;
      const unsigned m = __ballot_sync(kFull, bit);
      peers &= bit ? m : ~m;
    }
    const int old = valid ? cnt[d] : 0;
    __syncwarp();
    if (valid && lane == __ffs(peers) - 1) cnt[d] = (uint16_t)(old + __popc(peers));
    __syncwarp();
    rank[r] = old + __popc(peers & below);
  }
}

// A stable ranking of a tile of n keys (laid out as warp_rank takes them)
// by the digit (shift, width): on return rank[r] is each key's place among
// its warp's keys of its digit, s.cnt[w][d] warp w's exclusive offset in
// digit d, s.start[d] each digit's exclusive start in the tile
// (s.start[kBins] = n), and the block has passed a barrier; returns the
// tile's count of digit threadIdx.x.  A key's place in the tile in digit
// order is then place_in_tile.
template <int kN>
__device__ __forceinline__ int rank_tile(const uint64_t (&u)[kN], unsigned ok, int rounds, int n,
                                         int shift, int width, Smem& s, int (&rank)[kN]) {
  const int t = threadIdx.x;
  for (int i = t; i < kWarps * kBins / 2; i += kThreads) reinterpret_cast<unsigned*>(s.cnt)[i] = 0;
  __syncthreads();
  warp_rank<kN>(u, ok, rounds, shift, width, s, rank);
  __syncthreads();
  int c = 0;  // digit t: the warps' exclusive offsets, the tile's count
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int k = s.cnt[w * kBins + t];
    s.cnt[w * kBins + t] = (uint16_t)c;
    c += k;
  }
  s.start[t] = block_exclusive_sum(c, s.warp_sum);
  if (t == 0) s.start[kBins] = n;
  __syncthreads();
  return c;
}

// The place in its tile, in digit order, of a key of digit d and rank
// `rank` (rank_tile) held by warp `warp`.
__device__ __forceinline__ int place_in_tile(const Smem& s, int warp, int d, int rank) {
  return s.start[d] + s.cnt[warp * kBins + d] + rank;
}

// The split digit d* (the highest digit on which the keys differ; -1 where
// every key is equal), and in *below whether any digit below it differs.
// Digit p is constant iff the bin of key 0's digit p holds all T keys.
__device__ __forceinline__ int split_digit(const int64_t* keys, int64_t T,
                                           const unsigned* hist, bool* below) {
  const uint64_t u0 = (uint64_t)keys[0] ^ kSign;
  int top = -1;
  bool low = false;
  for (int p = kDigits - 1; p >= 0; --p) {
    if (hist[p * kBins + digit_of(u0, p * kBits, kBits)] != (unsigned)T) {
      low = top >= 0;
      if (top < 0) top = p;
      if (low) break;
    }
  }
  *below = low;
  return top;
}

// Key p of the shared-memory range [a, e) to its place in dst: with `equal`
// (every key of the range equal) its own place, else a + the count of the
// range's smaller keys and of its equal keys before p.
__device__ __forceinline__ void place(int p, int a, int e, bool equal, const Smem& s,
                                      int64_t* dst_keys, int* dst_vals) {
  const uint64_t k = s.key[p];
  int at = p;
  if (!equal) {
    int rank = 0;
    for (int j = a; j < e; ++j) {
      const uint64_t q = s.key[j];
      rank += (q < k) | ((q == k) & (j < p));
    }
    at = a + rank;
  }
  dst_keys[at] = (int64_t)(k ^ kSign);
  dst_vals[at] = s.val[p];
}

// Sorts n <= kThreads x kN keys stably in shared memory (the on-chip route):
// src_keys[i] with the index src_vals[i] (i where src_vals is null) to
// dst_keys / dst_vals, which may be the source.
template <int kN>
__device__ void sort_on_chip(const int64_t* src_keys, const int* src_vals, int n, int64_t* dst_keys,
                             int* dst_vals, Smem& s) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  for (int i0 = 0; i0 < n; i0 += kThreads * kStream) {  // kStream loads a thread in flight
    int64_t k[kStream];
    int v[kStream];
#pragma unroll
    for (int j = 0; j < kStream; ++j) {
      const int i = i0 + j * kThreads + t;
      if (i < n) {
        k[j] = src_keys[i];
        v[j] = src_vals != nullptr ? src_vals[i] : i;
      }
    }
#pragma unroll
    for (int j = 0; j < kStream; ++j) {
      const int i = i0 + j * kThreads + t;
      if (i < n) {
        s.key[i] = (uint64_t)k[j] ^ kSign;
        s.val[i] = v[j];
      }
    }
  }
  if (t == 0) {
    s.stack[0] = make_int2(0, n);
    *s.top = 1;
  }
  __syncthreads();
  for (;;) {
    const int top = *s.top;
    if (top == 0) break;
    const int2 range = s.stack[top - 1];
    const int lo = range.x, hi = range.y, m = hi - lo;
    uint64_t diff = 0;
    const uint64_t u0 = s.key[lo];
    for (int i = lo + t; i < hi; i += kThreads) diff |= s.key[i] ^ u0;
    const uint64_t mask = block_or(diff, s);  // (its barriers: every thread has read the top)
    if (t == 0) *s.top = top - 1;
    if (mask == 0 || m <= kCompare) {
      for (int p = lo + t; p < hi; p += kThreads) place(p, lo, hi, mask == 0, s, dst_keys, dst_vals);
      __syncthreads();
      continue;
    }
    // one radix step on the range's top varying bits
    const int h = 63 - __clzll((long long)mask);
    const int shift = h >= kBits - 1 ? h - (kBits - 1) : 0, width = h - shift + 1;
    const int rounds = (m + kThreads - 1) / kThreads;
    uint64_t u[kN];
    int v[kN], rank[kN];
    unsigned ok = 0;
#pragma unroll
    for (int r = 0; r < kN; ++r) {
      const int i = warp * 32 * rounds + r * 32 + lane;
      u[r] = 0;
      v[r] = 0;
      if (r < rounds && i < m) {
        ok |= 1u << r;
        u[r] = s.key[lo + i];
        v[r] = s.val[lo + i];
      }
    }
    rank_tile<kN>(u, ok, rounds, m, shift, width, s, rank);  // (every key read before any moves)
#pragma unroll
    for (int r = 0; r < kN; ++r) {
      if ((ok >> r) & 1u) {
        const int at = lo + place_in_tile(s, warp, digit_of(u[r], shift, width), rank[r]);
        s.key[at] = u[r];
        s.val[at] = v[r];
      }
    }
    __syncthreads();
    // each sub-range: in place (equal keys: the step reached bit 0), ranked
    // by comparison, or pushed to be refined
    for (int p = lo + t; p < hi; p += kThreads) {
      const int d = digit_of(s.key[p], shift, width);
      const int a = lo + s.start[d], e = lo + s.start[d + 1];
      if (shift == 0 || e - a <= kCompare) {
        place(p, a, e, shift == 0, s, dst_keys, dst_vals);
      } else if (p == a) {
        s.stack[atomicAdd(s.top, 1)] = make_int2(a, e);
      }
    }
    __syncthreads();
  }
}

// Sorts the n keys and indices of tkeys / tvals (where the partition put
// a bucket larger than the block's shared memory) stably into keys / vals
// through global memory: an LSD pass for each window of up to kBits of the
// keys' varying bits, lowest first, ping-ponging between the two; an even
// number of passes (none for equal keys) ends with a copy.
template <int kN>
__device__ void sort_through_memory(int64_t* keys, int* vals, int64_t* tkeys, int* tvals, int n,
                                    Smem& s) {
  constexpr int kTileN = kThreads * kN;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  // the bucket's varying bits
  const int64_t k0 = tkeys[0];
  uint64_t diff = 0;
  for (int i0 = 0; i0 < n; i0 += kThreads * kStream) {  // kStream loads a thread in flight
    int64_t k[kStream];
#pragma unroll
    for (int j = 0; j < kStream; ++j) {
      const int i = i0 + j * kThreads + t;
      k[j] = i < n ? tkeys[i] : k0;
    }
#pragma unroll
    for (int j = 0; j < kStream; ++j) diff |= (uint64_t)(k[j] ^ k0);
  }
  uint64_t mask = block_or(diff, s);
  int64_t *src_k = tkeys, *dst_k = keys;
  int *src_v = tvals, *dst_v = vals;
  // the first window's bin counts over the bucket; each later window's are
  // counted while the pass before it writes its keys out
  int shift = __ffsll((long long)mask) - 1, width = 64 - shift < kBits ? 64 - shift : kBits;
  s.next[t] = 0;
  __syncthreads();
  for (int i0 = 0; mask != 0 && i0 < n; i0 += kThreads * kStream) {
    int64_t k[kStream];
#pragma unroll
    for (int j = 0; j < kStream; ++j) {
      const int i = i0 + j * kThreads + t;
      k[j] = i < n ? src_k[i] : 0;
    }
#pragma unroll
    for (int j = 0; j < kStream; ++j)
      if (i0 + j * kThreads + t < n) atomicAdd(s.next + digit_of((uint64_t)k[j] ^ kSign, shift, width), 1);
  }
  while (mask != 0) {
    mask = shift + width >= 64 ? 0 : mask & (~0ull << (shift + width));
    const int next_shift = mask != 0 ? __ffsll((long long)mask) - 1 : 0;
    const int next_width = mask != 0 && 64 - next_shift < kBits ? 64 - next_shift : kBits;
    __syncthreads();
    // the exclusive scan of the window's counts starts each bin's running base
    int next = block_exclusive_sum(s.next[t], s.warp_sum);
    s.next[t] = 0;
    for (int t0 = 0; t0 < n; t0 += kTileN) {
      const int nn = n - t0 < kTileN ? n - t0 : kTileN;
      const int rounds = (nn + kThreads - 1) / kThreads;
      uint64_t u[kN];
      int v[kN], rank[kN];
      unsigned ok = 0;
#pragma unroll
      for (int r = 0; r < kN; ++r) {  // every load in flight before any is used
        if (r >= rounds) break;
        const int i = warp * 32 * rounds + r * 32 + lane;
        ok |= (unsigned)(i < nn) << r;
        const int at = t0 + (i < nn ? i : 0);
        u[r] = (uint64_t)src_k[at];
        v[r] = src_v[at];
      }
#pragma unroll
      for (int r = 0; r < kN; ++r)
        if (r < rounds) u[r] ^= kSign;
      const int count = rank_tile<kN>(u, ok, rounds, nn, shift, width, s, rank);
      s.base[t] = next - s.start[t];
      next += count;
#pragma unroll
      for (int r = 0; r < kN; ++r) {
        if ((ok >> r) & 1u) {
          const int at = place_in_tile(s, warp, digit_of(u[r], shift, width), rank[r]);
          s.key[at] = u[r];
          s.val[at] = v[r];
        }
      }
      __syncthreads();
      for (int i = t; i < nn; i += kThreads) {
        const uint64_t k = s.key[i];
        const int g = s.base[digit_of(k, shift, width)] + i;
        dst_k[g] = (int64_t)(k ^ kSign);
        dst_v[g] = s.val[i];
        if (mask != 0) atomicAdd(s.next + digit_of(k, next_shift, next_width), 1);
      }
      __syncthreads();  // the tile's keys and bases are free
    }
    shift = next_shift;
    width = next_width;
    int64_t* k = src_k;
    src_k = dst_k;
    dst_k = k;
    int* v = src_v;
    src_v = dst_v;
    dst_v = v;
  }
  if (src_k != keys) {  // an even number of passes: the keys are in tkeys
    for (int i0 = 0; i0 < n; i0 += kThreads * kStream) {
      int64_t k[kStream];
      int v[kStream];
#pragma unroll
      for (int j = 0; j < kStream; ++j) {
        const int i = i0 + j * kThreads + t;
        if (i < n) {
          k[j] = tkeys[i];
          v[j] = tvals[i];
        }
      }
#pragma unroll
      for (int j = 0; j < kStream; ++j) {
        const int i = i0 + j * kThreads + t;
        if (i < n) {
          keys[i] = k[j];
          vals[i] = v[j];
        }
      }
    }
  }
}

// The keys of bin b in the tiles before `tile` plus the bin's global start:
// the walk back over the predecessors' status words of bin b (kWindow tiles
// a step, waiting until every word of the step is published in this call)
// to the nearest inclusive prefix.
__device__ __forceinline__ int64_t bin_look_back(const unsigned long long* status, int64_t tile,
                                                 int b, uint64_t epoch) {
  int64_t before = 0;
  for (int64_t j = tile - 1;; j -= kWindow) {
    uint64_t w[kWindow];
    bool ready;
    do {
      ready = true;
#pragma unroll
      for (int r = 0; r < kWindow; ++r) {
        const int64_t p = j - r;
        w[r] = p >= 0 ? load_status(status + p * kBins + b) : ((epoch << 34) | kPrefix);
        ready &= (w[r] >> 34) == epoch && (w[r] & kFlags) != 0;
      }
    } while (!ready);
#pragma unroll
    for (int r = 0; r < kWindow; ++r) {
      before += (uint32_t)w[r];
      if ((w[r] & kFlags) == kPrefix) return before;
    }
  }
}

// The digit histograms (hist: uint32[kDigits][kBins], zeroed before the
// launch), and the partition's status words zeroed.
__global__ void __launch_bounds__(kThreads)
sort_histogram_kernel(const int64_t* __restrict__ keys, int64_t T, unsigned* __restrict__ hist,
                      unsigned long long* __restrict__ status, int64_t status_words) {
  extern __shared__ unsigned s_hist[];  // [kDigits][kBins]
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t g = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  for (int i = threadIdx.x; i < kDigits * kBins; i += kThreads) s_hist[i] = 0;
  for (int64_t i = g; i < status_words; i += stride) status[i] = 0;
  __syncthreads();
  for (int64_t i0 = g; i0 < T; i0 += kStream * stride) {  // kStream loads a thread in flight
    int64_t k[kStream];
#pragma unroll
    for (int j = 0; j < kStream; ++j) k[j] = i0 + j * stride < T ? __ldg(keys + i0 + j * stride) : 0;
#pragma unroll
    for (int j = 0; j < kStream; ++j) {
      if (i0 + j * stride >= T) break;
      const uint64_t u = (uint64_t)k[j] ^ kSign;
#pragma unroll
      for (int p = 0; p < kDigits; ++p)
        atomicAdd(s_hist + p * kBins + digit_of(u, p * kBits, kBits), 1u);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kDigits * kBins; i += kThreads)
    if (s_hist[i]) atomicAdd(hist + i, s_hist[i]);
}

// The stable partition on the split digit over tiles of kTile keys in input
// order: keys to keys_out, their indices to vals_out, but a bucket of more
// than `cap` keys that the bucket launch sorts (one that it sorts through
// global memory) to keys_tmp, vals_tmp; status: the words of a tile and
// bin (zeroed by the histogram launch; this pass's epoch is 1).
__global__ void __launch_bounds__(kThreads)
sort_partition_kernel(const int64_t* __restrict__ keys, int64_t T, const unsigned* __restrict__ hist,
                      unsigned long long* ticket, unsigned long long* status, int cap,
                      int64_t* __restrict__ keys_out, int* __restrict__ vals_out,
                      int64_t* __restrict__ keys_tmp, int* __restrict__ vals_tmp) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_split;
  __shared__ bool s_below;
  Smem s(smem, kTile);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0) {
    bool below;
    const int d = split_digit(keys, T, hist, &below);
    s_split = d > 0 ? d : 0;  // no digit varies: any digit gives the identity
    s_below = d > 0 && below;  // the bucket launch has work
  }
  const int64_t tile = draw_ticket(ticket);  // (its barrier publishes s_split)
  constexpr uint64_t kEpoch = 1;
  const int shift = s_split * kBits;
  const unsigned* h = hist + s_split * kBins;
  const int64_t t0 = tile * kTile;
  const int n = (int)(T - t0 < kTile ? T - t0 : kTile);
  uint64_t u[kItems];
  int rank[kItems];
  unsigned ok = 0;
#pragma unroll
  for (int r = 0; r < kItems; ++r) {  // every load in flight before any is used
    const int i = warp * 32 * kItems + r * 32 + lane;
    ok |= (unsigned)(i < n) << r;
    u[r] = (uint64_t)__ldg(keys + t0 + (i < n ? i : 0));
  }
#pragma unroll
  for (int r = 0; r < kItems; ++r) u[r] ^= kSign;
  const int count = rank_tile<kItems>(u, ok, kItems, n, shift, kBits, s, rank);
  // publish the tile's count of digit t, look back, publish its prefix
  int64_t base;
  if (tile == 0) {
    base = block_exclusive_sum((int)h[t], s.warp_sum);  // the digit's global start
    store_status(status + t, (kEpoch << 34) | kPrefix | (uint32_t)(base + count));
  } else {
    store_status(status + tile * kBins + t, (kEpoch << 34) | kCount | (uint32_t)count);
    base = bin_look_back(status, tile, t, kEpoch);
    store_status(status + tile * kBins + t, (kEpoch << 34) | kPrefix | (uint32_t)(base + count));
  }
  s.base[t] = (int)base - s.start[t];
  s.next[t] = s_below && h[t] > (unsigned)cap;  // bin t's bucket goes to the scratch
  // The keys in digit order in shared memory, then out to their places.
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    if ((ok >> r) & 1u) {
      const int at = place_in_tile(s, warp, digit_of(u[r], shift, kBits), rank[r]);
      s.key[at] = u[r];
      s.val[at] = (int)(t0 + warp * 32 * kItems + r * 32 + lane);
    }
  }
  __syncthreads();
  for (int i = t; i < n; i += kThreads) {
    const uint64_t k = s.key[i];
    const int d = digit_of(k, shift, kBits);
    const int64_t g = (int64_t)s.base[d] + i;
    (s.next[d] ? keys_tmp : keys_out)[g] = (int64_t)(k ^ kSign);
    (s.next[d] ? vals_tmp : vals_out)[g] = s.val[i];
  }
}

// Bucket blockIdx.x of the split digit, sorted in place in keys_out /
// vals_out by the bits below the split digit: on chip where it holds at
// most kThreads x kN keys, else through global memory with keys_tmp /
// vals_tmp.
template <int kN>
__global__ void __launch_bounds__(kThreads, 2)  // two blocks an SM: 256 buckets in one wave
sort_bucket_kernel(const int64_t* __restrict__ keys, int64_t T, const unsigned* __restrict__ hist,
                   int64_t* keys_out, int* vals_out, int64_t* keys_tmp, int* vals_tmp) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_split, s_start;
  __shared__ bool s_below;
  const int t = threadIdx.x, b = blockIdx.x;
  if (t == 0) {
    bool below;
    s_split = split_digit(keys, T, hist, &below);
    s_below = below;
  }
  __syncthreads();
  if (s_split <= 0 || !s_below) return;  // the partition sorted every key
  const unsigned* h = hist + s_split * kBins;
  const int n = (int)h[b];
  if (n <= 1) return;
  Smem s(smem, kThreads * kN);
  const int before = block_exclusive_sum((int)h[t], s.warp_sum);
  if (t == b) s_start = before;
  __syncthreads();
  const int at = s_start;
  if (n <= kThreads * kN)
    sort_on_chip<kN>(keys_out + at, vals_out + at, n, keys_out + at, vals_out + at, s);
  else
    sort_through_memory<kN>(keys_out + at, vals_out + at, keys_tmp + at, vals_tmp + at, n, s);
}

// Up to kSmallKeys keys: the on-chip route on every key, one block.
__global__ void __launch_bounds__(kThreads)
sort_small_kernel(const int64_t* __restrict__ keys, int n, int64_t* __restrict__ keys_out,
                  int* __restrict__ vals_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  Smem s(smem, (int)kSmallKeys);
  sort_on_chip<kSmallItems>(keys, nullptr, n, keys_out, vals_out, s);
}

int64_t tiles(int64_t T) { return (T + kTile - 1) / kTile; }

// Keys a thread of the bucket launch holds (its on-chip capacity is
// kThreads times that): 16, unless hash keys' largest bucket (the mean T /
// 256 plus five standard deviations, plus 64) may pass 4,096 keys; then 24.
// Both run two blocks an SM (128 registers a thread); 24 is the slower
// where 16 suffices (80 KB of shared memory a block against 55 KB).
int bucket_items(int64_t T) {
  const double mean = (double)T / kBins;
  return mean + 5.0 * std::sqrt(mean) + 64.0 <= 16.0 * kThreads ? 16 : 24;
}

cudaError_t allow(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int kN>
cudaError_t launch_buckets(const int64_t* keys, int64_t T, const unsigned* hist, int64_t* keys_out,
                           int* vals_out, int64_t* keys_tmp, int* vals_tmp, cudaStream_t st) {
  const size_t bytes = Smem::bytes(kThreads * kN);
  cudaError_t err = allow((const void*)sort_bucket_kernel<kN>, bytes);
  if (err != cudaSuccess) return err;
  sort_bucket_kernel<kN><<<kBins, kThreads, bytes, st>>>(keys, T, hist, keys_out, vals_out,
                                                         keys_tmp, vals_tmp);
  return cudaGetLastError();
}

}  // namespace

// int64 words of scratch symmer_sort_keys needs for T keys (0: the one-block
// route): the histograms (uint32[kDigits][kBins]), the partition's ticket,
// its status words (a tile and bin).
extern "C" int64_t symmer_sort_keys_scratch(int64_t T) {
  if (T <= kSmallKeys) return 0;
  return kDigits * kBins / 2 + 1 + tiles(T) * kBins;
}

// Launches a call makes for T keys: none for one key, one up to kSmallKeys,
// else three (and a memset).
extern "C" int64_t symmer_sort_keys_launches(int64_t T) {
  return T <= 1 ? 0 : T <= kSmallKeys ? 1 : 3;
}

// keys: int64[T] (1 <= T < 2^31); keys_out: int64[T], vals_out: int32[T]
// (the sorted keys and perm); keys_tmp: int64[T], vals_tmp: int32[T] and
// scratch: int64[symmer_sort_keys_scratch(T)] (all three unused by the
// one-block route).  Nothing overlaps.
extern "C" int symmer_sort_keys(const void* keys_v, int64_t T, void* keys_out_v, void* vals_out_v,
                                void* keys_tmp_v, void* vals_tmp_v, void* scratch_v,
                                void* stream) {
  if (T < 1 || T >= (int64_t(1) << 31)) return (int)cudaErrorInvalidValue;
  const auto* keys = static_cast<const int64_t*>(keys_v);
  auto* keys_out = static_cast<int64_t*>(keys_out_v);
  auto* vals_out = static_cast<int*>(vals_out_v);
  auto* keys_tmp = static_cast<int64_t*>(keys_tmp_v);
  auto* vals_tmp = static_cast<int*>(vals_tmp_v);
  auto* scratch = static_cast<int64_t*>(scratch_v);
  const auto st = static_cast<cudaStream_t>(stream);
  if (T <= kSmallKeys) {
    const size_t bytes = Smem::bytes((int)kSmallKeys);
    cudaError_t err = allow((const void*)sort_small_kernel, bytes);
    if (err != cudaSuccess) return (int)err;
    sort_small_kernel<<<1, kThreads, bytes, st>>>(keys, (int)T, keys_out, vals_out);
    return (int)cudaGetLastError();
  }
  auto* hist = reinterpret_cast<unsigned*>(scratch);
  auto* ticket = reinterpret_cast<unsigned long long*>(scratch + kDigits * kBins / 2);
  auto* status = ticket + 1;
  const int64_t blocks = tiles(T);
  cudaError_t err = cudaMemsetAsync(scratch, 0, (kDigits * kBins / 2 + 1) * 8, st);
  if (err != cudaSuccess) return (int)err;
  const size_t hbytes = (size_t)kDigits * kBins * 4;
  if ((err = allow((const void*)sort_histogram_kernel, hbytes)) != cudaSuccess) return (int)err;
  const int64_t hblocks = blocks < 2 * device_sms() ? blocks : 2 * device_sms();
  sort_histogram_kernel<<<(unsigned)hblocks, kThreads, hbytes, st>>>(keys, T, hist, status,
                                                                    blocks * kBins);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const size_t bytes = Smem::bytes(kTile);
  if ((err = allow((const void*)sort_partition_kernel, bytes)) != cudaSuccess) return (int)err;
  const int items = bucket_items(T);
  sort_partition_kernel<<<(unsigned)blocks, kThreads, bytes, st>>>(
      keys, T, hist, ticket, status, kThreads * items, keys_out, vals_out, keys_tmp, vals_tmp);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  err = items == 16
            ? launch_buckets<16>(keys, T, hist, keys_out, vals_out, keys_tmp, vals_tmp, st)
            : launch_buckets<24>(keys, T, hist, keys_out, vals_out, keys_tmp, vals_tmp, st);
  return (int)err;
}
