// The cleanup's merge (K3) in one block, for Hopper (sm_90a): every
// composite of at most kMaxSlots slots (torch_core._merge_sorted) is
// grouped, sorted, summed, thresholded and compacted by one block in one
// launch (a cluster of blocks copies a large call's rows), and the host
// reads the survivor count once, after it.
//
// Replaces, for small inputs, the same tail of symmer_tpu/kernels/jx_core.py
// as merge_groups.cu: cleanup_sorted (:255) and _cleanup_from_hashes
// (:416) with its segmented sum (:390), and the row sources of
// mul_pairs_cleanup (:531), rotate_nonclifford_cleanup (:682) and
// clifford_project_cleanup (:728).  Above kMaxSlots the port runs K17
// (sort_keys.cu) and merge_groups.cu's two passes.
//
// The fused route (symmer_sign_merge_small, the template's signing step 0)
// also replaces the key kernels of a small cleanup and a small product:
// jx_core.row_hashes (:205, K2, row_signature.cu) and mul_pairs_cleanup's
// product half (:531-559, K4, pair_products.cu).  A cleanup of stored rows
// or a product of at most kMaxSlots slots and kFusedWords slot-words
// (cuda.small_fused) signs each slot from its row inside this launch, with
// K2's and K4's arithmetic (row_signature.cuh, pair_phase.cuh), into block
// 0's shared memory: its keys and coefficients never go to global memory,
// and the call is one launch instead of two.  Signing costs 11 integer
// operations a half-word and lane (~5.7 us for 4,096 one-word slots on one
// SM) and a trip to memory a round of block 0's lane groups, so where one
// block would take more than kSignRounds rounds a cluster of kCopyBlocks
// blocks signs (each block its share of the slots, stored in block 0's
// shared memory through distributed shared memory) and copies; above
// kFusedWords K2 or K4 runs first, then this kernel's or the large route's
// merge.
// Inputs: ka, kb: int64[T], the slots' signatures; cr, ci: float64[T];
// live: bool[T] or null (every slot live); a row source (merge_rows.cuh).
// Outputs: the survivors' rows ox, oz: int64[n, W], sums ocr, oci:
// float64[n] and first keys oka: int64[n], and n in one int64 word.
// Bit for bit torch_core.merge_small (the plain version: the stable sort by
// (ka, kb), then torch_core.merge_groups) and merge_groups.cu:
//   - a group is the live slots of one signature (ka, kb); a dead slot adds
//     nothing and represents nothing, so it takes no part;
//   - a group's sum starts from +0.0 and adds its slots' coefficients one by
//     one in slot order (one sequential chain, however long the group);
//   - its representative is its first slot; it survives where hypot(re, im)
//     > zero_threshold (always without one);
//   - the survivors come in the order of their representatives.
//
// What bounds it: latency, and one SM's bandwidth.  A call reads at most
// 4,096 slots' 33 bytes and the survivors' rows and writes the survivors
// (chip_smoke.py's small_bound: under a microsecond at 3.35 TB/s); the
// launch, the block's barriers, the chains of dependent steps and, for wide
// rows, one SM's share of the memory system take the time.  So there is one
// launch, no scratch, no memset and no atomics outside shared memory; the
// inputs come in one trip to memory, the outputs go out in one, the rows in
// one more; work is skipped where the input allows it, and the rows of a
// large call are copied by a cluster.  Block 0 of the launch (N / 4
// threads, N the slots padded to a power of two, at least 128, at most
// 4,096: 1,024 threads) does steps 0-7; every block of the cluster (one
// block, or kCopyBlocks where T W passes kCopyWords) does step 8:
//   0. the keys and coefficients to shared memory (coalesced; each
//      thread's loads all issued before its stores, here and in step 8: a
//      cold load is ~1 us);
//   0'. (the fused route, in place of 0) each slot signed from its row in
//      registers by a group of lanes of a block of the launch, its keys
//      and coefficient stored in block 0's shared memory (sign_slots);
//   1. grouping: each live slot finds its signature's entry in an
//      open-addressing hash table of 4 N entries in shared memory: it
//      writes its slot at its hash's entry (any writer stays), joins the
//      slot it reads back there if they share a signature, else walks on,
//      past other signatures' entries, to its own or to a free one that it
//      claims by compare-and-swap (about a ninth of the slots at T = 4,096:
//      compare-and-swap on shared memory is slow, hence the large table);
//      each entry's first slot f is its own, lowered by atomicMin from the
//      group's slots below it (none where no signature repeats); which slot
//      owns an entry depends on the threads' order, f does not;
//   2. where no signature repeats, every live slot is a group of its own
//      and its position is the count of live slots before it (a block
//      scan as in step 6: no sort); else
//   2'. the sort key of a live slot s is (f << 16) | s, unique and 4 bytes
//      (dead slots and padding: 0xffffffff, after every live key); sorting
//      these puts each group's slots together in slot order, and the groups
//      in the order of their first slots, which is the output order: the
//      same groups, sums and order as the stable sort by (ka, kb) and no
//      split check, no repair; 5x less shared traffic than sorting (ka, kb,
//      slot);
//   3. a bitonic network over the N keys, 4 a thread in registers (position
//      4 t + i): steps of distance 1 and 2 within a thread's registers,
//      4 to 64 between the lanes of a warp (shuffles), 128 and up through
//      two exchange buffers in shared memory (one barrier a step); at N =
//      4,096, 78 steps: 23 in registers, 40 by shuffles, 15 by barriers
//      (~26,000 cycles: one SM's integer rate);
//   4. each group's last position noted at its first slot;
//   5. a group's first position (positions t + i nt) sums the group's
//      coefficients from shared memory (after a sort, gathered by position
//      over ka and kb; loads issued kUnroll ahead of the adds; a group of
//      one slot: its coefficient added to +0.0), keeps the sum at the
//      group's first slot and tests it (merge_rows.cuh's group_survives,
//      as pass B);
//   6. an exclusive scan of the survivors over the positions, the four
//      rounds t + i nt at once in 16-bit fields of one 64-bit word (warp
//      shuffles, then the warps' totals), gives each its place;
//   7. each survivor's sums and key written at its place, consecutive lanes
//      on consecutive places, and its slot noted for the rows;
//   8. after a cluster barrier, the rows: block b's warps take rows (b
//      warps + warp) P + g, + C warps P, ..., reading the survivors' slots
//      from block 0's shared memory (distributed shared memory), a group of
//      lanes a row, a word of x and of z a lane (merge_rows.cuh's
//      source_word, as merge_groups.cu's pass B), each lane's next
//      kRowsAhead rows loaded before any is stored; a last cluster barrier
//      keeps block 0's shared memory alive for those reads.
// Shared memory (dynamic, smem_bytes): 56 N bytes and 66 words, at most
// 229,640 bytes at N = 4,096 (the card allows 232,448 a block): ka and kb
// (16 N; after a sort the coefficients by position), the coefficients (16
// N; a group's sum at its first slot), by slot; the table (16 N; then the
// keys by position and the two exchange buffers); the slots' first slots
// (4 N; then the groups' ends, then the survivors' slots) and their owners
// (4 N); the warps' totals (32 words of 64 bits) and the survivor count.
// The output does not depend on the threads' order: the same on every run.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "merge_rows.cuh"
#include "pair_phase.cuh"
#include "row_signature.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxSlots = 4096;  // the route's most slots (cuda.SMALL_ROWS reads it here)
constexpr int kMinSlots = 128;   // the least padded size: one warp of four keys a thread
constexpr int kItems = 4;        // sort keys a thread holds
constexpr int kMaxThreads = kMaxSlots / kItems;
constexpr int kUnroll = 8;     // coefficients a group's sum loads ahead of its adds
constexpr int kRowsAhead = 4;  // rows a lane group loads before it stores them
constexpr int kCopyBlocks = 8;     // the cluster that copies the rows of a large call
constexpr int kCopyWords = 8192;   // T W above which the cluster copies
// The fused route (symmer_sign_merge_small): the rounds of block 0's lane
// groups above which the cluster signs the slots (and copies the rows), and
// the most T W the port sends it (cuda.FUSED_WORDS reads kFusedWords here:
// cuda.small_fused); both measured, tools/fused_budget.py
constexpr int kSignRounds = 2;
[[maybe_unused]] constexpr int kFusedWords = 8192;  // read by cuda.py, not here
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kEmpty = 0xffffffffu;  // a free table entry; a dead slot's or padding's key

__host__ __device__ inline size_t smem_bytes(int N) { return (size_t)N * 56 + 66 * 4; }

// What step 0 does: load each slot's keys and coefficient (K3's one-block
// route, symmer_merge_small), or sign each slot from its row (the fused
// route, symmer_sign_merge_small): stored rows (a cleanup) or a product's
// pairs
constexpr int kLoad = 0, kSignRows = 1, kSignPairs = 2;

// Where step 0 finds the slots
struct Slots {
  const int64_t* ka;  // kLoad: the signatures
  const int64_t* kb;
  const double* cr;  // kLoad, kSignRows: the slots' coefficients; kSignPairs: operand 1's
  const double* ci;
  const double* cr2;  // kSignPairs: operand 2's coefficients
  const double* ci2;
  const unsigned char* live;  // kLoad: the live flags, or null
  int64_t* ka_slots;          // signing: each slot's ka (int64[T], step 7's after a sort)
};

// a slot's first signature key in step 7, where the sort has overwritten
// the keys in shared memory: the input's, or the one step 0 signed (written
// by this launch: no read-only cache)
template <int kStep0>
__device__ __forceinline__ int64_t slot_ka(const Slots& in, int s) {
  if constexpr (kStep0 == kLoad)
    return __ldg(in.ka + s);
  else
    return __ldcg(in.ka_slots + s);
}

// the cluster's barrier in two halves: a relaxed arrival, and the wait
// for every block's (after it, every block of the cluster runs: its shared
// memory may be written)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The fused route's position constants: the four lanes' of x's low and high
// half and z's low and high half of each of a row's first kPosWords words,
// in shared memory after the merge's arrays (kPosBytes at pos_offset(N);
// 231,696 bytes in all at N = 4,096)
constexpr int kPosWords = 32;
static_assert(kPosWords >= 32, "a lane's first word (lane q of a slot's group) has its constants");
__host__ __device__ inline size_t pos_offset(int N) { return (smem_bytes(N) + 15) / 16 * 16; }
constexpr size_t kPosBytes = 4 * kPosWords * sizeof(uint4);

// One slot's loads in step 0': a lane's word of the row (x, z; a pair's
// operand-1 and operand-2 words) and, for the group's first lane, the
// coefficient (a pair's two operands')
struct SlotLoad {
  uint64_t x, z, x2, z2;
  double cr, ci, cr2, ci2;
};

template <int kStep0>
__device__ __forceinline__ void fetch_slot(const Slots& in, const RowSource& src, int T, int s,
                                           int li, SlotLoad& v) {
  constexpr bool pairs = kStep0 == kSignPairs;
  const int W = src.W;
  const int i = pairs ? s / (int)src.M2 : s, j = pairs ? s - i * (int)src.M2 : 0;
  const bool on = s < T;
  v.x = v.z = v.x2 = v.z2 = 0;
  v.cr = v.ci = v.cr2 = v.ci2 = 0.0;
  if (on && li < W) {
    v.x = (uint64_t)__ldg(src.x + (int64_t)i * W + li);
    v.z = (uint64_t)__ldg(src.z + (int64_t)i * W + li);
    if constexpr (pairs) {
      v.x2 = (uint64_t)__ldg(src.x2 + (int64_t)j * W + li);
      v.z2 = (uint64_t)__ldg(src.z2 + (int64_t)j * W + li);
    }
  }
  if (on && li == 0) {
    v.cr = __ldg(in.cr + i);
    v.ci = __ldg(in.ci + i);
    if constexpr (pairs) {
      v.cr2 = __ldg(in.cr2 + j);
      v.ci2 = __ldg(in.ci2 + j);
    }
  }
}

// Word q of a slot (its words a, b; a pair's c, d too) into the lane sums,
// and a pair's power of i and sign count
template <bool kPairs>
__device__ __forceinline__ void sign_word(uint32_t (&acc)[4], uint32_t& ipow, uint32_t& par,
                                          uint64_t a, uint64_t b, uint64_t c, uint64_t d,
                                          const uint4& xl, const uint4& xh, const uint4& zl,
                                          const uint4& zh) {
  if constexpr (kPairs) {
    pair_word(a, b, c, d, ipow, par);
    a ^= c;
    b ^= d;
  }
  hash_word(acc, a, xl, xh);
  hash_word(acc, b, zl, zh);
}

// Step 0' of the fused route, by every block of the cluster: each slot to
// a group of L lanes (L the power of two at or above W, at most 32:
// merge_rows.cuh's row_lanes_log2), word q of its row to lane q mod L, so
// a wide row's words are hashed side by side; the cluster's groups take
// slots g, g + G, ... (G groups: rounds), kAhead rounds' loads issued
// before any is used (the planes' or a pair's words and, by a group's first
// lane, the coefficients).  A lane adds its words' share to the four lane
// sums (row_signature.cuh) and a pair's power of i and sign count
// (pair_phase.cuh), the group adds them with xor shuffles, and its first
// lane makes the keys and the coefficient (bit for bit K2's and K4's) and
// stores them at slot s of d_ka, d_kb, d_c (block 0's shared memory,
// directly or through distributed shared memory) and ka in ka_slots.  The
// position constants of the first kPosWords words come from s_pos.  `many`:
// the cluster has other blocks, whose arrival is awaited before the first
// store.
template <int kStep0>
__device__ __forceinline__ void sign_slots(const Slots& in, const RowSource& src, int T,
                                           int thread, int threads, bool many,
                                           const uint4* s_pos, int64_t* d_ka, int64_t* d_kb,
                                           double2* d_c) {
  constexpr bool pairs = kStep0 == kSignPairs;
  constexpr int kAhead = pairs ? 2 : 4;  // rounds loaded at once (registers: 1,024 threads)
  const int W = src.W, log2_lanes = row_lanes_log2(W), L = 1 << log2_lanes;
  const int li = thread & (L - 1), g = thread >> log2_lanes, G = threads >> log2_lanes;
  SlotLoad v[kAhead];
  for (int r0 = 0; r0 * G < T; r0 += kAhead) {  // uniform over the block
#pragma unroll
    for (int k = 0; k < kAhead; ++k) fetch_slot<kStep0>(in, src, T, g + (r0 + k) * G, li, v[k]);
    if (r0 == 0) {
      __syncthreads();  // s_pos is written
      if (many) cluster_wait();  // every block runs: block 0's shared memory may be written
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int s = g + (r0 + k) * G;
      uint32_t acc[4] = {0u, 0u, 0u, 0u}, ipow = 0u, par = 0u;
      if (s < T && li < W) {
        sign_word<pairs>(acc, ipow, par, v[k].x, v[k].z, v[k].x2, v[k].z2, s_pos[li],
                         s_pos[kPosWords + li], s_pos[2 * kPosWords + li],
                         s_pos[3 * kPosWords + li]);
        // words past the first L (rows of more than 32 words): loaded here
        const int i = pairs ? s / (int)src.M2 : s, j = pairs ? s - i * (int)src.M2 : 0;
        for (int w = li + L; w < W; w += L) {
          const uint32_t jx = 2u * (uint32_t)w, jz = 2u * (uint32_t)(W + w);
          const uint64_t a = (uint64_t)__ldg(src.x + (int64_t)i * W + w),
                         b = (uint64_t)__ldg(src.z + (int64_t)i * W + w);
          uint64_t c = 0, d = 0;
          if constexpr (pairs) {
            c = (uint64_t)__ldg(src.x2 + (int64_t)j * W + w);
            d = (uint64_t)__ldg(src.z2 + (int64_t)j * W + w);
          }
          sign_word<pairs>(acc, ipow, par, a, b, c, d, positions(jx), positions(jx + 1),
                           positions(jz), positions(jz + 1));
        }
      }
      for (int o = L >> 1; o > 0; o >>= 1) {  // the group's sums (every lane of the warp)
#pragma unroll
        for (int l = 0; l < 4; ++l) acc[l] += __shfl_xor_sync(kFull, acc[l], o);
        if constexpr (pairs) {
          ipow += __shfl_xor_sync(kFull, ipow, o);
          par += __shfl_xor_sync(kFull, par, o);
        }
      }
      if (s < T && li == 0) {
        int64_t a, b;
        signature_keys(acc, &a, &b);
        d_ka[s] = a;
        d_kb[s] = b;
        d_c[s] = pairs ? pair_coefficient(v[k].cr, v[k].ci, v[k].cr2, v[k].ci2, ipow, par)
                       : make_double2(v[k].cr, v[k].ci);
        in.ka_slots[s] = a;
      }
    }
  }
}

__device__ __forceinline__ uint32_t signature_hash(int64_t a, int64_t b) {
  uint64_t h = (uint64_t)a * 0x9E3779B97F4A7C15ull + (uint64_t)b;
  h ^= h >> 29;
  h *= 0xBF58476D1CE4E5B9ull;
  return (uint32_t)(h ^ (h >> 32));
}

// a compare-exchange of the bitonic network: a <= b where up, else a >= b
__device__ __forceinline__ void order(uint32_t& a, uint32_t& b, bool up) {
  const uint32_t lo = min(a, b), hi = max(a, b);
  a = up ? lo : hi;
  b = up ? hi : lo;
}

// (re, im) of positions p .. e - 1 of c summed from +0.0 in order
__device__ __forceinline__ double2 group_sum(const double2* c, int p, int e) {
  double re = 0.0, im = 0.0;
  int q = p;
  for (; q + kUnroll <= e; q += kUnroll) {
    double2 w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) w[u] = c[q + u];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      re = __dadd_rn(re, w[u].x);
      im = __dadd_rn(im, w[u].y);
    }
  }
  for (; q < e; ++q) {
    const double2 w = c[q];
    re = __dadd_rn(re, w.x);
    im = __dadd_rn(im, w.y);
  }
  return make_double2(re, im);
}

// An exclusive scan over the block's threads of four counts at once, each
// in a 16-bit field of `mine` (round i of positions t + i nt in field i;
// every thread calls it): the threads before this one's sums, and in
// `total` the block's.  s_total: 32 words of 64 bits.
__device__ __forceinline__ uint64_t rounds_exclusive_scan(uint64_t mine, uint64_t* s_total,
                                                          uint64_t& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  uint64_t incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint64_t y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) s_total[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    uint64_t w = lane < warps ? s_total[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint64_t y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    if (lane < warps) s_total[lane] = w;
  }
  __syncthreads();
  total = s_total[warps - 1];
  const uint64_t before = (warp ? s_total[warp - 1] : 0) + incl - mine;
  __syncthreads();  // s_total is free for the next scan
  return before;
}

// Field i of a rounds_exclusive_scan word, and the fields below i summed
// (the positions of the rounds before round i)
__device__ __forceinline__ int field(uint64_t x, int i) {
  return (int)((x >> (16 * i)) & 0xffff);
}
__device__ __forceinline__ int fields_below(uint64_t x, int i) {
  int sum = 0;
  for (int j = 0; j < i; ++j) sum += field(x, j);
  return sum;
}

template <int kStep0>
__global__ void __launch_bounds__(kMaxThreads)
merge_small_kernel(Slots in, int T, int N, int has_threshold,
                   double threshold, RowSource src, int log2_lanes, int64_t* __restrict__ ox,
                   int64_t* __restrict__ oz, double* __restrict__ ocr, double* __restrict__ oci,
                   int64_t* __restrict__ oka, int64_t* __restrict__ count) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto* s_ka = reinterpret_cast<int64_t*>(smem);  // by slot
  int64_t* s_kb = s_ka + N;
  auto* s_cp = reinterpret_cast<double2*>(smem);  // after a sort: the coefficients by position
  auto* s_c = reinterpret_cast<double2*>(smem + (size_t)N * 16);  // by slot
  auto* s_table = reinterpret_cast<uint32_t*>(smem + (size_t)N * 32);  // 4 N entries
  auto* s_buf = reinterpret_cast<uint4*>(s_table);  // after the grouping: two of N / 4
  uint32_t* s_key = s_table;                        // the keys by position
  auto* s_first = reinterpret_cast<int*>(smem + (size_t)N * 48);  // by the entry's slot
  int* s_end = s_first;  // after the sort keys: by the group's first slot
  int* s_rep = s_first;  // after the sums: by place
  int* s_owner = s_first + N;  // by slot: its entry's slot, -1 where dead
  auto* s_total = reinterpret_cast<uint64_t*>(s_owner + N);  // a scan's warp totals
  int* s_flags = reinterpret_cast<int*>(s_total + 32);      // [1] the survivors
  cg::cluster_group cluster = cg::this_cluster();
  const int t = threadIdx.x, nt = blockDim.x, lane = t & 31, warp = t >> 5;
  const int warps = nt >> 5;

  if constexpr (kStep0 != kLoad) {
    // 0'. (the fused route) every block of the cluster signs its share of
    // the slots into block 0's shared memory (sign_slots), after its
    // position constants; block 0 empties the table and makes each slot its
    // own first slot meanwhile (every slot is live)
    const bool many = cluster.num_blocks() > 1;
    if (many) cluster_arrive_relaxed();
    auto* s_pos = reinterpret_cast<uint4*>(smem + pos_offset(N));
    for (int e = t; e < 4 * kPosWords; e += nt) {
      const int k = e / kPosWords, q = e - k * kPosWords;
      const uint32_t j = k < 2 ? 2u * (uint32_t)q + k : 2u * (uint32_t)(src.W + q) + k - 2;
      if (q < src.W) s_pos[e] = positions(j);
    }
    if (cluster.block_rank() == 0) {
      for (int h = t; h < 4 * N; h += nt) s_table[h] = kEmpty;
#pragma unroll
      for (int i = 0; i < kItems; ++i) s_first[t + i * nt] = t + i * nt < T ? t + i * nt : -1;
    }
    int64_t* d_ka = s_ka;
    int64_t* d_kb = s_kb;
    double2* d_c = s_c;
    if (many) {
      d_ka = cluster.map_shared_rank(s_ka, 0);
      d_kb = cluster.map_shared_rank(s_kb, 0);
      d_c = cluster.map_shared_rank(s_c, 0);
    }
    sign_slots<kStep0>(in, src, T, (int)cluster.block_rank() * nt + t,
                       (int)cluster.num_blocks() * nt, many, s_pos, d_ka, d_kb, d_c);
    if (many)
      cluster.sync();
    else
      __syncthreads();
  }

  if (cluster.block_rank() == 0) {
    if constexpr (kStep0 == kLoad) {
      // 0. the keys and coefficients to shared memory (slots t + i nt:
      // coalesced, every load issued before any store: one trip to
      // memory); the table empty; a slot's first slot its own where it is
      // live, -1 where it is dead
      int64_t a[kItems], b[kItems];
      double2 c[kItems];
      bool on[kItems];
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const int s = t + i * nt;
        a[i] = s < T ? __ldg(in.ka + s) : 0;
        b[i] = s < T ? __ldg(in.kb + s) : 0;
        c[i] = s < T ? make_double2(__ldg(in.cr + s), __ldg(in.ci + s)) : make_double2(0.0, 0.0);
        on[i] = s < T && (in.live == nullptr || __ldg(in.live + s) != 0);
      }
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        s_ka[t + i * nt] = a[i];
        s_kb[t + i * nt] = b[i];
        s_c[t + i * nt] = c[i];
        s_first[t + i * nt] = on[i] ? t + i * nt : -1;
      }
      for (int h = t; h < 4 * N; h += nt) s_table[h] = kEmpty;
      __syncthreads();
    }

    // 1. each live slot's entry (its slot: the owner; slots t + i nt, so
    // that a warp's accesses by slot fall in distinct banks): each
    // writes its slot at its hash's entry (any writer stays); barrier; it
    // joins the slot it reads back there if they share a signature, else it
    // walks on from the next entry, past other signatures' entries, until it
    // joins its own or claims a free one by compare-and-swap.  Which slot
    // owns an entry depends on the threads' order, the groups do not.  The
    // owners go to shared memory (few registers a thread: 1,024 threads
    // have 64 each).
    const uint32_t mask = 4u * (uint32_t)N - 1u;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int s = t + i * nt;
      if (s_first[s] >= 0) s_table[signature_hash(s_ka[s], s_kb[s]) & mask] = (uint32_t)s;
    }
    __syncthreads();
#pragma unroll 1
    for (int i = 0; i < kItems; ++i) {
      const int s = t + i * nt;
      int o = -1;
      if (s_first[s] >= 0) {
        const int64_t a = s_ka[s], b = s_kb[s];
        for (uint32_t h = signature_hash(a, b) & mask;; h = (h + 1) & mask) {
          uint32_t e = s_table[h];
          if (e == kEmpty) {
            e = atomicCAS(&s_table[h], kEmpty, (uint32_t)s);
            if (e == kEmpty) {
              o = s;
              break;
            }
          }
          if (s_ka[e] == a && s_kb[e] == b) {
            o = (int)e;
            break;
          }
        }
      }
      s_owner[s] = o;
    }
    __syncthreads();
    // each entry's first slot: a slot below its owner lowers it (atomicMin);
    // where all of a warp's lowering slots share one entry, its lowest lane
    // alone, whose slot is their least (a warp's slots rise with its lanes)
    bool repeats = false;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int s = t + i * nt, o = s_owner[s];
      repeats |= o >= 0 && o != s;
      const bool lower = o >= 0 && s < o;
      const unsigned lowering = __ballot_sync(kFull, lower);
      if (lowering) {
        const int leader = __ffs(lowering) - 1;
        const int e = __shfl_sync(kFull, o, leader);
        const bool one_entry = __all_sync(kFull, !lower || o == e);
        if (lower && (!one_entry || lane == leader)) atomicMin(&s_first[o], s);
      }
    }
    repeats = __syncthreads_or(repeats);

    if (!repeats) {
      // 2. no signature repeats: every live slot is its own group, and its
      // position is the live slots before it (a scan; no sort)
      uint64_t on = 0;  // live slots t + i nt, 16 bits a round i
#pragma unroll
      for (int i = 0; i < kItems; ++i) on |= (uint64_t)(s_owner[t + i * nt] >= 0) << (16 * i);
      uint64_t total;
      const uint64_t before = rounds_exclusive_scan(on, s_total, total);
      const int live_slots = fields_below(total, kItems);
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const int s = t + i * nt;
        if (field(on, i))
          s_key[fields_below(total, i) + field(before, i)] = ((uint32_t)s << 16) | (uint32_t)s;
        if (s >= live_slots) s_key[s] = kEmpty;
      }
      __syncthreads();
    } else {
      // 2'. the sort keys (first slot << 16) | slot at positions 4 t + i
      uint32_t v[kItems];
#pragma unroll
      for (int i = 0; i < kItems; ++i) {  // slot t + i nt at position 4 t + i: any will do
        const int o = s_owner[t + i * nt];
        v[i] = o < 0 ? kEmpty : ((uint32_t)s_first[o] << 16) | (uint32_t)(t + i * nt);
      }

      // 3. the bitonic network (uniform over the block: every thread takes
      // every step)
      int ping = 0;
      for (int k = 2; k <= N; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
          if (j >= kItems) {
            const int d = j / kItems;  // the partner thread: t ^ d
            const bool keep_min = (((kItems * t) & k) == 0) == ((t & d) == 0);
            uint32_t o[kItems];
            if (d < 32) {
#pragma unroll
              for (int i = 0; i < kItems; ++i) o[i] = __shfl_xor_sync(kFull, v[i], d);
            } else {
              uint4* buf = s_buf + ping * nt;
              buf[t] = make_uint4(v[0], v[1], v[2], v[3]);
              __syncthreads();
              const uint4 w = buf[t ^ d];
              o[0] = w.x;
              o[1] = w.y;
              o[2] = w.z;
              o[3] = w.w;
              ping ^= 1;  // the next exchange writes the other buffer: no second barrier
            }
#pragma unroll
            for (int i = 0; i < kItems; ++i) v[i] = keep_min ? min(v[i], o[i]) : max(v[i], o[i]);
          } else if (j == 2) {  // k >= 4: the direction is the thread's
            const bool up = ((kItems * t) & k) == 0;
            order(v[0], v[2], up);
            order(v[1], v[3], up);
          } else {
            order(v[0], v[1], ((kItems * t) & k) == 0);
            order(v[2], v[3], ((kItems * t + 2) & k) == 0);
          }
        }
      }
      __syncthreads();  // every read of the exchange buffers and of s_first is done
      reinterpret_cast<uint4*>(s_key)[t] = make_uint4(v[0], v[1], v[2], v[3]);
      __syncthreads();
      // the coefficients by position (positions t + i nt), over ka and kb
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const uint32_t key = s_key[t + i * nt];
        s_cp[t + i * nt] = key == kEmpty ? make_double2(0.0, 0.0) : s_c[key & 0xffffu];
      }
      __syncthreads();
    }

    // 4. each group's end at its first slot (positions t + i nt)
    uint32_t key[kItems], next[kItems];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int p = t + i * nt;
      key[i] = s_key[p];
      next[i] = p + 1 < N ? s_key[p + 1] : kEmpty;
      if (key[i] != kEmpty && (next[i] >> 16) != (key[i] >> 16)) s_end[key[i] >> 16] = p + 1;
    }
    __syncthreads();

    // 5. each group's sum, by its first position's thread (positions t + i
    // nt, whose keys step 4 left in registers; a group of one position ends
    // at the next, with no read of its end), kept in place of the group's
    // first coefficient (no other thread reads the group's)
    uint64_t mine = 0;  // the survivors among the positions, 16 bits a round i
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int p = t + i * nt;
      if (key[i] != kEmpty && (p == 0 || (s_key[p - 1] >> 16) != (key[i] >> 16))) {
        const int f = (int)(key[i] >> 16);  // the group's first slot: this position's slot
        double2 sum;
        if (repeats) {
          sum = group_sum(s_cp, p, (next[i] >> 16) != (key[i] >> 16) ? p + 1 : s_end[f]);
        } else {  // a group of one slot
          const double2 c = s_c[f];
          sum = make_double2(__dadd_rn(0.0, c.x), __dadd_rn(0.0, c.y));
        }
        s_c[f] = sum;
        if (group_survives(sum.x, sum.y, has_threshold, threshold)) mine |= 1ull << (16 * i);
      }
    }

    // 6. the survivors' places, in position order (round i, then t)
    uint64_t total;
    const uint64_t before = rounds_exclusive_scan(mine, s_total, total);
    const int n = fields_below(total, kItems);

    // 7. each survivor's sums and key at its place (consecutive lanes on
    // consecutive places), its slot noted for the rows
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if (field(mine, i)) {
        const int d = fields_below(total, i) + field(before, i), f = (int)(key[i] >> 16);
        const double2 sum = s_c[f];
        ocr[d] = sum.x;
        oci[d] = sum.y;
        oka[d] = repeats ? slot_ka<kStep0>(in, f) : s_ka[f];  // in shared memory unless overwritten
        s_rep[d] = f;
      }
    }
    if (t == 0) {
      s_flags[1] = n;
      *count = n;
    }
  }
  // block 0's survivors are in its shared memory
  const bool one = cluster.num_blocks() == 1;
  if (one)
    __syncthreads();
  else
    cluster.sync();

  // 8. the survivors' rows, by every block of the cluster: rows r = (rank
  // warps + warp) P + g, + C warps P, ..., a group of L lanes a row; up to
  // 32 words a row, a word of x and of z a lane and kRowsAhead rows' loads
  // issued before their stores
  const int* rep0 = one ? s_rep : cluster.map_shared_rank(s_rep, 0);
  const int n = one ? s_flags[1] : *cluster.map_shared_rank(s_flags + 1, 0);
  const int L = 1 << log2_lanes, li = lane & (L - 1), P = 32 >> log2_lanes;
  const int stride = (int)cluster.num_blocks() * warps * P;
  const int r_first = ((int)cluster.block_rank() * warps + warp) * P + (lane >> log2_lanes);
  if (src.W <= 32) {
    for (int r0 = r_first; r0 < n; r0 += stride * kRowsAhead) {
      int rr[kRowsAhead];
      int64_t xw[kRowsAhead], zw[kRowsAhead];
#pragma unroll
      for (int q = 0; q < kRowsAhead; ++q) {
        const int r = r0 + q * stride;
        rr[q] = r < n ? rep0[r] : 0;
      }
#pragma unroll
      for (int q = 0; q < kRowsAhead; ++q) {
        if (r0 + q * stride < n && li < src.W)
          source_word(src, source_place(src, rr[q]), li, xw[q], zw[q]);
      }
#pragma unroll
      for (int q = 0; q < kRowsAhead; ++q) {
        const int r = r0 + q * stride;
        if (r < n && li < src.W) {
          ox[(int64_t)r * src.W + li] = xw[q];
          oz[(int64_t)r * src.W + li] = zw[q];
        }
      }
    }
  } else {
    for (int r = r_first; r < n; r += stride) copy_row(src, rep0[r], r, li, L, ox, oz);
  }
  if (!one) cluster.sync();  // block 0's shared memory outlives the other blocks' reads
}

// One launch of merge_small_kernel<kStep0> over T slots: one block (a
// plain launch: its implicit cluster is that block), or a cluster of
// kCopyBlocks blocks
template <int kStep0>
int launch(const Slots& in, int64_t T, int64_t has_threshold, double threshold,
           const RowSource& src, unsigned blocks, void* ox, void* oz, void* ocr, void* oci,
           void* oka, void* count, void* stream) {
  int N = kMinSlots;
  while (N < T) N <<= 1;
  const size_t bytes = kStep0 == kLoad ? smem_bytes(N) : pos_offset(N) + kPosBytes;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        merge_small_kernel<kStep0>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchAttribute attr[1] = {};
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3((unsigned)(N / kItems));
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = blocks > 1 ? 1 : 0;
  return (int)cudaLaunchKernelEx(
      &cfg, merge_small_kernel<kStep0>, in, (int)T, N, (int)(has_threshold != 0), threshold, src,
      row_lanes_log2(src.W), static_cast<int64_t*>(ox), static_cast<int64_t*>(oz),
      static_cast<double*>(ocr), static_cast<double*>(oci), static_cast<int64_t*>(oka),
      static_cast<int64_t*>(count));
}

const int64_t* i64(const void* p) { return static_cast<const int64_t*>(p); }
const double* f64(const void* p) { return static_cast<const double*>(p); }

}  // namespace

// ka, kb: int64[T]; cr, ci: float64[T] (1 <= T <= 4,096); live: bool[T], or
// null (every slot live); the row source (source: 0 planes, 1 pairs, 2
// rotation, 3 masked; merge_rows.cuh): planes x, z int64[T, W] (x2 = z2 =
// null); pairs x, z the operands' x1, z1: int64[M1, W] and x2, z2:
// int64[M2, W] with M1 M2 = T; rotation x, z: int64[T / 2, W] and x2, z2
// Q's xr, zr: int64[W] (T even); masked x, z: int64[T, W] and x2 = z2 =
// col_keep: int64[W]; M2 is read for pairs only; ox, oz: int64[T, W], ocr,
// oci: float64[T], oka: int64[T] (the first n rows written), count:
// int64[1] (n).  One launch: one block, or a cluster of kCopyBlocks blocks
// where T W passes kCopyWords (block 0 merges, every block copies rows); no
// scratch.
extern "C" int symmer_merge_small(const void* ka, const void* kb, const void* cr, const void* ci,
                                  const void* live, int64_t T, int64_t has_threshold,
                                  double threshold, int64_t W, int64_t source, const void* x,
                                  const void* z, const void* x2, const void* z2, int64_t M2,
                                  void* ox, void* oz, void* ocr, void* oci, void* oka,
                                  void* count, void* stream) {
  if (T < 1 || T > kMaxSlots || W < 0 || W > (1 << 26) || source < kPlanes ||
      source > kMasked || (source == kPairs && (M2 < 1 || T % M2 != 0)) ||
      (source == kRotation && T % 2 != 0))
    return (int)cudaErrorInvalidValue;
  if (source == kRotation) M2 = T / 2;
  const Slots in{i64(ka), i64(kb), f64(cr), f64(ci), nullptr, nullptr,
                 static_cast<const unsigned char*>(live), nullptr};
  const RowSource src{(int)source, (int)W, M2, i64(x), i64(z), i64(x2), i64(z2)};
  return launch<kLoad>(in, T, has_threshold, threshold, src,
                       T * W > kCopyWords ? kCopyBlocks : 1, ox, oz, ocr, oci, oka, count,
                       stream);
}

// The fused route: a cleanup (source 0: planes x, z: int64[T, W] and their
// coefficients cr, ci: float64[T]; x2 = z2 = cr2 = ci2 = null) or a product
// (source 1: operand 1's x, z: int64[M1, W], cr, ci: float64[M1], operand
// 2's x2, z2: int64[M2, W], cr2, ci2: float64[M2], T = M1 M2, slot s = i M2
// + j) of 1 <= T <= 4,096 slots, each slot signed from its row in the
// launch (K2's and K4's bits), then merged as symmer_merge_small merges
// them; outputs as there, and ka_slots: int64[T], each slot's ka.  One
// launch: one block, or a cluster of kCopyBlocks blocks where one block's
// lane groups would take more than kSignRounds rounds (each block signs its
// share and copies rows).
extern "C" int symmer_sign_merge_small(int64_t source, const void* x, const void* z,
                                       const void* cr, const void* ci, const void* x2,
                                       const void* z2, const void* cr2, const void* ci2,
                                       int64_t M2, int64_t T, int64_t W, int64_t has_threshold,
                                       double threshold, void* ox, void* oz, void* ocr,
                                       void* oci, void* oka, void* count, void* ka_slots,
                                       void* stream) {
  if (T < 1 || T > kMaxSlots || W < 0 || W > (1 << 26) || (source != kPlanes && source != kPairs) ||
      (source == kPairs && (M2 < 1 || T % M2 != 0)))
    return (int)cudaErrorInvalidValue;
  const Slots in{nullptr, nullptr, f64(cr), f64(ci), f64(cr2), f64(ci2), nullptr,
                 static_cast<int64_t*>(ka_slots)};
  const RowSource src{(int)source, (int)W, source == kPairs ? M2 : 0, i64(x), i64(z), i64(x2),
                      i64(z2)};
  // one block where its lane groups (sign_slots) take every slot in
  // kSignRounds rounds, else the cluster: a round of loads costs about as
  // much as the cluster's barriers
  int N = kMinSlots;
  while (N < T) N <<= 1;
  const int64_t rounds = ((T << row_lanes_log2(W)) + N / kItems - 1) / (N / kItems);
  const unsigned blocks = rounds > kSignRounds ? kCopyBlocks : 1;
  return source == kPairs
             ? launch<kSignPairs>(in, T, has_threshold, threshold, src, blocks, ox, oz, ocr, oci,
                                  oka, count, stream)
             : launch<kSignRows>(in, T, has_threshold, threshold, src, blocks, ox, oz, ocr, oci,
                                 oka, count, stream);
}
