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
// What bounds it: bytes.  An LSD radix sort moves each key and its int32
// index once a digit pass (12 bytes read, 12 written), and the histograms
// read the keys once: 24 x passes + 8 bytes a key (chip_smoke.py's
// sort_bound).  The design, in the onesweep shape:
//   - digits of kBits = 8 bits of u = key ^ 2^63 (the top digit's sign bit
//     flipped, so unsigned order of u is signed order of the key), least
//     significant first: 8 passes (the width is chosen by measurement: see
//     kBits);
//   - one launch counts the digit histograms of every pass at once (each
//     block in shared memory, then one global atomic a bin) and zeroes the
//     passes' status words;
//   - one launch a pass.  A block takes its tile (kThreads x kItems keys,
//     in input order) by a ticket (look_back.cuh's draw_ticket) and ranks
//     its keys stably in shared memory: a warp ranks 32 keys at a time in
//     order, the lanes of one digit found by one ballot a digit bit, a
//     counter a warp and digit; the warps' counters turn into offsets and
//     the tile's digit counts.  A thread a bin publishes the tile's count
//     of its digit in the tile's status word of that digit (tile 0: the
//     inclusive prefix, from the histogram's exclusive scan), looks back
//     over its predecessors' words of that digit, kWindow tiles at a time,
//     adding counts until it meets an inclusive prefix, and publishes its
//     own (look_back.cuh's word: count, flag and the pass's epoch).  The
//     keys go to shared memory in digit order, then out to their places,
//     neighbouring lanes to neighbouring addresses within a digit;
//   - the passes ping-pong between the outputs and one scratch pair, so the
//     last pass (the pass count is even) writes the outputs;
//   - up to kSmallKeys keys, one launch of one block sorts every pass in
//     shared memory (no histogram, no look-back): a small cleanup gains no
//     launches.
// The ranks and prefixes are exact integers: the output is the same on every
// run, whichever block draws which ticket.  No allocation and no host
// synchronisation: the wrapper (kernels/cuda.py) allocates the outputs and
// the scratch; the one memset zeroes the histograms and tickets.

#include <cuda_runtime.h>

#include <cstdint>

#include "look_back.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint64_t kSign = 1ull << 63;
constexpr int kSmallItems = 16;  // keys a thread holds in the one-block route
constexpr int64_t kSmallKeys = (int64_t)kThreads * kSmallItems;
constexpr int kWindow = 16;      // status words of one digit a look-back step reads
constexpr int kItems = 8;        // keys a thread holds in a digit pass's tile
constexpr int kTile = kThreads * kItems;
// The digit width: 8 bits (8 passes).  An 11-bit variant (6 passes) was
// built and timed on an H100 80GB HBM3 and was the slower at every size
// timed, from the flagship's 200,000 keys to the chain's 1,162,560: at 11
// bits a tile of 2,048 keys has 2,048 bins, one a key, so its look-back
// reads 8 bins a thread and its scatter writes a sector a key.
constexpr int kBits = 8;
constexpr int kBins = 1 << kBits;
constexpr int kPasses = (64 + kBits - 1) / kBits;
constexpr int kPer = kBins / kThreads;  // bins a thread owns
static_assert(kBins % kThreads == 0, "a thread owns whole bins");
static_assert(kPasses % 2 == 0, "the last pass writes the outputs");

__device__ __forceinline__ int digit_of(uint64_t u, int shift) {
  return (int)((u >> shift) & (uint64_t)(kBins - 1));
}

// Shared memory of a tile of n keys: the warps' counters (uint16, a warp
// and bin), the tile's exclusive digit starts, the digits' global bases less
// those starts, the keys and their indices in digit order, the block scan's
// warp sums.
struct Smem {
  static size_t bytes(int n) {
    return (size_t)kWarps * kBins * 2 + 2 * (size_t)kBins * 4 + (size_t)n * 12 + kWarps * 4;
  }
  uint16_t* cnt;
  int* start;
  int* base;
  uint64_t* key;
  int* val;
  int* warp_sum;
  __device__ explicit Smem(unsigned char* p, int n) {
    key = reinterpret_cast<uint64_t*>(p);  // 8-byte aligned first
    cnt = reinterpret_cast<uint16_t*>(p + (size_t)n * 8);
    start = reinterpret_cast<int*>(p + (size_t)n * 8 + (size_t)kWarps * kBins * 2);
    base = start + kBins;
    val = base + kBins;
    warp_sum = val + n;
  }
};

// Ranks a tile's keys by the digit at `shift`, stably.  Key r of lane l of
// warp w is the tile's key w * 32 * kN + r * 32 + l (ok[r]: it exists).
// On return rank[r] is the key's place among the warp's keys of its digit,
// and s.cnt[w][d] holds warp w's count of digit d.
template <int kN>
__device__ __forceinline__ void warp_rank(const uint64_t (&u)[kN], unsigned ok, int shift,
                                          Smem& s, int (&rank)[kN]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  uint16_t* cnt = s.cnt + warp * kBins;
#pragma unroll
  for (int r = 0; r < kN; ++r) {
    const bool valid = (ok >> r) & 1u;
    const int d = digit_of(u[r], shift);
    unsigned peers = __ballot_sync(kFull, valid);  // the lanes of this key's digit
#pragma unroll
    for (int b = 0; b < kBits; ++b) {
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

// After warp_rank and a barrier: each thread's bins (kPerThread consecutive
// ones) get the warps' exclusive offsets in s.cnt, their tile counts in
// count[], and their exclusive starts in the tile in s.start.
__device__ __forceinline__ void tile_counts(Smem& s, int (&count)[kPer]) {
  int sum = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int b = threadIdx.x * kPer + j;
    int c = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int n = s.cnt[w * kBins + b];
      s.cnt[w * kBins + b] = (uint16_t)c;
      c += n;
    }
    count[j] = c;
    sum += c;
  }
  int at = block_exclusive_sum(sum, s.warp_sum);
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    s.start[threadIdx.x * kPer + j] = at;
    at += count[j];
  }
}

// The exclusive scan of a pass's global digit counts, for the thread's bins.
__device__ __forceinline__ void digit_starts(const unsigned* __restrict__ hist, Smem& s,
                                             int64_t (&start)[kPer]) {
  int c[kPer], sum = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    c[j] = (int)hist[threadIdx.x * kPer + j];
    sum += c[j];
  }
  int64_t at = block_exclusive_sum(sum, s.warp_sum);
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    start[j] = at;
    at += c[j];
  }
}

// The keys of digit bin b in the tiles before `tile` plus the digit's
// global start: the walk back over the predecessors' status words of bin b
// (kWindow tiles a step, waiting until every word of the step is published
// in this pass) to the nearest inclusive prefix.
__device__ __forceinline__ int64_t bin_look_back(const unsigned long long* status, int64_t tile,
                                                 int bins, int b, uint64_t epoch) {
  int64_t before = 0;
  for (int64_t j = tile - 1;; j -= kWindow) {
    uint64_t w[kWindow];
    bool ready;
    do {
      ready = true;
#pragma unroll
      for (int r = 0; r < kWindow; ++r) {
        const int64_t p = j - r;
        w[r] = p >= 0 ? load_status(status + p * bins + b) : ((epoch << 34) | kPrefix);
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

// Histograms of every pass's digits (hist: uint32[kPasses][kBins], zeroed
// before the launch), and the passes' status words zeroed.
__global__ void __launch_bounds__(kThreads)
sort_histogram_kernel(const int64_t* __restrict__ keys, int64_t T, unsigned* __restrict__ hist,
                      unsigned long long* __restrict__ status, int64_t status_words) {
  extern __shared__ unsigned s_hist[];  // [kPasses][kBins]
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t g = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  for (int i = threadIdx.x; i < kPasses * kBins; i += kThreads) s_hist[i] = 0;
  for (int64_t i = g; i < status_words; i += stride) status[i] = 0;
  __syncthreads();
  for (int64_t i = g; i < T; i += stride) {
    const uint64_t u = (uint64_t)__ldg(keys + i) ^ kSign;
#pragma unroll
    for (int p = 0; p < kPasses; ++p) atomicAdd(s_hist + p * kBins + digit_of(u, p * kBits), 1u);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kPasses * kBins; i += kThreads)
    if (s_hist[i]) atomicAdd(hist + i, s_hist[i]);
}

// One digit pass over tiles of kThreads x kItems keys: keys_in (u = key ^
// 2^63 is what is ranked), vals_in (null on the first pass: the key's
// index), hist: this pass's digit counts, status: int64[tiles][kBins].
__global__ void __launch_bounds__(kThreads)
sort_pass_kernel(const int64_t* __restrict__ keys_in, const int* __restrict__ vals_in, int64_t T,
                 int shift, const unsigned* __restrict__ hist, uint64_t epoch,
                 unsigned long long* ticket, unsigned long long* status,
                 int64_t* __restrict__ keys_out, int* __restrict__ vals_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  Smem s(smem, kTile);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t tile = draw_ticket(ticket);
  const int64_t t0 = tile * kTile;
  const int n = (int)(T - t0 < kTile ? T - t0 : kTile);
  for (int i = t; i < kWarps * kBins / 2; i += kThreads) reinterpret_cast<unsigned*>(s.cnt)[i] = 0;
  uint64_t u[kItems];
  int v[kItems];
  unsigned ok = 0;
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int i = warp * 32 * kItems + r * 32 + lane;
    u[r] = 0;
    v[r] = 0;
    if (i < n) {
      ok |= 1u << r;
      u[r] = (uint64_t)__ldg(keys_in + t0 + i) ^ kSign;
      v[r] = vals_in != nullptr ? __ldg(vals_in + t0 + i) : (int)(t0 + i);
    }
  }
  __syncthreads();  // the counters are zero
  int rank[kItems];
  warp_rank<kItems>(u, ok, shift, s, rank);
  __syncthreads();
  int count[kPer];
  tile_counts(s, count);  // (its block scan's barriers order the offsets)
  // publish the tile's digit counts, look back, publish the prefixes
  int64_t base[kPer];
  if (tile == 0) {
    digit_starts(hist, s, base);
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      store_status(status + t * kPer + j,
                   (epoch << 34) | kPrefix | (uint32_t)(base[j] + count[j]));
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      store_status(status + tile * kBins + t * kPer + j, (epoch << 34) | kCount | (uint32_t)count[j]);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      base[j] = bin_look_back(status, tile, kBins, t * kPer + j, epoch);
      store_status(status + tile * kBins + t * kPer + j,
                   (epoch << 34) | kPrefix | (uint32_t)(base[j] + count[j]));
    }
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) s.base[t * kPer + j] = (int)base[j] - s.start[t * kPer + j];
  __syncthreads();  // every bin's start and offsets are in shared memory
  // the keys in digit order in shared memory
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    if ((ok >> r) & 1u) {
      const int d = digit_of(u[r], shift);
      const int at = s.start[d] + s.cnt[warp * kBins + d] + rank[r];
      s.key[at] = u[r];
      s.val[at] = v[r];
    }
  }
  __syncthreads();
  for (int i = t; i < n; i += kThreads) {
    const uint64_t k = s.key[i];
    const int64_t g = (int64_t)s.base[digit_of(k, shift)] + i;
    keys_out[g] = (int64_t)(k ^ kSign);
    vals_out[g] = s.val[i];
  }
}

// Every pass of up to kSmallKeys keys in one block, in shared memory.
__global__ void __launch_bounds__(kThreads)
sort_small_kernel(const int64_t* __restrict__ keys, int n, int64_t* __restrict__ keys_out,
                  int* __restrict__ vals_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  Smem s(smem, (int)kSmallKeys);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  uint64_t u[kSmallItems];
  int v[kSmallItems];
  unsigned ok = 0;
#pragma unroll
  for (int r = 0; r < kSmallItems; ++r) {
    const int i = warp * 32 * kSmallItems + r * 32 + lane;
    u[r] = 0;
    v[r] = i;
    if (i < n) {
      ok |= 1u << r;
      u[r] = (uint64_t)__ldg(keys + i) ^ kSign;
    }
  }
  for (int shift = 0; shift < 64; shift += kBits) {
    for (int i = t; i < kWarps * kBins / 2; i += kThreads)
      reinterpret_cast<unsigned*>(s.cnt)[i] = 0;
    __syncthreads();
    int rank[kSmallItems];
    warp_rank<kSmallItems>(u, ok, shift, s, rank);
    __syncthreads();
    int count[kPer];
    tile_counts(s, count);
    __syncthreads();  // every bin's start and offsets are in shared memory
#pragma unroll
    for (int r = 0; r < kSmallItems; ++r) {
      if ((ok >> r) & 1u) {
        const int d = digit_of(u[r], shift);
        const int at = s.start[d] + s.cnt[warp * kBins + d] + rank[r];
        s.key[at] = u[r];
        s.val[at] = v[r];
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kSmallItems; ++r) {  // the next pass's input: this order
      if ((ok >> r) & 1u) {
        const int i = warp * 32 * kSmallItems + r * 32 + lane;
        u[r] = s.key[i];
        v[r] = s.val[i];
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < kSmallItems; ++r) {
    if ((ok >> r) & 1u) {
      const int i = warp * 32 * kSmallItems + r * 32 + lane;
      keys_out[i] = (int64_t)(u[r] ^ kSign);
      vals_out[i] = v[r];
    }
  }
}

int64_t tiles(int64_t T) { return (T + kTile - 1) / kTile; }

cudaError_t allow(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// int64 words of scratch symmer_sort_keys needs for T keys (0: the one-block
// route): the histograms (uint32[kPasses][kBins]), a ticket a pass, the
// status words (a tile and bin).
extern "C" int64_t symmer_sort_keys_scratch(int64_t T) {
  if (T <= kSmallKeys) return 0;
  return kPasses * kBins / 2 + kPasses + tiles(T) * kBins;
}

// The digit passes: 8.
extern "C" int64_t symmer_sort_keys_passes() { return kPasses; }

// keys: int64[T] (1 <= T < 2^31); keys_out: int64[T], vals_out: int32[T]
// (the sorted keys and perm); keys_tmp: int64[T], vals_tmp: int32[T] and
// scratch: int64[symmer_sort_keys_scratch(T)] (all three unused by the
// one-block route).  One launch up to 4,096 keys, else 1 + kPasses.
// Nothing overlaps.
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
  auto* tickets = reinterpret_cast<unsigned long long*>(scratch + kPasses * kBins / 2);
  auto* status = tickets + kPasses;
  const int64_t blocks = tiles(T);
  cudaError_t err = cudaMemsetAsync(scratch, 0, (kPasses * kBins / 2 + kPasses) * 8, st);
  if (err != cudaSuccess) return (int)err;
  const size_t hbytes = (size_t)kPasses * kBins * 4;
  if ((err = allow((const void*)sort_histogram_kernel, hbytes)) != cudaSuccess) return (int)err;
  const int64_t hblocks = blocks < 2 * device_sms() ? blocks : 2 * device_sms();
  sort_histogram_kernel<<<(unsigned)hblocks, kThreads, hbytes, st>>>(keys, T, hist, status,
                                                                    blocks * kBins);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const size_t bytes = Smem::bytes((int)kTile);
  if ((err = allow((const void*)sort_pass_kernel, bytes)) != cudaSuccess) return (int)err;
  for (int p = 0; p < kPasses; ++p) {  // in -> tmp -> out -> tmp ... -> out
    const int64_t* kin = p == 0 ? keys : p % 2 ? keys_tmp : keys_out;
    const int* vin = p == 0 ? nullptr : p % 2 ? vals_tmp : vals_out;
    int64_t* kout = p % 2 ? keys_out : keys_tmp;
    int* vout = p % 2 ? vals_out : vals_tmp;
    sort_pass_kernel<<<(unsigned)blocks, kThreads, bytes, st>>>(
        kin, vin, T, p * kBits, hist + p * kBins, (uint64_t)(p + 1), tickets + p, status, kout,
        vout);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
