// The decoupled look-back of the port's stream compactions: route_rows.cu
// (K16, the exchange's keep/send split) and merge_groups.cu (K3, the
// cleanup's survivors in input order).
//
// Blocks take their tiles by a ticket (an atomic counter, word 0 of the
// scratch; the block that draws the last ticket sets it back to 0), so a
// block never waits on one that has not started.  Each tile publishes its
// count in its status word, looks back over its predecessors' words and
// publishes its inclusive prefix.  A status word holds the count (bits
// 0-31), a flag (bits 32-33: count or inclusive prefix) and the call's
// epoch (bits 34-63): a word from an earlier call has another epoch and
// reads as not published, so the words need no reset between calls (the
// wrapper zeroes them once, when the epoch wraps).  The prefixes are exact
// integers: the same on every run, whichever block draws which ticket.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLookBack = 2;    // status words a lane reads in a look-back window
constexpr uint64_t kCount = 1ull << 32;   // the flags of a status word
constexpr uint64_t kPrefix = 2ull << 32;
constexpr uint64_t kFlags = 3ull << 32;

__device__ __forceinline__ uint64_t load_status(const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void store_status(unsigned long long* p, uint64_t v) {
  *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

// The block's tile: its ticket, drawn by thread 0 (call from every thread;
// the result is in shared memory after a barrier).
__device__ __forceinline__ int64_t draw_ticket(unsigned long long* ticket) {
  __shared__ int64_t s_tile;
  if (threadIdx.x == 0) {
    const unsigned long long b = atomicAdd(ticket, 1ull);
    if (b == gridDim.x - 1ull) atomicExch(ticket, 0ull);  // every block holds its ticket
    s_tile = (int64_t)b;
  }
  __syncthreads();
  return s_tile;
}

// The rows the tiles before `tile` counted, for every lane of warp 0.  A
// window is kLookBack status words a lane (lane l reads the words l *
// kLookBack .. l * kLookBack + kLookBack - 1 below j), so 32 * kLookBack
// predecessors a window, read again until all of them are published in this
// call: the nearest inclusive prefix among them ends the walk, else their
// counts are added and the walk goes on below the window.
__device__ int64_t look_back(const unsigned long long* status, int64_t tile, uint64_t epoch,
                             int lane) {
  int64_t before = 0;
  for (int64_t j = tile - 1;; j -= 32 * kLookBack) {
    uint64_t s[kLookBack];
    bool ready;
    do {  // until every word of the window is published by this call
      ready = true;
#pragma unroll
      for (int r = 0; r < kLookBack; ++r) {
        const int64_t p = j - lane * kLookBack - r;
        s[r] = p >= 0 ? load_status(status + p) : ((epoch << 34) | kPrefix);  // 0 before row 0
        ready &= (s[r] >> 34) == epoch && (s[r] & kFlags) != 0;
      }
    } while (!ready);
    // this lane's nearest inclusive prefix and the counts after it
    int64_t part = 0;
    bool found = false;
#pragma unroll
    for (int r = 0; r < kLookBack; ++r) {
      if (!found) part += (uint32_t)s[r];
      found |= (s[r] & kFlags) == kPrefix;
    }
    const unsigned prefixes = __ballot_sync(0xffffffffu, found);
    const int stop = prefixes ? __ffs(prefixes) - 1 : 31;
    int64_t add = lane <= stop ? part : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) add += __shfl_xor_sync(0xffffffffu, add, o);
    before += add;
    if (prefixes) return before;
  }
}

// Warp 0 of the block of `tile`: publishes the tile's count, looks back and
// publishes its inclusive prefix; returns the count before the tile (on
// every lane of warp 0).
__device__ __forceinline__ int64_t publish_and_look_back(unsigned long long* status,
                                                         int64_t tile, uint64_t epoch,
                                                         int lane, int tile_count) {
  int64_t before = 0;
  if (tile == 0) {
    if (lane == 0) store_status(status, (epoch << 34) | kPrefix | (uint32_t)tile_count);
  } else {
    if (lane == 0) store_status(status + tile, (epoch << 34) | kCount | (uint32_t)tile_count);
    before = look_back(status, tile, epoch, lane);
    if (lane == 0)
      store_status(status + tile, (epoch << 34) | kPrefix | (uint32_t)(before + tile_count));
  }
  return before;
}

int device_sms() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sms = 132;
  return sms;
}

// Rows a tile of a compaction of n rows by blocks of `threads`: about four
// tiles an SM, in whole chunks of `threads` rows, at most max_chunks of them.
int64_t look_back_tile_rows(int64_t n, int threads, int max_chunks) {
  const int64_t want = 4 * (int64_t)device_sms();
  int64_t tile = (n + want - 1) / want;
  tile = (tile + threads - 1) / threads * threads;
  if (tile < threads) tile = threads;
  return tile > (int64_t)threads * max_chunks ? (int64_t)threads * max_chunks : tile;
}

}  // namespace
