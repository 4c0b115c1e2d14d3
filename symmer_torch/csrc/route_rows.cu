// One round of the mesh's hash-routed exchange, for Hopper (sm_90a): a
// stable partition of a shard's rows into the rows it keeps and the rows it
// sends to its partner.
//
// Replaces the keep/send split and the two stable compactions of
// symmer_tpu/parallel/distributed.py:_exchange_round (:86-98, _compact at
// :48-65: a cumsum of the mask and a scatter per array, four arrays a side).
// Row i (planes x, z: int64[n, W], coefficients cr, ci: float64[n]) is kept
// when bit k of its routing key equals the shard's own bit, and sent
// otherwise; the kept rows are written in input order to the front of the
// keep buffers, the sent rows in input order to the front of the send
// buffers, and counts[0] / counts[1] get the two counts.
//
// What bounds it: bytes.  Every row is read once and written once (its
// planes and coefficients, 16 W + 16 bytes each way) and its key read once;
// chip_smoke.py's route_bound counts them at 3.35 TB/s.  The design, one
// launch with a decoupled look-back:
//   - a block takes its tile of rows by a ticket (an atomic counter), so it
//     never waits on a block that has not started; the block that draws the
//     last ticket sets the counter back to 0 for the next call;
//   - each warp counts the kept rows of its run of the tile with one ballot
//     per 32 rows (the masks stay in shared memory), and loads the first
//     rows of its run into registers with their keys (coefficients and
//     plane units: at W = 16 the whole run where the tiles are 256 rows,
//     half of its first 32 rows otherwise), before the block finds its
//     place;
//   - warp 0 publishes the tile's count in the tile's status word, looks
//     back over its predecessors' words, a window of 64 at a time, adding
//     their counts until it meets an inclusive prefix, and publishes its own
//     inclusive prefix.  A status word holds the count (bits 0-31), a flag
//     (bits 32-33: count or inclusive prefix) and the call's epoch (bits
//     34-63): a word from an earlier call has another epoch and reads as
//     not published, so the words need no reset between calls (the wrapper
//     zeroes them once, when the epoch wraps);
//   - a row's place follows from the ballot masks alone: the kept rows
//     before it, k, place a kept row at k and a sent one at i - k.  The
//     coefficients go out a lane a row; the planes as whole rows, a group
//     of lanes a row (16-byte vectors where W is even and the planes are
//     16-byte aligned), the row's place passed by a shuffle;
//   - three block barriers a tile (the ticket, the warps' counts, the
//     prefix), none per 32 rows;
//   - the block of the last tile writes the two counts.
// The prefix sums are exact integers: the outputs are the same on every run,
// whichever block draws which ticket.  The only atomics are the ticket's.
// The ticket, the look-back and the tile sizes are in look_back.cuh, shared
// with merge_groups.cu (K3).
#include <cuda_runtime.h>

#include <cstdint>

#include "look_back.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunks = 64;  // 32-row chunks of a warp's run: tiles of at most 16,384 rows
constexpr unsigned kFull = 0xffffffffu;
template <int V>
struct Unit;  // one unit of a plane row: two words in a 16-byte vector, or one
template <>
struct Unit<2> {
  using T = longlong2;
};
template <>
struct Unit<1> {
  using T = long long;
};

// V: words a unit of a plane row, 2 (one 16-byte vector) or 1; B: passes of
// plane rows a lane loads before it stores them
template <int V, int B>
__global__ void __launch_bounds__(kThreads)
route_rows_kernel(const int64_t* __restrict__ x, const int64_t* __restrict__ z,
                  const int64_t* __restrict__ cr, const int64_t* __restrict__ ci,
                  const int64_t* __restrict__ key, int64_t n, int W, int64_t tile_rows, int k,
                  int bit, int log2_lanes, uint64_t epoch, unsigned long long* ticket,
                  unsigned long long* status, int64_t* __restrict__ xk, int64_t* __restrict__ zk,
                  int64_t* __restrict__ crk, int64_t* __restrict__ cik,
                  int64_t* __restrict__ xs, int64_t* __restrict__ zs,
                  int64_t* __restrict__ crs, int64_t* __restrict__ cis,
                  int64_t* __restrict__ counts) {
  using Vec = typename Unit<V>::T;
  __shared__ int64_t s_before;
  __shared__ int s_warp_keep[kWarps];
  __shared__ unsigned s_mask[kWarps][kMaxChunks];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t tile = draw_ticket(ticket);
  const int64_t r0 = tile * tile_rows;
  const int64_t r1 = r0 + tile_rows < n ? r0 + tile_rows : n;
  const int chunks = (int)(tile_rows / kThreads);
  const int64_t w0 = r0 + (int64_t)warp * chunks * 32;  // this warp's run of the tile
  const int64_t w1 = w0 + chunks * 32 < r1 ? w0 + chunks * 32 : r1;

  // The plane rows go a group of L lanes a row, P = 32 / L rows a pass; where
  // a row has at most L units (one a lane) the passes run B at a time,
  // loads first.  The first chunk's coefficients and first batch of plane
  // units are loaded with its keys, before the block finds its place.
  const int L = 1 << log2_lanes, li = lane & (L - 1), g = lane >> log2_lanes;
  const int P = 32 >> log2_lanes;
  const int units = 2 * W / V;
  const bool one = units <= L;
  const int q = li * V;  // on the one-unit path: this lane's first word of a row's x then z words
  const bool in_x = q < W, has_unit = li < units;
  const int wofs = in_x ? q : q - W;
  const int64_t* plane = in_x ? x : z;
  Vec buf[B];
  int64_t cr0 = 0, ci0 = 0;
  if (w0 + lane < w1) {
    cr0 = __ldg(cr + w0 + lane);
    ci0 = __ldg(ci + w0 + lane);
  }
  if (one) {
#pragma unroll
    for (int b = 0; b < B; ++b) {
      if (b * P >= 32) break;  // the chunk's passes (uniform across the warp)
      const int j = b * P + g;
      if (has_unit && w0 + j < w1)
        buf[b] = __ldg(reinterpret_cast<const Vec*>(plane + (w0 + j) * W + wofs));
    }
  }
  int kept = 0;
  for (int c = 0; c < chunks; ++c) {
    const int64_t i = w0 + c * 32 + lane;
    const bool go = i < w1 && (int)((__ldg(key + i) >> k) & 1) == bit;
    const unsigned m = __ballot_sync(kFull, go);
    if (lane == 0) s_mask[warp][c] = m;
    kept += __popc(m);
  }
  if (lane == 0) s_warp_keep[warp] = kept;
  __syncthreads();
  int before_warp = 0, tile_keep = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    before_warp += w < warp ? s_warp_keep[w] : 0;
    tile_keep += s_warp_keep[w];
  }
  if (warp == 0) {
    const int64_t before = publish_and_look_back(status, tile, epoch, lane, tile_keep);
    if (lane == 0) s_before = before;
  }
  __syncthreads();
  const int64_t before_tile = s_before;
  if (tile == (int64_t)gridDim.x - 1 && t == 0) {
    counts[0] = before_tile + tile_keep;
    counts[1] = n - (before_tile + tile_keep);
  }

  // the scatter, chunk by chunk: row i's place d on its side from the masks
  const unsigned below = (1u << lane) - 1u;
  int64_t kept_before = before_tile + before_warp;  // kept rows before the chunk
  for (int c = 0; c < chunks; ++c) {
    const int64_t c0 = w0 + c * 32;
    if (c0 >= w1) break;
    const unsigned m = s_mask[warp][c];
    const int64_t i = c0 + lane;
    const int64_t ki = kept_before + __popc(m & below);
    const bool go = (m >> lane) & 1u;
    const int64_t d = go ? ki : i - ki;
    const int rows = w1 - c0 < 32 ? (int)(w1 - c0) : 32;
    if (lane < rows) {
      (go ? crk : crs)[d] = c == 0 ? cr0 : __ldg(cr + i);
      (go ? cik : cis)[d] = c == 0 ? ci0 : __ldg(ci + i);
    }
    if (one) {
      int64_t* const keep_plane = in_x ? xk : zk;
      int64_t* const send_plane = in_x ? xs : zs;
      for (int p0 = 0; p0 * P < rows; p0 += B) {
        if (c > 0 || p0 > 0) {
#pragma unroll
          for (int b = 0; b < B; ++b) {
            if ((p0 + b) * P >= rows) break;
            const int j = (p0 + b) * P + g;
            if (has_unit && j < rows)
              buf[b] = __ldg(reinterpret_cast<const Vec*>(plane + (c0 + j) * W + wofs));
          }
        }
#pragma unroll
        for (int b = 0; b < B; ++b) {
          if ((p0 + b) * P >= rows) break;
          const int j = (p0 + b) * P + g;  // below 32
          const int64_t dj = __shfl_sync(kFull, d, j);
          if (has_unit && j < rows) {
            int64_t* to = ((m >> j) & 1u ? keep_plane : send_plane) + dj * W + wofs;
            *reinterpret_cast<Vec*>(to) = buf[b];
          }
        }
      }
    } else {  // wide rows: each lane of a row's group takes every L-th unit
      for (int j0 = 0; j0 < rows; j0 += P) {
        const int j = j0 + g;
        const int64_t dj = __shfl_sync(kFull, d, j);
        if (j < rows) {
          const bool gj = (m >> j) & 1u;
          const int64_t src = (c0 + j) * W, dst = dj * W;
          for (int u = li; u < units; u += L) {
            const int qu = u * V;
            const bool ux = qu < W;
            const int w = ux ? qu : qu - W;
            int64_t* to = (ux ? (gj ? xk : xs) : (gj ? zk : zs)) + dst + w;
            *reinterpret_cast<Vec*>(to) =
                __ldg(reinterpret_cast<const Vec*>((ux ? x : z) + src + w));
          }
        }
      }
    }
    kept_before += __popc(m);
  }
}

}  // namespace

// The blocks (tiles) of a partition of n rows on the current device: the
// status words the call needs.
extern "C" int64_t symmer_route_rows_tiles(int64_t n) {
  if (n < 1) return 0;
  const int64_t tile = look_back_tile_rows(n, kThreads, kMaxChunks);
  return (n + tile - 1) / tile;
}

// x, z: int64[n, W]; cr, ci: float64[n]; key: int64[n]; 1 <= n < 2^31;
// 0 <= k < 63, bit in {0, 1}; the keep planes xk, zk and the send planes xs,
// zs: int64[>= n, W]; crk, cik, crs, cis: float64[>= n]; none of the outputs
// overlaps an input; scratch: int64[1 + symmer_route_rows_tiles(n)], word 0
// the ticket (0 between calls), then the status words, used on one stream
// at a time; epoch in [1, 2^30), another than the last call's on this
// scratch; counts: int64[2].  One launch.
extern "C" int symmer_route_rows(const void* x, const void* z, const void* cr, const void* ci,
                                 const void* key, int64_t n, int64_t W, int64_t k,
                                 int64_t bit, int64_t epoch, void* scratch, void* xk, void* zk,
                                 void* crk, void* cik, void* xs, void* zs, void* crs, void* cis,
                                 void* counts, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (n < 1 || n >= (int64_t(1) << 31) || W < 0 || W > (1 << 23) || k < 0 || k > 62 ||
      (bit != 0 && bit != 1) || epoch < 1 || epoch >= (int64_t(1) << 30))
    return (int)cudaErrorInvalidValue;
  const int64_t tile = look_back_tile_rows(n, kThreads, kMaxChunks);
  const int64_t blocks = (n + tile - 1) / tile;
  const bool vec = W % 2 == 0;
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool v2 = vec && aligned(x) && aligned(z) && aligned(xk) && aligned(zk) &&
                  aligned(xs) && aligned(zs);
  const int units = (int)(v2 ? W : 2 * W);
  int log2_lanes = 0;
  while ((1 << log2_lanes) < units && log2_lanes < 5) ++log2_lanes;
  auto* words = static_cast<unsigned long long*>(scratch);
  auto i64 = [](const void* p) { return static_cast<const int64_t*>(p); };
  auto o64 = [](void* p) { return static_cast<int64_t*>(p); };
  // a warp's whole first chunk in registers where its run is one chunk (tiles of
  // 256 rows: one wave of blocks); half of it where blocks come in waves, whose
  // occupancy the registers would cut
  auto kernel = v2 ? (tile == kThreads ? route_rows_kernel<2, 16> : route_rows_kernel<2, 8>)
                   : (tile == kThreads ? route_rows_kernel<1, 16> : route_rows_kernel<1, 8>);
  kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
      i64(x), i64(z), i64(cr), i64(ci), i64(key), n, (int)W, tile, (int)k, (int)bit, log2_lanes,
      (uint64_t)epoch, words, words + 1, o64(xk), o64(zk), o64(crk), o64(cik), o64(xs), o64(zs),
      o64(crs), o64(cis), o64(counts));
  return (int)cudaGetLastError();
}
