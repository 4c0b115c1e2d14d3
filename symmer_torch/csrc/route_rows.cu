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
// planes and coefficients, 16 W + 16 bytes) and its key read once;
// chip_smoke.py's route_bound counts them at 3.35 TB/s.  The design:
//   - launch 1 (route_count): each block counts the kept rows of its tile
//     of rows (one key load a row, a warp-shuffle sum);
//   - launch 2 (route_scatter): each block adds up the counts of the
//     blocks before it (a few hundred at most: the tile grows with n so
//     that there are about four blocks an SM), then walks its tile 256 rows
//     at a time: a warp ballot and the warps' totals give every row its
//     place on its side, the coefficients go out a thread a row, and the
//     planes go out as a flat copy of the chunk's words (neighbouring
//     threads on neighbouring words, kept and sent rows each in runs);
//   - the last block writes the two counts.
// No atomics: the result is the same on every run.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ bool kept(const int64_t* key, int64_t i, int k, int bit) {
  return (int)((__ldg(key + i) >> k) & 1) == bit;
}

// the sum of one value a thread, for thread 0
__device__ __forceinline__ int64_t block_sum(int64_t v, int64_t* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int64_t s = 0;
  if (threadIdx.x == 0)
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w];
  __syncthreads();
  return s;
}

__global__ void __launch_bounds__(kThreads)
route_count(const int64_t* __restrict__ key, int64_t n, int64_t tile, int k, int bit,
            int64_t* __restrict__ block_keep) {
  __shared__ int64_t red[kWarps];
  const int64_t r0 = (int64_t)blockIdx.x * tile;
  const int64_t r1 = r0 + tile < n ? r0 + tile : n;
  int64_t c = 0;
  for (int64_t i = r0 + threadIdx.x; i < r1; i += kThreads) c += kept(key, i, k, bit);
  c = block_sum(c, red);
  if (threadIdx.x == 0) block_keep[blockIdx.x] = c;
}

__global__ void __launch_bounds__(kThreads)
route_scatter(const int64_t* __restrict__ x, const int64_t* __restrict__ z,
              const double* __restrict__ cr, const double* __restrict__ ci,
              const int64_t* __restrict__ key, int64_t n, int W, int64_t tile, int k,
              int bit, const int64_t* __restrict__ block_keep, int64_t* __restrict__ xk,
              int64_t* __restrict__ zk, double* __restrict__ crk, double* __restrict__ cik,
              int64_t* __restrict__ xs, int64_t* __restrict__ zs, double* __restrict__ crs,
              double* __restrict__ cis, int64_t* __restrict__ counts) {
  __shared__ int64_t red[kWarps];
  __shared__ int warp_keep[kWarps], warp_send[kWarps];
  __shared__ int64_t dest[kThreads];
  __shared__ bool side[kThreads];
  __shared__ int64_t base;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t r0 = (int64_t)blockIdx.x * tile;
  const int64_t r1 = r0 + tile < n ? r0 + tile : n;
  // the kept rows of the blocks before this one
  int64_t before = 0;
  for (int64_t b = t; b < (int64_t)blockIdx.x; b += kThreads) before += __ldg(block_keep + b);
  before = block_sum(before, red);
  if (t == 0) base = before;
  __syncthreads();
  int64_t keep_at = base, send_at = r0 - base;
  const unsigned below = (1u << lane) - 1;
  for (int64_t c0 = r0; c0 < r1; c0 += kThreads) {
    const int64_t i = c0 + t;
    const bool valid = i < r1;
    const bool go = valid && kept(key, i, k, bit);
    const unsigned bk = __ballot_sync(0xffffffffu, go);
    const unsigned bs = __ballot_sync(0xffffffffu, valid && !go);
    if (lane == 0) {
      warp_keep[warp] = __popc(bk);
      warp_send[warp] = __popc(bs);
    }
    __syncthreads();
    int pk = 0, ps = 0, tk = 0, ts = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) {
        pk += warp_keep[w];
        ps += warp_send[w];
      }
      tk += warp_keep[w];
      ts += warp_send[w];
    }
    if (valid) {
      const int64_t d = go ? keep_at + pk + __popc(bk & below) : send_at + ps + __popc(bs & below);
      dest[t] = d;
      side[t] = go;
      (go ? crk : crs)[d] = __ldg(cr + i);
      (go ? cik : cis)[d] = __ldg(ci + i);
    }
    __syncthreads();
    // the chunk's planes, word by word: a thread takes every 256th word
    const unsigned rows = (unsigned)(r1 - c0 < kThreads ? r1 - c0 : kThreads);
    const unsigned words = rows * (unsigned)W;
    const int64_t* xin = x + c0 * W;
    const int64_t* zin = z + c0 * W;
    for (unsigned e = t; e < words; e += kThreads) {
      const unsigned r = e / (unsigned)W, w = e - r * (unsigned)W;
      const int64_t at = dest[r] * W + w;
      (side[r] ? xk : xs)[at] = __ldg(xin + e);
      (side[r] ? zk : zs)[at] = __ldg(zin + e);
    }
    keep_at += tk;
    send_at += ts;
    __syncthreads();  // dest, side and the warp totals are written again
  }
  if (blockIdx.x == gridDim.x - 1 && t == 0) {
    counts[0] = keep_at;
    counts[1] = send_at;
  }
}

}  // namespace

// The rows a block takes in a partition of n rows: about four blocks an SM
// of the current device, in whole 256-row chunks.
extern "C" int64_t symmer_route_rows_tile(int64_t n) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sms = 132;
  const int64_t want = 4 * (int64_t)sms;
  int64_t tile = (n + want - 1) / want;
  tile = (tile + kThreads - 1) / kThreads * kThreads;
  return tile < kThreads ? kThreads : tile;
}

// x, z: int64[n, W]; cr, ci: float64[n]; key: int64[n]; 0 <= k < 63, bit in
// {0, 1}; the keep planes xk, zk and the send planes xs, zs: int64[>= n, W];
// crk, cik, crs, cis: float64[>= n]; none of the outputs overlaps an input;
// block_keep: int64[ceil(n / tile)] scratch with tile from
// symmer_route_rows_tile(n); counts: int64[2].  Two launches.
extern "C" int symmer_route_rows(const void* x, const void* z, const void* cr, const void* ci,
                                 const void* key, int64_t n, int64_t W, int64_t k,
                                 int64_t bit, int64_t tile, void* block_keep, void* xk,
                                 void* zk, void* crk, void* cik, void* xs, void* zs,
                                 void* crs, void* cis, void* counts, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (n < 1 || W < 0 || W > (1 << 23) || k < 0 || k > 62 || (bit != 0 && bit != 1) ||
      tile < kThreads || tile % kThreads)
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = (n + tile - 1) / tile;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  const auto* k64 = static_cast<const int64_t*>(key);
  auto* bk = static_cast<int64_t*>(block_keep);
  route_count<<<(unsigned)blocks, kThreads, 0, st>>>(k64, n, tile, (int)k, (int)bit, bk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  route_scatter<<<(unsigned)blocks, kThreads, 0, st>>>(
      static_cast<const int64_t*>(x), static_cast<const int64_t*>(z),
      static_cast<const double*>(cr), static_cast<const double*>(ci), k64, n, (int)W, tile,
      (int)k, (int)bit, bk, static_cast<int64_t*>(xk), static_cast<int64_t*>(zk),
      static_cast<double*>(crk), static_cast<double*>(cik), static_cast<int64_t*>(xs),
      static_cast<int64_t*>(zs), static_cast<double*>(crs), static_cast<double*>(cis),
      static_cast<int64_t*>(counts));
  return (int)cudaGetLastError();
}
