// The cleanup's merge of sorted groups (K3), for Hopper (sm_90a): each group
// of equal row signatures summed, thresholded, and its first row written, in
// order of first occurrence.
//
// Replaces the tail of symmer_tpu/kernels/jx_core.py:cleanup_sorted's
// default route (:255, :356-367), _cleanup_from_hashes (:416) with its
// segmented sum (:390) and its row_source (the survivors' rows gathered, or
// rebuilt from their pair index after mul_pairs_cleanup's product, :561).
// Inputs: perm: int32[T], the rows sorted stably by the first signature
// key ka (K17, sort_keys.cu; or by (ka, kb) after a split run, below), kas:
// ka in that order, ka and kb: int64[T] by input row, the coefficients cr,
// ci: float64[T], optional live flags: bool[T] (rows that take part; all
// where absent) and a row source (merge_rows.cuh): planes, a product's
// pairs, a rotation's slots or masked rows.
// This is the route above 4,096 rows; up to that, one block sorts, merges
// and compacts in one launch (merge_small.cu, torch_core._merge_sorted).
// Bit for bit torch_core.merge_groups:
//   - a group is a run of sorted positions with equal (ka, kb); its sum
//     starts from +0.0 and adds the coefficients of the group's live rows
//     one by one in input order (the sort is stable), as
//     torch.segment_reduce does on the CPU over the live rows alone; a long
//     group stays one sequential sum (no tree, no atomics); a dead row adds
//     +0.0, which leaves such a sum as it is (begun at +0.0 it is never
//     -0.0);
//   - a group with a live row survives where hypot(re, im) > zero_threshold
//     (always without one); its first live row is its representative; the
//     survivors come in the order of their representatives, so the order
//     between groups in perm does not matter, and a sort by ka alone gives
//     the output of the sort by (ka, kb) unless two signatures share ka;
//   - the split check (a sort by ka alone): two adjacent sorted positions,
//     live or dead, with equal ka and unequal kb report a split run, and
//     the caller sorts by (ka, kb) and runs pass A again with the check off
//     (torch_core._merge_sorted).
//
// What bounds it: bytes.  perm, kas and the coefficients are read once (28
// bytes a row, and the flag's byte), kb where a key repeats, each
// survivor's row read and written once with its sum and key (chip_smoke.py's
// merge_bound).  The design, two launches and one host read between them:
//   - pass A (merge_sums_kernel), a thread a sorted position: perm and kas
//     read coalesced, the predecessor's from the lane below; kb through perm,
//     for both neighbours, only where ka equals the predecessor's; a
//     position whose keys differ from its predecessor's is a head; its
//     thread sums the group's first kShort rows, and where the group goes
//     on its warp sums the rest, kSpan x 32 positions loaded at once and
//     their coefficients added one by one in order from shared memory (the
//     same sequential sum, its loads no longer a chain), and finds the
//     group's first live row, rep (without flags perm[head]); the head's
//     thread tests the threshold and writes the sum and a keep flag at rep;
//     without flags every other row's flag is 0 (perm is a permutation, so
//     every flag is written once), with them the flags are zeroed before the
//     launch; the blocks add their keep counts to one integer counter and
//     set its bit 32 on a split run;
//   - the host reads that word (the call's one read): on a split run it
//     stops there, else the count sizes the outputs;
//   - pass B (merge_gather_kernel), over input order: a stream compaction
//     of the flags with the decoupled look-back of look_back.cuh (a ballot
//     a 32-row chunk, the tile's prefix from its predecessors' status
//     words), each survivor's sum and key written at its place by its lane,
//     its row copied by a group of lanes (a word of x and of z a lane),
//     from the planes or rebuilt from its source (merge_rows.cuh).
// No float atomics: the output is the same on every run.
#include <cuda_runtime.h>

#include <cstdint>

#include "look_back.cuh"
#include "merge_rows.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunks = 64;  // 32-row chunks of a warp's run: tiles of at most 16,384 rows
constexpr unsigned kFull = 0xffffffffu;
constexpr int kShort = 32;  // rows of a group its head's thread sums alone
constexpr int kSpan = 8;    // 32-row chunks a warp loads at once for a longer group
// the bit of pass A's count word that reports a split run (the count < 2^31)
constexpr unsigned long long kSplit = 1ull << 32;

// whether row g takes part (kLive: its flag; else every row does)
template <bool kLive>
__device__ __forceinline__ bool alive(const bool* __restrict__ live, int64_t g) {
  if constexpr (kLive) return __ldg(reinterpret_cast<const unsigned char*>(live) + g) != 0;
  return true;
}

// the coefficient a row adds to its group's sum: +0.0 for a dead row
template <bool kLive>
__device__ __forceinline__ double2 addend(const double* __restrict__ cr,
                                          const double* __restrict__ ci,
                                          const bool* __restrict__ live, int64_t g) {
  if (!alive<kLive>(live, g)) return make_double2(0.0, 0.0);
  return make_double2(__ldg(cr + g), __ldg(ci + g));
}

// kLive: rows carry live flags (else the flags and the representative's
// search compile away, and this is the kernel without flags)
template <bool kLive>
__global__ void __launch_bounds__(kThreads)
merge_sums_kernel(const int* __restrict__ perm, const int64_t* __restrict__ kas,
                  const int64_t* __restrict__ kb, const double* __restrict__ cr,
                  const double* __restrict__ ci, const bool* __restrict__ live, int64_t T,
                  int check, int has_threshold, double threshold, uint8_t* __restrict__ keep,
                  double* __restrict__ sr, double* __restrict__ si,
                  unsigned long long* __restrict__ count) {
  __shared__ double2 s_vals[kWarps][32];  // a chunk's coefficients, by lane
  const int64_t p = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool in = p < T;
  // the sorted key and row of this position, coalesced; the predecessor's
  // from the lane below (lane 0 loads its own)
  const int i = in ? __ldg(perm + p) : 0;
  const int64_t a = in ? __ldg(kas + p) : 0;
  int64_t pa = __shfl_up_sync(kFull, a, 1);
  int h = __shfl_up_sync(kFull, i, 1);
  if (lane == 0 && in && p > 0) {
    pa = __ldg(kas + p - 1);
    h = __ldg(perm + p - 1);
  }
  bool head = false, open = false, split = false;
  int64_t b = 0, q = 0;
  int rep = -1;  // the group's first live row
  double re = 0.0, im = 0.0;
  if (in) {
    head = p == 0 || pa != a;
    bool has_b = false;  // b: kb of row i, loaded only where a key repeats
    if (!head) {  // kb through perm, for both neighbours
      b = __ldg(kb + i);
      has_b = true;
      head = __ldg(kb + h) != b;
      split = head && check;  // a run of equal ka that is not one signature
    }
    if (head) {  // the first kShort rows of the group, alone
      const double2 v = addend<kLive>(cr, ci, live, i);
      re = __dadd_rn(0.0, v.x);
      im = __dadd_rn(0.0, v.y);
      if (alive<kLive>(live, i)) rep = i;
      for (q = p + 1; q < T && q < p + kShort; ++q) {
        if (__ldg(kas + q) != a) break;
        const int g = __ldg(perm + q);
        if (!has_b) {
          b = __ldg(kb + i);
          has_b = true;
        }
        if (__ldg(kb + g) != b) break;
        const double2 w = addend<kLive>(cr, ci, live, g);
        re = __dadd_rn(re, w.x);
        im = __dadd_rn(im, w.y);
        if (rep < 0 && alive<kLive>(live, g)) rep = g;
      }
      open = q == p + kShort && q < T;  // the group may go on past q (b is loaded)
    }
  }
  // the rest of an open group, by the whole warp: kSpan chunks of 32 sorted
  // positions loaded at once, the group's rows a prefix of them (the keys
  // are sorted), added one by one in order from shared memory
  for (unsigned o = __ballot_sync(kFull, open); o; o &= o - 1) {
    const int src = __ffs(o) - 1;
    const int64_t ga = __shfl_sync(kFull, a, src), gb = __shfl_sync(kFull, b, src);
    int64_t at = __shfl_sync(kFull, q, src);
    int r_rep = __shfl_sync(kFull, rep, src);
    double r = __shfl_sync(kFull, re, src), m = __shfl_sync(kFull, im, src);
    for (bool more = true; more;) {
      double vr[kSpan], vi[kSpan];
      bool same[kSpan], on[kSpan];
#pragma unroll
      for (int u = 0; u < kSpan; ++u) {
        const int64_t s = at + u * 32 + lane;
        same[u] = on[u] = false;
        vr[u] = vi[u] = 0.0;
        if (s < T && __ldg(kas + s) == ga) {
          const int g = __ldg(perm + s);
          same[u] = __ldg(kb + g) == gb;
          if (same[u]) {
            const double2 v = addend<kLive>(cr, ci, live, g);
            vr[u] = v.x;
            vi[u] = v.y;
            on[u] = alive<kLive>(live, g);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kSpan; ++u) {
        if (more) {  // uniform over the warp
          const unsigned sm = __ballot_sync(kFull, same[u]);
          const int n = sm == kFull ? 32 : __ffs(~sm) - 1;
          if (kLive && r_rep < 0) {  // the first live row of the chunk (at: its first)
            const unsigned lm = __ballot_sync(kFull, on[u]);
            if (lm) r_rep = __ldg(perm + at + __ffs(lm) - 1);
          }
          s_vals[warp][lane] = make_double2(vr[u], vi[u]);
          __syncwarp();
#pragma unroll 8
          for (int k = 0; k < n; ++k) {  // broadcast reads, issued ahead of the adds
            const double2 v = s_vals[warp][k];
            r = __dadd_rn(r, v.x);
            m = __dadd_rn(m, v.y);
          }
          __syncwarp();  // s_vals is rewritten for the next chunk
          at += n;
          more = n == 32;
        }
      }
    }
    if (lane == src) {
      re = r;
      im = m;
      rep = r_rep;
    }
  }
  bool kept = false;
  if (head) {
    kept = rep >= 0 && group_survives(re, im, has_threshold, threshold);
    if (kept) {
      sr[rep] = re;
      si[rep] = im;
    }
  }
  if (!kLive) {
    if (in) keep[i] = kept;  // rep == i
  } else if (kept) {
    keep[rep] = 1;  // the flags were zeroed before the launch
  }
  const int n = __syncthreads_count(kept);
  const int splits = __syncthreads_or(split);
  if (threadIdx.x == 0) {
    if (n) atomicAdd(count, (unsigned long long)n);
    if (splits) atomicOr(count, kSplit);
  }
}

__global__ void __launch_bounds__(kThreads)
merge_gather_kernel(const uint8_t* __restrict__ keep, const double* __restrict__ sr,
                    const double* __restrict__ si, const int64_t* __restrict__ ka, int64_t T,
                    int W, int64_t tile_rows, int source, const int64_t* __restrict__ x,
                    const int64_t* __restrict__ z, const int64_t* __restrict__ x2,
                    const int64_t* __restrict__ z2, int64_t M2, int log2_lanes, uint64_t epoch,
                    unsigned long long* ticket, unsigned long long* status,
                    int64_t* __restrict__ ox, int64_t* __restrict__ oz,
                    double* __restrict__ ocr, double* __restrict__ oci,
                    int64_t* __restrict__ oka) {
  __shared__ int64_t s_before;
  __shared__ int s_warp_keep[kWarps];
  __shared__ unsigned s_mask[kWarps][kMaxChunks];
  __shared__ int s_lane[kWarps][32];  // a chunk's kept lanes, by rank
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t tile = draw_ticket(ticket);
  const int64_t r0 = tile * tile_rows;
  const int64_t r1 = r0 + tile_rows < T ? r0 + tile_rows : T;
  const int chunks = (int)(tile_rows / kThreads);
  const int64_t w0 = r0 + (int64_t)warp * chunks * 32;  // this warp's run of the tile
  const int64_t w1 = w0 + chunks * 32 < r1 ? w0 + chunks * 32 : r1;
  int kept = 0;
  for (int c = 0; c < chunks; ++c) {
    const int64_t i = w0 + c * 32 + lane;
    const unsigned m = __ballot_sync(kFull, i < w1 && __ldg(keep + i));
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

  // the scatter, chunk by chunk: a kept row's place from the masks
  const RowSource src{source, W, M2, x, z, x2, z2};
  const int L = 1 << log2_lanes, li = lane & (L - 1), g = lane >> log2_lanes;
  const int P = 32 >> log2_lanes;  // rows a pass of the warp's row copies
  const unsigned below = (1u << lane) - 1u;
  int64_t base = s_before + before_warp;  // kept rows before the chunk
  for (int c = 0; c < chunks; ++c) {
    const int64_t c0 = w0 + c * 32;
    if (c0 >= w1) break;
    const unsigned m = s_mask[warp][c];
    if ((m >> lane) & 1u) {
      const int rank = __popc(m & below);
      const int64_t i = c0 + lane, d = base + rank;
      ocr[d] = __ldg(sr + i);
      oci[d] = __ldg(si + i);
      oka[d] = __ldg(ka + i);
      s_lane[warp][rank] = lane;
    }
    __syncwarp();
    const int nk = __popc(m);
    for (int r = g; r < nk; r += P)  // rotation: M2 is T / 2, the input rows
      copy_row(src, c0 + s_lane[warp][r], base + r, li, L, ox, oz);
    __syncwarp();  // s_lane is rewritten for the next chunk
    base += nk;
  }
}

}  // namespace

// Pass A.  perm: int32[T], the stable sort of the rows by ka (K17,
// sort_keys.cu) or by (ka, kb); kas: int64[T], ka in that order; kb:
// int64[T] by input row; cr, ci: float64[T] (1 <= T < 2^31); live: bool[T],
// or null (every row live); check: 1 where perm sorts by ka alone (adjacent
// equal ka with unequal kb then set bit 32 of the count: the sort split a
// group), 0 where it sorts by (ka, kb); keep: uint8[T] (zeroed here where
// live is given); sums: float64[2 T] (re, then im; only the kept rows' are
// written); count: uint64[1], set to 0 here, then the survivors (bits
// 0-31) and the split report.  One launch.
extern "C" int symmer_merge_groups_sums(const void* perm, const void* kas, const void* kb,
                                        const void* cr, const void* ci, const void* live,
                                        int64_t T, int64_t check, int64_t has_threshold,
                                        double threshold, void* keep, void* sums, void* count,
                                        void* stream) {
  if (T < 1 || T >= (int64_t(1) << 31)) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(count, 0, sizeof(unsigned long long), st);
  if (err == cudaSuccess && live != nullptr) err = cudaMemsetAsync(keep, 0, (size_t)T, st);
  if (err != cudaSuccess) return (int)err;
  auto* s = static_cast<double*>(sums);
  auto* kernel = live != nullptr ? merge_sums_kernel<true> : merge_sums_kernel<false>;
  kernel<<<(unsigned)((T + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      static_cast<const int*>(perm), static_cast<const int64_t*>(kas),
      static_cast<const int64_t*>(kb), static_cast<const double*>(cr),
      static_cast<const double*>(ci), static_cast<const bool*>(live), T, (int)(check != 0),
      (int)(has_threshold != 0), threshold, static_cast<uint8_t*>(keep), s, s + T,
      static_cast<unsigned long long*>(count));
  return (int)cudaGetLastError();
}

// The tiles (blocks) of pass B over T rows on the current device: the
// status words it needs.
extern "C" int64_t symmer_merge_groups_tiles(int64_t T) {
  if (T < 1) return 0;
  const int64_t tile = look_back_tile_rows(T, kThreads, kMaxChunks);
  return (T + tile - 1) / tile;
}

// Pass B.  keep, sums: pass A's; ka: int64[T]; the row source (source: 0
// planes, 1 pairs, 2 rotation, 3 masked): planes x, z int64[T, W] (x2 = z2 =
// null); pairs x, z the operands' x1, z1: int64[M1, W] and x2, z2: int64[M2,
// W] with M1 M2 = T; rotation x, z: int64[T / 2, W] and x2, z2 Q's xr, zr:
// int64[W] (T even); masked x, z: int64[T, W] and x2 = z2 = col_keep:
// int64[W]; M2 is read for pairs only; scratch:
// int64[1 + symmer_merge_groups_tiles(T)], word 0 the ticket (0 between
// calls), then the status words, used on one stream at a time; epoch in [1,
// 2^30), another than the last call's on this scratch; ox, oz: int64[n, W],
// ocr, oci: float64[n], oka: int64[n], n pass A's count.  One launch.
extern "C" int symmer_merge_groups_gather(const void* keep, const void* sums, const void* ka,
                                          int64_t T, int64_t W, int64_t source, const void* x,
                                          const void* z, const void* x2, const void* z2,
                                          int64_t M2, int64_t epoch, void* scratch, void* ox,
                                          void* oz, void* ocr, void* oci, void* oka,
                                          void* stream) {
  if (T < 1 || T >= (int64_t(1) << 31) || W < 0 || W > (1 << 26) || source < kPlanes ||
      source > kMasked || (source == kPairs && (M2 < 1 || T % M2 != 0)) ||
      (source == kRotation && T % 2 != 0) || epoch < 1 || epoch >= (int64_t(1) << 30))
    return (int)cudaErrorInvalidValue;
  if (source == kRotation) M2 = T / 2;
  const int64_t tile = look_back_tile_rows(T, kThreads, kMaxChunks);
  const int64_t blocks = (T + tile - 1) / tile;
  const int log2_lanes = row_lanes_log2(W);  // lanes a row's copy
  auto* words = static_cast<unsigned long long*>(scratch);
  const auto* s = static_cast<const double*>(sums);
  auto i64 = [](const void* p) { return static_cast<const int64_t*>(p); };
  merge_gather_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(keep), s, s + T, i64(ka), T, (int)W, tile, (int)source, i64(x),
      i64(z), i64(x2), i64(z2), M2, log2_lanes, (uint64_t)epoch, words, words + 1,
      static_cast<int64_t*>(ox), static_cast<int64_t*>(oz), static_cast<double*>(ocr),
      static_cast<double*>(oci), static_cast<int64_t*>(oka));
  return (int)cudaGetLastError();
}
