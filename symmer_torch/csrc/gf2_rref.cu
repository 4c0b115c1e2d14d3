// GF(2) row reduction of packed rows, in place, for Hopper (sm_90a): K11.
//
// Replaces symmer_tpu/kernels/jx_gf2.py:rref_packed_device (:21-37), an
// XLA fori_loop of R full-matrix masked XORs.  For int64[R, W] rows (bit q
// at bit q % 64 of word q // 64), in row order: a row that is zero is
// skipped; a nonzero row p pivots on its lowest set bit (word pw, bit
// pbit), and every other row holding that bit gets row p XORed in (above
// and below).  Plain version: kernels/torch_gf2.py:rref, bit for bit (the
// reduced rows are unique given the order, whatever the order of work).
//
// What bounds it: the matrix read and written once is the least (16 R W
// bytes), but the work depends on the data: every row ends up reduced by
// about half of the rank's pivots, and the pivots are found one after the
// other.  The rank is at most the bit count (2,000 at 1,000 qubits), so
// most of the R rows of a tall stack are zero when their turn comes.
//
// The design: right-looking block elimination in
// one cooperative launch, up to P = 64 pivots a pass, so about rank / 64
// passes and two grid barriers a pass instead of one a pivot.
//
//  1. Panel (block 0).  From the cursor it takes the next live rows, 64 at
//     a time (a flag a row, kept by every pass: a zero row stays zero).
//     They are already reduced by every earlier pass's pivots; all warps
//     reduce them by the panel's pivots so far (as in the update).  Then
//     one warp walks them in row order, as the sequential algorithm would,
//     without touching whole rows: lane l holds chunk rows l and l + 32 as
//     T_j, a 64-bit mask of the chunk rows they are the XOR of, and their
//     words w0 and w0 + 1 (every chunk row is zero below w0).  A row whose
//     window is nonzero pivots on its lowest bit, and every other row
//     holding that bit takes its window and T (three shuffles a pivot); a
//     row whose window is zero is built from T, a lane a word, to find its
//     pivot further on or none, and the rows holding that bit are those
//     whose T has odd parity with the bit's column of the chunk.  The walk
//     stops at P pivots, after 512 live rows (the update, on every block,
//     zeroes dependent rows faster than the panel walks them) or at the end
//     of the stack.  All warps then build the new pivots from T, reduce the
//     panel's earlier pivots by them (one mask each, as in the update) and
//     zero the walked rows that did not pivot.  The pivots, mutually
//     reduced, go to M and to a scratch copy with their (word, bit) columns.
//     (A walk that XORs whole rows a pivot, on 16 warps or 4, took
//     0.85-1.3 us a pivot on the card: bound by instruction issue or by its
//     dependent chain; this one takes ~0.21 us, PERF.md.)
//  2. Update (every block).  Every other live row: the earlier pivot rows
//     above the cursor and the rows below the panel.  A warp reads a row
//     coalesced (a lane a word; four rows at once), gathers its bits at the
//     P pivot columns into a mask m by shuffles (a lane a pivot,
//     __ballot_sync), and XORs in the pivots of m, staged in shared memory.
//     Because the pivots are mutually reduced, that one combination equals
//     the P sequential updates: the result is the one row of r + span that
//     is zero at every pivot column.  Up to 64 words a row, the method of
//     four Russians: a table of the 16 sums of each group of 4 pivots (64
//     KB at W = 32, built by every block from the staged pivots), so a row
//     takes 16 table words a lane instead of one pivot word for each of the
//     ~32 set bits of m.  A row that turns zero clears its flag, so later
//     panels and updates skip it.
//
// Tensor cores do not pay here: K1's b1.and.popc product would compute
// every column of the R x 64W result of (mask matrix) x (pivots), where
// the XOR of the ~32 selected pivots is less work.
//
// Rows wider than kSmemPanelWords (the panel's 64 + 64 rows no longer fit
// one block's shared memory, e.g. the 2,200 x 3,160-word transposed stack
// of a 1,100-qubit symmetry search without its sketch) keep the panel's
// rows and pivots in a global scratch buffer (the walk itself needs two
// words a row), and the update stages every pivot's words 128 at a time in
// shared memory for a block's 16 rows, no tables.
//
// Built with -DSYMMER_GF2_RREF_SPLIT (tools/k11_split.py), block 0 reads
// %globaltimer around each step and adds the spans, in nanoseconds, to the
// scratch's control words 3-11: the live flags and first grid barrier, the
// panels, the wait after each panel, block 0's share of the updates, the
// wait after them, and inside the panels the chunks' scan, load and
// reduction, the walks, the chunk count and the pivots' building.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

using u64 = unsigned long long;
constexpr unsigned kFull = 0xffffffffu;

#ifdef SYMMER_GF2_RREF_SPLIT
constexpr int kCtlWords = 16;
#define SPLIT(...) __VA_ARGS__
__device__ __forceinline__ u64 split_clock() {
  u64 t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#else
constexpr int kCtlWords = 8;
#define SPLIT(...)
#endif

// -- the blocked kernel --------------------------------------------------------

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPivots = 64;                // P: one bit of a uint64 mask each
constexpr int kChunk = 64;                 // rows the panel holds at once
constexpr int kOwned = kChunk / kWarps;    // chunk rows a warp owns (u % kWarps)
constexpr int kSlots = kPivots / kWarps;   // pivot slots a warp owns (k % kWarps)
constexpr int kBudget = 512;               // live rows a panel takes at most
constexpr int kScanRows = 16 * kThreads;   // flags a scan step reads
constexpr int64_t kSmemPanelWords = 192;   // the panel in shared memory up to here
constexpr int64_t kTableWords = 64;        // Four Russians tables up to here
constexpr int kGroups = kPivots / 4;       // tables of the 16 sums of 4 pivots
constexpr int kTileWords = 128;            // wider rows: the update's pivot tile
static_assert(kChunk == 64 && kChunk % kWarps == 0,
              "chunk rows are bits of a uint64; the walk's lane l holds rows l and l + 32");

// scratch (global), laid out by scratch_layout: ctl[kCtlWords] (0: pivots
// of the pass, 1: the row after the panel, 2: passes; 3-11 the clock split
// above), the pivot columns, the pivot rows, a live flag a row
struct Scratch {
  int64_t* ctl;
  int* gword;
  int* gbit;
  u64* gpiv;
  unsigned char* live;
  u64* panel;  // rows wider than kSmemPanelWords: the panel's chunk rows and pivots
};

struct Layout {
  int64_t gword, gbit, gpiv, live, panel, total;
};

Layout scratch_layout(int64_t R, int64_t W) {
  Layout l;
  l.gword = 8 * kCtlWords;
  l.gbit = l.gword + 4 * kPivots;
  l.gpiv = l.gbit + 4 * kPivots;                 // 16-byte aligned
  l.live = l.gpiv + 8 * (int64_t)kPivots * W;    // 16-byte aligned
  l.panel = l.live + ((R + 15) & ~int64_t(15));  // flags read 16 at a time
  l.total = l.panel + (W > kSmemPanelWords ? 8 * (kChunk + kPivots) * (W | 1) : 0);
  return l;
}

// Shared memory.  Words [0, region(W)): the panel's chunk rows and pivots,
// or the update's staged pivots and (W <= kTableWords) its tables; then
// the chunk's row indices, the pivots' rows and columns, scan and walk
// scratch.
struct Smem {
  u64* base;
  u64* rows;
  u64* piv;
  int64_t* idx;
  int64_t* prow;
  u64* T;        // [kChunk]: each chunk row as a combination of the chunk's rows
  u64* prepnz;   // [kWarps]: each warp's nonzero chunk rows after the reduction
  u64* pivmask;  // the chunk rows that pivoted
  int* pword;
  int* pbit;
  int* pchunk;   // [kPivots]: a new pivot's chunk row
  int* wsum;
  int* prepw0;   // [kWarps]: each warp's lowest first nonzero word
  int* walked;   // [3]: pivots, the last row walked and w0, for every warp
};

__host__ __device__ constexpr int64_t region_words(int64_t W) {
  // the panel's rows and pivots at the odd stride W | 1 (a lane a row reads
  // a column without bank conflicts), or the update's staged pivots (and
  // tables) at stride W; for wider rows (both in global memory) a tile of
  // kTileWords words of every pivot
  return W > kSmemPanelWords ? kPivots * kTileWords
         : (kChunk + kPivots) * (W | 1) > (W <= kTableWords ? kGroups * 16 + kPivots : kPivots) * W
             ? (kChunk + kPivots) * (W | 1)
             : (W <= kTableWords ? kGroups * 16 + kPivots : kPivots) * W;
}

__host__ __device__ constexpr int64_t smem_bytes(int64_t W) {
  return 8 * region_words(W) + 8 * (2 * kChunk + kPivots + kWarps + 2) + 4 * 3 * kPivots +
         4 * 2 * kWarps + 4 * 4;
}

__device__ Smem carve(u64* base, int64_t W) {
  Smem s;
  s.base = base;
  s.rows = base;
  s.piv = base + kChunk * (W | 1);
  s.idx = reinterpret_cast<int64_t*>(base + region_words(W));
  s.prow = s.idx + kChunk;
  s.T = reinterpret_cast<u64*>(s.prow + kPivots);
  s.prepnz = s.T + kChunk;
  s.pivmask = s.prepnz + kWarps;
  s.pword = reinterpret_cast<int*>(s.pivmask + 2);
  s.pbit = s.pword + kPivots;
  s.pchunk = s.pbit + kPivots;
  s.wsum = s.pchunk + kPivots;
  s.prepw0 = s.wsum + kWarps;
  s.walked = s.prepw0 + kWarps;
  return s;
}

// acc ^ the XOR of piv[k * W + w] over the set bits k of m (two chains)
__device__ __forceinline__ u64 combine(u64 acc, u64 m, const u64* piv, int64_t W, int64_t w) {
  u64 other = 0;
  while (m) {
    acc ^= piv[(int64_t)(__ffsll((long long)m) - 1) * W + w];
    m &= m - 1;
    if (!m) break;
    other ^= piv[(int64_t)(__ffsll((long long)m) - 1) * W + w];
    m &= m - 1;
  }
  return acc ^ other;
}

// a row's bits at the npiv pivot columns, read from global memory (lane k:
// pivots k and k + 32), as a mask over the pivots
__device__ __forceinline__ u64 gathered_mask(const u64* row, int npiv, const int* pword,
                                             const int* pbit, int lane) {
  const unsigned lo = lane < npiv ? (unsigned)(__ldcg(row + pword[lane]) >> pbit[lane]) & 1u : 0u;
  const unsigned hi =
      lane + 32 < npiv ? (unsigned)(__ldcg(row + pword[lane + 32]) >> pbit[lane + 32]) & 1u : 0u;
  return (u64)__ballot_sync(kFull, lo) | ((u64)__ballot_sync(kFull, hi) << 32);
}

// x[c] of the lane holding word `word` (x[c] is word c * 32 + lane); every
// lane asks for its own word
template <int NWL>
__device__ __forceinline__ u64 word_of(const u64 (&x)[NWL], int word) {
  u64 v = 0;
#pragma unroll
  for (int c = 0; c < NWL; ++c) {
    const u64 y = __shfl_sync(kFull, x[c], word & 31);
    if ((word >> 5) == c) v = y;
  }
  return v;
}

// A row's bits at the npiv pivot columns (lane k: pivots k and k + 32) as
// a mask over the pivots, the row spread over the lanes as in word_of.
template <int NWL>
__device__ __forceinline__ u64 pivot_mask(const u64 (&x)[NWL], int npiv, const int* pword,
                                          const int* pbit, int lane) {
  const bool has0 = lane < npiv, has1 = lane + 32 < npiv;
  const u64 v0 = word_of(x, has0 ? pword[lane] : 0);
  const u64 v1 = word_of(x, has1 ? pword[lane + 32] : 0);
  const unsigned lo = has0 ? (unsigned)(v0 >> pbit[lane]) & 1u : 0u;
  const unsigned hi = has1 ? (unsigned)(v1 >> pbit[lane + 32]) & 1u : 0u;
  return (u64)__ballot_sync(kFull, lo) | ((u64)__ballot_sync(kFull, hi) << 32);
}

// Up to kChunk live rows from `from` on, in order, into s.idx; returns
// their count (below kChunk only when no live row is left after them).
__device__ int scan_live(const unsigned char* live, int64_t R, int64_t from, const Smem& s) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int found = 0;
  for (int64_t base = from & ~int64_t(15); base < R && found < kChunk; base += kScanRows) {
    const int64_t r0 = base + 16 * (int64_t)tid;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 < R) v = __ldcg(reinterpret_cast<const uint4*>(live + r0));
    const unsigned words[4] = {v.x, v.y, v.z, v.w};
    unsigned bits = 0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int64_t r = r0 + j;
      if (((words[j >> 2] >> (8 * (j & 3))) & 0xffu) && r >= from && r < R) bits |= 1u << j;
    }
    const int cnt = __popc(bits);
    int incl = cnt;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += y;
    }
    if (lane == 31) s.wsum[warp] = incl;
    __syncthreads();
    int before = found, total = 0;
    for (int q = 0; q < kWarps; ++q) {
      const int c = s.wsum[q];
      if (q < warp) before += c;
      total += c;
    }
    int pos = before + incl - cnt;
    while (bits && pos < kChunk) {
      s.idx[pos++] = r0 + (__ffs(bits) - 1);
      bits &= bits - 1;
    }
    found += total;
    __syncthreads();  // wsum is rewritten by the next step
  }
  return found < kChunk ? found : kChunk;
}

// Step 1: block 0 finds the pass's pivots from row i on (see the header).
// A chunk: all warps load its rows and reduce them by the panel's pivots so
// far (warp u % kWarps row u, NWL words a lane: word c * 32 + lane) into
// s.rows, the chunk's rows as the walk starts.  Every current row is then a
// combination T_j of them, and all of them are zero below word w0 (the
// lowest first nonzero word).  One warp walks the chunk in row order, lane
// l holding rows l and l + 32 as T_j and their words w0 and w0 + 1: a row
// whose window is nonzero pivots there, and the rows holding its bit take
// its window and T (three shuffles a pivot).  A row whose window is zero is
// built from T (a lane a word) to find its pivot further on (or none), and
// the rows' bits at that column are the parities of T_j and the column of
// the chunk's rows.  Then all warps build the new pivots from T, reduce the
// panel's earlier pivots by them (one mask each, as in the update) and
// zero the chunk's other walked rows.
template <int NWL>
__device__ void panel(u64* M, int64_t R, int64_t W, int64_t i, const Scratch& g,
                      const Smem& s) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t WS = W | 1;  // shared-memory stride of chunk rows and pivots
  int npiv = 0, taken = 0;
  int64_t cursor = i;
  while (npiv < kPivots && taken < kBudget && cursor < R) {
    SPLIT(const u64 tc0 = split_clock();)
    const int n = scan_live(g.live, R, cursor, s);
    if (n == 0) {
      cursor = R;
      break;
    }
    // load and reduce the chunk rows; their first nonzero word
    u64 nonzero = 0;
    int first = INT_MAX;
    if constexpr (NWL == 0) {  // a row at a time, a lane a word
      for (int q = 0; q < kOwned; ++q) {
        const int u = warp + kWarps * q;
        if (u >= n) break;
        const u64* src = M + s.idx[u] * W;
        const u64 m = npiv ? gathered_mask(src, npiv, s.pword, s.pbit, lane) : 0;
        int f = INT_MAX;
        for (int64_t b = 0; b < W; b += 32) {
          const int64_t w = b + lane;
          u64 v = 0;
          if (w < W) {
            v = combine(__ldcg(src + w), m, s.piv, WS, w);
            s.rows[u * WS + w] = v;
          }
          const unsigned bal = __ballot_sync(kFull, v != 0);
          if (bal && f == INT_MAX) f = (int)b + __ffs(bal) - 1;
        }
        if (f != INT_MAX) {
          nonzero |= 1ull << u;
          first = min(first, f);
        }
      }
    } else {
      u64 rr[kOwned][NWL];
#pragma unroll
      for (int q = 0; q < kOwned; ++q) {
        const int u = warp + kWarps * q;
#pragma unroll
        for (int c = 0; c < NWL; ++c) {
          const int64_t w = c * 32 + lane;
          rr[q][c] = (u < n && w < W) ? __ldcg(M + s.idx[u] * W + w) : 0;
        }
      }
      if (npiv) {
        u64 mq[kOwned], any = 0;
#pragma unroll
        for (int q = 0; q < kOwned; ++q) {
          mq[q] = pivot_mask(rr[q], npiv, s.pword, s.pbit, lane);
          any |= mq[q];
        }
        for (int k = 0; k < npiv; ++k) {
          if (!((any >> k) & 1)) continue;
          u64 pk[NWL];
#pragma unroll
          for (int c = 0; c < NWL; ++c)
            pk[c] = c * 32 + lane < W ? s.piv[k * WS + c * 32 + lane] : 0;
#pragma unroll
          for (int q = 0; q < kOwned; ++q)
            if ((mq[q] >> k) & 1)
#pragma unroll
              for (int c = 0; c < NWL; ++c) rr[q][c] ^= pk[c];
        }
      }
#pragma unroll
      for (int q = 0; q < kOwned; ++q) {
        const int u = warp + kWarps * q;
#pragma unroll
        for (int c = 0; c < NWL; ++c) {
          if (u < n && c * 32 + lane < W) s.rows[u * WS + c * 32 + lane] = rr[q][c];
          const unsigned bal = __ballot_sync(kFull, rr[q][c] != 0);
          if (bal && u < n) {
            nonzero |= 1ull << u;
            first = min(first, c * 32 + __ffs(bal) - 1);
          }
        }
      }
    }
    if (lane == 0) {
      s.prepnz[warp] = nonzero;
      s.prepw0[warp] = first;
    }
    __syncthreads();
    SPLIT(const u64 tc1 = split_clock();)
    const int base = npiv;  // the panel's pivots before this chunk
    if (warp == 0) {
      u64 live_rows = 0;
      int w0 = INT_MAX;
      for (int q = 0; q < kWarps; ++q) {
        live_rows |= s.prepnz[q];
        w0 = min(w0, s.prepw0[q]);
      }
      if (!live_rows) w0 = 0;
      const int j0 = lane, j1 = lane + 32;
      const bool two = w0 + 1 < W;
      u64 a0[2], a1[2], T[2];  // rows j0, j1: words w0 and w0 + 1, combination
      a0[0] = j0 < n && live_rows ? s.rows[j0 * WS + w0] : 0;
      a1[0] = j0 < n && live_rows && two ? s.rows[j0 * WS + w0 + 1] : 0;
      a0[1] = j1 < n && live_rows ? s.rows[j1 * WS + w0] : 0;
      a1[1] = j1 < n && live_rows && two ? s.rows[j1 * WS + w0 + 1] : 0;
      T[0] = j0 < n ? 1ull << j0 : 0;
      T[1] = j1 < n ? 1ull << j1 : 0;
      u64 pivots = 0;
      int tlast = n - 1;
      int rec_w0 = 0, rec_b0 = 0, rec_t0 = 0, rec_w1 = 0, rec_b1 = 0, rec_t1 = 0;  // lane q % 32
      // the window holds every word from w0 on: a row with a zero window is
      // zero, and is skipped
      const bool covers = w0 + 2 >= W;
      u64 todo = live_rows;  // the rows still to walk
      if (covers)
        todo &= (u64)__ballot_sync(kFull, (a0[0] | a1[0]) != 0) |
                ((u64)__ballot_sync(kFull, (a0[1] | a1[1]) != 0) << 32);
      while (todo) {
        const int t = __ffsll((long long)todo) - 1;
        todo &= todo - 1;
        const int h = t >> 5, src = t & 31;
        const u64 x0 = __shfl_sync(kFull, h ? a0[1] : a0[0], src);
        const u64 x1 = __shfl_sync(kFull, h ? a1[1] : a1[0], src);
        const u64 Tt = __shfl_sync(kFull, h ? T[1] : T[0], src);
        int pw;
        u64 pbit;
        if (x0 | x1) {  // it pivots in the window
          const u64 x = x0 ? x0 : x1;
          pw = x0 ? w0 : w0 + 1;
          pbit = x & (~x + 1);
#pragma unroll
          for (int q = 0; q < 2; ++q)
            if (lane + 32 * q != t && ((x0 ? a0[q] : a1[q]) & pbit)) {
              a0[q] ^= x0;
              a1[q] ^= x1;
              T[q] ^= Tt;
            }
          if (covers)
            todo &= (u64)__ballot_sync(kFull, (a0[0] | a1[0]) != 0) |
                    ((u64)__ballot_sync(kFull, (a0[1] | a1[1]) != 0) << 32);
        } else {  // its row from T, a lane a word, from the chunk of word w0 on
          pw = -1;
          pbit = 0;
          for (int64_t b = w0 & ~31; b < W && pw < 0; b += 32) {
            const int64_t w = b + lane;
            u64 v = 0;
            if (w < W)
              for (u64 m = Tt; m; m &= m - 1) v ^= s.rows[(__ffsll((long long)m) - 1) * WS + w];
            const unsigned bal = __ballot_sync(kFull, v != 0);
            if (bal) {
              const int sl = __ffs(bal) - 1;
              const u64 x = __shfl_sync(kFull, v, sl);
              pw = (int)b + sl;
              pbit = x & (~x + 1);
            }
          }
          if (pw < 0) continue;  // in the span of the pivots before it
          const u64 col = (u64)__ballot_sync(kFull, j0 < n && (s.rows[j0 * WS + pw] & pbit)) |
                          ((u64)__ballot_sync(kFull, j1 < n && (s.rows[j1 * WS + pw] & pbit)) << 32);
#pragma unroll
          for (int q = 0; q < 2; ++q)
            if (lane + 32 * q != t && (__popcll(T[q] & col) & 1)) T[q] ^= Tt;
        }
        const int q = npiv - base;
        if (lane == q) {
          rec_w0 = pw;
          rec_b0 = __ffsll((long long)pbit) - 1;
          rec_t0 = t;
        }
        if (lane + 32 == q) {
          rec_w1 = pw;
          rec_b1 = __ffsll((long long)pbit) - 1;
          rec_t1 = t;
        }
        pivots |= 1ull << t;
        if (++npiv == kPivots) {
          tlast = t;
          break;
        }
      }
      s.T[j0] = T[0];
      s.T[j1] = T[1];
      if (lane < npiv - base) {
        s.pword[base + lane] = rec_w0;
        s.pbit[base + lane] = rec_b0;
        s.prow[base + lane] = s.idx[rec_t0];
        s.pchunk[lane] = rec_t0;
      }
      if (lane + 32 < npiv - base) {
        s.pword[base + lane + 32] = rec_w1;
        s.pbit[base + lane + 32] = rec_b1;
        s.prow[base + lane + 32] = s.idx[rec_t1];
        s.pchunk[lane + 32] = rec_t1;
      }
      if (lane == 0) {
        s.walked[0] = npiv;
        s.walked[1] = tlast;
        s.walked[2] = w0;
        s.pivmask[0] = pivots;
      }
    }
    __syncthreads();
    SPLIT(const u64 tcw = split_clock();)
    npiv = s.walked[0];
    const int tlast = s.walked[1], w0 = s.walked[2];
    const u64 pivots = s.pivmask[0];
    // the new pivots from their combinations of the chunk's rows: warp w
    // builds new pivots w + 16 j, reading each chunk row once for all four
    const int fresh = npiv - base;
    if (warp < fresh) {
      u64 Tq[kSlots];
#pragma unroll
      for (int j = 0; j < kSlots; ++j)
        Tq[j] = warp + kWarps * j < fresh ? s.T[s.pchunk[warp + kWarps * j]] : 0;
      for (int64_t w = lane; w < W; w += 32) {
        u64 acc[kSlots] = {};
        for (int k = 0; k < n; ++k) {
          const u64 r = s.rows[k * WS + w];
#pragma unroll
          for (int j = 0; j < kSlots; ++j)
            if ((Tq[j] >> k) & 1) acc[j] ^= r;
        }
#pragma unroll
        for (int j = 0; j < kSlots; ++j)
          if (warp + kWarps * j < fresh) s.piv[(base + warp + kWarps * j) * WS + w] = acc[j];
      }
    }
    if (fresh) __syncthreads();
    // the earlier pivots lose the new pivots' columns (the new pivots are
    // mutually reduced, so one combination does it; they are zero below
    // w0), warp w taking earlier pivots w + 16 j and reading each new pivot
    // once for all four
    if (fresh && warp < base) {
      u64 m[kSlots];
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        const int k = warp + kWarps * j;
        const u64* pk = s.piv + k * WS;
        const bool h0 = k < base && lane < fresh &&
                        ((pk[s.pword[base + lane]] >> s.pbit[base + lane]) & 1);
        const bool h1 = k < base && lane + 32 < fresh &&
                        ((pk[s.pword[base + lane + 32]] >> s.pbit[base + lane + 32]) & 1);
        m[j] = (u64)__ballot_sync(kFull, h0) | ((u64)__ballot_sync(kFull, h1) << 32);
      }
      if (m[0] | m[1] | m[2] | m[3]) {
        for (int64_t w = w0 + lane; w < W; w += 32) {
          u64 acc[kSlots];
#pragma unroll
          for (int j = 0; j < kSlots; ++j)
            acc[j] = warp + kWarps * j < base ? s.piv[(warp + kWarps * j) * WS + w] : 0;
          for (int q = 0; q < fresh; ++q) {
            const u64 r = s.piv[(base + q) * WS + w];
#pragma unroll
            for (int j = 0; j < kSlots; ++j)
              if ((m[j] >> q) & 1) acc[j] ^= r;
          }
#pragma unroll
          for (int j = 0; j < kSlots; ++j)
            if (m[j]) s.piv[(warp + kWarps * j) * WS + w] = acc[j];
        }
      }
    }
    // the walked rows that did not pivot are in the span: zero
#pragma unroll
    for (int q = 0; q < kOwned; ++q) {
      const int u = warp + kWarps * q;
      if (u > tlast || ((pivots >> u) & 1)) continue;
      const int64_t r = s.idx[u];
      for (int64_t w = lane; w < W; w += 32) M[r * W + w] = 0;
      if (lane == 0) g.live[r] = 0;
    }
    taken += tlast + 1;
    cursor = (n < kChunk && tlast == n - 1) ? R : s.idx[tlast] + 1;
    SPLIT(if (tid == 0) {
      g.ctl[8] += tc1 - tc0;
      g.ctl[9] += tcw - tc1;
      g.ctl[10] += 1;
      g.ctl[11] += split_clock() - tcw;
    })
    __syncthreads();  // s.idx, s.rows and s.walked are rewritten next chunk
  }
  // the pivots, mutually reduced, to their rows and to the scratch copy
  for (int k = warp; k < npiv; k += kWarps) {
    const int64_t r = s.prow[k];
    for (int64_t w = lane; w < W; w += 32) {
      const u64 x = s.piv[k * WS + w];
      M[r * W + w] = x;
      g.gpiv[k * W + w] = x;
    }
    if (lane == 0) {
      g.gword[k] = s.pword[k];
      g.gbit[k] = s.pbit[k];
    }
  }
  if (tid == 0) {
    g.ctl[0] = npiv;
    g.ctl[1] = cursor;
    g.ctl[2] += 1;
  }
}

// row r's live flag and words (nothing past the stack), a lane a word
template <int NWL>
__device__ __forceinline__ void load_row(const u64* M, int64_t R, int64_t W, int64_t r,
                                         const unsigned char* live, int lane,
                                         unsigned char* flag, u64 (&x)[NWL]) {
  *flag = r < R ? __ldcg(live + r) : 0;
#pragma unroll
  for (int c = 0; c < NWL; ++c) x[c] = r < R && c * 32 + lane < W ? __ldcg(M + r * W + c * 32 + lane) : 0;
}

// Step 2: every block reduces its share of the live rows outside the
// panel's [i, s) by the pass's npiv pivots (see the header).  Rows of at
// most kTableWords words use the method of four Russians: for each group
// of 4 pivots a table of its 16 sums, so a row takes 16 table words a
// lane, one a group, instead of one pivot word for each set bit of m;
// rows wider than kSmemPanelWords read the pivots in tiles (see there).
template <int NWL>
__device__ void update(u64* M, int64_t R, int64_t W, int64_t i, int64_t s_end, int npiv,
                       const Scratch& g, const Smem& s) {
  constexpr bool kTables = NWL > 0 && NWL * 32 <= kTableWords;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid < npiv) {
    s.pword[tid] = __ldcg(g.gword + tid);
    s.pbit[tid] = __ldcg(g.gbit + tid);
  }
  if constexpr (NWL == 0) {
    // wider rows: a warp a row, a block's rows at a time; every pivot's
    // words [t0, t0 + kTileWords) staged in shared memory, tile by tile
    __syncthreads();
    u64* tile = s.base;
    const int64_t stride = (int64_t)gridDim.x * kWarps;
    for (int64_t rb = (int64_t)blockIdx.x * kWarps; rb < R; rb += stride) {
      const int64_t r = rb + warp;
      const bool act = r < R && (r < i || r >= s_end) && __ldcg(g.live + r);
      const u64 m = act ? gathered_mask(M + r * W, npiv, s.pword, s.pbit, lane) : 0;
      if (!__syncthreads_or(m != 0)) continue;
      u64 nz = 0;
      for (int64_t t0 = 0; t0 < W; t0 += kTileWords) {
        for (int e = tid; e < npiv * kTileWords; e += kThreads) {
          const int64_t w = t0 + e % kTileWords;
          tile[e] = w < W ? __ldcg(g.gpiv + (e / kTileWords) * W + w) : 0;
        }
        __syncthreads();
        if (m)
          for (int c = lane; c < kTileWords && t0 + c < W; c += 32) {
            const u64 v = combine(__ldcg(M + r * W + t0 + c), m, tile, kTileWords, c);
            M[r * W + t0 + c] = v;
            nz |= v;
          }
        __syncthreads();
      }
      if (m && !__any_sync(kFull, nz != 0) && lane == 0) g.live[r] = 0;
    }
  } else {
    u64* stage = kTables ? s.base + kGroups * 16 * W : s.base;
    for (int64_t e = tid; e < (int64_t)npiv * W; e += kThreads) stage[e] = __ldcg(g.gpiv + e);
    __syncthreads();
    if (kTables) {  // table[(gg * 16 + c) * W + w]: the sum of pivots 4 gg + j, j in c;
                    // every group's, since a row's lookups read all 16 tables
      for (int64_t e = tid; e < (int64_t)kGroups * 16 * W; e += kThreads) {
        const int64_t w = e % W;
        const int gc = (int)(e / W), gg = gc >> 4, c = gc & 15;
        u64 v = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (((c >> j) & 1) && 4 * gg + j < npiv) v ^= stage[(4 * gg + j) * W + w];
        s.base[e] = v;
      }
      __syncthreads();
    }
    // a warp a row, U rows of a warp loaded at once (bytes in flight)
    constexpr int U = NWL <= 2 ? 4 : 2;
    const int64_t stride = (int64_t)gridDim.x * kWarps;
    for (int64_t r0 = (int64_t)blockIdx.x * kWarps + warp; r0 < R; r0 += U * stride) {
      unsigned char live[U];
      u64 x[U][NWL];
#pragma unroll
      for (int u = 0; u < U; ++u) load_row<NWL>(M, R, W, r0 + u * stride, g.live, lane, &live[u], x[u]);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int64_t r = r0 + u * stride;
        if (!live[u] || (r >= i && r < s_end)) continue;
        const u64 m = pivot_mask(x[u], npiv, s.pword, s.pbit, lane);
        if (!m) continue;
        u64 nz = 0;
#pragma unroll
        for (int c = 0; c < NWL; ++c) {
          const int64_t w = c * 32 + lane;
          if (w >= W) continue;
          u64 v = x[u][c];
          if (kTables) {
#pragma unroll
            for (int gg = 0; gg < kGroups; ++gg)  // entry 0 of a table is 0
              v ^= s.base[((gg << 4) | ((int)(m >> (4 * gg)) & 15)) * W + w];
          } else {
            v = combine(v, m, stage, W, w);
          }
          M[r * W + w] = v;
          nz |= v;
        }
        if (!__any_sync(kFull, nz != 0) && lane == 0) g.live[r] = 0;
      }
    }
  }
}

template <int NWL>
__global__ void __launch_bounds__(kThreads)
    gf2_rref_blocked(u64* M, int64_t R, int64_t W, Scratch g) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) u64 smem[];
  Smem s = carve(smem, W);
  if (NWL == 0) {  // the panel in global memory
    s.rows = g.panel;
    s.piv = g.panel + kChunk * (W | 1);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the live flags: a row is live while it is nonzero
  const int64_t stride = (int64_t)gridDim.x * kWarps;
  for (int64_t r = (int64_t)blockIdx.x * kWarps + warp; r < R; r += stride) {
    u64 nz = 0;
    for (int64_t w = lane; w < W; w += 32) nz |= __ldcg(M + r * W + w);
    const bool live = __any_sync(kFull, nz != 0);
    if (lane == 0) g.live[r] = live;
  }
  const bool rec = blockIdx.x == 0 && threadIdx.x == 0;
  if (rec)
    for (int q = 2; q < kCtlWords; ++q) g.ctl[q] = 0;
  SPLIT(u64 t0 = split_clock(), t1, t2, t3;)
  grid.sync();
  SPLIT(if (rec) g.ctl[3] += split_clock() - t0;)
  int64_t i = 0;
  while (true) {
    SPLIT(t0 = split_clock();)
    if (blockIdx.x == 0) panel<NWL>(M, R, W, i, g, s);
    SPLIT(t1 = split_clock();)
    grid.sync();
    SPLIT(t2 = split_clock(); if (rec) {
      g.ctl[4] += t1 - t0;
      g.ctl[5] += t2 - t1;
    })
    const int npiv = (int)__ldcg(g.ctl);
    const int64_t s_end = __ldcg(g.ctl + 1);
    if (npiv == 0) break;
    update<NWL>(M, R, W, i, s_end, npiv, g, s);
    SPLIT(t3 = split_clock(); if (rec) g.ctl[6] += t3 - t2;)
    if (s_end >= R) break;
    i = s_end;
    grid.sync();
    SPLIT(if (rec) g.ctl[7] += split_clock() - t3;)
  }
}

int g_sms = 0;  // streaming multiprocessors of the current card

cudaError_t sm_count() {
  if (g_sms) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount, dev);
  return err;
}

// blocks of gf2_rref_blocked<NWL> the card holds at once with the shared
// memory of W words (the last W each was set up for)
template <int NWL>
cudaError_t blocked_cap(int64_t W, int* cap) {
  static int64_t set_for = -1;
  static int blocks = 0;
  const int64_t smem = smem_bytes(W);
  if (smem != set_for) {
    int per_sm = 0;
    cudaError_t err = sm_count();
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(gf2_rref_blocked<NWL>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gf2_rref_blocked<NWL>,
                                                          kThreads, (size_t)smem);
    if (err != cudaSuccess) return err;
    if (g_sms * per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    blocks = g_sms * per_sm;
    set_for = smem;
  }
  *cap = blocks;
  return cudaSuccess;
}

template <int NWL>
cudaError_t launch_blocked(u64* M, int64_t R, int64_t W, Scratch g, cudaStream_t stream) {
  int cap = 0;
  const cudaError_t err = blocked_cap<NWL>(W, &cap);
  if (err != cudaSuccess) return err;
  const int64_t want = (R + kWarps - 1) / kWarps;  // a warp a row
  const unsigned grid = (unsigned)(want < cap ? want : cap);
  void* args[] = {&M, &R, &W, &g};
  return cudaLaunchCooperativeKernel((const void*)gf2_rref_blocked<NWL>, dim3(grid),
                                     dim3(kThreads), args, (size_t)smem_bytes(W), stream);
}

cudaError_t launch_blocked(u64* M, int64_t R, int64_t W, Scratch g, cudaStream_t stream) {
  if (W > kSmemPanelWords) return launch_blocked<0>(M, R, W, g, stream);
  if (W <= 32) return launch_blocked<1>(M, R, W, g, stream);
  if (W <= 64) return launch_blocked<2>(M, R, W, g, stream);
  if (W <= 128) return launch_blocked<4>(M, R, W, g, stream);
  return launch_blocked<6>(M, R, W, g, stream);
}

}  // namespace

// Bytes of the scratch buffer symmer_gf2_rref takes for an R x W stack.
extern "C" int64_t symmer_gf2_rref_scratch(int64_t R, int64_t W) {
  return scratch_layout(R, W).total;
}

// RREF of M (int64[R, W], row-major) in place (see above).  scratch: a
// 16-byte aligned buffer of symmer_gf2_rref_scratch(R, W) bytes; after the
// launch its first int64s hold (pivots of the last pass, the row after
// its panel, passes).  Returns a cudaError_t.
extern "C" int symmer_gf2_rref(void* M, int64_t R, int64_t W, void* scratch, void* stream) {
  if (R < 1 || W < 1) return (int)cudaErrorInvalidValue;
  auto base = static_cast<unsigned char*>(scratch);
  const Layout l = scratch_layout(R, W);
  Scratch g{reinterpret_cast<int64_t*>(base), reinterpret_cast<int*>(base + l.gword),
            reinterpret_cast<int*>(base + l.gbit), reinterpret_cast<u64*>(base + l.gpiv),
            base + l.live, reinterpret_cast<u64*>(base + l.panel)};
  return (int)launch_blocked(static_cast<u64*>(M), R, W, g, static_cast<cudaStream_t>(stream));
}
