// The Lanczos matvec in X-grouped form, recomputing the group diagonals from
// the terms, for Hopper (sm_90a).
//
// Replaces symmer_tpu/kernels/jx_lanczos.py:_matvec_block (a lax.scan over
// blocks of groups, each an XOR gather, or on the TPU two one-hot MXU
// permutations, then a complex multiply and a pairwise tree sum) together
// with the table it reads, _build_D_fn (:281).  For a block of b complex128
// columns V (b, 2^n):
//     out[c, r] = sum_g D_g(r) * V[c, r ^ ux[g]],
//     D_g(r)    = sum_{t in g} ph[t] (-1)^{popcount(r & z[t])},
// ph[t] = (-i)^{|Y_t|} c_t, with the terms sorted by group (group g holds
// terms off[g] .. off[g + 1] - 1).  Rows are 32-bit: 2^n <= 2^31.  ux is
// taken modulo 2^n, as the plain version (kernels/torch_lanczos.py:
// terms_matvec) reads it; z < 2^n.
//
// What bounds it: float64 operations.  No (G, 2^n) table is read (tapered
// N2: 198 MB, 59 us at 3.35 TB/s).  The least work (chip_smoke.py's
// matvec_bound): a thread of 2^k rows adds each term's signed phase into
// one of 2^k buckets (2 float64 operations per term and thread), a k-stage
// Walsh-Hadamard transform turns the buckets into D_g(r) (2k a row), and
// the multiply-add costs 4 FMAs per (group, row, column): 136 M operations
// at N2, b = 1 (k = 2), 8.1 us at 64 FP64 operations per clock per SM.
// This kernel pays one signed complex add per (term, row) instead: 196 M.
// The terms (2,229 at N2, 53 KB) and V (0.5 MB a column) stay in shared
// memory and L2.
//
// The design:
//   - a block of 128 threads owns a tile of 128 R rows (all 2^n rows when
//     fewer), R = 8 / b rows a thread: thread t holds the rows
//     base + t + j 2^sb, j < R, which differ in the bits sb .. sb + log2 R - 1.
//     The parity of (r & z) is the parity of (base + t) & z, one AND and
//     one popcount per (term, thread), flipped by z's bit sb + k for each
//     bit k of j: each row's sign is an XOR into the high word of 1.0, and
//     D += s ph is two FMAs, no branch;
//   - the terms of the block's groups are staged in shared memory, 1,024 at
//     a time, each with its group's X pattern and a last-of-group bit, and
//     read by every thread at the same address (a broadcast); the block
//     finds its groups in one parallel pass over the offsets;
//   - at the last term of a group, each row multiplies its D_g(r) into the
//     b columns' accumulators, held in registers; V[c, r ^ ux[g]] is a
//     gather that permutes consecutive rows, so a warp's loads stay
//     coalesced (V stays in L2); the gathers are issued at the group's
//     first term, so their latency hides behind the group's terms;
//   - to fill the card (a warp's 32 x 8 rows need enough warps to hide the
//     latency of each term's dependent chain), the groups are cut into S
//     slices of about equal term counts, S = 16 at N2: 32 tiles x 16 = 512
//     blocks, 4 an SM; each block writes its slice's partial tile to
//     scratch, and a second launch adds the S partials of each entry in
//     slice order (from 2^19 rows at b = 1, S = 1: one launch, straight
//     into out).  A first cut added the slices through distributed shared
//     memory in thread-block clusters of 8: their placement on the GPCs
//     left some SMs three blocks and others one, and it ran slower;
//   - a row range [r0, r1) (the mesh's row blocks, the counterpart of
//     symmer_tpu/kernels/jx_lanczos.py:_matvec_grouped_mesh_block) launches
//     only the tiles that hold those rows and writes them into a (b, r1 - r0)
//     output.  The tile shape and the slices S come from all 2^n rows, as in
//     the launch over every row, so each row is the same sequence of
//     operations and a range's rows are bit for bit the whole launch's; a
//     range narrower than a tile computes the tile's other rows and drops
//     them.
// Deterministic: no atomics; a fixed order of terms within a group, of
// groups within a slice and of slices, so pass 2 of the Lanczos drivers
// replays pass 1 bit for bit.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxSlices = 32;
constexpr int kTargetBlocks = 512;           // tiles x slices aimed at (132 SMs, 4 each)
constexpr int kStageTerms = 1024;            // terms staged in shared memory at a time
constexpr uint32_t kOneHi = 0x3FF00000u;     // the high word of 1.0
constexpr uint32_t kLast = 0x80000000u;      // a group's last term

// rows a thread holds for B columns: R B = 8 keeps the accumulators, the
// prefetched gathers and the running D_g(r) in registers
template <int B>
constexpr int kRows = 8 / B;

// block (tile, slice) = (blockIdx.x, blockIdx.y): the tile's partial sum
// over the slice's groups, into dst[slice][c][row] (dst = out when S = 1)
template <int B>
__global__ void __launch_bounds__(kThreads, 4)
    group_matvec_kernel(const int64_t* __restrict__ ux, const int32_t* __restrict__ off,
                        const uint32_t* __restrict__ z, const double2* __restrict__ ph,
                        const double2* __restrict__ V, double2* __restrict__ dst, int G,
                        int64_t T, uint32_t dim, int sb, int tile_rows, uint32_t tile0,
                        uint32_t r0, uint32_t r1) {
  constexpr int R = kRows<B>;
  __shared__ double2 ph_s[kStageTerms];
  __shared__ uint2 zw_s[kStageTerms];
  __shared__ int bounds[4];

  const int S = gridDim.y;
  const int slice = blockIdx.y;
  const int t = threadIdx.x;
  const int stride = tile_rows / R;  // 2^sb
  const bool live = t < stride;
  const uint32_t base = (tile0 + blockIdx.x) * (uint32_t)tile_rows;
  const uint32_t rb = base + (uint32_t)t;
  const uint32_t mask = dim - 1u;

  // the slice's groups [g0, g1): from the first group that starts at or
  // after term T s / S to the first at or after T (s + 1) / S, with their
  // term offsets, in one parallel pass over off
  {
    const int64_t lo = T * slice / S, hi = T * (slice + 1) / S;
    for (int i = t; i <= G; i += kThreads) {
      const int64_t o = __ldg(off + i);
      const int64_t prev = i > 0 ? (int64_t)__ldg(off + i - 1) : INT64_MIN;
      if (o >= lo && prev < lo) bounds[0] = i, bounds[2] = (int)o;
      if (o >= hi && prev < hi) bounds[1] = i, bounds[3] = (int)o;
    }
  }
  __syncthreads();
  const int g0 = bounds[0], g1 = bounds[1], t0 = bounds[2], t1 = bounds[3];

  uint32_t r[R];
#pragma unroll
  for (int j = 0; j < R; ++j) r[j] = rb + ((uint32_t)j << sb);
  double2 acc[B][R], vpre[B][R];
  double dr[R], di[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    dr[j] = di[j] = 0.0;
#pragma unroll
    for (int c = 0; c < B; ++c) acc[c][j] = vpre[c][j] = make_double2(0.0, 0.0);
  }
  bool fresh = true;  // the next term starts a group

  for (int c0 = t0; c0 < t1; c0 += kStageTerms) {
    const int cn = min(kStageTerms, t1 - c0);
    __syncthreads();  // the previous stage is consumed
    for (int i = t; i < cn; i += kThreads) {
      ph_s[i] = __ldg(ph + c0 + i);
      zw_s[i].x = __ldg(z + c0 + i);
    }
    // each staged term's second word: its group's X pattern, kLast on the
    // group's last term
    for (int g = g0 + t; g < g1; g += kThreads) {
      const int hi = __ldg(off + g + 1);
      const uint32_t x = (uint32_t)__ldg(ux + g) & mask;
      for (int i = max(__ldg(off + g), c0); i < min(hi, c0 + cn); ++i)
        zw_s[i - c0].y = x | (i == hi - 1 ? kLast : 0u);
    }
    __syncthreads();
    if (!live) continue;
#pragma unroll 2
    for (int i = 0; i < cn; ++i) {
      const uint2 zw = zw_s[i];
      const double2 p = ph_s[i];
      if (fresh) {  // the group's gathers, used at its last term
        const uint32_t x = zw.y & ~kLast;
#pragma unroll
        for (int j = 0; j < R; ++j) {
#pragma unroll
          for (int c = 0; c < B; ++c) vpre[c][j] = __ldg(V + (size_t)c * dim + ((r[j] ^ x) & mask));
        }
        fresh = false;
      }
      // row j's sign: the parity of (base + t) & z, flipped by z's bit sb + k
      // for each bit k of j, as the sign bit of 1.0
      uint32_t h[R];
      h[0] = kOneHi | ((uint32_t)__popc(rb & zw.x) << 31);
      const uint32_t qs = zw.x >> sb;
#pragma unroll
      for (int j = 1; j < R; ++j) {
        const int k = j & 1 ? 0 : j & 2 ? 1 : 2;  // the lowest set bit of j
        h[j] = h[j & (j - 1)] ^ ((qs << (31 - k)) & kLast);
      }
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const double sg = __hiloint2double((int)h[j], 0);
        dr[j] = __fma_rn(sg, p.x, dr[j]);
        di[j] = __fma_rn(sg, p.y, di[j]);
      }
      if (zw.y & kLast) {  // the group's last term: multiply into the columns
#pragma unroll
        for (int j = 0; j < R; ++j) {
#pragma unroll
          for (int c = 0; c < B; ++c) {
            const double2 v = vpre[c][j];
            acc[c][j].x = __fma_rn(dr[j], v.x, __fma_rn(-di[j], v.y, acc[c][j].x));
            acc[c][j].y = __fma_rn(dr[j], v.y, __fma_rn(di[j], v.x, acc[c][j].y));
          }
          dr[j] = di[j] = 0.0;
        }
        fresh = true;
      }
    }
  }

  if (live) {
    const uint32_t n = r1 - r0;  // the output's rows
    double2* d = dst + (size_t)slice * B * n;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (r[j] >= r0 && r[j] < r1) {
#pragma unroll
        for (int c = 0; c < B; ++c) d[(size_t)c * n + (r[j] - r0)] = acc[c][j];
      }
    }
  }
}

// out[e] = the sum over the S slices of part[s][e], in slice order
__global__ void __launch_bounds__(256)
    add_slices_kernel(const double2* __restrict__ part, double2* __restrict__ out, int S,
                      int64_t n) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < n; e += step) {
    double2 s = part[e];
    for (int q = 1; q < S; ++q) {
      const double2 v = part[(int64_t)q * n + e];
      s.x = __dadd_rn(s.x, v.x);
      s.y = __dadd_rn(s.y, v.y);
    }
    out[e] = s;
  }
}

struct Shape {
  int tile_rows, sb, S;
  int64_t tiles;
};

// the tiles and slices for B columns of dim rows
template <int B>
Shape shape_of(int64_t dim) {
  constexpr int R = kRows<B>;
  constexpr int kTileRows = kThreads * R;
  Shape s;
  s.tile_rows = dim < R ? R : (int)(dim < kTileRows ? dim : kTileRows);
  s.sb = 0;
  while ((R << s.sb) < s.tile_rows) ++s.sb;
  s.tiles = dim < R ? 1 : dim / s.tile_rows;
  s.S = 1;
  while (s.S < kMaxSlices && s.tiles * s.S < kTargetBlocks) s.S <<= 1;
  return s;
}

// rows [r0, r1) of the b = B columns: the tiles that hold them, with the
// shape and slices of all dim rows
template <int B>
cudaError_t launch(const int64_t* ux, const int32_t* off, const uint32_t* z, const double2* ph,
                   const double2* V, double2* out, double2* part, int G, int64_t T,
                   int64_t dim, int64_t r0, int64_t r1, cudaStream_t st) {
  const Shape s = shape_of<B>(dim);
  const int64_t tile0 = r0 / s.tile_rows;
  const int64_t tiles = (r1 + s.tile_rows - 1) / s.tile_rows - tile0;
  if (tiles > 0x7FFFFFFF) return cudaErrorInvalidConfiguration;
  group_matvec_kernel<B><<<dim3((unsigned)tiles, (unsigned)s.S), kThreads, 0, st>>>(
      ux, off, z, ph, V, s.S > 1 ? part : out, G, T, (uint32_t)((uint64_t)dim), s.sb,
      s.tile_rows, (uint32_t)tile0, (uint32_t)r0, (uint32_t)((uint64_t)r1));
  if (s.S > 1) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int64_t n = B * (r1 - r0);
    const int64_t want = (n + 255) / 256;
    add_slices_kernel<<<(unsigned)(want < 4096 ? want : 4096), 256, 0, st>>>(part, out, s.S, n);
  }
  return cudaGetLastError();
}

}  // namespace

// The slices S that the matvec cuts b columns of dim rows into: it needs
// S b dim complex128 of scratch when S > 1 (-1: b not supported).
extern "C" int64_t symmer_group_matvec_slices(int64_t dim, int64_t b) {
  switch (b) {
    case 1: return shape_of<1>(dim).S;
    case 2: return shape_of<2>(dim).S;
    case 4: return shape_of<4>(dim).S;
    case 8: return shape_of<8>(dim).S;
    default: return -1;
  }
}

// out (b, r1 - r0) = rows r0 .. r1 - 1 of H @ V (V: b columns of dim rows)
// for b in {1, 2, 4, 8}, T = off[G] terms; part:
// symmer_group_matvec_slices(dim, b) b (r1 - r0) complex128 of scratch
// (unused when that is 1).  One launch, or two when the groups are sliced.
// Returns a cudaError_t.
extern "C" int symmer_group_matvec(const void* ux, const void* off, const void* z, const void* ph,
                                   const void* V, void* out, void* part, int64_t G, int64_t T,
                                   int64_t dim, int64_t b, int64_t r0, int64_t r1, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dim < 1 || dim > (int64_t(1) << 31) || (dim & (dim - 1)) || G < 1 || G > 0x7FFFFFFE ||
      T < 0 || T > 0x7FFFFFFF || r0 < 0 || r1 <= r0 || r1 > dim)
    return (int)cudaErrorInvalidValue;
  const auto uxp = static_cast<const int64_t*>(ux);
  const auto offp = static_cast<const int32_t*>(off);
  const auto zp = static_cast<const uint32_t*>(z);
  const auto php = static_cast<const double2*>(ph);
  const auto Vp = static_cast<const double2*>(V);
  auto op = static_cast<double2*>(out);
  auto pp = static_cast<double2*>(part);
  switch (b) {
    case 1: return (int)launch<1>(uxp, offp, zp, php, Vp, op, pp, (int)G, T, dim, r0, r1, st);
    case 2: return (int)launch<2>(uxp, offp, zp, php, Vp, op, pp, (int)G, T, dim, r0, r1, st);
    case 4: return (int)launch<4>(uxp, offp, zp, php, Vp, op, pp, (int)G, T, dim, r0, r1, st);
    case 8: return (int)launch<8>(uxp, offp, zp, php, Vp, op, pp, (int)G, T, dim, r0, r1, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
