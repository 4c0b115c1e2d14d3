// Runs of Pauli rotations of a dense statevector over shared-memory coset
// tiles, for Hopper (sm_90a): K15a (the forward) and the adjoint sweep.
//
// Replaces the evolve step of symmer_tpu/evolution/jx_vqe.py's scans
// (_jitted_engine's loss_plain, :87-93, and _jitted_pool_grad's, :403-409),
// which XLA runs as a lax.scan over the generators, and the backward pass
// that jax.grad derives through that scan (:189).  For a complex128 state
// of 2^n rows (qubit 0 the most significant bit of a row index) and
// generators G_k = ph_k (-1)^{popcount(r & z_k)} X^{x_k}, ph = (-i)^{|Y|} c
// with c real +-1 (so G^2 = I and e^{i t G} = cos t + i sin t G):
//
//   forward:  psi <- e^{i t_k G_k} psi for k = 0 .. P-1, where one rotation
//             is out[r] = c_t psi[r] + i s_t ph (-1)^{popc(r & z)} psi[r ^ x]
//   sweep:    for k = P-1 .. 0: ov_k = <lam| G_k |psi>, then (k > 0)
//             psi <- U_k^dag psi, lam <- U_k^dag lam (the rotation at -t_k)
//
// The plan (kernels/torch_vqe.py:plan_runs, built once per engine) cuts
// the generators into runs whose x's span, with the two low row bits, a
// GF(2) subspace S of D dimensions (torch_vqe.default_tile_bits: 8-10,
// about 256 cosets): a rotation with x in S maps each coset of S onto
// itself, so a block loads a whole coset (2^D rows: 4-16 KB a vector) into
// shared memory, applies every rotation of the run there in order, and
// writes the rows back in place.  No other block touches those rows, so
// the pass needs no second buffer.  Tile row j of coset c is rep(c) ^ B(j)
// (B linear over the basis, which holds the low row bits first: four
// adjacent rows, 64 contiguous bytes, so the loads and stores stay
// coalesced); a generator's x is B(m) and popc(r & z) has the parity of
// popc(rep & z) + popc(j & zc).  A block stages the run's generators and
// stretches in shared memory once per coset (the parity of rep & z
// included); generators of one x form a stretch, whose row pairs (j0, j0 ^
// m) a thread takes two at a time through all its rotations in registers,
// one barrier a stretch.  The sweep adds each step's terms of a thread,
// then over the warp by a reduce-scatter (16 shuffles of a double for the
// up to 16 sums of a stretch), then over the warps in shared memory.
// Between runs: a grid-wide barrier in one cooperative launch (faster at
// tapered MgH2 than one launch per run; PERF.md gives both times).
//
// Plain versions: kernels/torch_vqe.py:rotate_runs and adjoint_sweep, bit
// for bit.  Every product and sum is an explicit round-to-nearest
// intrinsic in their order (no FMA contraction), a sign is a negation, and
// each row sees the same rotations in the same order as P one-generator
// rotations (torch_vqe.rotate).  The sweep's overlap per (generator, coset)
// is a thread's items added in order, then the pairwise tree over the
// block's threads; a second launch adds the partials of each generator by
// the pairwise tree over the cosets (csrc/pairwise_sum.cuh) and multiplies
// by ph once.  No atomics: a gradient repeats bit for bit.
//
// What bounds it: float64 operations.  The forward must read and write
// the state once (32 B a row: 4.2 MB at 2^17, 1.25 us at 3.35 TB/s) and
// do 4 operations a row and rotation (c p - s g per component, one
// multiply and one FMA; ph in {+-1, +-i} is a swap and a sign): 1,316
// rotations at 2^17 are 0.69 G, 41 us at 64 a clock per SM.  The sweep
// does 4 for each overlap and 4 for each of the two un-rotations (0.10
// ms).  The kernels keep each rotation's 12 separately rounded operations
// (8 products, 4 sums) of the plain version.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "pairwise_sum.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTileBits = 12;  // 64 KB a vector, 128 KB for the sweep's pair
constexpr int kMaxStretch = 8;    // torch_vqe.MAX_STRETCH
constexpr int kMaxRunGens = 256;  // torch_vqe.MAX_RUN

// the plan (torch_vqe.RunPlan), each array a section of one int64 buffer
struct Plan {
  const int64_t* run_off;       // [R + 1]: run r's stretches
  const int64_t* basis;         // [R, D]
  const int64_t* pivots;        // [R]: pivot bits as a mask
  const int64_t* stretch_off;   // [S + 1]: stretch s's generators
  const int64_t* stretch_mask;  // [S]: x in tile coordinates
  const int64_t* gz;            // [P]
  const int64_t* gzc;           // [P]: z in tile coordinates
  const double2* ph;            // [P]
  const double2* cs;            // [P]: (cos t, sin t)
  int64_t dim;
  int tile_bits;
};

// c with a zero inserted at each pivot bit, lowest first: the coset's
// representative row
__device__ __forceinline__ int64_t coset_rep(int64_t c, int64_t piv) {
  while (piv) {
    const int p = __ffsll(piv) - 1;
    piv &= piv - 1;
    const int64_t low = c & ((int64_t(1) << p) - 1);
    c = ((c >> p) << (p + 1)) | low;
  }
  return c;
}

// B(j): the XOR of the basis vectors at j's set bits
__device__ __forceinline__ int64_t tile_offset(int j, const int64_t* b) {
  int64_t o = 0;
  for (int i = 0; j; ++i, j >>= 1)
    if (j & 1) o ^= b[i];
  return o;
}

// the first row j0 of item p: p itself for m = 0, else p with a 0 inserted
// at m's lowest bit
__device__ __forceinline__ int item_row(int p, int m) {
  if (!m) return p;
  const int h = __ffs(m) - 1;
  return ((p >> h) << (h + 1)) | (p & ((1 << h) - 1));
}

// c p + i s ph (-1)^odd q: one row of a rotation (torch_vqe._rotated)
__device__ __forceinline__ double2 rotated(double2 p, double2 q, bool odd, double2 ph,
                                           double c, double s) {
  double gre = __dsub_rn(__dmul_rn(q.x, ph.x), __dmul_rn(q.y, ph.y));
  double gim = __dadd_rn(__dmul_rn(q.y, ph.x), __dmul_rn(q.x, ph.y));
  if (odd) {
    gre = -gre;
    gim = -gim;
  }
  return make_double2(__dsub_rn(__dmul_rn(p.x, c), __dmul_rn(gim, s)),
                      __dadd_rn(__dmul_rn(p.y, c), __dmul_rn(gre, s)));
}

// (-1)^odd conj(l) p (torch_vqe._terms)
__device__ __forceinline__ double2 term(double2 l, double2 p, bool odd) {
  double re = __dadd_rn(__dmul_rn(l.x, p.x), __dmul_rn(l.y, p.y));
  double im = __dsub_rn(__dmul_rn(l.x, p.y), __dmul_rn(l.y, p.x));
  if (odd) {
    re = -re;
    im = -im;
  }
  return make_double2(re, im);
}

// one generator of the run being applied, staged in shared memory with
// the parity of rep & z of the block's coset (so a row's sign needs one
// 32-bit popcount)
struct Gen {
  double2 ph, cs;  // ph, (cos t, sin t)
  int zc, par;
};

// the run's generators and stretches in shared memory: staged once per
// coset, read by every thread as broadcasts
struct RunSh {
  Gen gen[kMaxRunGens];
  int mask[kMaxRunGens], first[kMaxRunGens], count[kMaxRunGens];  // per stretch
  int64_t basis[kMaxTileBits];
};

// stage run r for the coset at rep; returns the run's stretch count
__device__ __forceinline__ int stage_run(RunSh& rs, const Plan& pl, int r, int64_t rep) {
  const int D = pl.tile_bits;
  const int64_t s0 = pl.run_off[r], s1 = pl.run_off[r + 1];
  const int64_t g0 = pl.stretch_off[s0], n_gens = pl.stretch_off[s1] - g0;
  for (int i = threadIdx.x; i < n_gens; i += kThreads) {
    const int64_t k = g0 + i;
    rs.gen[i].ph = pl.ph[k];
    rs.gen[i].cs = pl.cs[k];
    rs.gen[i].zc = (int)pl.gzc[k];
    rs.gen[i].par = __popcll((unsigned long long)(rep & pl.gz[k])) & 1;
  }
  for (int i = threadIdx.x; i < s1 - s0; i += kThreads) {
    rs.mask[i] = (int)pl.stretch_mask[s0 + i];
    rs.first[i] = (int)(pl.stretch_off[s0 + i] - g0);
    rs.count[i] = (int)(pl.stretch_off[s0 + i + 1] - pl.stretch_off[s0 + i]);
  }
  if (threadIdx.x < D) rs.basis[threadIdx.x] = pl.basis[(int64_t)r * D + threadIdx.x];
  return (int)(s1 - s0);
}

__device__ __forceinline__ bool odd_row(int par, int j, int zc) {
  return (par ^ __popc(j & zc)) & 1;
}

// one rotation of the pair (j0, j1 = j0 ^ m) whose rows' signs are odd
// o0, o1, or of row j0 alone where m = 0
__device__ __forceinline__ void rotate_pair(double2& v0, double2& v1, int m, bool o0, bool o1,
                                            double2 ph, double c, double s) {
  if (m) {
    const double2 n0 = rotated(v0, v1, o0, ph, c, s);
    v1 = rotated(v1, v0, o1, ph, c, s);
    v0 = n0;
  } else {
    v0 = rotated(v0, v0, o0, ph, c, s);
  }
}

// copy the coset's tile rows between global memory and shared memory
template <bool kLoad>
__device__ __forceinline__ void move_tile(double2* g, double2* sh, int64_t rep, int tile,
                                          const int64_t* b) {
  for (int j = threadIdx.x; j < tile; j += kThreads) {
    const int64_t r = rep ^ tile_offset(j, b);
    if (kLoad)
      sh[j] = g[r];
    else
      g[r] = sh[j];
  }
}

// the forward over the plan's n_runs runs: run 0 reads src, every run
// writes dst
__global__ void __launch_bounds__(kThreads)
    vqe_runs_kernel(const double2* src, double2* dst, Plan pl, int n_runs) {
  extern __shared__ double2 tile_sh[];
  __shared__ RunSh rs;
  const int D = pl.tile_bits, tile = 1 << D;
  const int64_t n_cosets = pl.dim >> D;
  for (int r = 0; r < n_runs; ++r) {
    const double2* in = r == 0 ? src : dst;
    for (int64_t c = blockIdx.x; c < n_cosets; c += gridDim.x) {
      __syncthreads();  // the previous coset's tile is written out
      const int64_t rep = coset_rep(c, pl.pivots[r]);
      const int n_st = stage_run(rs, pl, r, rep);
      __syncthreads();
      move_tile<true>(const_cast<double2*>(in), tile_sh, rep, tile, rs.basis);
      __syncthreads();
      for (int si = 0; si < n_st; ++si) {
        const int m = rs.mask[si], g0 = rs.first[si], n = rs.count[si];
        // two items a thread at a time: four independent rows in flight
        const int items = m ? tile >> 1 : tile;
        for (int p = threadIdx.x; p < items; p += 2 * kThreads) {
          const bool two = p + kThreads < items;
          const int a0 = item_row(p, m), a1 = a0 ^ m;
          const int b0 = two ? item_row(p + kThreads, m) : a0, b1 = b0 ^ m;
          double2 va0 = tile_sh[a0], va1 = tile_sh[a1], vb0 = tile_sh[b0], vb1 = tile_sh[b1];
#pragma unroll
          for (int u = 0; u < kMaxStretch; ++u) {
            if (u < n) {
              const Gen g = rs.gen[g0 + u];
              rotate_pair(va0, va1, m, odd_row(g.par, a0, g.zc), odd_row(g.par, a1, g.zc), g.ph,
                          g.cs.x, g.cs.y);
              if (two)
                rotate_pair(vb0, vb1, m, odd_row(g.par, b0, g.zc), odd_row(g.par, b1, g.zc),
                            g.ph, g.cs.x, g.cs.y);
            }
          }
          tile_sh[a0] = va0;
          if (m) tile_sh[a1] = va1;
          if (two) {
            tile_sh[b0] = vb0;
            if (m) tile_sh[b1] = vb1;
          }
        }
        __syncthreads();
      }
      move_tile<false>(dst, tile_sh, rep, tile, rs.basis);
    }
    if (r + 1 < n_runs) cg::this_grid().sync();
  }
}

// The 16 values of every lane (re[u], im[u]: the parts of step u's sum,
// value 2u + part) added over the warp's 32 lanes by the pairwise tree of
// adjacent lanes, the order of symmer_pairwise::block_pairwise's shuffles,
// as a reduce-scatter: at each of the first four levels a lane keeps the
// half of its values whose index bit matches its lane bit and adds its
// partner's copies of them (16 shuffles of a double, where a shuffle tree
// per value takes 80).  Lane l returns value l & 15.
// one level of warp_reduce_scatter: of the pair (lo, hi) of value slots,
// keep the one whose index bit is the lane's bit and add the partner's
__device__ __forceinline__ double scatter_add(double lo, double hi, bool bit, int d) {
  const double send = bit ? lo : hi, keep = bit ? hi : lo;
  return __dadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, d));
}

__device__ __forceinline__ double warp_reduce_scatter(const double (&re)[kMaxStretch],
                                                      const double (&im)[kMaxStretch],
                                                      int lane) {
  static_assert(kMaxStretch == 8, "four halving levels");
  double a[8], b[4], c[2];
#pragma unroll
  for (int s = 0; s < 8; ++s) a[s] = scatter_add(re[s], im[s], lane & 1, 1);
#pragma unroll
  for (int s = 0; s < 4; ++s) b[s] = scatter_add(a[2 * s], a[2 * s + 1], (lane >> 1) & 1, 2);
#pragma unroll
  for (int s = 0; s < 2; ++s) c[s] = scatter_add(b[2 * s], b[2 * s + 1], (lane >> 2) & 1, 4);
  const double v = scatter_add(c[0], c[1], (lane >> 3) & 1, 8);
  return __dadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 16));
}

// one item of a sweep step for generator g: its overlap value (the pair's
// two terms added, j0's first) into (are, aim) at item index i, then the
// un-rotation of both vectors unless `last`
__device__ __forceinline__ void sweep_item(double2& p0, double2& p1, double2& l0, double2& l1,
                                           int j0, int j1, int m, const Gen& g, bool last,
                                           bool first_item, double& are, double& aim) {
  const bool o0 = odd_row(g.par, j0, g.zc);
  const bool o1 = m ? odd_row(g.par, j1, g.zc) : o0;
  double2 v = term(l0, m ? p1 : p0, o0);
  if (m) {
    const double2 t1 = term(l1, p0, o1);
    v = make_double2(__dadd_rn(v.x, t1.x), __dadd_rn(v.y, t1.y));
  }
  are = first_item ? v.x : __dadd_rn(are, v.x);
  aim = first_item ? v.y : __dadd_rn(aim, v.y);
  if (!last) {  // U_k^dag; the last un-rotation, of U_0, is not needed
    const double c = g.cs.x, sn = -g.cs.y;
    rotate_pair(p0, p1, m, o0, o1, g.ph, c, sn);
    rotate_pair(l0, l1, m, o0, o1, g.ph, c, sn);
  }
}

// the sweep over runs n_runs - 1 down to 0, in place on psi and lam;
// part: [2][P][n_cosets] float64 partial sums (re, then im)
__global__ void __launch_bounds__(kThreads)
    vqe_sweep_kernel(double2* psi, double2* lam, Plan pl, int n_runs, double* part,
                     int64_t n_gens) {
  extern __shared__ double2 tile_sh[];
  __shared__ RunSh rs;
  __shared__ double wsum[2][kMaxStretch][2][kWarps];  // double-buffered warp sums
  const int D = pl.tile_bits, tile = 1 << D;
  double2* psi_sh = tile_sh;
  double2* lam_sh = tile_sh + tile;
  const int64_t n_cosets = pl.dim >> D;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = n_runs - 1; r >= 0; --r) {
    const int64_t g_base = pl.stretch_off[pl.run_off[r]];
    for (int64_t c = blockIdx.x; c < n_cosets; c += gridDim.x) {
      __syncthreads();
      const int64_t rep = coset_rep(c, pl.pivots[r]);
      const int n_st = stage_run(rs, pl, r, rep);
      __syncthreads();
      move_tile<true>(psi, psi_sh, rep, tile, rs.basis);
      move_tile<true>(lam, lam_sh, rep, tile, rs.basis);
      __syncthreads();
      int buf = 0;
      for (int si = n_st - 1; si >= 0; --si) {
        const int m = rs.mask[si], g0 = rs.first[si], n = rs.count[si];
        const int items = m ? tile >> 1 : tile;
        const int active = items < kThreads ? items : kThreads;
        double are[kMaxStretch], aim[kMaxStretch];
#pragma unroll
        for (int u = 0; u < kMaxStretch; ++u) are[u] = aim[u] = 0.0;
        // two items a thread at a time, their values added in item order
        for (int p = threadIdx.x, i = 0; p < items; p += 2 * kThreads, i += 2) {
          const bool two = p + kThreads < items;
          const int a0 = item_row(p, m), a1 = a0 ^ m;
          const int b0 = two ? item_row(p + kThreads, m) : a0, b1 = b0 ^ m;
          double2 pa0 = psi_sh[a0], pa1 = psi_sh[a1], la0 = lam_sh[a0], la1 = lam_sh[a1];
          double2 pb0 = psi_sh[b0], pb1 = psi_sh[b1], lb0 = lam_sh[b0], lb1 = lam_sh[b1];
#pragma unroll
          for (int u = 0; u < kMaxStretch; ++u) {
            if (u < n) {
              const Gen g = rs.gen[g0 + n - 1 - u];
              const bool last = g_base + g0 + n - 1 - u == 0;
              sweep_item(pa0, pa1, la0, la1, a0, a1, m, g, last, i == 0, are[u], aim[u]);
              if (two) sweep_item(pb0, pb1, lb0, lb1, b0, b1, m, g, last, false, are[u], aim[u]);
            }
          }
          psi_sh[a0] = pa0;
          lam_sh[a0] = la0;
          if (m) {
            psi_sh[a1] = pa1;
            lam_sh[a1] = la1;
          }
          if (two) {
            psi_sh[b0] = pb0;
            lam_sh[b0] = lb0;
            if (m) {
              psi_sh[b1] = pb1;
              lam_sh[b1] = lb1;
            }
          }
        }
        // each step's partial: the pairwise tree over the active threads
        // (the order of symmer_pairwise::block_pairwise), all steps at once
        const int width = active < 32 ? active : 32;
        const int nw = active > 32 ? active >> 5 : 1;
        if (width == 32) {
          const double w = warp_reduce_scatter(are, aim, lane);
          if (lane < 2 * n) wsum[buf][lane >> 1][lane & 1][warp] = w;
        } else {
#pragma unroll
          for (int u = 0; u < kMaxStretch; ++u) {
            if (u < n) {
              double vr = are[u], vi = aim[u];
              for (int d = 1; d < width; d <<= 1) {
                vr = __dadd_rn(vr, __shfl_xor_sync(0xffffffffu, vr, d));
                vi = __dadd_rn(vi, __shfl_xor_sync(0xffffffffu, vi, d));
              }
              if (lane == 0) {
                wsum[buf][u][0][warp] = vr;
                wsum[buf][u][1][warp] = vi;
              }
            }
          }
        }
        __syncthreads();  // the tiles and the warp sums are written
        if (threadIdx.x < 2 * n) {
          const int u = threadIdx.x >> 1, comp = threadIdx.x & 1;
          double w[kWarps];
          for (int q = 0; q < nw; ++q) w[q] = wsum[buf][u][comp][q];
          for (int h = 1; h < nw; h <<= 1)
            for (int q = 0; q < nw; q += 2 * h) w[q] = __dadd_rn(w[q], w[q + h]);
          part[((int64_t)comp * n_gens + g_base + g0 + n - 1 - u) * n_cosets + c] = w[0];
        }
        buf ^= 1;  // the next stretch writes the other buffer
      }
      move_tile<false>(psi, psi_sh, rep, tile, rs.basis);
      move_tile<false>(lam, lam_sh, rep, tile, rs.basis);
    }
    if (r > 0) cg::this_grid().sync();
  }
}

// ov[k] = ph_k * (the pairwise sum of generator k's partials over the cosets)
__global__ void __launch_bounds__(kThreads)
    sweep_totals_kernel(const double* part, int64_t n_cosets, int64_t n_gens,
                        const double2* ph, double2* ov) {
  __shared__ double sh[symmer_pairwise::kWarps];
  for (int64_t k = blockIdx.x; k < n_gens; k += gridDim.x) {
    const double re = symmer_pairwise::total_pairwise(part + k * n_cosets, n_cosets, sh);
    const double im =
        symmer_pairwise::total_pairwise(part + (n_gens + k) * n_cosets, n_cosets, sh);
    if (threadIdx.x == 0) ov[k] = symmer_pairwise::times_phase(re, im, ph[k]);
  }
}

// blocks of each kernel the card holds at once, per tile width
int g_cap_runs[kMaxTileBits + 1], g_cap_sweep[kMaxTileBits + 1];

// the kernel's shared-memory limit raised to its widest tile (once), then
// the blocks the card holds at once with `smem` bytes each (cached in *cap)
cudaError_t grid_cap(const void* kernel, size_t max_smem, size_t smem, int* cap) {
  if (*cap) return cudaSuccess;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)max_smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (sms * per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *cap = sms * per_sm;
  return cudaSuccess;
}

Plan make_plan(const void* ints, const int64_t* sec, const void* ph, const void* cs,
               int64_t dim, int tile_bits) {
  const int64_t* base = static_cast<const int64_t*>(ints);
  Plan pl;
  pl.run_off = base + sec[0];
  pl.basis = base + sec[1];
  pl.pivots = base + sec[2];
  pl.stretch_off = base + sec[3];
  pl.stretch_mask = base + sec[4];
  pl.gz = base + sec[5];
  pl.gzc = base + sec[6];
  pl.ph = static_cast<const double2*>(ph);
  pl.cs = static_cast<const double2*>(cs);
  pl.dim = dim;
  pl.tile_bits = tile_bits;
  return pl;
}

bool bad_shape(int64_t dim, int tile_bits, int n_runs) {
  return dim < 1 || (dim & (dim - 1)) || tile_bits < 0 || tile_bits > kMaxTileBits ||
         (int64_t(1) << tile_bits) > dim || n_runs < 0;
}

}  // namespace

// The forward (see above): dst = prod_k e^{i t_k G_k} src, in place when
// src == dst.  ints: the plan's int64 buffer, sec[7] the offsets of its
// sections (torch_vqe.RunPlan.int_sections); ph, cs: complex128[P].  One
// cooperative launch.  Returns a cudaError_t.
extern "C" int symmer_vqe_runs(const void* src, void* dst, int64_t dim, int tile_bits,
                               int n_runs, const void* ints, const int64_t* sec,
                               const void* ph, const void* cs, void* stream) {
  if (bad_shape(dim, tile_bits, n_runs)) return (int)cudaErrorInvalidValue;
  if (n_runs == 0) return (int)cudaSuccess;
  const size_t smem = (size_t)16 << tile_bits;
  int& cap = g_cap_runs[tile_bits];
  cudaError_t err =
      grid_cap((const void*)vqe_runs_kernel, (size_t)16 << kMaxTileBits, smem, &cap);
  if (err != cudaSuccess) return (int)err;
  const int64_t n_cosets = dim >> tile_bits;
  Plan pl = make_plan(ints, sec, ph, cs, dim, tile_bits);
  auto sp = static_cast<const double2*>(src);
  auto dp = static_cast<double2*>(dst);
  const unsigned grid = (unsigned)(n_cosets < cap ? n_cosets : cap);
  void* args[] = {&sp, &dp, &pl, &n_runs};
  return (int)cudaLaunchCooperativeKernel((const void*)vqe_runs_kernel, dim3(grid),
                                          dim3(kThreads), args, smem,
                                          static_cast<cudaStream_t>(stream));
}

// The adjoint sweep (see above), in place on psi and lam; part: 2 * P *
// (dim >> tile_bits) float64 of scratch; ov: complex128[P].  One
// cooperative launch, then one launch of the totals.  Returns a
// cudaError_t.
extern "C" int symmer_vqe_adjoint(void* psi, void* lam, int64_t dim, int tile_bits,
                                  int n_runs, const void* ints, const int64_t* sec,
                                  const void* ph, const void* cs, int64_t n_gens, void* part,
                                  void* ov, void* stream) {
  if (bad_shape(dim, tile_bits, n_runs) || n_gens < 0) return (int)cudaErrorInvalidValue;
  if (n_runs == 0 || n_gens == 0) return (int)cudaSuccess;
  const size_t smem = (size_t)32 << tile_bits;
  int& cap = g_cap_sweep[tile_bits];
  cudaError_t err =
      grid_cap((const void*)vqe_sweep_kernel, (size_t)32 << kMaxTileBits, smem, &cap);
  if (err != cudaSuccess) return (int)err;
  const int64_t n_cosets = dim >> tile_bits;
  Plan pl = make_plan(ints, sec, ph, cs, dim, tile_bits);
  auto pp = static_cast<double2*>(psi);
  auto lp = static_cast<double2*>(lam);
  auto partp = static_cast<double*>(part);
  auto st = static_cast<cudaStream_t>(stream);
  const unsigned grid = (unsigned)(n_cosets < cap ? n_cosets : cap);
  void* args[] = {&pp, &lp, &pl, &n_runs, &partp, &n_gens};
  err = cudaLaunchCooperativeKernel((const void*)vqe_sweep_kernel, dim3(grid), dim3(kThreads),
                                    args, smem, st);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)(n_gens < 65535 ? n_gens : 65535);
  sweep_totals_kernel<<<blocks, kThreads, 0, st>>>(partp, n_cosets, n_gens,
                                                   static_cast<const double2*>(ph),
                                                   static_cast<double2*>(ov));
  return (int)cudaGetLastError();
}
