// Overlaps <a| P_i |b> of a batch of Pauli operators grouped by their X
// part, for Hopper (sm_90a): K15c.
//
// Replaces the pool-gradient scan of symmer_tpu/evolution/jx_vqe.py
// (_jitted_pool_grad's pterm, :418-422); the port's engine
// (evolution/device_vqe.py) also takes its energy <psi|H psi> from here
// (the identity, N = 1).  For complex128 vectors a, b of 2^n rows and N
// Paulis (x_i, z_i, ph_i) with ph_i = (-i)^{|Y_i|} c_i:
//
//   out_i = ph_i sum_r (-1)^{popcount(r & z_i)} w(r),  w(r) = conj(a[r]) b[r ^ x_i]
//
// The pool gradient is -2 Im out_i with a = H psi, b = psi.  Plain version:
// kernels/torch_vqe.py:pauli_overlaps, bit for bit: the products are
// explicit round-to-nearest intrinsics in its order, the sum over the rows
// is the pairwise tree of adjacent pairs in row order
// (csrc/pairwise_sum.cuh), and ph_i multiplies the total once.
//
// What bounds it: the float64 work, or the reads of a and b once: 4 FMAs
// a row and X group for w, and 2 adds a row and Pauli for the signed sums
// (tapered N2's ADAPT pool: 91 X groups, 696 Paulis, 2^15 rows).
//
// The design: the caller sorts the Paulis by x on the host (groups ux, off
// and the slot order).  Two launches, no atomics, so a batch repeats bit
// for bit.  The first: a block per (X group, chunk of rows), a thread RPT
// adjacent rows (16, or 4 where that leaves too few blocks for the card);
// the thread forms w(r) once, in registers, and for each Pauli of the
// group adds its RPT signed terms by the pairwise tree (the signs of the
// RPT rows from one popcount: a Walsh pattern of z's low bits, flipped by
// the parity of the first row's bits); warp shuffles and the warp sums of
// up to 16 Paulis at a time in shared memory give each (Pauli, chunk) sum
// after one barrier.  The second: a block per Pauli adds its chunk sums by
// the same tree and multiplies by ph.
#include <cuda_runtime.h>

#include <cstdint>

#include "pairwise_sum.cuh"

namespace {

using symmer_pairwise::kThreads;
using symmer_pairwise::kWarps;
using symmer_pairwise::times_phase;
using symmer_pairwise::total_pairwise;

constexpr int kBatch = 16;              // Paulis whose warp sums share one barrier
constexpr int kTargetBlocks = 2 * 132;  // blocks that keep the card busy
constexpr int kMaxGrid = 1 << 20;

// bit u: the parity of u & zl for the RPT rows of a thread (zl < 16)
__device__ __forceinline__ unsigned walsh(int64_t zl) {
  unsigned m = 0;
  if (zl & 1) m ^= 0xAAAAu;
  if (zl & 2) m ^= 0xCCCCu;
  if (zl & 4) m ^= 0xF0F0u;
  if (zl & 8) m ^= 0xFF00u;
  return m;
}

template <int RPT>
__global__ void __launch_bounds__(kThreads)
    overlap_groups_kernel(const double2* __restrict__ a, const double2* __restrict__ b,
                          int64_t dim, const int64_t* __restrict__ ux,
                          const int64_t* __restrict__ off, const int64_t* __restrict__ order,
                          const int64_t* __restrict__ zs, int64_t n_groups, int active,
                          int64_t n_chunks, int64_t n, double* __restrict__ part) {
  __shared__ double wsum[2][kBatch][2][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool on = threadIdx.x < active;
  const int width = active < 32 ? active : 32;
  const int nw = active > 32 ? active >> 5 : 1;
  const int64_t chunk = (int64_t)RPT * active;
  int buf = 0;  // alternates over every batch of the block (no barrier between tasks)
  for (int64_t task = blockIdx.x; task < n_groups * n_chunks; task += gridDim.x) {
    const int64_t g = task / n_chunks, ch = task - g * n_chunks;
    const int64_t x = ux[g] & (dim - 1);
    const int64_t r0 = ch * chunk + (int64_t)threadIdx.x * RPT;
    double wre[RPT], wim[RPT];
#pragma unroll
    for (int u = 0; u < RPT; ++u) {
      wre[u] = wim[u] = 0.0;
      if (on) {
        const double2 p = a[r0 + u], q = b[(r0 + u) ^ x];
        wre[u] = __dadd_rn(__dmul_rn(p.x, q.x), __dmul_rn(p.y, q.y));
        wim[u] = __dsub_rn(__dmul_rn(p.x, q.y), __dmul_rn(p.y, q.x));
      }
    }
    const int64_t s0 = off[g], s1 = off[g + 1];
    for (int64_t b0 = s0; b0 < s1; b0 += kBatch) {
      const int nb = (int)(s1 - b0 < kBatch ? s1 - b0 : kBatch);
      for (int q = 0; q < nb; ++q) {
        const int64_t z = zs[order[b0 + q]];
        unsigned wm = walsh(z & (RPT - 1));
        if (__popcll((unsigned long long)(r0 & z)) & 1) wm = ~wm;
        double vr[RPT], vi[RPT];
#pragma unroll
        for (int u = 0; u < RPT; ++u) {
          const bool odd = (wm >> u) & 1;
          vr[u] = odd ? -wre[u] : wre[u];
          vi[u] = odd ? -wim[u] : wim[u];
        }
#pragma unroll
        for (int h = 1; h < RPT; h <<= 1) {
#pragma unroll
          for (int u = 0; u < RPT; u += 2 * h) {
            vr[u] = __dadd_rn(vr[u], vr[u + h]);
            vi[u] = __dadd_rn(vi[u], vi[u + h]);
          }
        }
        double sr = on ? vr[0] : 0.0, si = on ? vi[0] : 0.0;
        for (int d = 1; d < width; d <<= 1) {
          sr = __dadd_rn(sr, __shfl_xor_sync(0xffffffffu, sr, d));
          si = __dadd_rn(si, __shfl_xor_sync(0xffffffffu, si, d));
        }
        if (lane == 0) {
          wsum[buf][q][0][warp] = sr;
          wsum[buf][q][1][warp] = si;
        }
      }
      __syncthreads();
      if (threadIdx.x < 2 * nb) {
        const int q = threadIdx.x >> 1, comp = threadIdx.x & 1;
        double w[kWarps];
        for (int i = 0; i < nw; ++i) w[i] = wsum[buf][q][comp][i];
        for (int h = 1; h < nw; h <<= 1)
          for (int i = 0; i < nw; i += 2 * h) w[i] = __dadd_rn(w[i], w[i + h]);
        part[((int64_t)comp * n + b0 + q) * n_chunks + ch] = w[0];
      }
      buf ^= 1;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    overlap_totals_kernel(const double* __restrict__ part, int64_t n_chunks, int64_t n,
                          const int64_t* __restrict__ order, const double2* __restrict__ ph,
                          double2* __restrict__ out) {
  __shared__ double sh[kWarps];
  for (int64_t s = blockIdx.x; s < n; s += gridDim.x) {
    const double re = total_pairwise(part + s * n_chunks, n_chunks, sh);
    const double im = total_pairwise(part + (n + s) * n_chunks, n_chunks, sh);
    if (threadIdx.x == 0) {
      const int64_t i = order[s];
      out[i] = times_phase(re, im, ph[i]);
    }
  }
}

// rows a thread takes: 16, or 4 (2 below 4 rows) where 16 leaves fewer
// blocks than the card wants
int rows_per_thread(int64_t dim, int64_t n_groups) {
  const int64_t chunks16 = dim > 16 * kThreads ? dim / (16 * kThreads) : 1;
  if (dim >= 16 && n_groups * chunks16 >= kTargetBlocks) return 16;
  return dim >= 4 ? 4 : 2;
}

}  // namespace

// Chunk sums per Pauli that the scratch of symmer_pauli_overlaps holds: it
// takes 2 * n * symmer_pauli_overlaps_chunks(dim, n_groups) float64.
extern "C" int64_t symmer_pauli_overlaps_chunks(int64_t dim, int64_t n_groups) {
  const int64_t chunk = (int64_t)rows_per_thread(dim, n_groups) * kThreads;
  return dim > chunk ? dim / chunk : 1;
}

// out[i] = <a| P_i |b> (see above): a, b complex128[dim], dim a power of two
// of at least 2; ux int64[G] (x taken modulo dim), off int64[G + 1] and
// order int64[n]: slot s of group g (off[g] <= s < off[g + 1]) is Pauli
// order[s]; zs int64[n]; ph complex128[n]; out complex128[n].  Two
// launches.  Returns a cudaError_t.
extern "C" int symmer_pauli_overlaps(const void* a, const void* b, int64_t dim, const void* ux,
                                     const void* off, const void* order, int64_t n_groups,
                                     const void* zs, const void* ph, int64_t n, void* part,
                                     void* out, void* stream) {
  if (dim < 2 || (dim & (dim - 1)) || n < 1 || n_groups < 1) return (int)cudaErrorInvalidValue;
  const int rpt = rows_per_thread(dim, n_groups);
  const int64_t rows = dim < (int64_t)rpt * kThreads ? dim : (int64_t)rpt * kThreads;
  const int active = (int)(rows / rpt);
  const int64_t n_chunks = dim / rows;
  const int64_t tasks = n_groups * n_chunks;
  const unsigned grid = (unsigned)(tasks < kMaxGrid ? tasks : kMaxGrid);
  auto st = static_cast<cudaStream_t>(stream);
  auto ap = static_cast<const double2*>(a);
  auto bp = static_cast<const double2*>(b);
  auto uxp = static_cast<const int64_t*>(ux);
  auto offp = static_cast<const int64_t*>(off);
  auto ordp = static_cast<const int64_t*>(order);
  auto zp = static_cast<const int64_t*>(zs);
  auto partp = static_cast<double*>(part);
  if (rpt == 16)
    overlap_groups_kernel<16><<<grid, kThreads, 0, st>>>(ap, bp, dim, uxp, offp, ordp, zp,
                                                         n_groups, active, n_chunks, n, partp);
  else if (rpt == 4)
    overlap_groups_kernel<4><<<grid, kThreads, 0, st>>>(ap, bp, dim, uxp, offp, ordp, zp,
                                                        n_groups, active, n_chunks, n, partp);
  else
    overlap_groups_kernel<2><<<grid, kThreads, 0, st>>>(ap, bp, dim, uxp, offp, ordp, zp,
                                                        n_groups, active, n_chunks, n, partp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)(n < 65535 ? n : 65535);
  overlap_totals_kernel<<<blocks, kThreads, 0, st>>>(partp, n_chunks, n, ordp,
                                                     static_cast<const double2*>(ph),
                                                     static_cast<double2*>(out));
  return (int)cudaGetLastError();
}
