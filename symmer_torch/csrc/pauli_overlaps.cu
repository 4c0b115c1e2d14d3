// Overlaps <a| P_i |b> of a batch of Pauli operators, for Hopper (sm_90a):
// K15c.
//
// Replaces the pool-gradient scan of symmer_tpu/evolution/jx_vqe.py
// (_jitted_pool_grad's pterm, :418-422) and the reductions of the backward
// pass that jax.grad derives for the engine's loss (:189); the port's
// engine (evolution/device_vqe.py) also takes its energy <psi|H psi> from
// here (the identity, N = 1).  For complex128 vectors a, b of 2^n rows and
// N Paulis (x_i, z_i, ph_i) with ph_i = (-i)^{|Y_i|} c_i:
//
//   out_i = sum_r conj(a[r]) ph_i (-1)^{popcount(r & z_i)} b[r ^ x_i]
//
// The pool gradient is -2 Im out_i with a = H psi, b = psi; the adjoint
// step's g_k is -2 Im out with a = lambda, b = psi, N = 1.  Plain version:
// kernels/torch_vqe.py:pauli_overlaps, bit for bit: the products are
// explicit round-to-nearest intrinsics in its order and the sum over rows
// is the pairwise tree of adjacent pairs (csrc/pairwise_sum.cuh).
//
// What bounds it: the reads of a and b, once per Pauli where the two
// vectors do not stay in L2 (2^22 rows: 134 MB a Pauli), else the float64
// operations (8 a row and Pauli, 2^15 rows x 704 Paulis: 185 M).
//
// The design: two launches, no atomics, so a batch repeats bit for bit.
// The first: a block takes 512-row chunks of a Pauli (grid x over chunks,
// grid y over Paulis), a thread two adjacent rows, and writes the chunk's
// pairwise sum of the re and im parts; the second: a block per Pauli adds
// its chunk sums in the same tree.
#include <cuda_runtime.h>

#include <cstdint>

#include "pairwise_sum.cuh"

namespace {

using symmer_pairwise::block_pairwise;
using symmer_pairwise::kThreads;
using symmer_pairwise::kWarps;
using symmer_pairwise::total_pairwise;

constexpr int64_t kChunk = 2 * kThreads;  // rows a block takes at a time
constexpr int kMaxGridY = 65535;
constexpr int kTargetBlocks = 8 * 132;  // enough blocks in flight for the card

// conj(a[r]) ph (-1)^{popcount(r & z)} b[r ^ x] as (re, im)
__device__ __forceinline__ double2 row_term(const double2* __restrict__ a,
                                            const double2* __restrict__ b, int64_t r, int64_t x,
                                            int64_t z, double phr, double phi, int64_t mask) {
  const double2 q = b[(r ^ x) & mask], p = a[r];
  double gre = __dsub_rn(__dmul_rn(q.x, phr), __dmul_rn(q.y, phi));
  double gim = __dadd_rn(__dmul_rn(q.y, phr), __dmul_rn(q.x, phi));
  if (__popcll((unsigned long long)(r & z)) & 1) {
    gre = -gre;
    gim = -gim;
  }
  return make_double2(__dadd_rn(__dmul_rn(p.x, gre), __dmul_rn(p.y, gim)),
                      __dsub_rn(__dmul_rn(p.x, gim), __dmul_rn(p.y, gre)));
}

__global__ void __launch_bounds__(kThreads)
    overlap_chunks_kernel(const double2* __restrict__ a, const double2* __restrict__ b,
                          int64_t dim, const int64_t* __restrict__ xs,
                          const int64_t* __restrict__ zs, const double* __restrict__ ph,
                          int64_t n, double* __restrict__ part) {
  __shared__ double sh[kWarps];
  const int64_t n_chunks = dim > kChunk ? dim / kChunk : 1;
  const int active = dim >= kChunk ? kThreads : (int)(dim >> 1);
  for (int64_t i = blockIdx.y; i < n; i += gridDim.y) {
    const int64_t x = xs[i], z = zs[i];
    const double phr = ph[2 * i], phi = ph[2 * i + 1];
    double* pre = part + i * n_chunks;
    double* pim = part + (n + i) * n_chunks;
    for (int64_t c = blockIdx.x; c < n_chunks; c += gridDim.x) {
      const int64_t r = c * kChunk + 2 * threadIdx.x;
      double vre = 0.0, vim = 0.0;
      if (threadIdx.x < active) {
        const double2 t0 = row_term(a, b, r, x, z, phr, phi, dim - 1);
        const double2 t1 = row_term(a, b, r + 1, x, z, phr, phi, dim - 1);
        vre = __dadd_rn(t0.x, t1.x);
        vim = __dadd_rn(t0.y, t1.y);
      }
      vre = block_pairwise(vre, active, sh);
      vim = block_pairwise(vim, active, sh);
      if (threadIdx.x == 0) {
        pre[c] = vre;
        pim[c] = vim;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    overlap_total_kernel(const double* __restrict__ part, int64_t n_chunks, int64_t n,
                         double2* __restrict__ out) {
  __shared__ double sh[kWarps];
  for (int64_t i = blockIdx.x; i < n; i += gridDim.x) {
    const double re = total_pairwise(part + i * n_chunks, n_chunks, sh);
    const double im = total_pairwise(part + (n + i) * n_chunks, n_chunks, sh);
    if (threadIdx.x == 0) out[i] = make_double2(re, im);
  }
}

}  // namespace

// Chunk sums per Pauli that the scratch of symmer_pauli_overlaps holds:
// it takes 2 * n * symmer_pauli_overlaps_chunks(dim) float64.
extern "C" int64_t symmer_pauli_overlaps_chunks(int64_t dim) {
  return dim > kChunk ? dim / kChunk : 1;
}

// out[i] = <a| P_i |b> (see above): a, b complex128[dim], dim a power of two
// of at least 2; xs, zs int64[n] (x taken modulo dim); ph float64[n, 2] (re, im);
// out complex128[n].  Two launches.  Returns a cudaError_t.
extern "C" int symmer_pauli_overlaps(const void* a, const void* b, int64_t dim, const void* xs,
                                     const void* zs, const void* ph, int64_t n, void* part,
                                     void* out, void* stream) {
  if (dim < 2 || (dim & (dim - 1)) || n < 1) return (int)cudaErrorInvalidValue;
  const int64_t n_chunks = symmer_pauli_overlaps_chunks(dim);
  const int64_t gy = n < kMaxGridY ? n : kMaxGridY;
  int64_t gx = (kTargetBlocks + gy - 1) / gy;
  if (gx > n_chunks) gx = n_chunks;
  auto st = static_cast<cudaStream_t>(stream);
  overlap_chunks_kernel<<<dim3((unsigned)gx, (unsigned)gy), kThreads, 0, st>>>(
      static_cast<const double2*>(a), static_cast<const double2*>(b), dim,
      static_cast<const int64_t*>(xs), static_cast<const int64_t*>(zs),
      static_cast<const double*>(ph), n, static_cast<double*>(part));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)(n < kMaxGridY ? n : kMaxGridY);
  overlap_total_kernel<<<blocks, kThreads, 0, st>>>(static_cast<const double*>(part), n_chunks,
                                                    n, static_cast<double2*>(out));
  return (int)cudaGetLastError();
}
