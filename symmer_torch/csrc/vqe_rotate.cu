// One Pauli rotation of a dense statevector, for Hopper (sm_90a): K15a.
//
// Replaces the evolve step of symmer_tpu/evolution/jx_vqe.py's scans
// (_jitted_engine's loss_plain, :87-93, and _jitted_pool_grad's, :403-409),
// which XLA runs as a lax.scan over the generators.  For a complex128
// state of 2^n rows (qubit 0 the most significant bit of a row index) and
// one generator G = ph (-1)^{popcount(r & z)} X^x, with ph = (-i)^{|Y|} c
// and c real +-1 (so G^2 = I and e^{i t G} = cos t + i sin t G):
//
//   out[r] = c_t psi[r] + i s_t ph (-1)^{popcount(r & z)} psi[r ^ x]
//
// with (c_t, s_t) = (cos t, sin t) from the caller (the forward passes +t,
// the adjoint sweep -t).  Plain version: kernels/torch_vqe.py:rotate, bit
// for bit: every product and sum is an explicit round-to-nearest
// intrinsic in the plain version's order (no FMA contraction), and the sign
// is a negation.
//
// What bounds it: bytes.  psi is read once (the permuted read r ^ x stays
// inside the aligned 2^k blocks a warp covers, so it costs no more sectors
// than the direct one, and the second read of each row hits L2) and out is
// written once: 32 bytes a row, 4.2 MB at 2^17 (1.25 us at 3.35 TB/s), 134
// MB at 2^22 (40 us).  Out of place, since row r reads row r ^ x.
//
// The design: a thread per row, grid-stride; one launch per rotation.  A
// persistent launch that runs many rotations between grid barriers is
// later work (ROADMAP Queue 2).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    vqe_rotate_kernel(const double2* __restrict__ psi, double2* __restrict__ out, int64_t dim,
                      int64_t x, int64_t z, double phr, double phi, double c, double s) {
  const int64_t step = (int64_t)gridDim.x * kThreads;
  for (int64_t r = (int64_t)blockIdx.x * kThreads + threadIdx.x; r < dim; r += step) {
    const double2 p = psi[r], q = psi[r ^ x];
    double gre = __dsub_rn(__dmul_rn(q.x, phr), __dmul_rn(q.y, phi));
    double gim = __dadd_rn(__dmul_rn(q.y, phr), __dmul_rn(q.x, phi));
    if (__popcll((unsigned long long)(r & z)) & 1) {
      gre = -gre;
      gim = -gim;
    }
    // c psi + i s g:  (c p.re - s g.im, c p.im + s g.re)
    out[r] = make_double2(__dsub_rn(__dmul_rn(p.x, c), __dmul_rn(gim, s)),
                          __dadd_rn(__dmul_rn(p.y, c), __dmul_rn(gre, s)));
  }
}

}  // namespace

// out = e^{i t G} psi (see above), with c = cos t, s = sin t; psi and out:
// complex128[dim], dim a power of two, x and z in [0, dim).  Returns a
// cudaError_t.
extern "C" int symmer_vqe_rotate(const void* psi, void* out, int64_t dim, int64_t x, int64_t z,
                                 double phr, double phi, double c, double s, void* stream) {
  if (dim < 1 || (dim & (dim - 1)) || x < 0 || x >= dim || z < 0 || z >= dim)
    return (int)cudaErrorInvalidValue;
  const int64_t want = (dim + kThreads - 1) / kThreads;
  const unsigned blocks = (unsigned)(want < (1 << 16) ? want : (1 << 16));
  vqe_rotate_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double2*>(psi), static_cast<double2*>(out), dim, x, z, phr, phi, c, s);
  return (int)cudaGetLastError();
}
