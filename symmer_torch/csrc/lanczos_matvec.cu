// The Lanczos matvec in X-grouped form, for Hopper (sm_90a).
//
// Replaces symmer_tpu/kernels/jx_lanczos.py:_matvec_block (a lax.scan over
// blocks of groups, each an XOR gather, or on the TPU two one-hot MXU
// permutations, _onehot_perms / _xor_permute, then a complex multiply and a
// pairwise tree sum).  For a block of b complex128 columns V (b, 2^n):
//     out[c, r] = sum_g D[g, r] * V[c, r ^ ux[g]],
// with D the (G, 2^n) group-diagonal table (csrc/group_diag.cu) and ux the
// G distinct X patterns.  Rows are 32-bit: 2^n <= 2^31.  ux is taken modulo
// 2^n (r ^ ux is masked to a row), as the plain version
// (kernels/torch_lanczos.py:group_matvec) reads it.
//
// What bounds it: the table.  Each matvec reads all G 2^n entries of D (16
// bytes each) once, V and out are 2^n b entries each: at tapered N2 (G =
// 378, n = 15, b = 1) 199 MB, 59.5 us at 3.35 TB/s.  Recomputing D_g(r) from
// the terms instead would cost T 2^n b (term, row) pairs of a parity and a
// complex multiply-add in float64 (73 M at N2, 17.5 us at 4 FMAs a pair):
// chip_smoke.py reports both and takes the lesser as the bound, so the gap
// says where a later design should go.
//
// The design (first cut, simple and right):
//   - a block is 32 rows x kSlices warps; lane = row, warp = a contiguous
//     range of groups, so the D reads of a warp are 512 contiguous bytes
//     and each D[g, r] is read once for all b columns, which sit in
//     registers (b = 1, 2, 4, 8 are template widths);
//   - the V reads r ^ ux[g] permute the rows inside their aligned 32-row
//     segment, so they coalesce too; V (0.5 MB a column at N2) stays in L2;
//   - ux[g] is one broadcast load per warp and group (all lanes read the
//     same word; it stays in L1), not staged in shared memory;
//   - kSlices warps per row block give the card 8x more warps than rows
//     (32,768 rows fill only 248 threads an SM); each warp's partial sums
//     go through shared memory and are added in slice order 0..7.
// Deterministic: no atomics, a fixed order of groups within a slice and of
// slices, so pass 2 of the Lanczos drivers replays pass 1 bit for bit.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kSlices = 8;
constexpr int kThreads = 32 * kSlices;

template <int B>
__global__ void __launch_bounds__(kThreads)
    group_matvec_kernel(const int64_t* __restrict__ ux, const double2* __restrict__ D,
                        const double2* __restrict__ V, double2* __restrict__ out, int64_t G,
                        uint32_t dim) {
  __shared__ double2 part[kSlices * B * 32];
  const int lane = threadIdx.x & 31;
  const int slice = threadIdx.x >> 5;
  const uint32_t r = blockIdx.x * 32u + (uint32_t)lane;
  const uint32_t mask = dim - 1u;
  double2 acc[B];
#pragma unroll
  for (int c = 0; c < B; ++c) acc[c] = make_double2(0.0, 0.0);
  if (r < dim) {
    const int64_t g0 = G * slice / kSlices;
    const int64_t g1 = G * (slice + 1) / kSlices;
    const double2* Dr = D + r;
#pragma unroll 4
    for (int64_t g = g0; g < g1; ++g) {
      const uint32_t src = (r ^ (uint32_t)__ldg(ux + g)) & mask;
      const double2 d = __ldg(Dr + g * (int64_t)dim);
#pragma unroll
      for (int c = 0; c < B; ++c) {
        const double2 v = __ldg(V + (int64_t)c * dim + src);
        acc[c].x = fma(d.x, v.x, fma(-d.y, v.y, acc[c].x));
        acc[c].y = fma(d.x, v.y, fma(d.y, v.x, acc[c].y));
      }
    }
  }
#pragma unroll
  for (int c = 0; c < B; ++c) part[(slice * B + c) * 32 + lane] = acc[c];
  __syncthreads();
  for (int t = threadIdx.x; t < B * 32; t += kThreads) {
    const int c = t >> 5, l = t & 31;
    const uint32_t row = blockIdx.x * 32u + (uint32_t)l;
    double2 s = part[c * 32 + l];
#pragma unroll
    for (int k = 1; k < kSlices; ++k) {
      const double2 p = part[(k * B + c) * 32 + l];
      s.x += p.x;
      s.y += p.y;
    }
    if (row < dim) out[(int64_t)c * dim + row] = s;
  }
}

}  // namespace

// out (b, dim) = H @ V for b in {1, 2, 4, 8}; returns a cudaError_t.
extern "C" int symmer_group_matvec(const void* ux, const void* D, const void* V, void* out,
                                   int64_t G, int64_t dim, int64_t b, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dim < 1 || dim > (int64_t(1) << 31) || (dim & (dim - 1)) || G < 1)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((dim + 31) / 32);
  const auto uxp = static_cast<const int64_t*>(ux);
  const auto Dp = static_cast<const double2*>(D);
  const auto Vp = static_cast<const double2*>(V);
  auto op = static_cast<double2*>(out);
  const auto n = (uint32_t)(dim - 1) + 1u;  // 2^31 fits uint32_t
  switch (b) {
    case 1: group_matvec_kernel<1><<<blocks, kThreads, 0, s>>>(uxp, Dp, Vp, op, G, n); break;
    case 2: group_matvec_kernel<2><<<blocks, kThreads, 0, s>>>(uxp, Dp, Vp, op, G, n); break;
    case 4: group_matvec_kernel<4><<<blocks, kThreads, 0, s>>>(uxp, Dp, Vp, op, G, n); break;
    case 8: group_matvec_kernel<8><<<blocks, kThreads, 0, s>>>(uxp, Dp, Vp, op, G, n); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
