// Clifford rotation sequence for Hopper (sm_90a).
//
// Replaces symmer_tpu/kernels/jx_core.py:clifford_scan (a lax.scan of D
// steps, one full pass over the operator per rotation; host oracle
// np_core.clifford_sequence).  Applies D rotations R_k(m_k * pi/2) to every
// term in ONE launch.  For a term P anticommuting with the rotation Pauli Q:
//     m mod 4 == 1: P -> -i P Q,  2: P -> -P,  3: P -> +i P Q
// (0 and commuting terms are unchanged).  P Q carries the phase
// (-1)^{popc(x_P & z_Q)} * i^{3 (y_P + y_Q) + y_PQ}; every phase is an exact
// swap / negation of the (re, im) pair, so the result equals the plain torch
// version bit for bit.
//
// What bounds it: the scan on the TPU streams the whole operator through
// device memory D times.  Here a thread owns one term for the whole
// sequence, so the operator is read and written once (2 planes x W words +
// 2 doubles per term; 54 MB each way at 200k terms x 1000 qubits) and the
// D rotations cost popcount/AND/XOR work on registers:
//   - W <= 16 words (up to 1024 qubits): the row lives in registers (the
//     word loops are unrolled to a compile-time bound picked from W), and
//     the rotations are read from shared memory, staged 32 at a time by the
//     whole block;
//   - wider rows are streamed from device memory in place in the output
//     buffer; every thread reads the same rotation words (cache broadcast).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kRotChunk = 32;

// (re, im) *= i^k for k in 0..3
__device__ __forceinline__ void apply_i_pow(int k, double& re, double& im) {
  const double r = re, i = im;
  switch (k & 3) {
    case 1: re = -i; im = r; break;
    case 2: re = -r; im = -i; break;
    case 3: re = i; im = -r; break;
    default: break;
  }
}

__device__ __forceinline__ int mod4(int64_t m) { return (int)(((m % 4) + 4) % 4); }

template <int WMAX>
__global__ void __launch_bounds__(kThreads) clifford_scan_registers(
    const uint64_t* __restrict__ x, const uint64_t* __restrict__ z,
    const double* __restrict__ cr, const double* __restrict__ ci, int64_t T, int W,
    const uint64_t* __restrict__ rx, const uint64_t* __restrict__ rz,
    const int64_t* __restrict__ rm, int64_t D,
    uint64_t* __restrict__ ox, uint64_t* __restrict__ oz,
    double* __restrict__ ocr, double* __restrict__ oci) {
  __shared__ uint64_t s_rx[kRotChunk][WMAX];
  __shared__ uint64_t s_rz[kRotChunk][WMAX];
  __shared__ int s_m[kRotChunk];

  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const bool live = t < T;
  uint64_t px[WMAX], pz[WMAX];
#pragma unroll
  for (int w = 0; w < WMAX; ++w) {
    px[w] = (live && w < W) ? x[t * W + w] : 0ull;
    pz[w] = (live && w < W) ? z[t * W + w] : 0ull;
  }
  double re = live ? cr[t] : 0.0;
  double im = live ? ci[t] : 0.0;

  for (int64_t d0 = 0; d0 < D; d0 += kRotChunk) {
    const int dn = (int)((D - d0) < kRotChunk ? (D - d0) : kRotChunk);
    __syncthreads();  // the previous chunk is no longer read
    for (int e = threadIdx.x; e < dn * W; e += kThreads) {
      const int k = e / W, w = e % W;
      s_rx[k][w] = rx[(d0 + k) * W + w];
      s_rz[k][w] = rz[(d0 + k) * W + w];
    }
    for (int e = threadIdx.x; e < dn; e += kThreads) s_m[e] = mod4(rm[d0 + e]);
    __syncthreads();
    for (int k = 0; k < dn; ++k) {
      const int m4 = s_m[k];
      if (m4 == 0) continue;
      uint64_t acc = 0;
#pragma unroll
      for (int w = 0; w < WMAX; ++w)
        if (w < W) acc ^= (px[w] & s_rz[k][w]) ^ (pz[w] & s_rx[k][w]);
      if (!(__popcll(acc) & 1)) continue;  // commutes: unchanged
      if (m4 == 2) {
        re = -re;
        im = -im;
        continue;
      }
      int y_in = 0, y_out = 0, sgn = 0;
#pragma unroll
      for (int w = 0; w < WMAX; ++w) {
        if (w < W) {
          const uint64_t a = s_rx[k][w], b = s_rz[k][w];
          y_in += __popcll(px[w] & pz[w]) + __popcll(a & b);
          sgn += __popcll(px[w] & b);
          px[w] ^= a;
          pz[w] ^= b;
          y_out += __popcll(px[w] & pz[w]);
        }
      }
      // sign * i^(3 y_in + y_out), then -i (= i^3) for m4 == 1, +i for 3
      apply_i_pow(3 * y_in + y_out + 2 * (sgn & 1) + (m4 == 1 ? 3 : 1), re, im);
    }
  }
  if (live) {
#pragma unroll
    for (int w = 0; w < WMAX; ++w) {
      if (w < W) {
        ox[t * W + w] = px[w];
        oz[t * W + w] = pz[w];
      }
    }
    ocr[t] = re;
    oci[t] = im;
  }
}

__global__ void __launch_bounds__(kThreads) clifford_scan_streamed(
    const uint64_t* __restrict__ x, const uint64_t* __restrict__ z,
    const double* __restrict__ cr, const double* __restrict__ ci, int64_t T, int64_t W,
    const uint64_t* __restrict__ rx, const uint64_t* __restrict__ rz,
    const int64_t* __restrict__ rm, int64_t D,
    uint64_t* __restrict__ ox, uint64_t* __restrict__ oz,
    double* __restrict__ ocr, double* __restrict__ oci) {
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= T) return;
  uint64_t* px = ox + t * W;
  uint64_t* pz = oz + t * W;
  for (int64_t w = 0; w < W; ++w) {
    px[w] = x[t * W + w];
    pz[w] = z[t * W + w];
  }
  double re = cr[t], im = ci[t];
  for (int64_t d = 0; d < D; ++d) {
    const int m4 = mod4(rm[d]);
    if (m4 == 0) continue;
    const uint64_t* a = rx + d * W;
    const uint64_t* b = rz + d * W;
    uint64_t acc = 0;
    for (int64_t w = 0; w < W; ++w) acc ^= (px[w] & b[w]) ^ (pz[w] & a[w]);
    if (!(__popcll(acc) & 1)) continue;
    if (m4 == 2) {
      re = -re;
      im = -im;
      continue;
    }
    int64_t y_in = 0, y_out = 0, sgn = 0;
    for (int64_t w = 0; w < W; ++w) {
      const uint64_t aw = a[w], bw = b[w];
      y_in += __popcll(px[w] & pz[w]) + __popcll(aw & bw);
      sgn += __popcll(px[w] & bw);
      px[w] ^= aw;
      pz[w] ^= bw;
      y_out += __popcll(px[w] & pz[w]);
    }
    apply_i_pow((int)((3 * y_in + y_out + 2 * (sgn & 1) + (m4 == 1 ? 3 : 1)) & 3), re, im);
  }
  ocr[t] = re;
  oci[t] = im;
}

}  // namespace

extern "C" int symmer_clifford_scan(const void* x, const void* z, const void* cr,
                                    const void* ci, int64_t T, int64_t W,
                                    const void* rx, const void* rz, const void* rm,
                                    int64_t D, void* ox, void* oz, void* ocr,
                                    void* oci, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int64_t blocks = (T + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidConfiguration;
  const auto xp = static_cast<const uint64_t*>(x);
  const auto zp = static_cast<const uint64_t*>(z);
  const auto crp = static_cast<const double*>(cr);
  const auto cip = static_cast<const double*>(ci);
  const auto rxp = static_cast<const uint64_t*>(rx);
  const auto rzp = static_cast<const uint64_t*>(rz);
  const auto rmp = static_cast<const int64_t*>(rm);
  auto oxp = static_cast<uint64_t*>(ox);
  auto ozp = static_cast<uint64_t*>(oz);
  auto ocrp = static_cast<double*>(ocr);
  auto ocip = static_cast<double*>(oci);
  const dim3 grid((unsigned)blocks);
#define SYMMER_SCAN_REG(WM)                                                     \
  clifford_scan_registers<WM><<<grid, kThreads, 0, s>>>(                        \
      xp, zp, crp, cip, T, (int)W, rxp, rzp, rmp, D, oxp, ozp, ocrp, ocip)
  if (W <= 1) SYMMER_SCAN_REG(1);
  else if (W <= 2) SYMMER_SCAN_REG(2);
  else if (W <= 4) SYMMER_SCAN_REG(4);
  else if (W <= 8) SYMMER_SCAN_REG(8);
  else if (W <= 16) SYMMER_SCAN_REG(16);
  else
    clifford_scan_streamed<<<grid, kThreads, 0, s>>>(xp, zp, crp, cip, T, W, rxp, rzp,
                                                     rmp, D, oxp, ozp, ocrp, ocip);
#undef SYMMER_SCAN_REG
  return (int)cudaGetLastError();
}
