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
// What bounds it: the operator is read and written once (2 planes x W words
// + 2 doubles per term; 54 MB each way at 200k terms x 1000 qubits), so a
// short run (the taper's D <= 16 stabilizer rotations) is bound by device
// memory, a long one by the ALU work of the commutation tests.
//   - W <= 16 words (up to 1024 qubits): tiles of 128 consecutive terms,
//     whose planes are contiguous in memory.  Persistent blocks walk over
//     the tiles; a tile is staged into shared memory with coalesced cp.async
//     copies while the block rotates the previous one (double buffer).  Each
//     thread moves its own row into registers (rows padded to an odd word
//     stride: no bank conflicts), runs all D rotations there and writes the
//     row back through the same buffer, which the block stores with
//     coalesced stores.  Rotations are staged 16 at a time (once for all
//     tiles when D <= 16), zero-padded to the template width, so the word
//     loops are unrolled with no bound checks.
//   - Bookkeeping per rotation: two XOR accumulators s1 = xor(px & rz) and
//     s2 = xor(pz & rx); the term anticommutes iff parity(s1 ^ s2), and the
//     product's sign (-1)^{popc(px & rz)} is parity(s1).  y_P = popc(px & pz)
//     mod 4 is kept in a register from step to step (y_out of one step is
//     y_in of the next), and y_Q is computed once per rotation while staging.
//     An anticommuting step then costs one popcount per word (y_out): POPC
//     runs in its own pipe, beside the logic ops.
//   - Wider rows are streamed from device memory in place in the output
//     buffer; every thread reads the same rotation words (cache broadcast).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kRotChunk = 16;

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

// 8-byte asynchronous copy global -> shared (no register round trip)
__device__ __forceinline__ void cp_async8(uint64_t* smem, const uint64_t* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most one committed group (the next tile's copies) is in flight
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Copy `rows` terms (contiguous rows of W words) of both planes into a tile
// of kThreads rows at an odd word stride: consecutive threads copy
// consecutive words.
template <int kStride>
__device__ __forceinline__ void stage_rows(uint64_t* s_x, uint64_t* s_z,
                                           const uint64_t* x, const uint64_t* z,
                                           int rows, int W) {
  const int n = rows * W, dr = kThreads / W, dc = kThreads % W;
  int r = threadIdx.x / W, c = threadIdx.x % W;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    cp_async8(&s_x[r * kStride + c], x + e);
    cp_async8(&s_z[r * kStride + c], z + e);
    r += dr;
    c += dc;
    if (c >= W) { c -= W; ++r; }
  }
}

// The inverse: coalesced stores of a staged tile's rows.
template <int kStride>
__device__ __forceinline__ void store_rows(uint64_t* x, uint64_t* z, const uint64_t* s_x,
                                           const uint64_t* s_z, int rows, int W) {
  const int n = rows * W, dr = kThreads / W, dc = kThreads % W;
  int r = threadIdx.x / W, c = threadIdx.x % W;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    x[e] = s_x[r * kStride + c];
    z[e] = s_z[r * kStride + c];
    r += dr;
    c += dc;
    if (c >= W) { c -= W; ++r; }
  }
}

template <int WMAX>
constexpr size_t tiled_smem_bytes() {
  return (size_t)2 * 2 * kThreads * (WMAX | 1) * sizeof(uint64_t);  // 2 buffers x 2 planes
}

// Persistent blocks walk over tiles of kThreads terms; the next tile's copy
// is in flight while this one is rotated (double buffer).
template <int WMAX>
__global__ void __launch_bounds__(kThreads, 3) clifford_scan_tiled(
    const uint64_t* __restrict__ x, const uint64_t* __restrict__ z,
    const double* __restrict__ cr, const double* __restrict__ ci, int64_t T, int W,
    const uint64_t* __restrict__ rx, const uint64_t* __restrict__ rz,
    const int64_t* __restrict__ rm, int64_t D,
    uint64_t* __restrict__ ox, uint64_t* __restrict__ oz,
    double* __restrict__ ocr, double* __restrict__ oci) {
  constexpr int kStride = WMAX | 1;  // odd word stride: a row per thread, no conflicts
  constexpr int kTile = kThreads * kStride;
  extern __shared__ __align__(16) uint64_t s_tiles[];  // [buffer][plane][kTile]
  __shared__ __align__(16) uint64_t s_rx[kRotChunk][WMAX];
  __shared__ __align__(16) uint64_t s_rz[kRotChunk][WMAX];
  __shared__ int s_m[kRotChunk];
  __shared__ int s_yr[kRotChunk];

  // stage rotations [d0, d0 + kRotChunk), zero words past W and past D
  auto stage_rotations = [&](int64_t d0) {
    const int dn = (int)((D - d0) < kRotChunk ? (D - d0) : kRotChunk);
    for (int e = threadIdx.x; e < kRotChunk * WMAX; e += kThreads) {
      const int k = e / WMAX, w = e % WMAX;
      const bool in = k < dn && w < W;
      s_rx[k][w] = in ? rx[(d0 + k) * W + w] : 0ull;
      s_rz[k][w] = in ? rz[(d0 + k) * W + w] : 0ull;
    }
    if (threadIdx.x < dn) {
      const int k = threadIdx.x;
      int yr = 0;
      for (int w = 0; w < W; ++w) yr += __popcll(rx[(d0 + k) * W + w] & rz[(d0 + k) * W + w]);
      s_m[k] = mod4(rm[d0 + k]);
      s_yr[k] = yr & 3;
    }
  };
  // a run of at most kRotChunk rotations is staged once for all tiles
  const bool rotations_once = D <= kRotChunk;
  if (rotations_once) stage_rotations(0);

  const int64_t n_tiles = (T + kThreads - 1) / kThreads;
  auto tile_rows = [&](int64_t tile) {
    const int64_t left = T - tile * kThreads;
    return (int)(left < kThreads ? left : kThreads);
  };
  int64_t tile = blockIdx.x;
  if (tile < n_tiles)
    stage_rows<kStride>(s_tiles, s_tiles + kTile, x + tile * kThreads * W,
                        z + tile * kThreads * W, tile_rows(tile), W);
  cp_async_commit();

  for (int buf = 0; tile < n_tiles; tile += gridDim.x, buf ^= 1) {
    uint64_t* s_x = s_tiles + buf * 2 * kTile;
    uint64_t* s_z = s_x + kTile;
    const int64_t next = tile + gridDim.x;
    if (next < n_tiles) {
      uint64_t* n_x = s_tiles + (buf ^ 1) * 2 * kTile;
      stage_rows<kStride>(n_x, n_x + kTile, x + next * kThreads * W,
                          z + next * kThreads * W, tile_rows(next), W);
    }
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();

    const int64_t t0 = tile * kThreads;
    const int rows = tile_rows(tile);
    const int i = threadIdx.x;
    const bool live = i < rows;
    uint64_t px[WMAX], pz[WMAX];
    int y = 0;  // popc(px & pz) mod 4
#pragma unroll
    for (int w = 0; w < WMAX; ++w) {
      px[w] = (live && w < W) ? s_x[i * kStride + w] : 0ull;
      pz[w] = (live && w < W) ? s_z[i * kStride + w] : 0ull;
      y += __popcll(px[w] & pz[w]);
    }
    double re = live ? cr[t0 + i] : 0.0;
    double im = live ? ci[t0 + i] : 0.0;

    for (int64_t d0 = 0; d0 < D; d0 += kRotChunk) {
      if (!rotations_once) {
        __syncthreads();  // the previous chunk is no longer read
        stage_rotations(d0);
        __syncthreads();
      }
      const int dn = (int)((D - d0) < kRotChunk ? (D - d0) : kRotChunk);
      for (int k = 0; k < dn; ++k) {
        const int m4 = s_m[k];
        if (m4 == 0) continue;
        uint64_t s1 = 0, s2 = 0;
#pragma unroll
        for (int w = 0; w < WMAX; ++w) {
          s1 ^= px[w] & s_rz[k][w];
          s2 ^= pz[w] & s_rx[k][w];
        }
        const int sgn = __popcll(s1) & 1;
        if (!(__popcll(s1 ^ s2) & 1)) continue;  // commutes: unchanged
        if (m4 == 2) {
          re = -re;
          im = -im;
          continue;
        }
        int y_out = 0;
#pragma unroll
        for (int w = 0; w < WMAX; ++w) {
          px[w] ^= s_rx[k][w];
          pz[w] ^= s_rz[k][w];
          y_out += __popcll(px[w] & pz[w]);
        }
        // sign * i^(3 y_in + y_out), then -i (= i^3) for m4 == 1, +i for 3
        apply_i_pow(3 * (y + s_yr[k]) + y_out + 2 * sgn + (m4 == 1 ? 3 : 1), re, im);
        y = y_out & 3;
      }
    }

    // write back through this tile's buffer (each thread rewrites its own
    // row, then the block stores the tile with coalesced stores)
    if (live) {
#pragma unroll
      for (int w = 0; w < WMAX; ++w) {
        if (w < W) {
          s_x[i * kStride + w] = px[w];
          s_z[i * kStride + w] = pz[w];
        }
      }
      ocr[t0 + i] = re;
      oci[t0 + i] = im;
    }
    __syncthreads();
    store_rows<kStride>(ox + t0 * W, oz + t0 * W, s_x, s_z, rows, W);
    __syncthreads();  // this buffer is refilled two tiles on
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

template <int WMAX>
cudaError_t launch_tiled(int64_t n_tiles, int sms, cudaStream_t s, const uint64_t* x,
                         const uint64_t* z, const double* cr, const double* ci, int64_t T,
                         int W, const uint64_t* rx, const uint64_t* rz, const int64_t* rm,
                         int64_t D, uint64_t* ox, uint64_t* oz, double* ocr, double* oci) {
  constexpr size_t smem = tiled_smem_bytes<WMAX>();
  cudaError_t err = cudaFuncSetAttribute(
      clifford_scan_tiled<WMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, clifford_scan_tiled<WMAX>,
                                                        kThreads, smem);
  if (err != cudaSuccess) return err;
  const int64_t resident = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  const int64_t blocks = n_tiles < resident ? n_tiles : resident;
  clifford_scan_tiled<WMAX><<<(unsigned)blocks, kThreads, smem, s>>>(
      x, z, cr, ci, T, W, rx, rz, rm, D, ox, oz, ocr, oci);
  return cudaGetLastError();
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
  if (W > 16) {
    clifford_scan_streamed<<<(unsigned)blocks, kThreads, 0, s>>>(
        xp, zp, crp, cip, T, W, rxp, rzp, rmp, D, oxp, ozp, ocrp, ocip);
    return (int)cudaGetLastError();
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
#define SYMMER_SCAN_TILED(WM)                                                     \
  err = launch_tiled<WM>(blocks, sms, s, xp, zp, crp, cip, T, (int)W, rxp, rzp, rmp, D, \
                         oxp, ozp, ocrp, ocip)
  if (W <= 1) SYMMER_SCAN_TILED(1);
  else if (W <= 2) SYMMER_SCAN_TILED(2);
  else if (W <= 4) SYMMER_SCAN_TILED(4);
  else if (W <= 8) SYMMER_SCAN_TILED(8);
  else SYMMER_SCAN_TILED(16);
#undef SYMMER_SCAN_TILED
  return (int)err;
}
