// Symplectic anticommutation matrix for Hopper (sm_90a).
//
// Replaces symmer_tpu/kernels/pallas_gf2.py:_anticommutes_kernel (launched by
// anticommutes_pallas, padded by anticommutes_tiled) and the XLA broadcast
// jx_core.anticommutes:
//
//     C[i, j] = parity(popc(x1_i & z2_j) + popc(z1_i & x2_j))
//
// over packed planes (one bit per qubit, W 64-bit words per row), as
// uint8[M1, M2].  The parity of a sum of popcounts is the popcount parity of
// the XOR of the words, so each output keeps one 64-bit XOR accumulator and
// takes a single __popcll at the end.
//
// What bounds it: the two shapes of the taper path differ.
//   - Tall-skinny (the projection filter: M1 = terms, up to 2e5, M2 = S <= 16
//     stabilizers): bound by reading op1 once from device memory (2 planes x
//     W words x M1 rows; 51 MB at 200k x 1000 qubits).  Tiles of 128 op1 rows
//     x 8 op2 rows; the few op2 rows sit in shared memory for the whole block,
//     op1 rows are staged through shared memory with coalesced loads, and
//     every op1 word is read from device memory exactly once.
//   - Square (adjacency matrices, M1 = M2 ~ 4096): integer ALU work
//     (M1 * M2 * W AND/XOR pairs) plus the M1 * M2 byte output.  Tiles of
//     64 x 32; each block reuses its staged rows 32 (resp. 64) times, and a
//     warp writes 32 consecutive output bytes.
// Ragged edges (M1, M2 not multiples of the tile, W not a multiple of the
// word chunk) are masked in the kernel: no padding of the inputs.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWordChunk = 16;  // words of each row staged per pass

template <int TM, int TN>
__global__ void __launch_bounds__(kThreads) anticommutes_kernel(
    const uint64_t* __restrict__ x1, const uint64_t* __restrict__ z1, int64_t M1,
    const uint64_t* __restrict__ x2, const uint64_t* __restrict__ z2, int64_t M2,
    int64_t W, int64_t n_row_tiles, uint8_t* __restrict__ out) {
  static_assert(kThreads % TN == 0, "tile width must divide the block");
  constexpr int kRowsPerPass = kThreads / TN;
  static_assert(TM % kRowsPerPass == 0, "tile height must be a multiple");
  constexpr int kRowsPerThread = TM / kRowsPerPass;
  // +1 word of padding per row: threads of a warp reading the same word of
  // consecutive rows hit distinct banks
  __shared__ uint64_t s_x1[TM][kWordChunk + 1];
  __shared__ uint64_t s_z1[TM][kWordChunk + 1];
  __shared__ uint64_t s_x2[TN][kWordChunk + 1];
  __shared__ uint64_t s_z2[TN][kWordChunk + 1];

  // one flat grid: consecutive blocks share a column tile (op2 rows stay in L2)
  const int64_t tile = blockIdx.x;
  const int64_t i0 = (tile % n_row_tiles) * TM;
  const int64_t j0 = (tile / n_row_tiles) * TN;
  const int tj = threadIdx.x % TN;
  const int ti = threadIdx.x / TN;
  const int wc = (int)(W < kWordChunk ? W : kWordChunk);

  uint64_t acc[kRowsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) acc[r] = 0;

  for (int64_t w0 = 0; w0 < W; w0 += kWordChunk) {
    const int wn = (int)((W - w0) < kWordChunk ? (W - w0) : kWordChunk);
    // coalesced staging: consecutive threads read consecutive words
    for (int e = threadIdx.x; e < TM * wc; e += kThreads) {
      const int r = e / wc, w = e % wc;
      const int64_t gi = i0 + r;
      const bool in = gi < M1 && w < wn;
      s_x1[r][w] = in ? x1[gi * W + w0 + w] : 0ull;
      s_z1[r][w] = in ? z1[gi * W + w0 + w] : 0ull;
    }
    for (int e = threadIdx.x; e < TN * wc; e += kThreads) {
      const int r = e / wc, w = e % wc;
      const int64_t gj = j0 + r;
      const bool in = gj < M2 && w < wn;
      s_x2[r][w] = in ? x2[gj * W + w0 + w] : 0ull;
      s_z2[r][w] = in ? z2[gj * W + w0 + w] : 0ull;
    }
    __syncthreads();
    for (int w = 0; w < wn; ++w) {
      const uint64_t bx = s_x2[tj][w];
      const uint64_t bz = s_z2[tj][w];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const int i = ti + r * kRowsPerPass;
        acc[r] ^= (s_x1[i][w] & bz) ^ (s_z1[i][w] & bx);
      }
    }
    __syncthreads();
  }

  const int64_t j = j0 + tj;
  if (j < M2) {
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const int64_t i = i0 + ti + r * kRowsPerPass;
      if (i < M1) out[i * M2 + j] = (uint8_t)(__popcll(acc[r]) & 1);
    }
  }
}

template <int TM, int TN>
cudaError_t launch(const uint64_t* x1, const uint64_t* z1, int64_t M1,
                   const uint64_t* x2, const uint64_t* z2, int64_t M2,
                   int64_t W, uint8_t* out, cudaStream_t stream) {
  const int64_t row_tiles = (M1 + TM - 1) / TM;
  const int64_t col_tiles = (M2 + TN - 1) / TN;
  const int64_t blocks = row_tiles * col_tiles;
  if (blocks > 0x7FFFFFFF) return cudaErrorInvalidConfiguration;
  anticommutes_kernel<TM, TN><<<(unsigned)blocks, kThreads, 0, stream>>>(
      x1, z1, M1, x2, z2, M2, W, row_tiles, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" int symmer_anticommutes(const void* x1, const void* z1, int64_t M1,
                                   const void* x2, const void* z2, int64_t M2,
                                   int64_t W, void* out, void* stream) {
  auto a = static_cast<const uint64_t*>(x1);
  auto b = static_cast<const uint64_t*>(z1);
  auto c = static_cast<const uint64_t*>(x2);
  auto d = static_cast<const uint64_t*>(z2);
  auto o = static_cast<uint8_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = (M2 <= 8) ? launch<128, 8>(a, b, M1, c, d, M2, W, o, s)
                              : launch<64, 32>(a, b, M1, c, d, M2, W, o, s);
  return (int)err;
}
