// Symplectic anticommutation matrix for Hopper (sm_90a).
//
// Replaces symmer_tpu/kernels/pallas_gf2.py:_anticommutes_kernel (launched by
// anticommutes_pallas, padded by anticommutes_tiled) and the XLA broadcast
// jx_core.anticommutes:
//
//     C[i, j] = parity(popc(x1_i & z2_j) + popc(z1_i & x2_j))
//
// over packed planes (one bit per qubit, W 64-bit words per row), as
// uint8[M1, M2].  Two regimes, chosen by shape (and op1's alignment) only:
//
//   - Tall-skinny (M2 <= 16, W <= 64 and 16-byte aligned op1 planes; the
//     projection filter: M1 = terms, up to 2e5, M2 = S stabilizers).  Bound by
//     reading op1 once from device memory (51 MB at 200k x 1000 qubits).  A
//     persistent block stages the op2 rows in shared memory, and each lane
//     keeps its own words of them in registers.  op1 streams through two
//     stages (double-buffered) of 4 KB tiles of whole rows: one thread issues
//     a 1-D bulk copy (TMA) per plane and tile, which completes on the stage's
//     mbarrier, so the block's next tile is in flight while it computes on
//     this one.  Each op1 row is read from shared memory by a group of lanes
//     (16-byte reads, 8 lanes per row at W = 16).  Per op2 row a lane XORs
//     its products into one word (the parity of a sum of popcounts is the
//     popcount parity of the XOR of the words) and keeps its parity as one
//     bit of a mask; the lanes of a row XOR-reduce that mask with
//     __shfl_xor_sync.  The M2 bytes of a row are written by consecutive lanes.
//   - Square (everything else; adjacency matrices, M1 = M2 ~ 4096): bound by
//     the AND-popcount work.  C = ([x1|z1] . [z2|x2]^T) & 1 is a binary
//     matrix product, which the tensor cores run as
//     mma.m16n8k256.row.col.s32.b1.b1.s32.and.popc: an A row is a term's
//     bits and a B column an op2 row's bits, which is the planes' layout,
//     so nothing is transposed.  A block computes a 128 x 128 tile with 8
//     warps of 32 x 64; 16-word chunks of the rows (4 k-steps of 256 bits
//     per plane) are staged in shared memory with zero-filling cp.async
//     copies (ragged M1, M2 and W read as zero words), fragments come from
//     ldmatrix, and the x half and the z half of k accumulate into the same
//     s32 sums (at most 128 W, exact).  The tile's bits leave through shared
//     memory as coalesced byte rows.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// ---- tall-skinny regime ----------------------------------------------------

constexpr int kTallThreads = 256;
constexpr int kTallMaxM2 = 16;
constexpr int kTallMaxW = 64;
constexpr int kTileWords = 512;  // op1 words of one plane in a stage (4 KB)
constexpr int kStages = 2;       // double buffer: one tile in flight while one is read
static_assert(kStages <= 16, "the mbarriers take the first 128 bytes of shared memory");

// kStages mbarriers (padded to 128 B), kStages x {x1, z1} tiles, z2 and x2 rows
template <int M2MAX>
constexpr size_t tall_smem_bytes() {
  static_assert(M2MAX <= kTallMaxM2, "op2 rows beyond the tall regime");
  return 128 + sizeof(uint64_t) * ((size_t)kStages * 2 * kTileWords + 2 * M2MAX * kTallMaxW);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

// the phase's one arrival, announcing `bytes` of bulk copies to come
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Thread 0 loads op1's tile `tile` (rows tile*R, ... of both planes) into a
// stage: whole 16-byte units by bulk copy; an odd last word (odd W, last
// tile) it stores itself before its arrival, which releases that store.
__device__ __forceinline__ void load_tile(const uint64_t* x1, const uint64_t* z1, int64_t M1,
                                          int W, int R, int64_t tile, uint64_t* sx,
                                          uint64_t* sz, uint64_t* bar) {
  const int64_t r0 = tile * R;
  const unsigned words = (unsigned)((M1 - r0 < R ? M1 - r0 : R) * W);
  const unsigned bulk = words & ~1u;
  const uint64_t* gx = x1 + r0 * W;
  const uint64_t* gz = z1 + r0 * W;
  if (words & 1u) {
    sx[words - 1] = gx[words - 1];
    sz[words - 1] = gz[words - 1];
  }
  mbar_arrive_expect(bar, 2 * bulk * (unsigned)sizeof(uint64_t));
  if (bulk) {
    bulk_load(sx, gx, bulk * (unsigned)sizeof(uint64_t), bar);
    bulk_load(sz, gz, bulk * (unsigned)sizeof(uint64_t), bar);
  }
}

// VEC: 64-bit words a lane reads at once (2, 16-byte reads, for even W).
// R: rows of a tile, a whole number of block passes (rows the 8 warps take
// at once), so that every lane of a warp runs the row loop equally often.
template <int VEC, int M2MAX>
__global__ void __launch_bounds__(kTallThreads) anticommutes_tall(
    const uint64_t* __restrict__ x1, const uint64_t* __restrict__ z1, int64_t M1,
    const uint64_t* __restrict__ x2, const uint64_t* __restrict__ z2, int M2, int W,
    int lanes_log2, int R, uint8_t* __restrict__ out) {
  extern __shared__ __align__(128) uint64_t ring[];
  uint64_t* bar = ring;
  uint64_t* tiles = ring + 16;  // stage s: x1 rows at 2 s kTileWords, z1 rows after
  uint64_t* s_z2 = tiles + kStages * 2 * kTileWords;
  uint64_t* s_x2 = s_z2 + M2 * W;
  const int64_t n_tiles = (M1 + R - 1) / R;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&bar[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < kStages; ++s) {
      const int64_t t = blockIdx.x + (int64_t)s * gridDim.x;
      if (t < n_tiles)
        load_tile(x1, z1, M1, W, R, t, tiles + 2 * s * kTileWords,
                  tiles + (2 * s + 1) * kTileWords, &bar[s]);
    }
  }
  for (int e = threadIdx.x; e < M2 * W; e += kTallThreads) {
    s_z2[e] = z2[e];
    s_x2[e] = x2[e];
  }
  __syncthreads();

  // this lane's words of every op2 row, held in registers for the launch:
  // chunk `sub` (words 2 sub, 2 sub + 1) for even W, words sub and sub + 32
  // for odd W (up to 63 words); zeros where W ends or j >= M2
  const int lane = threadIdx.x & 31;
  const int L = 1 << lanes_log2;  // lanes per op1 row
  const int sub = lane & (L - 1);
  const int rows_per_warp = 32 >> lanes_log2;
  const int w0 = VEC * sub, w1 = VEC == 2 ? w0 + 1 : sub + 32;
  const bool in0 = w0 < W, in1 = w1 < W;
  uint64_t z2a[M2MAX], z2b[M2MAX], x2a[M2MAX], x2b[M2MAX];
#pragma unroll
  for (int j = 0; j < M2MAX; ++j) {
    const bool row = j < M2;
    z2a[j] = row && in0 ? s_z2[j * W + w0] : 0;
    z2b[j] = row && in1 ? s_z2[j * W + w1] : 0;
    x2a[j] = row && in0 ? s_x2[j * W + w0] : 0;
    x2b[j] = row && in1 ? s_x2[j * W + w1] : 0;
  }
  int k = 0;  // tiles this block has taken
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x, ++k) {
    const int s = k % kStages;
    mbar_wait(&bar[s], (unsigned)(k / kStages) & 1u);
    const uint64_t* sx = tiles + 2 * s * kTileWords;
    const uint64_t* sz = sx + kTileWords;
    for (int r = (threadIdx.x >> 5) * rows_per_warp + (lane >> lanes_log2); r < R;
         r += (kTallThreads / 32) * rows_per_warp) {
      uint64_t xa = 0, xb = 0, za = 0, zb = 0;  // the row's words w0, w1 of x1 and z1
      if constexpr (VEC == 2) {
        if (in0) {
          const ulonglong2 a = reinterpret_cast<const ulonglong2*>(sx + r * W)[sub];
          const ulonglong2 b = reinterpret_cast<const ulonglong2*>(sz + r * W)[sub];
          xa = a.x, xb = a.y, za = b.x, zb = b.y;
        }
      } else {
        if (in0) xa = sx[r * W + w0], za = sz[r * W + w0];
        if (in1) xb = sx[r * W + w1], zb = sz[r * W + w1];
      }
      unsigned bits = 0;
#pragma unroll
      for (int j = 0; j < M2MAX; ++j)
        bits |= (unsigned)(__popcll((xa & z2a[j]) ^ (xb & z2b[j]) ^ (za & x2a[j]) ^
                                    (zb & x2b[j])) & 1) << j;
      for (int o = L >> 1; o > 0; o >>= 1) bits ^= __shfl_xor_sync(0xffffffffu, bits, o);
      const int64_t i = t * R + r;  // rows past M1 in the last tile are not written
      if (i < M1)
        for (int j = sub; j < M2; j += L) out[i * M2 + j] = (uint8_t)((bits >> j) & 1);
    }
    __syncthreads();  // stage s is read: thread 0 refills it with tile k + kStages
    const int64_t next = t + (int64_t)kStages * gridDim.x;
    if (threadIdx.x == 0 && next < n_tiles)
      load_tile(x1, z1, M1, W, R, next, tiles + 2 * s * kTileWords,
                tiles + (2 * s + 1) * kTileWords, &bar[s]);
  }
}

template <int VEC, int M2MAX>
cudaError_t launch_tall(const uint64_t* x1, const uint64_t* z1, int64_t M1,
                        const uint64_t* x2, const uint64_t* z2, int M2, int W,
                        uint8_t* out, cudaStream_t stream) {
  const int n_chunks = W / VEC;
  int lanes_log2 = 0;
  while ((1 << lanes_log2) < n_chunks && lanes_log2 < 5) ++lanes_log2;
  const int pass = (kTallThreads / 32) * (32 >> lanes_log2);
  const int R = kTileWords / W / pass * pass;  // >= pass for every W <= 64
  constexpr size_t smem = tall_smem_bytes<M2MAX>();  // < 48 KB: no attribute needed
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, anticommutes_tall<VEC, M2MAX>, kTallThreads, smem);
  if (err != cudaSuccess) return err;
  const int64_t n_tiles = (M1 + R - 1) / R;
  int64_t blocks = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > n_tiles) blocks = n_tiles;  // persistent: the blocks loop over tiles
  anticommutes_tall<VEC, M2MAX><<<(unsigned)blocks, kTallThreads, smem, stream>>>(
      x1, z1, M1, x2, z2, M2, W, lanes_log2, R, out);
  return cudaGetLastError();
}

template <int VEC>
cudaError_t dispatch_tall(const uint64_t* x1, const uint64_t* z1, int64_t M1,
                          const uint64_t* x2, const uint64_t* z2, int M2, int W,
                          uint8_t* out, cudaStream_t s) {
  if (M2 <= 4) return launch_tall<VEC, 4>(x1, z1, M1, x2, z2, M2, W, out, s);
  if (M2 <= 8) return launch_tall<VEC, 8>(x1, z1, M1, x2, z2, M2, W, out, s);
  return launch_tall<VEC, 16>(x1, z1, M1, x2, z2, M2, W, out, s);
}

// ---- square regime: binary tensor-core product ------------------------------

constexpr int kMmaThreads = 256;  // 8 warps: 4 along M x 2 along N
constexpr int kBM = 128, kBN = 128;
constexpr int kKC = 16;                  // 64-bit words of each plane per stage
constexpr int kRowU32 = 2 * kKC + 4;     // +16 B per row: conflict-free ldmatrix
constexpr size_t kMmaSmem = (size_t)(2 * kBM + 2 * kBN) * kRowU32 * sizeof(uint32_t);

// 8-byte async copy; src_bytes 0 fills the destination with zeros
__device__ __forceinline__ void cp_async8_zfill(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_and_popc(int (&c)[4], const unsigned (&a)[4],
                                             unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kMmaThreads, 2) anticommutes_mma(
    const uint64_t* __restrict__ x1, const uint64_t* __restrict__ z1, int64_t M1,
    const uint64_t* __restrict__ x2, const uint64_t* __restrict__ z2, int64_t M2,
    int64_t W, int64_t n_row_tiles, uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t smem[];
  // plane p of A ([x1 | z1]) and of B ([z2 | x2]): kBM (kBN) rows of kRowU32
  uint32_t* sA = smem;
  uint32_t* sB = smem + 2 * kBM * kRowU32;

  // one flat grid: consecutive blocks share a column tile (op2 rows stay in L2)
  const int64_t tile = blockIdx.x;
  const int64_t i0 = (tile % n_row_tiles) * kBM;
  const int64_t j0 = (tile / n_row_tiles) * kBN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp & 3) * 32, wn = (warp >> 2) * 64;
  const int q = lane >> 3, r8 = lane & 7;  // ldmatrix: matrix q, row r8

  int acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[mi][ni][k] = 0;

  for (int64_t w0 = 0; w0 < W; w0 += kKC) {
    const int wc = (int)((W - w0) < kKC ? (W - w0) : kKC);
    __syncthreads();  // the previous chunk is no longer read
    for (int e = threadIdx.x; e < kBM * kKC; e += kMmaThreads) {
      const int r = e / kKC, w = e % kKC;
      const int64_t gi = i0 + r, gj = j0 + r;
      const bool ina = gi < M1 && w < wc, inb = gj < M2 && w < wc;
      const int64_t oa = ina ? gi * W + w0 + w : 0, ob = inb ? gj * W + w0 + w : 0;
      cp_async8_zfill(&sA[r * kRowU32 + 2 * w], x1 + oa, ina ? 8 : 0);
      cp_async8_zfill(&sA[(kBM + r) * kRowU32 + 2 * w], z1 + oa, ina ? 8 : 0);
      cp_async8_zfill(&sB[r * kRowU32 + 2 * w], z2 + ob, inb ? 8 : 0);
      cp_async8_zfill(&sB[(kBN + r) * kRowU32 + 2 * w], x2 + ob, inb ? 8 : 0);
    }
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();
    const int ksteps = (wc + 3) / 4;  // 256 bits = 4 words = 8 u32 per k-step
    for (int p = 0; p < 2; ++p) {     // x1 . z2, then z1 . x2
      const uint32_t* A = sA + p * kBM * kRowU32;
      const uint32_t* B = sB + p * kBN * kRowU32;
      for (int ks = 0; ks < ksteps; ++ks) {
        const int kw = ks * 8;
        unsigned a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)  // matrices: rows 0-7 / 8-15, words 0-3 / 4-7
          ldmatrix_x4(a[mi], A + (wm + mi * 16 + r8 + (q & 1) * 8) * kRowU32 + kw + (q >> 1) * 4);
#pragma unroll
        for (int np = 0; np < 4; ++np) {  // two n8 tiles per ldmatrix
          unsigned b[4];
          ldmatrix_x4(b, B + (wn + np * 16 + r8 + (q >> 1) * 8) * kRowU32 + kw + (q & 1) * 4);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mma_and_popc(acc[mi][2 * np], a[mi], b[0], b[1]);
            mma_and_popc(acc[mi][2 * np + 1], a[mi], b[2], b[3]);
          }
        }
      }
    }
  }

  // epilogue: parities -> a kBM x kBN byte tile in shared memory -> coalesced rows
  __syncthreads();
  uint8_t* sO = reinterpret_cast<uint8_t*>(smem);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const int row = wm + mi * 16 + g, col = wn + ni * 8 + 2 * t;
      sO[row * kBN + col] = (uint8_t)(acc[mi][ni][0] & 1);
      sO[row * kBN + col + 1] = (uint8_t)(acc[mi][ni][1] & 1);
      sO[(row + 8) * kBN + col] = (uint8_t)(acc[mi][ni][2] & 1);
      sO[(row + 8) * kBN + col + 1] = (uint8_t)(acc[mi][ni][3] & 1);
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kBM * kBN; e += kMmaThreads) {
    const int64_t gi = i0 + e / kBN, gj = j0 + e % kBN;
    if (gi < M1 && gj < M2) out[gi * M2 + gj] = sO[e];
  }
}

cudaError_t launch_mma(const uint64_t* x1, const uint64_t* z1, int64_t M1,
                       const uint64_t* x2, const uint64_t* z2, int64_t M2, int64_t W,
                       uint8_t* out, cudaStream_t stream) {
  const int64_t row_tiles = (M1 + kBM - 1) / kBM;
  const int64_t blocks = row_tiles * ((M2 + kBN - 1) / kBN);
  if (blocks > 0x7FFFFFFF) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      anticommutes_mma, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMmaSmem);
  if (err != cudaSuccess) return err;
  anticommutes_mma<<<(unsigned)blocks, kMmaThreads, kMmaSmem, stream>>>(
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
  // the tall kernel's bulk copies need 16-byte aligned op1 planes
  const bool tall = M2 <= kTallMaxM2 && W <= kTallMaxW &&
                    ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) & 15) == 0;
  if (!tall) return (int)launch_mma(a, b, M1, c, d, M2, W, o, s);
  return (int)(W % 2 == 0 ? dispatch_tall<2>(a, b, M1, c, d, (int)M2, (int)W, o, s)
                          : dispatch_tall<1>(a, b, M1, c, d, (int)M2, (int)W, o, s));
}
