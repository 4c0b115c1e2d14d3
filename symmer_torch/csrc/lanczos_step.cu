// One step of the scalar Lanczos recurrence, for Hopper (sm_90a).
//
// Replaces the vector operations of symmer_tpu/kernels/jx_lanczos.py's
// pass-1 step (_tridiag_segment_fn's `step`, :623) and of its replay
// (_ritz_segment_fn's `step`, :682), which the port ran as ~15 torch
// launches a step.  For complex128 vectors of 2^n rows and float64 scalars
// on the card (plain versions: kernels/torch_lanczos.py:lanczos_step and
// lanczos_replay, bit for bit):
//   pass 1:  w = hv - beta_{j-1} v_prev;  alpha = Re <v_cur, w>;
//            w -= alpha v_cur;  beta = ||w||;  alphas[j] = alpha;
//            betas[j] = beta;  v_prev <- w / beta (0 where beta is 0)
//   pass 2:  y[e] += S[j, e] v_cur;  the same vector operations from the
//            stored alphas[j], betas[j - 1], betas[j]
// hv (H v_cur from csrc/lanczos_matvec.cu, deflation shift included) holds
// w after pass 1's step (its scratch between phases; no caller reads it)
// and is only read by pass 2's; v_prev's memory receives v_{j+1}.
//
// What bounds it: bytes.  Pass 1 must read hv, v_prev and v_cur and write
// v_next once each (4 x 16 B a row: 2.1 MB at 2^15, under 1 us at 3.35
// TB/s, and the vectors sit in the 50 MB L2); pass 2 also reads and writes
// the m Ritz vectors.  In practice a step is bound by latency: two sums
// over the whole vector stand between pass 1's three elementwise passes.
//
// The design: one cooperative launch per pass-1 step.  A block of 256
// threads takes 512-row chunks (grid-stride, the grid at most what the card
// holds at once); a thread takes two adjacent rows, the same ones in all
// three phases.  Each sum is the pairwise tree of adjacent pairs in index
// order (torch_lanczos.pairwise_sum): a thread adds its two rows, warp
// shuffles (xor 1 .. 16) and the 8 warp sums in shared memory make the
// chunk's sum, written to its slot; after a grid-wide barrier every block
// adds the chunk sums itself in the same tree order, so every block holds
// the same alpha (and beta) bit for bit.  No atomics.  Every product and
// sum is an explicit round-to-nearest intrinsic (no FMA contraction), as the
// plain version's separate torch operations round, so pass 2 replays pass 1
// and the card agrees with the CPU device bit for bit on the same hv.
// Pass 2 needs no sum: one ordinary launch, a thread per row.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int64_t kChunk = 2 * kThreads;  // rows a block takes at a time

// the pairwise sum of p[0 .. K), K a power of two, streamed with a stack of
// partial sums (one per tree level)
__device__ double seq_pairwise(const double* p, int64_t K) {
  double stack[40];
  for (int64_t i = 0; i < K; ++i) {
    double v = p[i];
    int lvl = 0;
    while ((i >> lvl) & 1) {
      v = __dadd_rn(stack[lvl], v);
      ++lvl;
    }
    stack[lvl] = v;
  }
  int top = 0;
  while ((int64_t(1) << top) < K) ++top;
  return stack[top];
}

// every thread receives the pairwise sum of the values of threads
// 0 .. active - 1 (active a power of two up to kThreads)
__device__ double block_pairwise(double v, int active, double* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int width = active < 32 ? active : 32;
  for (int m = 1; m < width; m <<= 1) v = __dadd_rn(v, __shfl_xor_sync(0xffffffffu, v, m));
  const int nw = active > 32 ? active >> 5 : 1;
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  double s[kWarps];
  for (int i = 0; i < nw; ++i) s[i] = sh[i];
  for (int h = 1; h < nw; h <<= 1)
    for (int i = 0; i < nw; i += 2 * h) s[i] = __dadd_rn(s[i], s[i + h]);
  const double r = s[0];
  __syncthreads();  // sh is free again
  return r;
}

// the pairwise sum of the P chunk sums (P a power of two), in every block
__device__ double total_pairwise(const double* part, int64_t P, double* sh) {
  double v = 0.0;
  int active;
  if (P > kThreads) {
    const int64_t K = P / kThreads;
    v = seq_pairwise(part + threadIdx.x * K, K);
    active = kThreads;
  } else {
    active = (int)P;
    if (threadIdx.x < P) v = part[threadIdx.x];
  }
  return block_pairwise(v, active, sh);
}

// w = hv - bp v_prev at row r (stored); returns Re(conj(v_cur) w) there
__device__ __forceinline__ double phase_a(double2* w, const double2* v_prev,
                                          const double2* __restrict__ v_cur, double bp,
                                          int64_t r) {
  const double2 h = w[r], p = v_prev[r], c = v_cur[r];
  const double wx = __dsub_rn(h.x, __dmul_rn(p.x, bp));
  const double wy = __dsub_rn(h.y, __dmul_rn(p.y, bp));
  w[r] = make_double2(wx, wy);
  return __dadd_rn(__dmul_rn(c.x, wx), __dmul_rn(c.y, wy));
}

// w -= alpha v_cur at row r (stored); returns |w|^2 there
__device__ __forceinline__ double phase_b(double2* w, const double2* __restrict__ v_cur,
                                          double alpha, int64_t r) {
  const double2 h = w[r], c = v_cur[r];
  const double wx = __dsub_rn(h.x, __dmul_rn(c.x, alpha));
  const double wy = __dsub_rn(h.y, __dmul_rn(c.y, alpha));
  w[r] = make_double2(wx, wy);
  return __dadd_rn(__dmul_rn(wx, wx), __dmul_rn(wy, wy));
}

__global__ void __launch_bounds__(kThreads)
    lanczos_step_kernel(double2* w, double2* v_prev, const double2* __restrict__ v_cur,
                        double* alphas, double* betas, int64_t j, double* part, int64_t dim) {
  __shared__ double sh[kWarps];
  cg::grid_group grid = cg::this_grid();
  const int64_t n_chunks = dim > kChunk ? dim / kChunk : 1;
  const int active = dim >= kChunk ? kThreads : (int)((dim + 1) >> 1);
  const double bp = j > 0 ? betas[j - 1] : 0.0;
  double* pa = part;
  double* pb = part + n_chunks;

  for (int64_t c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const int64_t r = c * kChunk + 2 * threadIdx.x;
    double v = 0.0;
    if (r < dim) {
      v = phase_a(w, v_prev, v_cur, bp, r);
      if (r + 1 < dim) v = __dadd_rn(v, phase_a(w, v_prev, v_cur, bp, r + 1));
    }
    v = block_pairwise(v, active, sh);
    if (threadIdx.x == 0) pa[c] = v;
  }
  grid.sync();
  const double alpha = total_pairwise(pa, n_chunks, sh);

  for (int64_t c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const int64_t r = c * kChunk + 2 * threadIdx.x;
    double v = 0.0;
    if (r < dim) {
      v = phase_b(w, v_cur, alpha, r);
      if (r + 1 < dim) v = __dadd_rn(v, phase_b(w, v_cur, alpha, r + 1));
    }
    v = block_pairwise(v, active, sh);
    if (threadIdx.x == 0) pb[c] = v;
  }
  grid.sync();
  const double beta = __dsqrt_rn(total_pairwise(pb, n_chunks, sh));
  const double inv = beta > 0.0 ? __drcp_rn(beta) : 0.0;

  for (int64_t c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const int64_t r0 = c * kChunk + 2 * threadIdx.x;
    for (int64_t r = r0; r < r0 + 2 && r < dim; ++r) {
      const double2 h = w[r];
      v_prev[r] = make_double2(__dmul_rn(h.x, inv), __dmul_rn(h.y, inv));
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    alphas[j] = alpha;
    betas[j] = beta;
  }
}

__global__ void __launch_bounds__(kThreads)
    lanczos_replay_kernel(const double2* __restrict__ hv, double2* __restrict__ v_prev,
                          const double2* __restrict__ v_cur, const double* __restrict__ alphas,
                          const double* __restrict__ betas, int64_t j,
                          const double* __restrict__ S, double2* __restrict__ y, int64_t m,
                          int64_t dim) {
  const double bp = j > 0 ? betas[j - 1] : 0.0;
  const double alpha = alphas[j], beta = betas[j];
  const double inv = beta > 0.0 ? __drcp_rn(beta) : 0.0;
  const int64_t step = (int64_t)gridDim.x * kThreads;
  for (int64_t r = (int64_t)blockIdx.x * kThreads + threadIdx.x; r < dim; r += step) {
    const double2 c = v_cur[r];
    for (int64_t e = 0; e < m; ++e) {
      const double s = S[j * m + e];
      const double2 ye = y[e * dim + r];
      y[e * dim + r] = make_double2(__dadd_rn(ye.x, __dmul_rn(c.x, s)),
                                    __dadd_rn(ye.y, __dmul_rn(c.y, s)));
    }
    const double2 h = hv[r], p = v_prev[r];
    double wx = __dsub_rn(h.x, __dmul_rn(p.x, bp));
    double wy = __dsub_rn(h.y, __dmul_rn(p.y, bp));
    wx = __dsub_rn(wx, __dmul_rn(c.x, alpha));
    wy = __dsub_rn(wy, __dmul_rn(c.y, alpha));
    v_prev[r] = make_double2(__dmul_rn(wx, inv), __dmul_rn(wy, inv));
  }
}

int g_grid_cap = 0;  // blocks of lanczos_step_kernel the card holds at once

}  // namespace

// Pass 1's step (see above); part: 2 x max(1, dim / 512) float64 of
// scratch.  Returns a cudaError_t.
extern "C" int symmer_lanczos_step(void* w, void* v_prev, const void* v_cur, void* alphas,
                                   void* betas, int64_t j, void* part, int64_t dim,
                                   void* stream) {
  if (dim < 1 || (dim & (dim - 1)) || j < 0) return (int)cudaErrorInvalidValue;
  if (g_grid_cap == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lanczos_step_kernel,
                                                          kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    if (sms * per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    g_grid_cap = sms * per_sm;
  }
  const int64_t n_chunks = dim > kChunk ? dim / kChunk : 1;
  const unsigned grid = (unsigned)(n_chunks < g_grid_cap ? n_chunks : g_grid_cap);
  auto wp = static_cast<double2*>(w);
  auto pp = static_cast<double2*>(v_prev);
  auto cp = static_cast<const double2*>(v_cur);
  auto ap = static_cast<double*>(alphas);
  auto bp = static_cast<double*>(betas);
  auto partp = static_cast<double*>(part);
  void* args[] = {&wp, &pp, &cp, &ap, &bp, &j, &partp, &dim};
  return (int)cudaLaunchCooperativeKernel((const void*)lanczos_step_kernel, dim3(grid),
                                          dim3(kThreads), args, 0,
                                          static_cast<cudaStream_t>(stream));
}

// Pass 2's step; S: float64[k, m] (row j used), y: complex128[m, dim].
// Returns a cudaError_t.
extern "C" int symmer_lanczos_replay(const void* hv, void* v_prev, const void* v_cur,
                                     const void* alphas, const void* betas, int64_t j,
                                     const void* S, void* y, int64_t m, int64_t dim,
                                     void* stream) {
  if (dim < 1 || (dim & (dim - 1)) || j < 0 || m < 0) return (int)cudaErrorInvalidValue;
  const int64_t want = (dim + kThreads - 1) / kThreads;
  const unsigned blocks = (unsigned)(want < 4096 ? want : 4096);
  lanczos_replay_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double2*>(hv), static_cast<double2*>(v_prev),
      static_cast<const double2*>(v_cur), static_cast<const double*>(alphas),
      static_cast<const double*>(betas), j, static_cast<const double*>(S),
      static_cast<double2*>(y), m, dim);
  return (int)cudaGetLastError();
}
