// The scalar Lanczos recurrence's vector work, for Hopper (sm_90a).
//
// Replaces the vector operations of symmer_tpu/kernels/jx_lanczos.py's
// pass-1 step (_tridiag_segment_fn's `step`, :623) and of its pass 2
// (_ritz_segment_fn, :682), which the port ran as ~15 torch launches a
// step.  For complex128 vectors of 2^n rows and float64 scalars on the card
// (plain versions in kernels/torch_lanczos.py, bit for bit):
//   pass 1 (lanczos_step):  w = hv - beta_{j-1} v_prev;  alpha = Re <v_cur, w>;
//            w -= alpha v_cur;  beta = ||w||;  alphas[j] = alpha;
//            betas[j] = beta;  v_next <- w / beta (0 where beta is 0)
//   pass 2, from the basis pass 1 kept (lanczos_ritz):
//            y[e] = sum_{j < k_eff} S[j, e] v_j, added in the order j = 0, 1, ...
//   pass 2 where the basis does not fit (lanczos_replay):  y[e] += S[j, e] v_cur,
//            then pass 1's vector operations from the stored alphas[j],
//            betas[j - 1], betas[j]
// hv is H v_cur from csrc/lanczos_matvec.cu (deflation shift included) and
// pass 1's scratch: the grid route keeps w there between its phases, the
// cluster route leaves it as it was (no caller reads it after the step).
// v_next may be v_prev (the replay route's pair of vectors) or a row of the
// basis, so neither carries __restrict__.
//
// Every product and sum is an explicit round-to-nearest intrinsic (no FMA
// contraction), as the plain versions' separate torch operations round, and
// every sum is the pairwise tree of adjacent pairs in index order
// (torch_lanczos.pairwise_sum; csrc/pairwise_sum.cuh): any aligned
// power-of-two run of rows is a node of that tree, so a kernel may cut the
// rows into such runs and add the runs' sums the same way.  The kernels are
// deterministic, so the stored basis and the replay give pass 1's vectors
// bit for bit, and the card agrees with the CPU device on the same hv.
//
// Pass 1: bytes bound it (hv, v_prev and v_cur read, v_next written: 4 x
// 16 B a row, 2.1 MB at 2^15, under 1 us at 3.35 TB/s), but two sums over
// the whole vector stand between its three elementwise phases, so latency
// sets its pace.  Two routes, by size (symmer_lanczos_step_cluster):
//   - the cluster route, up to kQMax x 256 x the cluster's blocks rows (2^15
//     with 16 blocks): one thread-block cluster of up to 16 blocks owns the
//     whole vector; block b its aligned range of R = dim / C rows; thread t
//     the rows b R + i A + t for its slots i (A the block's active threads,
//     so each warp load is coalesced).  A thread reads its hv, v_prev and
//     v_cur rows once, keeps v_cur and w in registers across the three
//     phases, and writes v_next once.  A sum: the slots' warp
//     shuffles (xor 1 .. 16, all slots a level at a time) and the slot-major
//     warp sums in shared memory (tree nodes of 32 and 256 rows), added by
//     warp 0 in index order; after cluster.sync() every warp reads the
//     cluster's block sums through distributed shared memory
//     (map_shared_rank) and adds them by the same tree.  No atomics, no
//     grid-wide barrier.  A cluster sits in one GPC, whose share of the L2
//     bandwidth then bounds the step: above 2^15 rows the grid
//     route, spread over the card, is faster (tools/step_routes.py on an
//     NVIDIA H100 80GB HBM3 at 700 W: 2^16 rows 0.01540 ms L2-cold in one
//     cluster against 0.01450 on the grid route; 2^15 0.01177 against
//     0.01219), and w is not written back to hv (at 2^15 that write cost
//     0.00085 ms, 7%).
//   - the grid route above that: one cooperative launch over 512-row chunks
//     (grid-stride, the grid at most what the card holds at once), a thread
//     two adjacent rows in all three phases, w kept in hv between them; each
//     chunk's sum is written to its slot and, after a grid-wide barrier,
//     every block adds the chunk sums itself in the same tree order.
// Pass 2 from the basis: bytes bound it (k_eff x dim x 16 B read, m x dim x
// 16 B written).  A thread owns a row and walks j with kRitzUnroll loads in
// flight, S's rows staged in shared memory, the m accumulators in
// registers; one launch.  The replay needs no sum: a thread per row.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "pairwise_sum.cuh"

namespace cg = cooperative_groups;

namespace {

using symmer_pairwise::block_pairwise;
using symmer_pairwise::kThreads;
using symmer_pairwise::kWarps;
using symmer_pairwise::total_pairwise;

constexpr int64_t kChunk = 2 * kThreads;  // rows a block of the grid route takes at a time
constexpr int kQMax = 8;                  // slots (rows) a thread of the cluster route holds
constexpr unsigned kFull = 0xffffffffu;

// -- the cluster route ---------------------------------------------------------

// each v[i] added with the lanes xor 1 .. width / 2 (width a power of two
// up to 32), the Q sums a level apart: lane 0 of each group of `width` lanes
// holds their pairwise sums
template <int Q>
__device__ __forceinline__ void lanes_pairwise(double (&v)[Q], int width) {
  if (width == 32) {
#pragma unroll
    for (int m = 1; m < 32; m <<= 1)
#pragma unroll
      for (int i = 0; i < Q; ++i) v[i] = __dadd_rn(v[i], __shfl_xor_sync(kFull, v[i], m));
  } else {
    for (int m = 1; m < width; m <<= 1)
#pragma unroll
      for (int i = 0; i < Q; ++i) v[i] = __dadd_rn(v[i], __shfl_xor_sync(kFull, v[i], m));
  }
}

// The pairwise sum over the cluster's rows, in every thread, of each
// thread's slot values v (its rows' terms): each slot's warp shuffles, the
// block's Q x nw warp sums slot-major in ws (slot i, warp w at i nw + w:
// nodes of adjacent rows in that order), added by warp 0 (a run of K
// adjacent ones a lane, then the lanes) into `slot`, which the cluster's
// blocks read through distributed shared memory after a cluster-wide
// barrier and add by the same tree.  ws is free again on return.
template <int Q>
__device__ __forceinline__ double cluster_pairwise(double (&v)[Q], int A, double* ws,
                                                   double* slot, cg::cluster_group cluster) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = A > 32 ? A >> 5 : 1;
  lanes_pairwise<Q>(v, A < 32 ? A : 32);
  if (lane == 0 && warp < nw) {
#pragma unroll
    for (int i = 0; i < Q; ++i) ws[i * nw + warp] = v[i];
  }
  __syncthreads();
  if (warp == 0) {
    constexpr int K = Q >= 8 ? Q / 4 : 1;  // Q >= 2 means nw = kWarps
    const int P = Q * nw;
    const int L = P < 32 ? P : 32;
    double a[K];
#pragma unroll
    for (int i = 0; i < K; ++i) a[i] = lane < L ? ws[lane * K + i] : 0.0;
#pragma unroll
    for (int h = 1; h < K; h <<= 1)
#pragma unroll
      for (int i = 0; i < K; i += 2 * h) a[i] = __dadd_rn(a[i], a[i + h]);
    double s[1] = {a[0]};
    lanes_pairwise<1>(s, L);
    if (lane == 0) *slot = s[0];
  }
  cluster.sync();
  const int C = (int)cluster.num_blocks();
  double s[1] = {lane < C ? *cluster.map_shared_rank(slot, (unsigned)lane) : 0.0};
  lanes_pairwise<1>(s, C);
  return __shfl_sync(kFull, s[0], 0);
}

// One pass-1 step in one cluster of C blocks (the grid): a block's rows are
// base + i A + t for slots i < Q and its A = min(dim / C, 256) active
// threads t; Q = dim / (C A).  A thread keeps its rows' v_cur and w in
// registers through the three phases.
template <int Q>
__global__ void __launch_bounds__(kThreads, 1)
    lanczos_step_cluster(const double2* __restrict__ hv, const double2* v_prev,
                         const double2* __restrict__ v_cur,
                         double2* v_next, double* alphas, double* betas, int64_t j, int64_t dim) {
  __shared__ double ws[Q * kWarps];
  __shared__ double sums[2];  // this block's sums: alpha's, beta's
  cg::cluster_group cluster = cg::this_cluster();
  const int64_t R = dim / (int64_t)cluster.num_blocks();
  const int A = R < kThreads ? (int)R : kThreads;
  const int t = threadIdx.x;
  const bool on = t < A;
  const int64_t base = (int64_t)cluster.block_rank() * R + t;
  const double bp = j > 0 ? betas[j - 1] : 0.0;

  // phase a: w = hv - bp v_prev; the slots' Re(conj(v_cur) w); every load
  // is issued before the first use
  double2 w[Q], p[Q], c[Q];
  double v[Q];
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    w[i] = p[i] = c[i] = make_double2(0.0, 0.0);
    if (on) {
      const int64_t r = base + (int64_t)i * A;
      w[i] = __ldg(hv + r);
      p[i] = v_prev[r];
      c[i] = __ldg(v_cur + r);
    }
  }
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    w[i] = make_double2(__dsub_rn(w[i].x, __dmul_rn(p[i].x, bp)),
                        __dsub_rn(w[i].y, __dmul_rn(p[i].y, bp)));
    v[i] = __dadd_rn(__dmul_rn(c[i].x, w[i].x), __dmul_rn(c[i].y, w[i].y));
  }
  const double alpha = cluster_pairwise<Q>(v, A, ws, &sums[0], cluster);

  // phase b: w -= alpha v_cur; the slots' |w|^2
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    w[i] = make_double2(__dsub_rn(w[i].x, __dmul_rn(c[i].x, alpha)),
                        __dsub_rn(w[i].y, __dmul_rn(c[i].y, alpha)));
    v[i] = __dadd_rn(__dmul_rn(w[i].x, w[i].x), __dmul_rn(w[i].y, w[i].y));
  }
  const double beta = __dsqrt_rn(cluster_pairwise<Q>(v, A, ws, &sums[1], cluster));
  const double inv = beta > 0.0 ? __drcp_rn(beta) : 0.0;
  // the other blocks may still read sums[1]: this block leaves only after
  // they have all arrived here
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");

  // phase c: v_next <- w / beta
  if (on) {
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      const int64_t r = base + (int64_t)i * A;
      v_next[r] = make_double2(__dmul_rn(w[i].x, inv), __dmul_rn(w[i].y, inv));
    }
  }
  if (cluster.block_rank() == 0 && t == 0) {
    alphas[j] = alpha;
    betas[j] = beta;
  }
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// the launch configuration of one cluster of C blocks (used in place: cfg
// points at attr)
struct ClusterLaunch {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  ClusterLaunch(int C, cudaStream_t stream) : attr{}, cfg{} {
    cfg.gridDim = dim3((unsigned)C);
    cfg.blockDim = dim3(kThreads);
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

template <int Q>
cudaError_t launch_cluster(int C, const double2* hv, const double2* v_prev, const double2* v_cur,
                           double2* v_next, double* alphas, double* betas, int64_t j,
                           int64_t dim, cudaStream_t stream) {
  ClusterLaunch launch(C, stream);
  return cudaLaunchKernelEx(&launch.cfg, lanczos_step_cluster<Q>, hv, v_prev, v_cur, v_next,
                            alphas, betas, j, dim);
}

template <int Q>
cudaError_t allow_cluster() {
  return cudaFuncSetAttribute(lanczos_step_cluster<Q>,
                              cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// blocks of the pass-1 cluster (16, or 8 where the card admits no cluster
// of 16 of the widest instance); 0 until found
int g_cluster = 0;

cudaError_t find_cluster() {
  if (g_cluster) return cudaSuccess;
  cudaError_t err = allow_cluster<1>();
  if (err == cudaSuccess) err = allow_cluster<2>();
  if (err == cudaSuccess) err = allow_cluster<4>();
  if (err == cudaSuccess) err = allow_cluster<kQMax>();
  if (err != cudaSuccess) return err;
  const int sizes[] = {16, 8};
  for (int C : sizes) {
    ClusterLaunch launch(C, nullptr);
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, (const void*)lanczos_step_cluster<kQMax>,
                                         &launch.cfg);
    if (err == cudaSuccess && n >= 1) {
      g_cluster = C;
      return cudaSuccess;
    }
    (void)cudaGetLastError();  // a refused size: try the next
  }
  return err == cudaSuccess ? cudaErrorInvalidClusterSize : err;
}

// -- the grid route ------------------------------------------------------------

// w = hv - bp v_prev at row r (stored in hv); returns Re(conj(v_cur) w) there
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
    lanczos_step_kernel(double2* w, const double2* v_prev, const double2* __restrict__ v_cur,
                        double2* v_next, double* alphas, double* betas, int64_t j, double* part,
                        int64_t dim) {
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
      v_next[r] = make_double2(__dmul_rn(h.x, inv), __dmul_rn(h.y, inv));
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    alphas[j] = alpha;
    betas[j] = beta;
  }
}

int g_grid_cap = 0;  // blocks of lanczos_step_kernel the card holds at once

// -- pass 2 --------------------------------------------------------------------

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

constexpr int kRitzThreads = 128;  // rows of a block of lanczos_ritz
constexpr int kRitzUnroll = 16;    // basis rows a thread has in flight
constexpr int kRitzTile = 256;     // rows of S a block stages at a time

// y[e0 + e, r] = sum_{j < k_eff} S[j, e0 + e] basis[j, r] for e < MB (and
// e0 + e < m), e0 = blockIdx.y MB; added in the order j = 0, 1, ... from
// +0.0, each product and sum rounded on its own
template <int MB>
__global__ void __launch_bounds__(kRitzThreads)
    lanczos_ritz_kernel(const double2* __restrict__ basis, const double* __restrict__ S,
                        double2* __restrict__ y, int64_t k_eff, int64_t m, int64_t dim) {
  __shared__ double s_tile[kRitzTile * MB];
  const int64_t e0 = (int64_t)blockIdx.y * MB;
  const int64_t r = (int64_t)blockIdx.x * kRitzThreads + threadIdx.x;
  double2 acc[MB];
#pragma unroll
  for (int e = 0; e < MB; ++e) acc[e] = make_double2(0.0, 0.0);
  for (int64_t j0 = 0; j0 < k_eff; j0 += kRitzTile) {
    const int jn = (int)(k_eff - j0 < kRitzTile ? k_eff - j0 : kRitzTile);
    __syncthreads();  // the last tile's reads are done
    for (int idx = threadIdx.x; idx < jn * MB; idx += kRitzThreads) {
      const int64_t e = e0 + idx % MB;
      s_tile[idx] = e < m ? S[(j0 + idx / MB) * m + e] : 0.0;
    }
    __syncthreads();
    if (r >= dim) continue;
    const double2* col = basis + j0 * dim + r;
    int jj = 0;
    for (; jj + kRitzUnroll <= jn; jj += kRitzUnroll) {
      double2 v[kRitzUnroll];
#pragma unroll
      for (int u = 0; u < kRitzUnroll; ++u) v[u] = __ldcs(col + (int64_t)(jj + u) * dim);
#pragma unroll
      for (int u = 0; u < kRitzUnroll; ++u)
#pragma unroll
        for (int e = 0; e < MB; ++e) {
          const double s = s_tile[(jj + u) * MB + e];
          acc[e] = make_double2(__dadd_rn(acc[e].x, __dmul_rn(v[u].x, s)),
                                __dadd_rn(acc[e].y, __dmul_rn(v[u].y, s)));
        }
    }
    for (; jj < jn; ++jj) {
      const double2 v = __ldcs(col + (int64_t)jj * dim);
#pragma unroll
      for (int e = 0; e < MB; ++e) {
        const double s = s_tile[jj * MB + e];
        acc[e] = make_double2(__dadd_rn(acc[e].x, __dmul_rn(v.x, s)),
                              __dadd_rn(acc[e].y, __dmul_rn(v.y, s)));
      }
    }
  }
  if (r < dim) {
#pragma unroll
    for (int e = 0; e < MB; ++e)
      if (e0 + e < m) y[(e0 + e) * dim + r] = acc[e];
  }
}

template <int MB>
void launch_ritz(const double2* basis, const double* S, double2* y, int64_t k_eff, int64_t m,
                 int64_t dim, cudaStream_t stream) {
  const dim3 grid((unsigned)((dim + kRitzThreads - 1) / kRitzThreads),
                  (unsigned)((m + MB - 1) / MB));
  lanczos_ritz_kernel<MB><<<grid, kRitzThreads, 0, stream>>>(basis, S, y, k_eff, m, dim);
}

}  // namespace

// The pass-1 cluster: *blocks (16 or 8, found once) and *rows, the most
// rows its route takes.  Returns a cudaError_t.
extern "C" int symmer_lanczos_step_cluster(int64_t* blocks, int64_t* rows) {
  const cudaError_t err = find_cluster();
  if (err != cudaSuccess) return (int)err;
  *blocks = g_cluster;
  *rows = (int64_t)g_cluster * kThreads * kQMax;
  return (int)cudaSuccess;
}

// Pass 1's step (see above).  cluster: 1 for the cluster route (dim at most
// symmer_lanczos_step_cluster's rows), 0 for the grid route, whose part is
// 2 x max(1, dim / 512) float64 of scratch; blocks: the cluster's blocks (a
// power of two up to the card's; 0 for the card's), for measurements.
// v_next may be v_prev.  Returns a cudaError_t.
extern "C" int symmer_lanczos_step(void* hv, const void* v_prev, const void* v_cur,
                                   void* v_next, void* alphas, void* betas, int64_t j,
                                   void* part, int64_t dim, int cluster, int blocks,
                                   void* stream) {
  if (dim < 1 || (dim & (dim - 1)) || j < 0) return (int)cudaErrorInvalidValue;
  auto wp = static_cast<double2*>(hv);
  auto pp = static_cast<const double2*>(v_prev);
  auto cp = static_cast<const double2*>(v_cur);
  auto np = static_cast<double2*>(v_next);
  auto ap = static_cast<double*>(alphas);
  auto bp = static_cast<double*>(betas);
  auto st = static_cast<cudaStream_t>(stream);
  if (cluster) {
    const cudaError_t err = find_cluster();
    if (err != cudaSuccess) return (int)err;
    if (blocks == 0) blocks = g_cluster;
    if (blocks < 1 || blocks > g_cluster || (blocks & (blocks - 1)))
      return (int)cudaErrorInvalidValue;
    const int64_t fill = dim / kThreads > 1 ? dim / kThreads : 1;  // blocks of 256 rows
    const int C = (int)(fill < blocks ? fill : blocks);
    const int64_t R = dim / C;
    const int64_t Q = R > kThreads ? R / kThreads : 1;
    switch (Q) {
      case 1: return (int)launch_cluster<1>(C, wp, pp, cp, np, ap, bp, j, dim, st);
      case 2: return (int)launch_cluster<2>(C, wp, pp, cp, np, ap, bp, j, dim, st);
      case 4: return (int)launch_cluster<4>(C, wp, pp, cp, np, ap, bp, j, dim, st);
      case 8: return (int)launch_cluster<8>(C, wp, pp, cp, np, ap, bp, j, dim, st);
      default: return (int)cudaErrorInvalidValue;  // more rows than the cluster holds
    }
  }
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
  auto partp = static_cast<double*>(part);
  void* args[] = {&wp, &pp, &cp, &np, &ap, &bp, &j, &partp, &dim};
  return (int)cudaLaunchCooperativeKernel((const void*)lanczos_step_kernel, dim3(grid),
                                          dim3(kThreads), args, 0, st);
}

// Pass 2's replay step; S: float64[k, m] (row j used), y: complex128[m, dim].
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

// Pass 2 from the basis: y[e] = sum_{j < k_eff} S[j, e] basis[j] for the
// complex128[>= k_eff, dim] basis, S float64[>= k_eff, m] and y
// complex128[m, dim].  One launch.  Returns a cudaError_t.
extern "C" int symmer_lanczos_ritz(const void* basis, const void* S, void* y, int64_t k_eff,
                                   int64_t m, int64_t dim, void* stream) {
  if (dim < 1 || (dim & (dim - 1)) || k_eff < 1 || m < 1) return (int)cudaErrorInvalidValue;
  auto b = static_cast<const double2*>(basis);
  auto s = static_cast<const double*>(S);
  auto yp = static_cast<double2*>(y);
  auto st = static_cast<cudaStream_t>(stream);
  if (m == 1)
    launch_ritz<1>(b, s, yp, k_eff, m, dim, st);
  else if (m == 2)
    launch_ritz<2>(b, s, yp, k_eff, m, dim, st);
  else if (m <= 4)
    launch_ritz<4>(b, s, yp, k_eff, m, dim, st);
  else
    launch_ritz<8>(b, s, yp, k_eff, m, dim, st);
  return (int)cudaGetLastError();
}
