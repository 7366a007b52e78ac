// Quaternion whitening batch norm ('q-batch-norm'): training forward and
// backward, and the eval transform (sm_90a).
//
// Replaces the four Pallas kernels of phc_gnn_tpu/ops/fused_whitening.py:
//   wbn_stats_f32     <- _wbn_stats_kernel      (:184, pallas_call :347)  J
//   wbn_transform_f32 <- _wbn_transform_kernel  (:236, pallas_call :364)  K
//   wbn_bwd_sums_f32  <- _wbn_bwd_sums_kernel   (:253, pallas_call :388)  L
//                        together with the T/S/M field algebra that JAX runs
//                        in XLA between L and M (:408-412, _m_from_lbar
//                        :110-130), here in L's epilogue
//   wbn_dx_f32        <- _wbn_dx_kernel         (:304, pallas_call :413)  M
// and, for the eval path (phc_gnn_tpu/nn/norm.py:301-345, inline XLA there),
//   wbn_transform_eval_f32
//                        K with the Cholesky factor of the running
//                        covariance + eps I (J's device function) in its
//                        prologue, one launch; it writes the factor too;
//   wbn_bwd_sums_frozen_f32, wbn_dx_frozen_f32
//                        the eval path's backward: L's and M's kernels with
//                        the statistics fixed (kFrozen), below.
//
// Layout: x [N, 4d] f32, component-major: x[n, k*d + f] is component k of
// feature f.  mean [4, d]; cov [4, 4, d] (symmetric); the Cholesky factor
// L [10, d] in JAX's _L_IDX order (0,0) (1,0) (1,1) (2,0) (2,1) (2,2) (3,0)
// (3,1) (3,2) (3,3); Gamma [4, 4, d]; beta [4, d]; M [16, d], row a*4+b.
//
// Math (fused_whitening.py:13-34), per feature, with the row mask m:
//   cnt = max(sum m, 1),  mu = sum m x / cnt,  Sigma = sum m u u^T / cnt
//   L = chol(Sigma + eps I)    closed form (fused_whitening.py:61-78)
//   u = x - mu,  z = L^{-1} u,  y = Gamma z + beta         on EVERY row
// backward, with the cotangent g, every sum over ALL rows:
//   dbeta_c = sum g_c,  dGamma_ck = sum g_c z_k,  h = Gamma^T g,  w = L^{-T} h
//   Lbar = -tril(sum w z^T),  sum_w = sum w
//   T = L^T Lbar,  S = tril_s(T) + tril_s(T)^T + diag(T),  M = L^{-T} S L^{-1}
//   dx = w + (m / cnt) (M u - sum w)     only the mean-path term is masked
// The substitutions multiply by the reciprocal diagonal, as JAX's do.  With
// the running statistics fixed (the eval path, whose mean and L are buffers)
// mu and L carry no gradient: dx = w on every row, and dbeta, dGamma are the
// same sums.  The frozen variants of L and M compute just that: L skips w
// and its 14 sums and the T/S/M algebra, and M skips the mean-path term.
// Reaching this through the training variants with an all-false mask would
// give cnt = 0, and the mean-path term (m / cnt) (M u - sum w) would read
// 0 * inf = NaN.
//
// Design of J and L: one launch each, a grid of thread-block clusters (as
// the batch norms D and E of fused_bn.cu).  The TPU kernels walk a
// SEQUENTIAL grid of 1,024-row blocks with a VMEM carry; here the row
// blocks are a cluster's CTAs, which run at once and meet through
// distributed shared memory: no workspace, no second kernel, no float
// atomics.  The launch plan (features a slab, cluster, rows per CTA, shared
// memory) is computed in Python (ops/fused_whitening.py::wbn_plan) and
// checked here.
//   A cluster owns a slab of F = kSlab = 8 features with all four component
//   columns of each (k*d + f, k = 0..3); its CTA of rank r owns the rows
//   [r * rows, min(N, (r + 1) * rows)).  A thread owns one feature (t % F)
//   and walks rows t / F, + 256 / F, ..., so a warp reads 32 / F rows of F
//   consecutive floats a component.  All four components of a feature sit
//   in one thread, so its loads are 4 bytes wide; its rows are unrolled (8
//   in flight) so that a CTA has all its loads in flight at once.  Neither
//   kernel rereads a row, so nothing is staged in shared memory.
//   What bounds the sweep is the 32-byte sectors it pulls: a slab's 32-byte
//   run of a component straddles two sectors for k*d*4 not a multiple of
//   32, and the neighbouring slab pulls the other half: at d = 50 a slab
//   of 4 features pulls 2.5x its bytes in sectors, of 8 1.75x, and wider
//   slabs leave too few SMs (slabs of 4 took 1.3-1.7x as long).  So the
//   plan takes slabs of 8 and clusters of 16 CTAs (a non-portable size,
//   allowed per kernel), or 8, 4, 2, 1: the largest whose clusters an H100
//   holds all at once, one CTA an SM: at [4096, 200] 7 slabs x 16 = 112
//   CTAs of 256 rows.
//   J, one sweep: per thread Welford's count, 4 means and 10 co-moments of
//   x - s about the thread's shift s (x at its first live row, 0 without
//   one).  Merged with Chan's formula (the Pallas kernel's combine,
//   fused_whitening.py:204-216), b's mean taken about a's shift, delta =
//   ((s_b - s_a) + m_b) - m_a, in fixed shuffle trees: the lanes of a
//   feature, then the warps, then -- after the exchange -- the ranks, one
//   lane each; then mean = s + m, cov = M2 * (1 / cnt) and the closed-form
//   Cholesky (cholesky, the eval Cholesky's too).  The shifts are data of
//   the column, so every partial stays at the size of the deviations where
//   a column sits far from 0 (a column at 1e3 with std 0.1 lost 6e-5 of its
//   covariance to unshifted block means); a partial with no live row is an
//   exact no-op in every merge, and a single live row gets its own value as
//   the mean exactly.
//   L, one sweep of the 20 sums that are linear in the rows: sum g and G =
//   sum g u^T (u = x - mu), over all rows, a shuffle tree and the warps'
//   sums in order.  Since z = L^{-1} u and w = L^{-T} Gamma^T g,
//     dGamma = G L^{-T},  sum w z^T = L^{-T} Gamma^T dGamma,
//     sum w = L^{-T} Gamma^T sum g,
//   which the epilogue solves once a feature: 24 operations a row and
//   feature in place of the ~130 of a per-row z and w.  The frozen variant
//   takes the same sweep and stops at dGamma.
//   Feature i of a slab belongs to rank i % cluster: each CTA writes its
//   partials of feature i into that rank's shared memory, in its own slot
//   (cluster.map_shared_rank), then one cluster barrier, and the owner
//   writes the feature's outputs: J from its rank tree; L sums the ranks in
//   rank order, then four lanes a feature solve (lane j: row j of dGamma,
//   column j of sum w z^T, then L^T v_j = S e_j and row j of M = L^{-T} S
//   L^{-1}, the lanes trading columns by shuffles).  Two launches on one
//   input give bit-equal outputs.
//   M: elementwise over tiles of 32 features (one per lane) by 64 rows.
//
// Design of K, both routes: elementwise, bound by its bytes, but at the
// quaternion path's [4096, 200] it moves 6.6 MB, so a launch's fixed cost
// and one latency chain weigh as much.  A tile of 32 features by 64 rows,
// each thread walking its 8 rows one load-compute-store at a time, would
// leave 22 % of the lanes idle at d = 50 and run a chain of 8 latencies;
// a Cholesky launch of its own in front of the eval route would add a
// launch for 50 4x4 factors.  Here the threads map onto (row, feature)
// pairs: consecutive lanes take consecutive features of a row, then the
// next row, so at most kThreads % d lanes idle.  A thread's feature is
// fixed: it loads Gamma, the mean and beta once, and its kTransformRows
// rows are unrolled with all their loads in flight before the first use.
// The factor of each feature of the CTA is computed once, by one thread,
// into shared memory (L's six entries below the diagonal and its four
// reciprocal diagonals): loaded from L, or, in the eval route, factored
// from the running covariance (cholesky, as J does), whose loads go out
// before the rows' so that the chain runs while they are in flight; the
// eval route's first row block writes L for the frozen backward.  A CTA's
// rows are shortened so that the CTAs come to about whole waves of the
// card's SMs (launch_transform).  Tried on an H100
// and dropped, each slower than the 32-feature tile there: every field
// read from shared memory per (row, feature) pair (34 reads a pair); a
// tile of whole rows staged with 16-byte cp.async and whitened in place
// (its load, compute and store phases run in series); a warp per row with
// two features a lane in 8-byte vectors (128 registers).  Every element's
// arithmetic is the same in the same order (1 / diag, fwd_subst, Gamma z
// from its first term, then + beta), so the eval route's y is K's fed the
// factor it writes, bit for bit.
//
// Bound on an H100: bytes.  At [4096, 200] f32 (3.28 MB): J reads x and the
// mask (3.28 MB, 0.98 us at 3.35 TB/s); K reads x and writes y (6.56 MB,
// 1.96 us); L reads x and g (6.56 MB, 1.96 us); M reads x, g and the mask and
// writes dx (9.83 MB, 2.94 us); frozen, L reads the same and M reads g and
// writes dx (6.56 MB, 1.96 us).  Their arithmetic (about 30, 60, 40 and 90
// f32 operations per (row, feature)) is an order of magnitude under the
// 67 TFLOP/s of the CUDA cores.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace cg = cooperative_groups;

namespace {

constexpr int kCols = 32;                  // M: features per tile, a warp
constexpr int kGroups = 8;                 // M: row groups (warps) a block
constexpr int kThreads = kCols * kGroups;  // every kernel of this file
constexpr int kRows = 64;                  // M: rows per row block
constexpr int kTransformRows = 4;          // K: rows a thread, in flight
constexpr int kWarps = kThreads / 32;
constexpr int kStatsSums = 15;             // J: count, mean 0..3, M2 5..14
constexpr int kSums = 20;                  // L: sum g 0..3, sum g u^T 4..19
constexpr int kSlab = 8;                   // J, L: features a cluster
constexpr int kMaxCluster = 16;            // past 8 a non-portable size
constexpr int kMaxSmem = 48 * 1024;        // without an opt-in
constexpr int kStatsUnroll = 8;            // J's rows in flight a thread
constexpr int kSumsUnroll = 8;             // L's (x and g)
constexpr unsigned kFull = 0xffffffffu;

// entry (j, k), j <= k, of the upper covariance in JAX's _COV_IDX order
__host__ __device__ constexpr int cov_at(int j, int k) {
  return j * 4 - j * (j - 1) / 2 + k - j;
}

// entry (j, k), j >= k, of the Cholesky factor in JAX's _L_IDX order
__host__ __device__ constexpr int l_at(int j, int k) {
  return j * (j + 1) / 2 + k;
}

// Closed-form Cholesky of cov + eps I (_chol_fields, fused_whitening.py:61-78);
// c holds the upper covariance in cov order.
__device__ __forceinline__ void cholesky(const float* c, float eps, float* l) {
  l[0] = sqrtf(c[cov_at(0, 0)] + eps);
  l[1] = c[cov_at(0, 1)] / l[0];
  l[2] = sqrtf(c[cov_at(1, 1)] + eps - l[1] * l[1]);
  l[3] = c[cov_at(0, 2)] / l[0];
  l[4] = (c[cov_at(1, 2)] - l[1] * l[3]) / l[2];
  l[5] = sqrtf(c[cov_at(2, 2)] + eps - (l[4] * l[4] + l[3] * l[3]));
  l[6] = c[cov_at(0, 3)] / l[0];
  l[7] = (c[cov_at(1, 3)] - l[1] * l[6]) / l[2];
  l[8] = (c[cov_at(2, 3)] - (l[4] * l[7] + l[3] * l[6])) / l[5];
  l[9] = sqrtf(c[cov_at(3, 3)] + eps -
               (l[8] * l[8] + l[7] * l[7] + l[6] * l[6]));
}

__device__ __forceinline__ void inv_diag(const float* l, float* il) {
  il[0] = 1.0f / l[0];
  il[1] = 1.0f / l[2];
  il[2] = 1.0f / l[5];
  il[3] = 1.0f / l[9];
}

// L z = b (_fwd_subst)
__device__ __forceinline__ void fwd_subst(const float* l, const float* il,
                                          const float* b, float* z) {
  z[0] = b[0] * il[0];
  z[1] = (b[1] - l[1] * z[0]) * il[1];
  z[2] = (b[2] - l[3] * z[0] - l[4] * z[1]) * il[2];
  z[3] = (b[3] - l[6] * z[0] - l[7] * z[1] - l[8] * z[2]) * il[3];
}

// L^T w = b (_bwd_subst)
__device__ __forceinline__ void bwd_subst(const float* l, const float* il,
                                          const float* b, float* w) {
  w[3] = b[3] * il[3];
  w[2] = (b[2] - l[8] * w[3]) * il[2];
  w[1] = (b[1] - l[4] * w[2] - l[7] * w[3]) * il[1];
  w[0] = (b[0] - l[1] * w[1] - l[3] * w[2] - l[6] * w[3]) * il[0];
}

__device__ __forceinline__ void load_factor(const float* __restrict__ lf,
                                            int64_t f, int64_t d, float* l,
                                            float* il) {
#pragma unroll
  for (int i = 0; i < 10; ++i) l[i] = lf[i * d + f];
  inv_diag(l, il);
}

// ------------------------------------------------- J and L: the clusters

// The cluster barrier in two halves: every CTA arrives as it starts and
// waits just before it first writes another CTA's shared memory, by which
// time every CTA of the cluster has started.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Every rank's partials in its shared memory, once every CTA has written its
// own: one cluster barrier (a CTA barrier in a cluster of 1).  No CTA
// touches another's shared memory after it.
__device__ __forceinline__ void exchange(cg::cluster_group& cluster,
                                         unsigned ranks) {
  if (ranks > 1) {
    cluster.sync();
  } else {
    __syncthreads();
  }
}

// Floats of J's and L's dynamic shared memory for a slab of f features, r
// ranks and q quantities a feature (ops/fused_whitening.py::wbn_plan), in
// slots of q + 4 floats a feature (J's partial is its q = 15 and its shift):
//   rank  [r][q + 4][f]       every rank's partials, each written by its rank
//   warp  [kWarps][q + 4][f]  each warp's partials
//   tot   [q + 4][f]          L: the cluster's sums of the features it owns
__host__ __device__ constexpr int64_t smem_floats(int64_t f, int64_t r,
                                                  int64_t q) {
  return f * (r + kWarps + 1) * (q + 4);
}

// J's and L's dynamic shared memory, indexed as an array of the shared
// space so that every access is a shared-memory instruction
extern __shared__ float wsm[];

// Offsets of the regions in wsm.
struct Layout {
  int rank, warp, tot, F, S;
  __device__ Layout(int f, unsigned r, int q)
      : rank(0),
        warp(static_cast<int>(r) * (q + 4) * f),
        tot(warp + kWarps * (q + 4) * f),
        F(f),
        S(q + 4) {}
  // offset of quantity i of feature fi in slot q of the rank or warp region
  __device__ int slot(int q, int i, int fi) const {
    return (q * S + i) * F + fi;
  }
};

// Where this thread works: feature f (the slab's fi-th), rows rg, rg +
// groups, ... of its CTA's rows [r0, r1).
struct Place {
  int64_t f, base, r0, r1;
  int fi, rg, groups;
  unsigned rank, ranks;
  bool live;
};

__device__ Place place(int64_t n, int64_t d, int rows) {
  const cg::cluster_group cluster = cg::this_cluster();
  Place p;
  p.rank = cluster.block_rank();
  p.ranks = cluster.num_blocks();
  p.fi = threadIdx.x % kSlab;
  p.rg = threadIdx.x / kSlab;
  p.groups = kThreads / kSlab;
  p.base = static_cast<int64_t>(blockIdx.x / p.ranks) * kSlab;
  p.f = p.base + p.fi;
  p.live = p.f < d;
  const int64_t r0 = static_cast<int64_t>(p.rank) * rows;
  p.r0 = r0 < n ? r0 : n;
  p.r1 = p.r0 + rows < n ? p.r0 + rows : n;
  return p;
}

// Feature fi of the slab belongs to rank fi % ranks, which writes it.
__device__ __forceinline__ bool owns(const Place& p, int fi) {
  return static_cast<unsigned>(fi) % p.ranks == p.rank;
}

// Load U of this thread's rows from c0 on, the four components of its
// feature from each of src (0 past the CTA's rows or for a feature past
// d), and whether each row counts: inside the rows and, with kMask, live.
template <int U, int kN, bool kMask>
__device__ __forceinline__ void load_rows(const float* const (&src)[kN],
                                          const uint8_t* __restrict__ mask,
                                          int64_t c0, int64_t d,
                                          const Place& p,
                                          float (&v)[U][kN][4], bool (&m)[U]) {
  const int64_t dd = 4 * d;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int64_t r = c0 + static_cast<int64_t>(u) * p.groups;
    const bool in = r < p.r1;
    m[u] = kMask ? in && mask[r] != 0 : in;
#pragma unroll
    for (int k = 0; k < kN; ++k) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        v[u][k][c] = in && p.live ? __ldg(src[k] + r * dd + c * d + p.f)
                                  : 0.0f;
      }
    }
  }
}

// ----------------------------------------------------------------- J

// A partial of J for one feature: its live rows c, its shift s (x at its
// first live row, 0 without one), the mean m of x - s and the co-moments q
// about that mean.
struct Moments {
  float c;      // live rows
  float m[4];   // mean of x - s per component
  float q[10];  // centred co-moments, cov order
  float s[4];   // shift
};

// Quantity i of a partial as published: 0 count, 1..4 mean, 5..14 M2, then
// 15..18 the shift.
__device__ __forceinline__ float& moment(Moments& a, int i) {
  return i == 0 ? a.c : i < 5 ? a.m[i - 1] : i < 15 ? a.q[i - 5] : a.s[i - 15];
}

constexpr int kMoments = kStatsSums + 4;

// Chan's combine of b into a (fused_whitening.py:204-216), with b's mean
// taken about a's shift: delta = ((s_b - s_a) + m_b) - m_a.  The shifts are
// data of one column, so s_b - s_a keeps its digits where the column sits
// far from 0.  A partial with no live row is an exact no-op, and one merged
// into an empty partial is copied.  The weights take the fast reciprocal
// (__fdividef, 2 ulp): a few ulp in a mean of deviations.
__device__ __forceinline__ void chan_merge(Moments& a, const Moments& b) {
  if (b.c == 0.0f) return;
  if (a.c == 0.0f) {
    a = b;
    return;
  }
  const float cn = a.c + b.c;
  const float ratio = __fdividef(b.c, cn);
  const float cross = a.c * ratio;
  float delta[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) delta[k] = ((b.s[k] - a.s[k]) + b.m[k]) - a.m[k];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int k = j; k < 4; ++k) {
      a.q[cov_at(j, k)] += b.q[cov_at(j, k)] + delta[j] * delta[k] * cross;
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) a.m[k] += delta[k] * ratio;
  a.c = cn;
}

__device__ __forceinline__ Moments shfl_down(Moments& a, int off) {
  Moments b;
#pragma unroll
  for (int i = 0; i < kMoments; ++i) {
    moment(b, i) = __shfl_down_sync(kFull, moment(a, i), off);
  }
  return b;
}

// mean [4, d], cov [4, 4, d], L [10, d] and cnt [1] of the masked rows.
__global__ void __launch_bounds__(kThreads, 1)
wbn_stats_kernel(const float* __restrict__ x, const uint8_t* __restrict__ mask,
                 float eps, float* __restrict__ mean_out,
                 float* __restrict__ cov_out, float* __restrict__ l_out,
                 float* __restrict__ cnt_out, int64_t n, int64_t d,
                 int rows) {
  constexpr int F = kSlab;
  cg::cluster_group cluster = cg::this_cluster();
  const Place p = place(n, d, rows);
  if (p.ranks > 1) cluster_arrive_relaxed();
  const Layout lay(F, p.ranks, kStatsSums);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const float* const src[1] = {x};

  // Welford over this thread's live rows, about its first one
  Moments a;
#pragma unroll
  for (int i = 0; i < kMoments; ++i) moment(a, i) = 0.0f;
  for (int64_t c0 = p.r0 + p.rg; c0 < p.r1;
       c0 += static_cast<int64_t>(kStatsUnroll) * p.groups) {
    float v[kStatsUnroll][1][4];
    bool m[kStatsUnroll];
    load_rows<kStatsUnroll, 1, true>(src, mask, c0, d, p, v, m);
#pragma unroll
    for (int u = 0; u < kStatsUnroll; ++u) {
      if (!m[u]) continue;
      if (a.c == 0.0f) {
#pragma unroll
        for (int c = 0; c < 4; ++c) a.s[c] = v[u][0][c];
      }
      a.c += 1.0f;
      const float inv = __fdividef(1.0f, a.c);
      float xs[4], e[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        xs[c] = v[u][0][c] - a.s[c];
        e[c] = xs[c] - a.m[c];
        a.m[c] += e[c] * inv;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int k = j; k < 4; ++k) {
          a.q[cov_at(j, k)] += e[j] * (xs[k] - a.m[k]);
        }
      }
    }
  }

  // the lanes of a feature, in a fixed tree; lane fi < F holds the warp's
  for (int off = 16; off >= F; off >>= 1) {
    const Moments b = shfl_down(a, off);
    chan_merge(a, b);
  }
  if (lane < F) {
#pragma unroll
    for (int i = 0; i < kMoments; ++i) {
      wsm[lay.warp + lay.slot(warp, i, lane)] = moment(a, i);
    }
  }
  __syncthreads();
  if (p.ranks > 1) cluster_wait();
  // a thread per (feature, warp), 8 lanes a feature: the warps' partials in
  // a fixed tree; lane w = the feature's owner (fi % ranks < F <= 8) takes
  // lane 0's and writes it into the owner's slot for this rank
  if (t < F * kWarps) {  // whole warps
    const int fi = t / kWarps, w = t % kWarps;
    Moments acc;
#pragma unroll
    for (int i = 0; i < kMoments; ++i) {
      moment(acc, i) = wsm[lay.warp + lay.slot(w, i, fi)];
    }
#pragma unroll
    for (int off = kWarps / 2; off > 0; off >>= 1) {
      Moments b;
#pragma unroll
      for (int i = 0; i < kMoments; ++i) {
        moment(b, i) = __shfl_down_sync(kFull, moment(acc, i), off, kWarps);
      }
      chan_merge(acc, b);
    }
#pragma unroll
    for (int i = 0; i < kMoments; ++i) {
      moment(acc, i) = __shfl_sync(kFull, moment(acc, i), 0, kWarps);
    }
    if (static_cast<unsigned>(w) == static_cast<unsigned>(fi) % p.ranks) {
      float* dst = cluster.map_shared_rank(wsm, w) + lay.rank;
#pragma unroll
      for (int i = 0; i < kMoments; ++i) {
        dst[lay.slot(p.rank, i, fi)] = moment(acc, i);
      }
    }
  }
  exchange(cluster, p.ranks);

  // lanes 8 fi + q (q < 8; 16 fi + q for q < 16 past 8 ranks): rank q's
  // partial of feature fi, merged over the ranks in the same fixed tree;
  // lane q = 0 of the feature's owner writes its outputs
  const int lanes = p.ranks > 8 ? 16 : 8;
  if (t >= F * lanes) return;  // no barrier follows
  const int fi = t / lanes, q = t % lanes;
  const int64_t f = p.base + fi;
  Moments r;
#pragma unroll
  for (int i = 0; i < kMoments; ++i) {
    moment(r, i) = q < static_cast<int>(p.ranks)
                       ? wsm[lay.rank + lay.slot(q, i, fi)]
                       : 0.0f;
  }
  for (int off = lanes / 2; off > 0; off >>= 1) {
    Moments b;
#pragma unroll
    for (int i = 0; i < kMoments; ++i) {
      moment(b, i) = __shfl_down_sync(kFull, moment(r, i), off, lanes);
    }
    chan_merge(r, b);
  }
  if (q != 0 || !owns(p, fi) || f >= d) return;
  const float cnt = fmaxf(r.c, 1.0f);
  const float inv = 1.0f / cnt;
  float cov[10], l[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) cov[i] = r.q[i] * inv;
  cholesky(cov, eps, l);
#pragma unroll
  for (int c = 0; c < 4; ++c) mean_out[c * d + f] = r.s[c] + r.m[c];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      cov_out[(j * 4 + k) * d + f] = cov[j <= k ? cov_at(j, k) : cov_at(k, j)];
    }
  }
#pragma unroll
  for (int i = 0; i < 10; ++i) l_out[i * d + f] = l[i];
  if (f == 0) cnt_out[0] = cnt;
}

// ----------------------------------------------------------------- K

// l_at of the i-th entry below the diagonal: (1,0) (2,0) (2,1) (3,0) (3,1) (3,2)
__host__ __device__ constexpr int off_diag(int i) {
  return i < 1 ? 1 : i < 3 ? i + 2 : i + 3;
}

// Both routes stage the factor of each feature of a CTA's chunk in shared
// memory, computed once by thread f for feature f: kEval factors the running
// covariance lf [4, 4, d] (cov + eps I, the Cholesky that J and the eval
// path share) and the CTAs of row block 0 write it to l_out [10, d];
// otherwise lf is the factor [10, d].  Shared: L's six entries below the
// diagonal (l_at order) and its four reciprocal diagonals, 10 floats a
// feature.
// CTA (b, c) owns feature chunk c, its first `feats` features (fc of them
// live), and its threads cover groups = kThreads / feats rows at a time:
// thread t takes feature t % feats of row t / feats, so consecutive lanes
// take consecutive features of a row, then the next row, and at most
// kThreads % feats lanes idle whatever d is.  Its feature is fixed, so it
// loads Gamma, the mean and beta once, into registers; its rows, groups
// apart, up to kTransformRows, are unrolled and their loads issued first.
// CTA b owns the rows [b * rows, (b + 1) * rows), rows <= groups *
// kTransformRows, shortened by the launch so that the CTAs come to about
// whole waves of the card's SMs.
template <bool kEval>
__global__ void __launch_bounds__(kThreads)
wbn_transform_kernel(const float* __restrict__ x,
                     const float* __restrict__ mean,
                     const float* __restrict__ lf,
                     const float* __restrict__ gamma,
                     const float* __restrict__ beta, float eps,
                     float* __restrict__ y, float* __restrict__ l_out,
                     int64_t n, int64_t d, int feats, int rows) {
  extern __shared__ float factor[];  // [10][feats]
  const int64_t f0 = static_cast<int64_t>(blockIdx.y) * feats;
  const int fc = static_cast<int>(d - f0 < feats ? d - f0 : feats);
  const int groups = kThreads / feats;
  const int g = static_cast<int>(threadIdx.x) / feats;
  const int j = static_cast<int>(threadIdx.x) - g * feats;
  const bool mine = g < groups && j < fc;
  const int64_t f = f0 + j;
  const int64_t dd = 4 * d;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rows + g;
  const int64_t r1 = r0 - g + rows < n ? r0 - g + rows : n;
  // the factor's inputs for feature f0 + threadIdx.x, loaded before the
  // rows so that the eval route's chain runs while they are in flight
  const bool factors = threadIdx.x < fc;
  const int64_t ff = f0 + threadIdx.x;
  float src[10];
  if (factors) {
    if constexpr (kEval) {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int b = a; b < 4; ++b) {
          src[cov_at(a, b)] = lf[(a * 4 + b) * d + ff];
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < 10; ++i) src[i] = lf[i * d + ff];
    }
  }
  bool live[kTransformRows];
  float xv[kTransformRows][4];
#pragma unroll
  for (int i = 0; i < kTransformRows; ++i) {
    const int64_t r = r0 + static_cast<int64_t>(i) * groups;
    live[i] = mine && r < r1;
    if (live[i]) {
#pragma unroll
      for (int c = 0; c < 4; ++c) xv[i][c] = x[r * dd + c * d + f];
    }
  }
  float mu[4], bet[4], gam[16];
  if (mine) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      mu[c] = mean[c * d + f];
      bet[c] = beta[c * d + f];
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) gam[i] = gamma[i * d + f];
  }
  if (factors) {
    float lg[10], ilg[4];
    if constexpr (kEval) {
      cholesky(src, eps, lg);
      if (blockIdx.x == 0) {
#pragma unroll
        for (int i = 0; i < 10; ++i) l_out[i * d + ff] = lg[i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < 10; ++i) lg[i] = src[i];
    }
    inv_diag(lg, ilg);
#pragma unroll
    for (int i = 0; i < 6; ++i) factor[i * feats + threadIdx.x] = lg[off_diag(i)];
#pragma unroll
    for (int c = 0; c < 4; ++c) factor[(6 + c) * feats + threadIdx.x] = ilg[c];
  }
  __syncthreads();
  if (!mine) return;
  float l[10] = {}, il[4];
#pragma unroll
  for (int i = 0; i < 6; ++i) l[off_diag(i)] = factor[i * feats + j];
#pragma unroll
  for (int c = 0; c < 4; ++c) il[c] = factor[(6 + c) * feats + j];
#pragma unroll
  for (int i = 0; i < kTransformRows; ++i) {
    if (!live[i]) continue;
    const int64_t at = (r0 + static_cast<int64_t>(i) * groups) * dd + f;
    float u[4], z[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) u[c] = xv[i][c] - mu[c];
    fwd_subst(l, il, u, z);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float acc = gam[c * 4] * z[0];
#pragma unroll
      for (int k = 1; k < 4; ++k) acc += gam[c * 4 + k] * z[k];
      y[at + c * d] = acc + bet[c];
    }
  }
}

// ----------------------------------------------------------------- L

// S e_j of the symmetric S = copyltu(L^T Lbar) (_m_from_lbar), Lbar in L
// order.
__device__ __forceinline__ void s_column(const float* l, const float* lbar,
                                         int j, float* col) {
  float s[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = 0; b <= a; ++b) {
      float t = 0.0f;  // T_ab = sum_{c >= a} L_ca Lbar_cb  (b <= a)
#pragma unroll
      for (int c = a; c < 4; ++c) t += l[l_at(c, a)] * lbar[l_at(c, b)];
      s[a][b] = t;
      s[b][a] = t;
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    col[a] = j == 0 ? s[a][0] : j == 1 ? s[a][1] : j == 2 ? s[a][2] : s[a][3];
  }
}

// One lane j of the 4 of a feature in L's epilogue takes, from lane b of
// its quad, b's value v[j]: the transpose of what the 4 lanes hold.
__device__ __forceinline__ void quad_transpose(const float (&v)[4], int j,
                                               float (&out)[4]) {
  const int base = (threadIdx.x & 31) & ~3;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float o = __shfl_sync(kFull, v[k], base + b);
      if (k == j) out[b] = o;
    }
  }
}

// dGamma [4, 4, d], dbeta [4, d], M [16, d] and sum w [4, d] over all rows;
// frozen, dGamma and dbeta alone (mmat and sw are not written).  The sweep
// sums the 20 quantities that are linear in the rows, sum g and
// G = sum g u^T (u = x - mean); since z = L^{-1} u and w = L^{-T} Gamma^T g,
//   dGamma = G L^{-T},  sum w z^T = L^{-T} Gamma^T dGamma,
//   sum w = L^{-T} Gamma^T sum g,
// which the epilogue solves once a feature.
template <bool kFrozen>
__global__ void __launch_bounds__(kThreads, 1)
wbn_bwd_sums_kernel(const float* __restrict__ x, const float* __restrict__ g,
                    const float* __restrict__ mean,
                    const float* __restrict__ lf,
                    const float* __restrict__ gamma,
                    float* __restrict__ dgamma, float* __restrict__ dbeta,
                    float* __restrict__ mmat, float* __restrict__ sw,
                    int64_t n, int64_t d, int rows) {
  constexpr int F = kSlab;
  cg::cluster_group cluster = cg::this_cluster();
  const Place p = place(n, d, rows);
  if (p.ranks > 1) cluster_arrive_relaxed();
  const Layout lay(F, p.ranks, kSums);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const float* const src[2] = {x, g};

  // the epilogue's lanes 4 fi + j (t < 4 F) load feature fi's factor and,
  // outside the frozen variant, Gamma, while the rows stream in
  const int fq = t >> 2, j = t & 3;
  const int ei = fq < F ? fq : F - 1;
  const int64_t ef = p.base + ei;
  float lq[10], gam[16];
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    lq[i] = t < 4 * F && ef < d ? lf[i * d + ef]
                                : (i == 0 || i == 2 || i == 5 || i == 9);
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    gam[i] = !kFrozen && t < 4 * F && ef < d ? gamma[i * d + ef] : 0.0f;
  }
  float mu[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) mu[c] = p.live ? mean[c * d + p.f] : 0.0f;

  // acc: sum g 0..3, then G row-major (4 + c * 4 + k: sum g_c u_k)
  float acc[kSums];
#pragma unroll
  for (int i = 0; i < kSums; ++i) acc[i] = 0.0f;
  for (int64_t c0 = p.r0 + p.rg; c0 < p.r1;
       c0 += static_cast<int64_t>(kSumsUnroll) * p.groups) {
    float v[kSumsUnroll][2][4];
    bool in[kSumsUnroll];
    load_rows<kSumsUnroll, 2, false>(src, nullptr, c0, d, p, v, in);
#pragma unroll
    for (int r = 0; r < kSumsUnroll; ++r) {
      if (!in[r]) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[c] += v[r][1][c];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          acc[4 + c * 4 + k] += v[r][1][c] * (v[r][0][k] - mu[k]);
        }
      }
    }
  }

  // the lanes of a feature, in a fixed tree; lane fi < F holds the warp's
  for (int off = 16; off >= F; off >>= 1) {
#pragma unroll
    for (int i = 0; i < kSums; ++i) {
      acc[i] += __shfl_down_sync(kFull, acc[i], off);
    }
  }
  if (lane < F) {
#pragma unroll
    for (int i = 0; i < kSums; ++i) {
      wsm[lay.warp + lay.slot(warp, i, lane)] = acc[i];
    }
  }
  __syncthreads();
  if (p.ranks > 1) cluster_wait();
  // a thread per (sum, feature): the warps in order, then into the
  // feature's owner
  for (int idx = t; idx < kSums * F; idx += kThreads) {
    const int i = idx / F, fi = idx % F;
    float s = wsm[lay.warp + lay.slot(0, i, fi)];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += wsm[lay.warp + lay.slot(w, i, fi)];
    cluster.map_shared_rank(wsm, fi % static_cast<int>(p.ranks))[
        lay.rank + lay.slot(p.rank, i, fi)] = s;
  }
  exchange(cluster, p.ranks);

  // the owner of each feature sums the ranks in order
  for (int idx = t; idx < kSums * F; idx += kThreads) {
    const int i = idx / F, fi = idx % F;
    if (!owns(p, fi)) continue;
    float s = 0.0f;
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q) {
      const bool in = q < static_cast<int>(p.ranks);
      const float v = wsm[lay.rank + lay.slot(in ? q : 0, i, fi)];
      s += in ? v : 0.0f;
    }
    wsm[lay.tot + i * F + fi] = s;
    if (i < 4 && p.base + fi < d) dbeta[i * d + p.base + fi] = s;
  }
  __syncthreads();
  if (warp >= (4 * F + 31) / 32) return;  // no barrier follows
  // lanes 4 fi + j: row j of dGamma = L^{-1} G[j, :]^T; outside the frozen
  // variant lane j then solves column j of W = sum w z^T = L^{-T} Gamma^T
  // dGamma, the lanes trade W into Lbar = -tril(W), and lane j solves
  // L^T v_j = S e_j and row j of M = L^{-T} S L^{-1} from
  // (v_0[j], v_1[j], v_2[j], v_3[j]), and writes sum w [j]
  const bool mine = fq < F && owns(p, ei) && ef < d;
  float ilq[4], grow[4], dg[4];
  inv_diag(lq, ilq);
#pragma unroll
  for (int k = 0; k < 4; ++k) grow[k] = wsm[lay.tot + (4 + j * 4 + k) * F + ei];
  fwd_subst(lq, ilq, grow, dg);
  if (mine) {
#pragma unroll
    for (int k = 0; k < 4; ++k) dgamma[(j * 4 + k) * d + ef] = dg[k];
  }
  if constexpr (!kFrozen) {
    float col[4], a[4], wj[4], sg[4], h[4], swv[4];
    quad_transpose(dg, j, col);  // col[c] = dGamma[c][j]
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float s = gam[k] * col[0];
#pragma unroll
      for (int c = 1; c < 4; ++c) s += gam[c * 4 + k] * col[c];
      a[k] = s;  // (Gamma^T dGamma)[k][j]
    }
    bwd_subst(lq, ilq, a, wj);  // W[:, j]
    float lbar[10];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float o = __shfl_sync(kFull, wj[r], (lane & ~3) + b);
        if (r >= b) lbar[l_at(r, b)] = -o;
      }
    }
    float scol[4], vj[4], row[4], mrow[4];
    s_column(lq, lbar, j, scol);
    bwd_subst(lq, ilq, scol, vj);
    quad_transpose(vj, j, row);
    bwd_subst(lq, ilq, row, mrow);
#pragma unroll
    for (int c = 0; c < 4; ++c) sg[c] = wsm[lay.tot + c * F + ei];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float s = gam[k] * sg[0];
#pragma unroll
      for (int c = 1; c < 4; ++c) s += gam[c * 4 + k] * sg[c];
      h[k] = s;
    }
    bwd_subst(lq, ilq, h, swv);
    if (mine) {
#pragma unroll
      for (int b = 0; b < 4; ++b) mmat[(j * 4 + b) * d + ef] = mrow[b];
      sw[j * d + ef] =
          j == 0 ? swv[0] : j == 1 ? swv[1] : j == 2 ? swv[2] : swv[3];
    }
  }
}

// ----------------------------------------------------------------- M

// Frozen: dx = w, and x, the mask, mean, M, sum w and cnt are not read.
template <bool kFrozen>
__global__ void __launch_bounds__(kThreads)
wbn_dx_kernel(const float* __restrict__ x, const float* __restrict__ g,
              const uint8_t* __restrict__ mask, const float* __restrict__ mean,
              const float* __restrict__ lf, const float* __restrict__ gamma,
              const float* __restrict__ mmat, const float* __restrict__ sw,
              const float* __restrict__ cnt, float* __restrict__ dx, int64_t n,
              int64_t d) {
  const int lane = threadIdx.x % kCols;
  const int rg = threadIdx.x / kCols;
  const int64_t f = static_cast<int64_t>(blockIdx.x) * kCols + lane;
  if (f >= d) return;  // no barrier in this kernel
  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * kRows;
  const int64_t r1 = r0 + kRows < n ? r0 + kRows : n;
  const int64_t dd = 4 * d;
  float mu[4], l[10], il[4], gam[16], mm[16], s[4];
  if constexpr (!kFrozen) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      mu[c] = mean[c * d + f];
      s[c] = sw[c * d + f];
    }
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    gam[i] = gamma[i * d + f];
    if constexpr (!kFrozen) mm[i] = mmat[i * d + f];
  }
  load_factor(lf, f, d, l, il);
  const float inv_cnt = kFrozen ? 0.0f : 1.0f / cnt[0];
  for (int64_t r = r0 + rg; r < r1; r += kGroups) {
    float u[4], gv[4], h[4], w[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if constexpr (!kFrozen) u[c] = x[r * dd + c * d + f] - mu[c];
      gv[c] = g[r * dd + c * d + f];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float hk = gam[k] * gv[0];
#pragma unroll
      for (int c = 1; c < 4; ++c) hk += gam[c * 4 + k] * gv[c];
      h[k] = hk;
    }
    bwd_subst(l, il, h, w);
    if constexpr (kFrozen) {
#pragma unroll
      for (int a = 0; a < 4; ++a) dx[r * dd + a * d + f] = w[a];
    } else {
      const float scale = mask[r] ? inv_cnt : 0.0f;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        float mu_a = mm[a * 4] * u[0];
#pragma unroll
        for (int bb = 1; bb < 4; ++bb) mu_a += mm[a * 4 + bb] * u[bb];
        dx[r * dd + a * d + f] = w[a] + scale * (mu_a - s[a]);
      }
    }
  }
}

int64_t row_blocks(int64_t n) { return (n + kRows - 1) / kRows; }

dim3 tile_grid(int64_t n, int64_t d) {
  return dim3(static_cast<unsigned>((d + kCols - 1) / kCols),
              static_cast<unsigned>(row_blocks(n)));
}

// The plan of wbn_plan, checked: slabs of kSlab features, a cluster of at
// most kMaxCluster CTAs, rows that cover n, and the shared memory of
// smem_floats.
bool plan_ok(int64_t n, int64_t d, int64_t slab, int64_t cluster,
             int64_t rows, int64_t smem, int sums) {
  return slab == kSlab && cluster >= 1 && cluster <= kMaxCluster && n >= 0 &&
         n < (int64_t{1} << 31) && rows >= 0 && rows < (int64_t{1} << 31) &&
         rows * cluster >= n && smem == 4 * smem_floats(kSlab, cluster, sums) &&
         smem <= kMaxSmem && d >= 0 &&
         (d + kSlab - 1) / kSlab * cluster < (int64_t{1} << 31);
}

cudaLaunchConfig_t cluster_config(int64_t blocks, int64_t cluster,
                                  int64_t smem, void* stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters past the portable 8 must be allowed per kernel, on each device;
// done once.
cudaError_t allow_clusters() {
  static std::atomic<uint64_t> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = 1ull << (dev & 63);
  if (done.load() & bit) return cudaSuccess;
  const cudaFuncAttribute attr = cudaFuncAttributeNonPortableClusterSizeAllowed;
  if ((err = cudaFuncSetAttribute(wbn_stats_kernel, attr, 1)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(wbn_bwd_sums_kernel<false>, attr, 1)) !=
          cudaSuccess ||
      (err = cudaFuncSetAttribute(wbn_bwd_sums_kernel<true>, attr, 1)) !=
          cudaSuccess) {
    return err;
  }
  done.fetch_or(bit);
  return cudaSuccess;
}

template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), int64_t d, int64_t cluster,
                   int64_t smem, void* stream, Args... args) {
  const cudaError_t err = allow_clusters();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(
      (d + kSlab - 1) / kSlab * cluster, cluster, smem, stream, attr);
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// K, both routes: grid (row blocks, feature chunks), chunks of equal size
// up to kThreads features, the threads of a CTA its rows a pass times the
// chunk's features, in whole warps.  Row blocks of at most groups *
// kTransformRows rows.  Where those give at least one CTA each of the `sms`
// SMs, a CTA's rows are shortened so that the CTAs come to about whole
// waves: the count is rounded up to whole waves, the rows spread evenly
// over it, and the count taken anew from those rows (at [4096, 200], 205
// CTAs of 20 rows become 256 of 16).  The eval route launches one row block
// even for n = 0, so that the factor is written.
int launch_transform(bool eval, const void* x, const void* mean,
                     const void* lf, const void* gamma, const void* beta,
                     float eps, void* y, void* l_out, int64_t n, int64_t d,
                     int64_t sms, void* stream) {
  if (n < 0 || n >= (int64_t{1} << 31) || d < 0 || sms < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (d == 0 || (n == 0 && !eval)) return static_cast<int>(cudaGetLastError());
  const int64_t chunks = (d + kThreads - 1) / kThreads;
  const int feats = static_cast<int>((d + chunks - 1) / chunks);
  const int groups = kThreads / feats;
  const int threads = (groups * feats + 31) / 32 * 32;
  const int64_t most = int64_t{groups} * kTransformRows;
  int64_t blocks = (n + most - 1) / most;
  if (blocks >= sms) blocks = (blocks + sms - 1) / sms * sms;
  const int64_t rows = blocks > 0 ? (n + blocks - 1) / blocks : most;
  blocks = n > 0 ? (n + rows - 1) / rows : 1;
  if (blocks >= (int64_t{1} << 31) || chunks > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(chunks));
  const size_t smem = sizeof(float) * 10 * feats;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* mf = static_cast<const float*>(mean);
  const float* lff = static_cast<const float*>(lf);
  const float* gf = static_cast<const float*>(gamma);
  const float* bf = static_cast<const float*>(beta);
  const int r = static_cast<int>(rows);
  if (eval) {
    wbn_transform_kernel<true><<<grid, threads, smem, s>>>(
        xf, mf, lff, gf, bf, eps, static_cast<float*>(y),
        static_cast<float*>(l_out), n, d, feats, r);
  } else {
    wbn_transform_kernel<false><<<grid, threads, smem, s>>>(
        xf, mf, lff, gf, bf, 0.0f, static_cast<float*>(y), nullptr, n, d,
        feats, r);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The clusters of a plan (cluster, smem) that the card holds at once, for J
// (which 0), L (1) or L's frozen variant (2): a plan whose grid has more
// runs in waves.  A check of the plan; no launch path calls it.
extern "C" int wbn_max_active_clusters(int64_t which, int64_t cluster,
                                       int64_t smem, int* out) {
  const void* kernel =
      which == 0 ? reinterpret_cast<const void*>(wbn_stats_kernel)
      : which == 1
          ? reinterpret_cast<const void*>(wbn_bwd_sums_kernel<false>)
      : which == 2
          ? reinterpret_cast<const void*>(wbn_bwd_sums_kernel<true>)
          : nullptr;
  if (kernel == nullptr || cluster < 1 || cluster > kMaxCluster || smem < 0 ||
      smem > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = allow_clusters();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(cluster, cluster, smem, nullptr, attr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(out, kernel, &cfg));
}

// The plan arguments (slab, cluster, rows, smem) of J and L are those of
// ops/fused_whitening.py::wbn_plan(n, d, sums) with sums 15 (J) or 20 (L,
// both variants); a plan this file cannot run returns cudaErrorInvalidValue
// and launches nothing.
extern "C" int wbn_stats_f32(const void* x, const void* mask, float eps,
                             void* mean, void* cov, void* l, void* cnt,
                             int64_t n, int64_t d, int64_t slab,
                             int64_t cluster, int64_t rows, int64_t smem,
                             void* stream) {
  if (!plan_ok(n, d, slab, cluster, rows, smem, kStatsSums)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (d == 0) return static_cast<int>(cudaSuccess);
  const cudaError_t err = launch(
      wbn_stats_kernel, d, cluster, smem, stream,
      static_cast<const float*>(x), static_cast<const uint8_t*>(mask), eps,
      static_cast<float*>(mean), static_cast<float*>(cov),
      static_cast<float*>(l), static_cast<float*>(cnt), n, d,
      static_cast<int>(rows));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// K's launches take the SMs of the card (ops/_build.py's SMS).
extern "C" int wbn_transform_f32(const void* x, const void* mean,
                                 const void* l, const void* gamma,
                                 const void* beta, void* y, int64_t n,
                                 int64_t d, int64_t sms, void* stream) {
  return launch_transform(false, x, mean, l, gamma, beta, 0.0f, y, nullptr, n,
                          d, sms, stream);
}

// The eval route: K with the running covariance's factor in its prologue;
// writes y and the factor L [10, d] for the frozen backward.
extern "C" int wbn_transform_eval_f32(const void* x, const void* mean,
                                      const void* cov, const void* gamma,
                                      const void* beta, float eps, void* y,
                                      void* l, int64_t n, int64_t d,
                                      int64_t sms, void* stream) {
  return launch_transform(true, x, mean, cov, gamma, beta, eps, y, l, n, d,
                          sms, stream);
}

extern "C" int wbn_bwd_sums_f32(const void* x, const void* g, const void* mean,
                                const void* l, const void* gamma,
                                void* dgamma, void* dbeta, void* mmat, void* sw,
                                int64_t n, int64_t d, int64_t slab,
                                int64_t cluster, int64_t rows, int64_t smem,
                                void* stream) {
  if (!plan_ok(n, d, slab, cluster, rows, smem, kSums)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (d == 0) return static_cast<int>(cudaSuccess);
  const cudaError_t err = launch(
      wbn_bwd_sums_kernel<false>, d, cluster, smem, stream,
      static_cast<const float*>(x), static_cast<const float*>(g),
      static_cast<const float*>(mean), static_cast<const float*>(l),
      static_cast<const float*>(gamma), static_cast<float*>(dgamma),
      static_cast<float*>(dbeta), static_cast<float*>(mmat),
      static_cast<float*>(sw), n, d, static_cast<int>(rows));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

extern "C" int wbn_dx_f32(const void* x, const void* g, const void* mask,
                          const void* mean, const void* l, const void* gamma,
                          const void* mmat, const void* sw, const void* cnt,
                          void* dx, int64_t n, int64_t d, void* stream) {
  if (row_blocks(n) > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0 && d > 0) {
    wbn_dx_kernel<false><<<tile_grid(n, d), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(g),
        static_cast<const uint8_t*>(mask), static_cast<const float*>(mean),
        static_cast<const float*>(l), static_cast<const float*>(gamma),
        static_cast<const float*>(mmat), static_cast<const float*>(sw),
        static_cast<const float*>(cnt), static_cast<float*>(dx), n, d);
  }
  return static_cast<int>(cudaGetLastError());
}

// The eval path's backward, with the statistics fixed: dGamma and dbeta
// (Gamma is not read).
extern "C" int wbn_bwd_sums_frozen_f32(const void* x, const void* g,
                                       const void* mean, const void* l,
                                       void* dgamma, void* dbeta, int64_t n,
                                       int64_t d, int64_t slab,
                                       int64_t cluster, int64_t rows,
                                       int64_t smem, void* stream) {
  if (!plan_ok(n, d, slab, cluster, rows, smem, kSums)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (d == 0) return static_cast<int>(cudaSuccess);
  const cudaError_t err = launch(
      wbn_bwd_sums_kernel<true>, d, cluster, smem, stream,
      static_cast<const float*>(x), static_cast<const float*>(g),
      static_cast<const float*>(mean), static_cast<const float*>(l),
      static_cast<const float*>(nullptr), static_cast<float*>(dgamma),
      static_cast<float*>(dbeta), static_cast<float*>(nullptr),
      static_cast<float*>(nullptr), n, d, static_cast<int>(rows));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

extern "C" int wbn_dx_frozen_f32(const void* g, const void* l,
                                 const void* gamma, void* dx, int64_t n,
                                 int64_t d, void* stream) {
  if (row_blocks(n) > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0 && d > 0) {
    wbn_dx_kernel<true><<<tile_grid(n, d), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        nullptr, static_cast<const float*>(g), nullptr, nullptr,
        static_cast<const float*>(l), static_cast<const float*>(gamma),
        nullptr, nullptr, nullptr, static_cast<float*>(dx), n, d);
  }
  return static_cast<int>(cudaGetLastError());
}
