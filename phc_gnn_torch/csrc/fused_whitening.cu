// Quaternion whitening batch norm ('q-batch-norm'): training forward and
// backward, and the eval transform (sm_90a).
//
// Replaces the four Pallas kernels of phc_gnn_tpu/ops/fused_whitening.py:
//   wbn_stats_f32     <- _wbn_stats_kernel      (:184, pallas_call :347)  J
//   wbn_transform_f32 <- _wbn_transform_kernel  (:236, pallas_call :364)  K
//   wbn_bwd_sums_f32  <- _wbn_bwd_sums_kernel   (:253, pallas_call :388)  L
//                        together with the T/S/M field algebra that JAX runs
//                        in XLA between L and M (:408-412, _m_from_lbar
//                        :110-130), here in the epilogue of L's combine
//   wbn_dx_f32        <- _wbn_dx_kernel         (:304, pallas_call :413)  M
// and, for the eval path (phc_gnn_tpu/nn/norm.py:301-345, inline XLA there),
//   wbn_cholesky_f32     the Cholesky factor of a running covariance + eps I,
//                        with the device function of J's combine; it feeds
//                        wbn_transform_f32 with the running mean;
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
//   dx = w + (m / cnt) (M u - sum_w)     only the mean-path term is masked
// The substitutions multiply by the reciprocal diagonal, as JAX's do.  With
// the running statistics fixed (the eval path, whose mean and L are buffers)
// mu and L carry no gradient: dx = w on every row, and dbeta, dGamma are the
// same sums.  The frozen variants of L and M compute just that: L's row
// blocks skip w and its 14 sums, its combine skips the T/S/M algebra, and M
// skips the mean-path term.  Reaching this through the training variants
// with an all-false mask would give cnt = 0, and the mean-path term
// (m / cnt) (M u - sum w) would read 0 * inf = NaN.
//
// Design.  The TPU kernels walk a SEQUENTIAL grid of 1,024-row blocks with a
// VMEM carry.  Here the per-row kernels share one tiling: block (c, b) owns
// 32 features (one per lane, so that each of the four component slices
// x[:, k*d + f] is read as one coalesced run per warp) and a block of 64
// rows, over 8 warps (row groups).  A thread loads its feature's fields
// (mean, L, Gamma, ...) once and walks 8 rows.
//   J: each block writes its row block's partial (count, 4 means, 10
//      co-moments centred on the block's own mean, from a second pass over
//      its rows, which then come from L1) per feature: 15 partials.  The
//      combine gives each feature a warp: lane i merges row blocks i, i+32,
//      ... in order with Chan's formula, then the lanes merge in a fixed
//      shuffle tree (deterministic, an all-masked block an exact no-op), and
//      lane 0 writes mean, cov = M2 / cnt and L.  The partials are taken
//      about a shift, the feature's value in the first live row: Chan's
//      deltas between block means then keep their digits under a large
//      common offset (a column at 1e3 with std 0.1 lost 6e-5 of its
//      covariance to the f32 rounding of unshifted block means of 64 rows),
//      and a single live row gets its own value as the mean exactly.
//   L: each block writes its row block's 34 partial sums per feature (dbeta
//      4, dGamma 16, sum w z^T 10, sum w 4); the combine sums them with the
//      same warp per feature and shuffle tree, and lane 0 runs the T/S/M
//      algebra (about 150 scalar operations) for its feature: no XLA-style
//      chain of small launches between L and M.
//   K, M: elementwise over the same tiles.
// The partials are laid out [quantity, feature, row block] so that the
// combine's lanes read consecutive row blocks.
//
// Bound on an H100: bytes.  At [4096, 200] f32 (3.28 MB): J reads x and the
// mask (3.28 MB, 0.98 us at 3.35 TB/s); K reads x and writes y (6.56 MB,
// 1.96 us); L reads x and g (6.56 MB, 1.96 us); M reads x, g and the mask and
// writes dx (9.83 MB, 2.94 us); frozen, L reads the same and M reads g and
// writes dx (6.56 MB, 1.96 us).  Their arithmetic (about 30, 60, 130 and 90
// f32 operations per (row, feature)) is an order of magnitude under the
// 67 TFLOP/s of the CUDA cores.  At d = 50 the grid is 2 feature tiles (64
// lanes for 50 features) by 64 row blocks: 128 blocks of 256 threads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 32;                  // features per tile: one warp
constexpr int kGroups = 8;                 // row groups (warps) per block
constexpr int kThreads = kCols * kGroups;
constexpr int kRows = 64;                  // rows per row block
constexpr int kSums = 34;                  // dbeta 0..3, dGamma 4..19 (c*4+k),
                                           // sum w z^T 20..29 (L order),
                                           // sum w 30..33
constexpr int kFrozenSums = 20;            // dbeta and dGamma alone
constexpr int kCombineWarps = 8;           // features per combine block
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

// M = L^{-T} S L^{-1} from the Cholesky cotangent Lbar (_m_from_lbar);
// m[a*4+b] = M_ab.
__device__ __forceinline__ void m_from_lbar(const float* l, const float* il,
                                            const float* lbar, float* m) {
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
  float v[4][4];  // v[b] = L^{-T} S[:, b]
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const float col[4] = {s[0][b], s[1][b], s[2][b], s[3][b]};
    bwd_subst(l, il, col, v[b]);
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const float row[4] = {v[0][a], v[1][a], v[2][a], v[3][a]};
    bwd_subst(l, il, row, m + 4 * a);
  }
}

__device__ __forceinline__ void load_factor(const float* __restrict__ lf,
                                            int64_t f, int64_t d, float* l,
                                            float* il) {
#pragma unroll
  for (int i = 0; i < 10; ++i) l[i] = lf[i * d + f];
  inv_diag(l, il);
}

// ----------------------------------------------------------------- J

struct Moments {
  float c;      // live rows
  float m[4];   // mean per component
  float q[10];  // centred co-moments, cov order
};

// Chan's combine of b into a (fused_whitening.py:204-216); c' is clamped to
// >= 1, so a block with no live row (c_b = 0, q = 0) is an exact no-op.
__device__ __forceinline__ void chan_merge(Moments& a, const Moments& b) {
  const float cn = a.c + b.c;
  const float ratio = b.c / fmaxf(cn, 1.0f);
  const float cross = a.c * ratio;
  float delta[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) delta[k] = b.m[k] - a.m[k];
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

__device__ __forceinline__ Moments shfl_down(const Moments& a, int off) {
  Moments b;
  b.c = __shfl_down_sync(kFull, a.c, off);
#pragma unroll
  for (int k = 0; k < 4; ++k) b.m[k] = __shfl_down_sync(kFull, a.m[k], off);
#pragma unroll
  for (int i = 0; i < 10; ++i) b.q[i] = __shfl_down_sync(kFull, a.q[i], off);
  return b;
}

// Partial (count, mean, centred co-moments) of one row block per feature,
// about the shift; work is [15, d, nrb] (count, mean 0..3, M2 in cov order)
// followed by the shifts [4, d], which row block 0 writes.
__global__ void __launch_bounds__(kThreads)
wbn_stats_partial_kernel(const float* __restrict__ x,
                         const uint8_t* __restrict__ mask,
                         float* __restrict__ work, int64_t n, int64_t d,
                         int64_t nrb) {
  __shared__ float sm[10][kGroups][kCols];
  __shared__ int first_live;
  const int lane = threadIdx.x % kCols;
  const int rg = threadIdx.x / kCols;
  const int64_t f = static_cast<int64_t>(blockIdx.x) * kCols + lane;
  const int64_t b = blockIdx.y;
  const int64_t r0 = b * kRows;
  const int64_t r1 = r0 + kRows < n ? r0 + kRows : n;
  const int64_t dd = 4 * d;
  const bool live = f < d;

  // the first live row, whose values are the shift (0 without one); a
  // thread stops at its first live row, so this reads little of the mask
  if (threadIdx.x == 0) first_live = static_cast<int>(n);
  __syncthreads();
  for (int64_t r = threadIdx.x; r < n; r += kThreads) {
    if (mask[r]) {
      atomicMin(&first_live, static_cast<int>(r));
      break;
    }
  }
  __syncthreads();
  const int64_t rs = first_live;
  float shift[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    shift[c] = live && rs < n ? x[rs * dd + c * d + f] : 0.0f;
  }
  if (b == 0 && rg == 0 && live) {
#pragma unroll
    for (int c = 0; c < 4; ++c) work[(15 * nrb + c) * d + f] = shift[c];
  }

  // loads are not behind the mask's branch, so that several rows are in
  // flight at once; a masked row adds an exact 0
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float k = 0.0f;
  for (int64_t r = r0 + rg; r < r1; r += kGroups) {
    const bool m = mask[r];
    k += m ? 1.0f : 0.0f;
    if (live) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float v = x[r * dd + c * d + f] - shift[c];
        s[c] += m ? v : 0.0f;
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) sm[c][rg][lane] = s[c];
  sm[4][rg][lane] = k;
  __syncthreads();
  float cb = 0.0f, tot[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int i = 0; i < kGroups; ++i) {
    cb += sm[4][i][lane];
#pragma unroll
    for (int c = 0; c < 4; ++c) tot[c] += sm[c][i][lane];
  }
  float mean[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) mean[c] = tot[c] / fmaxf(cb, 1.0f);
  __syncthreads();  // sm is reused below

  float q[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) q[i] = 0.0f;
  if (live) {
    for (int64_t r = r0 + rg; r < r1; r += kGroups) {
      const bool m = mask[r];
      float u[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float v = (x[r * dd + c * d + f] - shift[c]) - mean[c];
        u[c] = m ? v : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int kk = j; kk < 4; ++kk) q[cov_at(j, kk)] += u[j] * u[kk];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 10; ++i) sm[i][rg][lane] = q[i];
  __syncthreads();
  if (!live) return;  // no barrier follows
  if (rg == 0) {
    work[(0 * d + f) * nrb + b] = cb;
#pragma unroll
    for (int c = 0; c < 4; ++c) work[((1 + c) * d + f) * nrb + b] = mean[c];
  }
  for (int i = rg; i < 10; i += kGroups) {
    float v = 0.0f;
    for (int j = 0; j < kGroups; ++j) v += sm[i][j][lane];
    work[((5 + i) * d + f) * nrb + b] = v;
  }
}

// Combine of J's partials, one warp per feature, and its epilogue: mean
// (the shift restored; 0 without a live row), cov = M2 / cnt (both
// triangles), L = chol(cov + eps I), cnt.
__global__ void __launch_bounds__(kCombineWarps * 32)
wbn_stats_combine_kernel(const float* __restrict__ work, float eps,
                         float* __restrict__ mean_out,
                         float* __restrict__ cov_out, float* __restrict__ l_out,
                         float* __restrict__ cnt_out, int64_t d, int64_t nrb) {
  const int lane = threadIdx.x % 32;
  const int64_t f = static_cast<int64_t>(blockIdx.x) * kCombineWarps +
                    threadIdx.x / 32;
  if (f >= d) return;  // the whole warp: f is the warp's
  Moments acc;
  acc.c = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) acc.m[k] = 0.0f;
#pragma unroll
  for (int i = 0; i < 10; ++i) acc.q[i] = 0.0f;
  for (int64_t b = lane; b < nrb; b += 32) {
    Moments p;
    p.c = work[(0 * d + f) * nrb + b];
#pragma unroll
    for (int k = 0; k < 4; ++k) p.m[k] = work[((1 + k) * d + f) * nrb + b];
#pragma unroll
    for (int i = 0; i < 10; ++i) p.q[i] = work[((5 + i) * d + f) * nrb + b];
    chan_merge(acc, p);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const Moments other = shfl_down(acc, off);
    chan_merge(acc, other);  // lanes past 31 - off merge junk nobody reads
  }
  if (lane != 0) return;
  const float cnt = fmaxf(acc.c, 1.0f);
  float cov[10], l[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) cov[i] = acc.q[i] / cnt;
  cholesky(cov, eps, l);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    mean_out[k * d + f] =
        acc.c > 0.0f ? work[(15 * nrb + k) * d + f] + acc.m[k] : 0.0f;
  }
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

__global__ void __launch_bounds__(kThreads)
wbn_transform_kernel(const float* __restrict__ x,
                     const float* __restrict__ mean,
                     const float* __restrict__ lf,
                     const float* __restrict__ gamma,
                     const float* __restrict__ beta, float* __restrict__ y,
                     int64_t n, int64_t d) {
  const int lane = threadIdx.x % kCols;
  const int rg = threadIdx.x / kCols;
  const int64_t f = static_cast<int64_t>(blockIdx.x) * kCols + lane;
  if (f >= d) return;  // no barrier in this kernel
  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * kRows;
  const int64_t r1 = r0 + kRows < n ? r0 + kRows : n;
  const int64_t dd = 4 * d;
  float mu[4], l[10], il[4], gam[16], bet[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    mu[c] = mean[c * d + f];
    bet[c] = beta[c * d + f];
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) gam[i] = gamma[i * d + f];
  load_factor(lf, f, d, l, il);
  for (int64_t r = r0 + rg; r < r1; r += kGroups) {
    float u[4], z[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) u[c] = x[r * dd + c * d + f] - mu[c];
    fwd_subst(l, il, u, z);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float acc = gam[c * 4] * z[0];
#pragma unroll
      for (int k = 1; k < 4; ++k) acc += gam[c * 4 + k] * z[k];
      y[r * dd + c * d + f] = acc + bet[c];
    }
  }
}

// ----------------------------------------------------------------- L

__host__ __device__ constexpr int sums_of(bool frozen) {
  return frozen ? kFrozenSums : kSums;
}

// Partial sums of one row block per feature over ALL rows; work is
// [sums_of(kFrozen), d, nrb].
template <bool kFrozen>
__global__ void __launch_bounds__(kThreads)
wbn_bwd_sums_partial_kernel(const float* __restrict__ x,
                            const float* __restrict__ g,
                            const float* __restrict__ mean,
                            const float* __restrict__ lf,
                            const float* __restrict__ gamma,
                            float* __restrict__ work, int64_t n, int64_t d,
                            int64_t nrb) {
  constexpr int kN = sums_of(kFrozen);
  __shared__ float sm[kN][kGroups][kCols];  // 34,816 bytes, or 20,480 frozen
  const int lane = threadIdx.x % kCols;
  const int rg = threadIdx.x / kCols;
  const int64_t f = static_cast<int64_t>(blockIdx.x) * kCols + lane;
  const int64_t b = blockIdx.y;
  const int64_t r0 = b * kRows;
  const int64_t r1 = r0 + kRows < n ? r0 + kRows : n;
  const int64_t dd = 4 * d;
  const bool live = f < d;

  float acc[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) acc[i] = 0.0f;
  if (live) {
    float mu[4], l[10], il[4], gam[16];
#pragma unroll
    for (int c = 0; c < 4; ++c) mu[c] = mean[c * d + f];
#pragma unroll
    for (int i = 0; i < 16; ++i) gam[i] = gamma[i * d + f];
    load_factor(lf, f, d, l, il);
    for (int64_t r = r0 + rg; r < r1; r += kGroups) {
      float u[4], z[4], gv[4], h[4], w[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        u[c] = x[r * dd + c * d + f] - mu[c];
        gv[c] = g[r * dd + c * d + f];
      }
      fwd_subst(l, il, u, z);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[c] += gv[c];
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[4 + c * 4 + k] += gv[c] * z[k];
      }
      if constexpr (!kFrozen) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float hk = gam[k] * gv[0];
#pragma unroll
          for (int c = 1; c < 4; ++c) hk += gam[c * 4 + k] * gv[c];
          h[k] = hk;
        }
        bwd_subst(l, il, h, w);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int k = 0; k <= j; ++k) acc[20 + l_at(j, k)] += w[j] * z[k];
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[30 + k] += w[k];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kN; ++i) sm[i][rg][lane] = acc[i];
  __syncthreads();
  if (!live) return;  // no barrier follows
  for (int qi = rg; qi < kN; qi += kGroups) {
    float v = 0.0f;
    for (int i = 0; i < kGroups; ++i) v += sm[qi][i][lane];
    work[(qi * d + f) * nrb + b] = v;
  }
}

// Sum of L's partials, one warp per feature, and the T/S/M epilogue:
// dGamma, dbeta, M = L^{-T} S L^{-1} from Lbar = -sum w z^T, and sum w;
// frozen, dGamma and dbeta alone (mmat and sw are not written).
template <bool kFrozen>
__global__ void __launch_bounds__(kCombineWarps * 32)
wbn_bwd_sums_combine_kernel(const float* __restrict__ work,
                            const float* __restrict__ lf,
                            float* __restrict__ dgamma,
                            float* __restrict__ dbeta,
                            float* __restrict__ mmat, float* __restrict__ sw,
                            int64_t d, int64_t nrb) {
  const int lane = threadIdx.x % 32;
  const int64_t f = static_cast<int64_t>(blockIdx.x) * kCombineWarps +
                    threadIdx.x / 32;
  if (f >= d) return;  // the whole warp: f is the warp's
  constexpr int kN = sums_of(kFrozen);
  float acc[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) acc[i] = 0.0f;
  for (int64_t b = lane; b < nrb; b += 32) {
#pragma unroll
    for (int i = 0; i < kN; ++i) acc[i] += work[(i * d + f) * nrb + b];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      acc[i] += __shfl_down_sync(kFull, acc[i], off);
    }
  }
  if (lane != 0) return;
  if constexpr (kFrozen) {
#pragma unroll
    for (int c = 0; c < 4; ++c) dbeta[c * d + f] = acc[c];
#pragma unroll
    for (int i = 0; i < 16; ++i) dgamma[i * d + f] = acc[4 + i];
  } else {
    float l[10], il[4], lbar[10], m[16];
    load_factor(lf, f, d, l, il);
#pragma unroll
    for (int i = 0; i < 10; ++i) lbar[i] = -acc[20 + i];
    m_from_lbar(l, il, lbar, m);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      dbeta[c * d + f] = acc[c];
      sw[c * d + f] = acc[30 + c];
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      dgamma[i * d + f] = acc[4 + i];
      mmat[i * d + f] = m[i];
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

// ----------------------------------------------------------------- eval

__global__ void wbn_cholesky_kernel(const float* __restrict__ cov, float eps,
                                    float* __restrict__ lf, int64_t d) {
  const int64_t f = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (f >= d) return;
  float c[10], l[10];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int k = j; k < 4; ++k) c[cov_at(j, k)] = cov[(j * 4 + k) * d + f];
  }
  cholesky(c, eps, l);
#pragma unroll
  for (int i = 0; i < 10; ++i) lf[i * d + f] = l[i];
}

int64_t row_blocks(int64_t n) { return (n + kRows - 1) / kRows; }

dim3 tile_grid(int64_t n, int64_t d) {
  return dim3(static_cast<unsigned>((d + kCols - 1) / kCols),
              static_cast<unsigned>(row_blocks(n)));
}

unsigned combine_blocks(int64_t d) {
  return static_cast<unsigned>((d + kCombineWarps - 1) / kCombineWarps);
}

}  // namespace

// Rows per row block: the partial workspaces have ceil(n / rows) row blocks.
extern "C" int64_t wbn_block_rows() { return kRows; }

// work: (15 * ceil(n / wbn_block_rows()) + 4) * d floats of scratch.
extern "C" int wbn_stats_f32(const void* x, const void* mask, float eps,
                             void* work, void* mean, void* cov, void* l,
                             void* cnt, int64_t n, int64_t d, void* stream) {
  const int64_t nrb = row_blocks(n);
  if (nrb > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d > 0) {
    if (nrb > 0) {
      wbn_stats_partial_kernel<<<tile_grid(n, d), kThreads, 0, s>>>(
          static_cast<const float*>(x), static_cast<const uint8_t*>(mask),
          static_cast<float*>(work), n, d, nrb);
    }
    wbn_stats_combine_kernel<<<combine_blocks(d), kCombineWarps * 32, 0, s>>>(
        static_cast<const float*>(work), eps, static_cast<float*>(mean),
        static_cast<float*>(cov), static_cast<float*>(l),
        static_cast<float*>(cnt), d, nrb);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wbn_transform_f32(const void* x, const void* mean,
                                 const void* l, const void* gamma,
                                 const void* beta, void* y, int64_t n,
                                 int64_t d, void* stream) {
  if (row_blocks(n) > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0 && d > 0) {
    wbn_transform_kernel<<<tile_grid(n, d), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(mean),
        static_cast<const float*>(l), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), static_cast<float*>(y), n, d);
  }
  return static_cast<int>(cudaGetLastError());
}

// work: [34, d, ceil(n / wbn_block_rows())] floats of scratch.
extern "C" int wbn_bwd_sums_f32(const void* x, const void* g, const void* mean,
                                const void* l, const void* gamma, void* work,
                                void* dgamma, void* dbeta, void* mmat, void* sw,
                                int64_t n, int64_t d, void* stream) {
  const int64_t nrb = row_blocks(n);
  if (nrb > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d > 0) {
    if (nrb > 0) {
      wbn_bwd_sums_partial_kernel<false><<<tile_grid(n, d), kThreads, 0, s>>>(
          static_cast<const float*>(x), static_cast<const float*>(g),
          static_cast<const float*>(mean), static_cast<const float*>(l),
          static_cast<const float*>(gamma), static_cast<float*>(work), n, d,
          nrb);
    }
    wbn_bwd_sums_combine_kernel<false><<<combine_blocks(d),
                                         kCombineWarps * 32, 0, s>>>(
        static_cast<const float*>(work), static_cast<const float*>(l),
        static_cast<float*>(dgamma), static_cast<float*>(dbeta),
        static_cast<float*>(mmat), static_cast<float*>(sw), d, nrb);
  }
  return static_cast<int>(cudaGetLastError());
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

extern "C" int wbn_cholesky_f32(const void* cov, float eps, void* l, int64_t d,
                                void* stream) {
  if (d > 0) {
    wbn_cholesky_kernel<<<static_cast<unsigned>((d + 127) / 128), 128, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(cov), eps, static_cast<float*>(l), d);
  }
  return static_cast<int>(cudaGetLastError());
}

// The eval path's backward, with the statistics fixed.  work: [20, d,
// ceil(n / wbn_block_rows())] floats of scratch.
extern "C" int wbn_bwd_sums_frozen_f32(const void* x, const void* g,
                                       const void* mean, const void* l,
                                       const void* gamma, void* work,
                                       void* dgamma, void* dbeta, int64_t n,
                                       int64_t d, void* stream) {
  const int64_t nrb = row_blocks(n);
  if (nrb > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d > 0) {
    if (nrb > 0) {
      wbn_bwd_sums_partial_kernel<true><<<tile_grid(n, d), kThreads, 0, s>>>(
          static_cast<const float*>(x), static_cast<const float*>(g),
          static_cast<const float*>(mean), static_cast<const float*>(l),
          static_cast<const float*>(gamma), static_cast<float*>(work), n, d,
          nrb);
    }
    wbn_bwd_sums_combine_kernel<true><<<combine_blocks(d),
                                        kCombineWarps * 32, 0, s>>>(
        static_cast<const float*>(work), static_cast<const float*>(l),
        static_cast<float*>(dgamma), static_cast<float*>(dbeta), nullptr,
        nullptr, d, nrb);
  }
  return static_cast<int>(cudaGetLastError());
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
