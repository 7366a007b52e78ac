// Masked batch norm in training mode, forward and backward (sm_90a).
//
// Replaces the four Pallas kernels of phc_gnn_tpu/ops/fused_bn.py, two
// kernels each launched by one entry point on the plan it is given:
//   fused_bn_forward_f32   D <- _bn_fwd_kernel (:50, pallas_call :85), up to
//                             the size gate (nn/norm.py); past it
//                          F <- _bn_stats_blocked_kernel (:162, pallas_call
//                             :238) with the normalise JAX leaves to XLA
//                             (:282-286)
//   fused_bn_backward_f32  E <- _bn_bwd_kernel (:64, pallas_call :96)
//                          G <- _bn_bwd_sums_blocked_kernel (:202,
//                             pallas_call :259) with its dx (:295-302)
// The row-blocked pair computes the same function as D and E; the TPU needs
// it only for VMEM.  Here F and G are D's and E's kernels on the same plan,
// counted apart by their wrappers (ops/fused_bn.py).
//
// Semantics (fused_bn.py:11-22, :50-80), per column j of x [N, D] with the
// row mask m [N]:
//   cnt    = max(sum m, 1)
//   mean_j = sum m x_j / cnt
//   var_j  = sum m (x_j - mean_j)^2 / cnt       biased, and CENTRED: the
//            one-pass E[x^2] - E[x]^2 cancels in f32 (nn/norm.py:105-110)
//   y      = (x - mean) * rsqrt(var + eps) * scale + bias   on EVERY row
// and, with xhat = (x - mean) * r, r = rsqrt(var + eps), the cotangent g:
//   dbias  = sum g,  dscale = sum g * xhat      over ALL rows
//   dx     = scale * r * (g - m * (dbias + xhat * dscale) / cnt)
// where only the row's own mask gates the statistics term.  An all-masked
// input gives cnt = 1, mean = 0, var = 0: finite outputs.
//
// Design: one launch each, a grid of thread-block clusters.  The columns
// are cut into slabs of kSlab = 16 (64 bytes a row: a warp reads 8 rows of
// 64 bytes, whole sectors, 16 bytes a thread as float4; a width that is not
// a multiple of 4 takes 4-byte copies instead, and the ragged last slab is
// masked).  A cluster of 1-8 CTAs (portable sizes) owns one slab, and its
// CTA of rank r owns the contiguous rows [r * rows, min(N, (r + 1) * rows)).
// The TPU's row-blocked kernels walk a SEQUENTIAL grid of 512-row blocks
// with a VMEM carry; here the row blocks are a cluster's CTAs, which run at
// once and meet through distributed shared memory.  The launch plan (slab,
// cluster, rows per CTA, rows per chunk, dynamic shared memory) is computed
// in Python (ops/fused_bn.py::bn_plan) and checked here.
//
// x is read from device memory once.  Each CTA copies its rows of the slab
// into shared memory with cp.async (x for the forward; x and g for the
// backward), and the later passes read them there.  Where a CTA's rows do
// not fit in kTileBytes, the passes walk them in chunks and copy each chunk
// again (from L2 where it holds them): below the size gate only the
// narrowest shapes ([109375, 8]) do; past it the forward past 3,150 rows a
// CTA and the backward past 1,587 (at d = 512 from [16384, 512] and
// [8192, 512] on).  The rows' mask bytes are
// copied beside the tile, and the per-column parameters are loaded first,
// so a launch waits on device memory once before its passes; one barrier
// after the copy makes the tile whole.
//
// Reductions, in a fixed order: a thread reduces its rows; the 8 lanes of a
// column quad meet by warp shuffles; the 8 warps meet through shared
// memory, a thread per (column, warp) and shuffles between them.  Each CTA
// then writes its per-column partials into every rank's shared memory,
// its own slot of each (remote stores through cluster.map_shared_rank),
// and after one cluster barrier every thread combines the ranks' partials
// of its own 4 columns from its CTA's shared memory, in rank order.  So
// every thread of a cluster holds bit-identical totals for a column, and
// two launches on one input give bit-equal outputs: no float atomics, no
// workspace, no second kernel.  A cluster of 1 has no cluster barrier.
//   Forward: per thread, in one sweep of the tile (Welford), the count c,
//   the mean of x - s about the CTA's shift s (x at its first live row, 0
//   without one) and the centred M2 about that mean, merged over the CTA
//   with Chan's formula (the Pallas kernel's combine, fused_bn.py:184-192);
//   then, over the ranks in order, with K the shift of the first rank with
//   a live row and e_q = (s_q - K) + mean_q:
//     corr = sum c_q e_q / cnt,  var = sum [M2_q + c_q (e_q - corr)^2] / cnt,
//   mean = K + corr and y = ((x - K) - corr) * r * scale + bias from the
//   tile.  The shift keeps every sum at the size of the deviations where a
//   column sits far from 0 (offset 1e3, std 0.1), so f32 keeps their
//   digits; every term of M2 is >= 0.
//   Backward: per thread sum g, sum g * xhat and the count, the same
//   shuffles and one exchange, then dx from the tile.
// Every CTA arrives at a first cluster barrier as it starts and waits on it
// before its first remote store, so none writes into a CTA that has not
// started; after the exchange barrier no CTA touches another's shared
// memory, so each exits when it is done.
//
// Grids: at [4096, 200] 13 slabs (8 columns live in the last) x a cluster
// of 8 = 104 CTAs of 256 threads, 512 rows each: a 32 KB tile for D, 64 KB
// for E.  A cluster grows only while each CTA keeps 256 rows, so a head's
// 129 rows take clusters of 1: at [129, 768] 48 CTAs, at [129, 100] 7, each
// of 129 rows, with no cluster barrier.  At pcba's [4096, 512] (F and G)
// 32 slabs x clusters of 5 = 160 CTAs of 820 rows, a 53 KB tile for F,
// 106 KB for G: two CTAs an SM, so every cluster is resident at once.
//
// Bound on an H100: bytes.  At [4096, 200] f32 the forward reads x (3.28 MB)
// and the mask and writes y (3.28 MB): ~6.56 MB, ~1.96 us at 3.35 TB/s; the
// backward reads x and g and writes dx: ~9.84 MB, ~2.94 us.  At [4096, 512]
// (8.39 MB) the forward moves ~16.78 MB, ~5.01 us, the backward ~25.17 MB,
// ~7.51 us.
// At [4096, 512] the grid is 16 column tiles x 32 row blocks = 512 blocks of
// 256 threads: every one of the 132 SMs works (up to 8 such blocks each).
//
// Bounds on an H100 at [4096, 512] f32 (8.39 MB), at 3.35 TB/s: the stats
// read x once (8.39 MB, 2.50 us); the normalise reads x and writes y
// (16.78 MB, 5.01 us); the backward sums read x and g (16.78 MB, 5.01 us);
// dx reads x and g and writes dx (25.17 MB, 7.51 us).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace cg = cooperative_groups;

namespace {

constexpr int kSlab = 16;                  // columns a cluster owns
constexpr int kQuads = kSlab / 4;          // threads a row, 4 columns each
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowGroups = kThreads / kQuads;
constexpr int kMaxCluster = 8;
constexpr int kTileBytes = 200 * 1024;     // dynamic shared memory, at most
constexpr int kStaticBytes = 4096;         // ops/fused_bn.py::BN_STATIC_SMEM
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNoRow = 0xffffffffu;


// One CTA's partials, per column of its slab: what the other CTAs of its
// cluster read through distributed shared memory.
struct alignas(16) Partials {
  float shift[kSlab];     // forward: x at the CTA's first live row
  float a[kSlab];         // forward: the mean of x - shift; backward: sum g
  float b[kSlab];         // forward: M2 about that mean; backward: sum g xhat
  float cnt;              // live rows
};

// This thread's 4 columns of one of a rank's per-column arrays.
__device__ __forceinline__ float4 quad_of(const float* arr, int quad) {
  return reinterpret_cast<const float4*>(arr)[quad];
}

struct Exchange {
  float warp_cnt[kWarps];           // per-warp partials
  float warp[kWarps][2][kSlab];
  unsigned first[kWarps];           // per-warp first live row
  float shift[kSlab];               // this CTA's shift (the forward's)
  Partials rank[kMaxCluster];       // every rank's, each written by its rank
};
static_assert(sizeof(Exchange) <= kStaticBytes, "see BN_STATIC_SMEM");
static_assert(kSlab * kWarps <= kThreads && kWarps >= kMaxCluster,
              "a thread per (column, warp), and one of them per rank");

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The cluster barrier in two halves: every CTA arrives as it starts and
// waits just before it first writes another CTA's shared memory, by which
// time every CTA of the cluster has started.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Where this thread works: 4 columns from col, rows rg, rg + kRowGroups, ...
// of its CTA's rows [r0, r1) of the slab.
struct Place {
  int64_t col, r0, r1;
  int quad, rg;
  unsigned rank, ranks;
};

__device__ Place place(int64_t n, int rows) {
  const cg::cluster_group cluster = cg::this_cluster();
  Place p;
  p.rank = cluster.block_rank();
  p.ranks = cluster.num_blocks();
  p.quad = threadIdx.x % kQuads;
  p.rg = threadIdx.x / kQuads;
  p.col = static_cast<int64_t>(blockIdx.x / p.ranks) * kSlab + p.quad * 4;
  const int64_t r0 = static_cast<int64_t>(p.rank) * rows;
  p.r0 = r0 < n ? r0 : n;
  p.r1 = p.r0 + rows < n ? p.r0 + rows : n;
  return p;
}

// The tile of shared memory: kN planes of [chunk][kSlab] floats, then the
// chunk's mask bytes.
template <int kN>
__device__ __forceinline__ uint8_t* mask_of(float* tile, int chunk) {
  return reinterpret_cast<uint8_t*>(tile + kN * chunk * kSlab);
}

// Start copying rows [c0, c0 + rows) into the tile: this thread's 4 columns
// of each src (cp.async; columns past d are zero) and the mask bytes of rows
// threadIdx.x, + kThreads, ...  Returns the first live row among those, or
// kNoRow.  The caller waits (cp.async.wait_all) and syncs the CTA.
template <bool kVec, int kN>
__device__ unsigned stage(float* tile, const float* const (&src)[kN],
                          const uint8_t* __restrict__ mask, int64_t c0,
                          int rows, int chunk, int64_t d, const Place& p) {
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    float* plane = tile + k * chunk * kSlab;
    for (int r = p.rg; r < rows; r += kRowGroups) {
      float* dst = plane + r * kSlab + p.quad * 4;
      const float* s = src[k] + (c0 + r) * d + p.col;
      if (kVec) {
        if (p.col < d) {
          cp_async16(dst, s);
        } else {
          *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (p.col + j < d) {
            cp_async4(dst + j, s + j);
          } else {
            dst[j] = 0.0f;
          }
        }
      }
    }
  }
  uint8_t* smask = mask_of<kN>(tile, chunk);
  unsigned first = kNoRow;
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    const uint8_t m = mask[c0 + r];
    smask[r] = m;
    if (m && first == kNoRow) first = static_cast<unsigned>(r);
  }
  return first;
}

// f(row, live, v) for each of this thread's rows, v[k] its 4 columns of
// src[k] from the tile.  With `copy` (a CTA whose rows take more than one
// chunk), each chunk is copied in first; else the tile holds them all.
template <bool kVec, int kN, typename F>
__device__ void sweep(float* tile, const float* const (&src)[kN],
                      const uint8_t* __restrict__ mask, bool copy, int chunk,
                      int64_t d, const Place& p, F f) {
  const uint8_t* smask = mask_of<kN>(tile, chunk);
  for (int64_t c0 = p.r0; c0 < p.r1; c0 += chunk) {
    const int rows = static_cast<int>(p.r1 - c0 < chunk ? p.r1 - c0 : chunk);
    if (copy) {
      __syncthreads();  // every thread is done with the last chunk's mask
      stage<kVec, kN>(tile, src, mask, c0, rows, chunk, d, p);
      cp_async_wait_all();
      __syncthreads();
    }
    for (int r = p.rg; r < rows; r += kRowGroups) {
      float4 v[kN];
#pragma unroll
      for (int k = 0; k < kN; ++k) {
        v[k] = *reinterpret_cast<const float4*>(tile + k * chunk * kSlab +
                                                r * kSlab + p.quad * 4);
      }
      f(c0 + r, smask[r] != 0, v);
    }
  }
}

// Chan's merge of (c, m, m2) -- a count, the mean of the values about a
// common shift and their M2 about that mean -- with another such triple; a
// triple of count 0 adds nothing.  The weights take the fast reciprocal
// (__fdividef, 2 ulp): a few ulp in a mean of deviations, far inside the
// checks' 1e-5.
__device__ __forceinline__ void chan(float& c, float& m, float& m2, float oc,
                                     float om, float om2) {
  const float n = c + oc;
  const float f = n > 0.0f ? __fdividef(oc, n) : 0.0f;
  const float delta = om - m;
  m += delta * f;
  m2 += om2 + delta * delta * (c * f);
  c = n;
}

// The CTA's partials of column col, from the 8 lanes (column, w) that
// merged them: every lane takes lane w = 0's, bit for bit, and lane w
// writes them into rank w's shared memory, in this CTA's slot: one remote
// store each, before the cluster barrier that publishes them.
__device__ __forceinline__ void publish(cg::cluster_group& cluster,
                                        Exchange& ex, const Place& p, int col,
                                        int w, float cnt, float a, float b,
                                        float shift) {
  const int base = (threadIdx.x & 31) & ~(kWarps - 1);
  cnt = __shfl_sync(kFull, cnt, base);
  a = __shfl_sync(kFull, a, base);
  b = __shfl_sync(kFull, b, base);
  if (static_cast<unsigned>(w) < p.ranks) {
    Partials& slot = cluster.map_shared_rank(&ex, w)->rank[p.rank];
    slot.a[col] = a;
    slot.b[col] = b;
    slot.shift[col] = shift;
    if (col == 0) slot.cnt = cnt;
  }
}

// The CTA's (count, mean, M2) of each column, merged from its threads':
// warp shuffles over the 8 lanes of a column quad, then a thread per
// (column, warp) and shuffles over the warps, each merge in a fixed order.
// Published to every rank (publish).  Every thread calls it.
__device__ void cta_chan(cg::cluster_group& cluster, Exchange& ex,
                         const Place& p, float c, float (&m)[4],
                         float (&m2)[4]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = kQuads; off < 32; off <<= 1) {
    const float oc = __shfl_xor_sync(kFull, c, off);
    const float n = c + oc;
    const float f = n > 0.0f ? __fdividef(oc, n) : 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float om = __shfl_xor_sync(kFull, m[j], off);
      const float om2 = __shfl_xor_sync(kFull, m2[j], off);
      const float delta = om - m[j];
      m[j] += delta * f;
      m2[j] += om2 + delta * delta * (c * f);
    }
    c = n;
  }
  if (lane < kQuads) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ex.warp[warp][0][lane * 4 + j] = m[j];
      ex.warp[warp][1][lane * 4 + j] = m2[j];
    }
    if (lane == 0) ex.warp_cnt[warp] = c;
  }
  __syncthreads();
  if (p.ranks > 1) cluster_wait();
  const int t = threadIdx.x;
  if (t < kSlab * kWarps) {  // whole warps
    const int col = t / kWarps, w = t % kWarps;
    float cc = ex.warp_cnt[w], mm = ex.warp[w][0][col], mm2 = ex.warp[w][1][col];
#pragma unroll
    for (int off = 1; off < kWarps; off <<= 1) {
      const float oc = __shfl_xor_sync(kFull, cc, off);
      const float om = __shfl_xor_sync(kFull, mm, off);
      const float om2 = __shfl_xor_sync(kFull, mm2, off);
      chan(cc, mm, mm2, oc, om, om2);
    }
    publish(cluster, ex, p, col, w, cc, mm, mm2, ex.shift[col]);
  }
}

// The CTA's sums of two statistics per column and its count, in the same
// fixed order as cta_chan, published to every rank.
__device__ void cta_sums(cg::cluster_group& cluster, Exchange& ex,
                         const Place& p, float k, float (&a)[4],
                         float (&b)[4]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = kQuads; off < 32; off <<= 1) {
    k += __shfl_xor_sync(kFull, k, off);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a[j] += __shfl_xor_sync(kFull, a[j], off);
      b[j] += __shfl_xor_sync(kFull, b[j], off);
    }
  }
  if (lane < kQuads) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ex.warp[warp][0][lane * 4 + j] = a[j];
      ex.warp[warp][1][lane * 4 + j] = b[j];
    }
    if (lane == 0) ex.warp_cnt[warp] = k;
  }
  __syncthreads();
  if (p.ranks > 1) cluster_wait();
  const int t = threadIdx.x;
  if (t < kSlab * kWarps) {
    const int col = t / kWarps, w = t % kWarps;
    float kk = ex.warp_cnt[w], aa = ex.warp[w][0][col], bb = ex.warp[w][1][col];
#pragma unroll
    for (int off = 1; off < kWarps; off <<= 1) {
      kk += __shfl_xor_sync(kFull, kk, off);
      aa += __shfl_xor_sync(kFull, aa, off);
      bb += __shfl_xor_sync(kFull, bb, off);
    }
    publish(cluster, ex, p, col, w, kk, aa, bb, 0.0f);
  }
}

// Every rank's partials in ex.rank, once every CTA has written its own:
// one cluster barrier (a CTA barrier in a cluster of 1).  No CTA touches
// another's shared memory after it.
__device__ __forceinline__ void exchange(cg::cluster_group& cluster,
                                         unsigned ranks) {
  if (ranks > 1) {
    cluster.sync();
  } else {
    __syncthreads();
  }
}

__device__ __forceinline__ float comp(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// Streaming stores (st.global.cs): a slab's rows are 64-byte pieces 4 * d
// bytes apart, and default stores of that pattern ran at half the rate of
// contiguous ones on an H100, streaming ones at the same rate.
template <bool kVec>
__device__ __forceinline__ void store(float* __restrict__ out, int64_t row,
                                      int64_t d, const Place& p,
                                      const float (&o)[4]) {
  float* dst = out + row * d + p.col;
  if (kVec) {
    if (p.col < d) {
      __stcs(reinterpret_cast<float4*>(dst),
             make_float4(o[0], o[1], o[2], o[3]));
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (p.col + j < d) __stcs(dst + j, o[j]);
    }
  }
}

// Forward.  Per thread, then merged over the CTA by cta_chan: Welford's
// count c, mean of x - s about the CTA's shift s (x at its first live row)
// and M2 about that mean, in one sweep of the tile.  Across the cluster, in
// rank order, with K the shift of the first rank with a live row and
// e_q = (s_q - K) + mean_q:
//   corr = sum c_q e_q / cnt,  var = sum [M2_q + c_q (e_q - corr)^2] / cnt,
//   mean = K + corr.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
bn_forward_kernel(const float* __restrict__ x, const uint8_t* __restrict__ mask,
                  const float* __restrict__ scale,
                  const float* __restrict__ bias, float eps,
                  float* __restrict__ y, float* __restrict__ mean_out,
                  float* __restrict__ var_out, int64_t n, int64_t d, int rows,
                  int chunk) {
  extern __shared__ float4 dyn[];
  float* tile = reinterpret_cast<float*>(dyn);
  __shared__ Exchange ex;
  cg::cluster_group cluster = cg::this_cluster();
  const Place p = place(n, rows);
  if (p.ranks > 1) cluster_arrive_relaxed();
  const bool recopy = p.r1 - p.r0 > chunk;
  const float* const src[1] = {x};
  const int t = threadIdx.x;
  float sc[4], bi[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool in = p.col + j < d;
    sc[j] = in ? scale[p.col + j] : 0.0f;
    bi[j] = in ? bias[p.col + j] : 0.0f;
  }

  // the first chunk's copy in flight while the CTA looks for its first
  // live row; past the first chunk, in device memory
  const int rows0 = static_cast<int>(
      p.r1 - p.r0 < chunk ? p.r1 - p.r0 : chunk);
  unsigned first = stage<kVec, 1>(tile, src, mask, p.r0, rows0, chunk, d, p);
  if (first == kNoRow) {
    for (int64_t r = p.r0 + rows0 + t; r < p.r1; r += kThreads) {
      if (mask[r]) {
        first = static_cast<unsigned>(r - p.r0);
        break;
      }
    }
  }
  first = __reduce_min_sync(kFull, first);
  if ((t & 31) == 0) ex.first[t >> 5] = first;
  cp_async_wait_all();
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) first = min(first, ex.first[w]);
  float sh[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    sh[j] = first == kNoRow || p.col + j >= d ? 0.0f
            : first < static_cast<unsigned>(rows0)
                ? tile[first * kSlab + p.quad * 4 + j]
                : x[(p.r0 + first) * d + p.col + j];
  }
  if (p.rg == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) ex.shift[p.quad * 4 + j] = sh[j];
  }

  float c = 0.0f, m[4] = {0.f, 0.f, 0.f, 0.f}, m2[4] = {0.f, 0.f, 0.f, 0.f};
  sweep<kVec, 1>(tile, src, mask, recopy, chunk, d, p,
                 [&](int64_t, bool live, const float4* v) {
                   if (live) {
                     c += 1.0f;
                     const float f = __fdividef(1.0f, c);
#pragma unroll
                     for (int j = 0; j < 4; ++j) {
                       const float xs = comp(v[0], j) - sh[j];
                       const float e = xs - m[j];
                       m[j] += e * f;
                       m2[j] += e * (xs - m[j]);
                     }
                   }
                 });
  cta_chan(cluster, ex, p, c, m, m2);
  exchange(cluster, p.ranks);
  // every thread folds the ranks for its own 4 columns, as every other
  // thread of the cluster with those columns does, in rank order
  const Partials* pr = ex.rank;
  float4 K = make_float4(0.f, 0.f, 0.f, 0.f);
  for (unsigned q = 0; q < p.ranks; ++q) {
    if (pr[q].cnt > 0.0f) {
      K = quad_of(pr[q].shift, p.quad);
      break;
    }
  }
  float total[4] = {0.f, 0.f, 0.f, 0.f}, cc = 0.0f;
  for (unsigned q = 0; q < p.ranks; ++q) {
    const float cq = pr[q].cnt;
    const float4 s4 = quad_of(pr[q].shift, p.quad), a4 = quad_of(pr[q].a, p.quad);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      total[j] += cq * ((comp(s4, j) - comp(K, j)) + comp(a4, j));
    }
    cc += cq;
  }
  const float inv = __frcp_rn(fmaxf(cc, 1.0f));
  float corr[4], var[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 4; ++j) corr[j] = total[j] * inv;
  for (unsigned q = 0; q < p.ranks; ++q) {
    const float cq = pr[q].cnt;
    const float4 s4 = quad_of(pr[q].shift, p.quad), a4 = quad_of(pr[q].a, p.quad);
    const float4 b4 = quad_of(pr[q].b, p.quad);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float dev = ((comp(s4, j) - comp(K, j)) + comp(a4, j)) - corr[j];
      var[j] += comp(b4, j) + cq * (dev * dev);
    }
  }
  float a[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    var[j] *= inv;
    a[j] = rsqrtf(var[j] + eps) * sc[j];
  }
  sweep<kVec, 1>(tile, src, mask, recopy, chunk, d, p,
                 [&](int64_t row, bool, const float4* v) {
                   float o[4];
#pragma unroll
                   for (int j = 0; j < 4; ++j) {
                     o[j] = ((comp(v[0], j) - comp(K, j)) - corr[j]) * a[j] +
                            bi[j];
                   }
                   store<kVec>(y, row, d, p, o);
                 });
  if (p.rank == 0 && p.rg == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (p.col + j < d) {
        mean_out[p.col + j] = comp(K, j) + corr[j];
        var_out[p.col + j] = var[j];
      }
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
bn_backward_kernel(const float* __restrict__ x,
                   const uint8_t* __restrict__ mask,
                   const float* __restrict__ scale,
                   const float* __restrict__ mean_in,
                   const float* __restrict__ var_in, float eps,
                   const float* __restrict__ g, float* __restrict__ dx,
                   float* __restrict__ dscale, float* __restrict__ dbias,
                   int64_t n, int64_t d, int rows, int chunk) {
  extern __shared__ float4 dyn[];
  float* tile = reinterpret_cast<float*>(dyn);
  __shared__ Exchange ex;
  cg::cluster_group cluster = cg::this_cluster();
  const Place p = place(n, rows);
  if (p.ranks > 1) cluster_arrive_relaxed();
  const bool recopy = p.r1 - p.r0 > chunk;
  const float* const src[2] = {x, g};

  float mu[4], rs[4], a[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool in = p.col + j < d;
    mu[j] = in ? mean_in[p.col + j] : 0.0f;
    rs[j] = in ? rsqrtf(var_in[p.col + j] + eps) : 0.0f;
    a[j] = in ? scale[p.col + j] * rs[j] : 0.0f;
  }
  if (!recopy) {
    stage<kVec, 2>(tile, src, mask, p.r0, static_cast<int>(p.r1 - p.r0),
                   chunk, d, p);
    cp_async_wait_all();
    __syncthreads();
  }
  float sg[4] = {0.f, 0.f, 0.f, 0.f}, sgx[4] = {0.f, 0.f, 0.f, 0.f};
  float k = 0.0f;
  sweep<kVec, 2>(tile, src, mask, recopy, chunk, d, p,
                 [&](int64_t, bool live, const float4* v) {
#pragma unroll
                   for (int j = 0; j < 4; ++j) {
                     const float gv = comp(v[1], j);
                     sg[j] += gv;
                     sgx[j] += gv * ((comp(v[0], j) - mu[j]) * rs[j]);
                   }
                   k += live ? 1.0f : 0.0f;
                 });
  cta_sums(cluster, ex, p, k, sg, sgx);
  exchange(cluster, p.ranks);
  // every thread folds the ranks for its own 4 columns, in rank order
  const Partials* pr = ex.rank;
  float cc = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) sg[j] = sgx[j] = 0.0f;
  for (unsigned q = 0; q < p.ranks; ++q) {
    const float4 a4 = quad_of(pr[q].a, p.quad), b4 = quad_of(pr[q].b, p.quad);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      sg[j] += comp(a4, j);
      sgx[j] += comp(b4, j);
    }
    cc += pr[q].cnt;
  }
  const float inv_cnt = __frcp_rn(fmaxf(cc, 1.0f));
  sweep<kVec, 2>(tile, src, mask, recopy, chunk, d, p,
                 [&](int64_t row, bool live, const float4* v) {
                   float o[4];
#pragma unroll
                   for (int j = 0; j < 4; ++j) {
                     const float xhat = (comp(v[0], j) - mu[j]) * rs[j];
                     const float stats =
                         live ? (sg[j] + xhat * sgx[j]) * inv_cnt : 0.0f;
                     o[j] = a[j] * (comp(v[1], j) - stats);
                   }
                   store<kVec>(dx, row, d, p, o);
                 });
  if (p.rank == 0 && p.rg == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (p.col + j < d) {
        dscale[p.col + j] = sgx[j];
        dbias[p.col + j] = sg[j];
      }
    }
  }
}

// Dynamic shared memory past 48 KB must be allowed per kernel, on each
// device; done once.
cudaError_t allow_tiles() {
  static std::atomic<uint64_t> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = 1ull << (dev & 63);
  if (done.load() & bit) return cudaSuccess;
  const cudaFuncAttribute attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  if ((err = cudaFuncSetAttribute(bn_forward_kernel<true>, attr,
                                  kTileBytes)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(bn_forward_kernel<false>, attr,
                                  kTileBytes)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(bn_backward_kernel<true>, attr,
                                  kTileBytes)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(bn_backward_kernel<false>, attr,
                                  kTileBytes)) != cudaSuccess) {
    return err;
  }
  done.fetch_or(bit);
  return cudaSuccess;
}

// The plan of bn_plan, checked: the slab this file is built for, a portable
// cluster, rows that cover n, and a tile that fits: `tensors` planes of
// [chunk][kSlab] floats and the chunk's mask bytes, in 16-byte units.
bool plan_ok(int64_t n, int64_t d, int64_t slab_cols, int64_t cluster,
             int64_t rows, int64_t chunk, int64_t smem, int tensors) {
  return slab_cols == kSlab && cluster >= 1 && cluster <= kMaxCluster &&
         n >= 0 && n < (int64_t{1} << 31) && rows >= 0 &&
         rows * cluster >= n && chunk >= 1 && chunk <= (int64_t{1} << 30) &&
         smem == (chunk * (kSlab * 4 * tensors + 1) + 15) / 16 * 16 &&
         smem <= kTileBytes &&
         (d + kSlab - 1) / kSlab * cluster < (int64_t{1} << 31);
}

bool aligned(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), int64_t d, int64_t cluster,
                   int64_t smem, void* stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((d + kSlab - 1) / kSlab * cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// How many clusters of `cluster` CTAs with `smem` bytes of tile the card
// holds at once, for the forward (tensors 1) or the backward (2).
cudaError_t active_clusters(int64_t tensors, int64_t cluster, int64_t smem,
                            int* out) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const void* kernel =
      tensors == 1 ? reinterpret_cast<const void*>(bn_forward_kernel<true>)
                   : reinterpret_cast<const void*>(bn_backward_kernel<true>);
  return cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
}

}  // namespace

// The clusters of a plan (cluster, smem) that the card holds at once, for
// the forward (tensors 1) or the backward (2): a plan whose grid has more
// runs in waves.  A check of the plan; no launch path calls it.
extern "C" int bn_max_active_clusters(int64_t tensors, int64_t cluster,
                                      int64_t smem, int* out) {
  if (tensors < 1 || tensors > 2 || cluster < 1 || cluster > kMaxCluster ||
      smem < 0 || smem > kTileBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = allow_tiles();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(active_clusters(tensors, cluster, smem, out));
}

// The plan arguments (slab_cols, cluster, rows, chunk, smem) are those of
// ops/fused_bn.py::bn_plan(n, d, tensors) with tensors 1 for the forward
// and 2 for the backward; a plan this file cannot run returns
// cudaErrorInvalidValue and launches nothing.
extern "C" int fused_bn_forward_f32(const void* x, const void* mask,
                                    const void* scale, const void* bias,
                                    float eps, void* y, void* mean, void* var,
                                    int64_t n, int64_t d, int64_t slab_cols,
                                    int64_t cluster, int64_t rows,
                                    int64_t chunk, int64_t smem,
                                    void* stream) {
  if (!plan_ok(n, d, slab_cols, cluster, rows, chunk, smem, 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (d <= 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = allow_tiles();
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = d % 4 == 0 && aligned(x) && aligned(y);
  auto kernel = &bn_forward_kernel<true>;
  if (!vec) kernel = &bn_forward_kernel<false>;
  err = launch(kernel, d, cluster, smem, stream,
               static_cast<const float*>(x), static_cast<const uint8_t*>(mask),
               static_cast<const float*>(scale),
               static_cast<const float*>(bias), eps, static_cast<float*>(y),
               static_cast<float*>(mean), static_cast<float*>(var), n, d,
               static_cast<int>(rows), static_cast<int>(chunk));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

extern "C" int fused_bn_backward_f32(const void* x, const void* mask,
                                     const void* scale, const void* mean,
                                     const void* var, float eps, const void* g,
                                     void* dx, void* dscale, void* dbias,
                                     int64_t n, int64_t d, int64_t slab_cols,
                                     int64_t cluster, int64_t rows,
                                     int64_t chunk, int64_t smem,
                                     void* stream) {
  if (!plan_ok(n, d, slab_cols, cluster, rows, chunk, smem, 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (d <= 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = allow_tiles();
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = d % 4 == 0 && aligned(x) && aligned(g) && aligned(dx);
  auto kernel = &bn_backward_kernel<true>;
  if (!vec) kernel = &bn_backward_kernel<false>;
  err = launch(kernel, d, cluster, smem, stream,
               static_cast<const float*>(x), static_cast<const uint8_t*>(mask),
               static_cast<const float*>(scale),
               static_cast<const float*>(mean), static_cast<const float*>(var),
               eps, static_cast<const float*>(g), static_cast<float*>(dx),
               static_cast<float*>(dscale), static_cast<float*>(dbias), n, d,
               static_cast<int>(rows), static_cast<int>(chunk));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
