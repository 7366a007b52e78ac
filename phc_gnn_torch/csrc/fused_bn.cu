// Masked batch norm in training mode, forward and backward (sm_90a).
//
// Replaces the two single-block Pallas kernels of phc_gnn_tpu/ops/fused_bn.py:
//   fused_bn_forward_f32  <- _bn_fwd_kernel (:50, pallas_call :85)
//   fused_bn_backward_f32 <- _bn_bwd_kernel (:64, pallas_call :96)
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
// Design: per-column reductions over N rows.  Block b owns a tile of 8
// columns (32 bytes, one memory sector per row); its 1,024 threads are 8
// columns by 128 row groups, so one warp reads 4 rows x 8 columns, four full
// sectors, and each thread strides the rows by 128.  Partial sums meet in
// shared memory through a tree over the row groups.  The forward makes three
// passes over its tile (masked sum and count, centred squares, normalise and
// write), the backward two (the two sums, then dx); the passes after the
// first find the tile in L2.  At D = 200 the grid has 25 blocks, so a
// quarter of the card's 132 SMs work: a row-split grid with a second pass
// across blocks is later work.
//
// Bound on an H100: bytes.  At [4096, 200] f32 the forward reads x (3.28 MB)
// and the mask and writes y (3.28 MB): ~6.56 MB, ~1.96 us at 3.35 TB/s; the
// backward reads x and g and writes dx: ~9.83 MB, ~2.93 us.
//
// The row-blocked pair, for inputs past the single-block gate (nn/norm.py):
//   bn_stats_blocked_f32    <- _bn_stats_blocked_kernel (:162, pallas_call :238)
//   bn_bwd_sums_blocked_f32 <- _bn_bwd_sums_blocked_kernel (:202, pallas_call :259)
// with the two elementwise passes that JAX leaves to XLA (:282-286, :295-302)
// as kernels of their own:
//   bn_normalize_f32        y  = (x - mean) * rsqrt(var + eps) * scale + bias
//   bn_dx_f32               dx = scale * r * (g - m * (sum_g + xhat * sum_gx) / cnt)
//
// The TPU kernels walk a SEQUENTIAL grid of 512-row blocks with a VMEM carry.
// GPU blocks run in no order, so the grid here is row-split: block (c, b)
// owns a tile of 32 columns (128 bytes a row, one coalesced line per warp)
// and a block of 128 rows; its 256 threads are 32 columns by 8 row groups.
// Each block writes its partial (count, mean, M2) -- or (sum g, sum g*xhat)
// -- per column to a workspace [3 or 2, row blocks, D], and a second small
// kernel combines the partials of each column in row-block order, with Chan's
// formula for the statistics (fused_bn.py:184-192):
//   c' = c + c_b,  delta = mean_b - mean,  mean' = mean + delta * c_b / c',
//   M2' = M2 + M2_b + delta^2 * c * c_b / c'        (c' clamped to >= 1)
// so the result is deterministic, a row block with no live row is an exact
// no-op (c_b = 0), and no E[x^2] - E[x]^2 appears anywhere: each block's own
// M2_b is centred on its own mean in a second pass over its rows, which then
// come from L1/L2.  The ragged last row block simply has fewer rows.
// At [4096, 512] the grid is 16 column tiles x 32 row blocks = 512 blocks of
// 256 threads: every one of the 132 SMs works (up to 8 such blocks each).
//
// Bounds on an H100 at [4096, 512] f32 (8.39 MB), at 3.35 TB/s: the stats
// read x once (8.39 MB, 2.50 us); the normalise reads x and writes y
// (16.78 MB, 5.01 us); the backward sums read x and g (16.78 MB, 5.01 us);
// dx reads x and g and writes dx (25.17 MB, 7.51 us).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileCols = 8;
constexpr int kThreads = 1024;
constexpr int kRowGroups = kThreads / kTileCols;

constexpr int kBlkCols = 32;                     // row-blocked kernels
constexpr int kBlkGroups = 8;
constexpr int kBlkThreads = kBlkCols * kBlkGroups;
constexpr int kBlkRows = 128;
constexpr int kCombineThreads = 256;
constexpr int kCombineChunk = 8;
constexpr int kElemThreads = 256;

// Sum of v over the row groups of this thread's column, returned to every
// thread of the block; sm holds kThreads floats.
__device__ float column_sum(float v, float* sm) {
  const int t = threadIdx.x;
  sm[t] = v;
  __syncthreads();
  for (int s = kThreads / 2; s >= kTileCols; s >>= 1) {
    if (t < s) sm[t] += sm[t + s];
    __syncthreads();
  }
  const float total = sm[t % kTileCols];
  __syncthreads();  // sm is reused by the next reduction
  return total;
}

__global__ void __launch_bounds__(kThreads)
bn_forward_kernel(const float* __restrict__ x, const uint8_t* __restrict__ mask,
                  const float* __restrict__ scale,
                  const float* __restrict__ bias, float eps,
                  float* __restrict__ y, float* __restrict__ mean_out,
                  float* __restrict__ var_out, int64_t n, int64_t d) {
  __shared__ float sm[kThreads];
  const int rg = threadIdx.x / kTileCols;
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kTileCols +
                      threadIdx.x % kTileCols;
  const bool live = col < d;

  float s = 0.0f, k = 0.0f;
  if (live) {
#pragma unroll 4
    for (int64_t r = rg; r < n; r += kRowGroups) {
      if (mask[r]) {
        s += x[r * d + col];
        k += 1.0f;
      }
    }
  }
  const float cnt = fmaxf(column_sum(k, sm), 1.0f);
  const float mean = column_sum(s, sm) / cnt;

  float q = 0.0f;
  if (live) {
#pragma unroll 4
    for (int64_t r = rg; r < n; r += kRowGroups) {
      if (mask[r]) {
        const float c = x[r * d + col] - mean;
        q += c * c;
      }
    }
  }
  const float var = column_sum(q, sm) / cnt;
  if (!live) return;  // no barrier follows

  const float rs = rsqrtf(var + eps);
  const float sc = scale[col];
  const float b = bias[col];
#pragma unroll 4
  for (int64_t r = rg; r < n; r += kRowGroups) {
    y[r * d + col] = (x[r * d + col] - mean) * rs * sc + b;
  }
  if (rg == 0) {
    mean_out[col] = mean;
    var_out[col] = var;
  }
}

__global__ void __launch_bounds__(kThreads)
bn_backward_kernel(const float* __restrict__ x,
                   const uint8_t* __restrict__ mask,
                   const float* __restrict__ scale,
                   const float* __restrict__ mean_in,
                   const float* __restrict__ var_in, float eps,
                   const float* __restrict__ g, float* __restrict__ dx,
                   float* __restrict__ dscale, float* __restrict__ dbias,
                   int64_t n, int64_t d) {
  __shared__ float sm[kThreads];
  const int rg = threadIdx.x / kTileCols;
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kTileCols +
                      threadIdx.x % kTileCols;
  const bool live = col < d;
  const float mean = live ? mean_in[col] : 0.0f;
  const float rs = live ? rsqrtf(var_in[col] + eps) : 0.0f;

  float sg = 0.0f, sgx = 0.0f, k = 0.0f;
  if (live) {
#pragma unroll 4
    for (int64_t r = rg; r < n; r += kRowGroups) {
      const float gv = g[r * d + col];
      sg += gv;
      sgx += gv * ((x[r * d + col] - mean) * rs);
      k += mask[r] ? 1.0f : 0.0f;
    }
  }
  const float cnt = fmaxf(column_sum(k, sm), 1.0f);
  sg = column_sum(sg, sm);
  sgx = column_sum(sgx, sm);
  if (!live) return;  // no barrier follows

  if (rg == 0) {
    dscale[col] = sgx;
    dbias[col] = sg;
  }
  const float a = scale[col] * rs;
#pragma unroll 4
  for (int64_t r = rg; r < n; r += kRowGroups) {
    const float xhat = (x[r * d + col] - mean) * rs;
    const float stats = mask[r] ? (sg + xhat * sgx) / cnt : 0.0f;
    dx[r * d + col] = a * (g[r * d + col] - stats);
  }
}

unsigned blocks_for(int64_t d) {
  return static_cast<unsigned>((d + kTileCols - 1) / kTileCols);
}

// ------------------------------------------------------ row-blocked pair

// Partial (count, mean, M2) of the live rows of one row block, per column of
// one column tile; work is [3, nrb, d].
__global__ void __launch_bounds__(kBlkThreads)
bn_stats_partial_kernel(const float* __restrict__ x,
                        const uint8_t* __restrict__ mask,
                        float* __restrict__ work, int64_t n, int64_t d,
                        int64_t nrb) {
  __shared__ float s_val[kBlkGroups][kBlkCols];
  __shared__ float s_cnt[kBlkGroups];
  const int lane = threadIdx.x % kBlkCols;
  const int rg = threadIdx.x / kBlkCols;
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kBlkCols + lane;
  const int64_t b = blockIdx.y;
  const int64_t r0 = b * kBlkRows;
  const int64_t r1 = r0 + kBlkRows < n ? r0 + kBlkRows : n;
  const bool live = col < d;

  // loads are not behind the mask's branch, so that several rows are in
  // flight at once; a masked row adds an exact 0
  float s = 0.0f, k = 0.0f;
  if (live) {  // lane 0 is live in every tile, and it writes the count
#pragma unroll 4
    for (int64_t r = r0 + rg; r < r1; r += kBlkGroups) {
      const bool m = mask[r];
      const float v = x[r * d + col];
      s += m ? v : 0.0f;
      k += m ? 1.0f : 0.0f;
    }
  }
  s_val[rg][lane] = s;
  if (lane == 0) s_cnt[rg] = k;
  __syncthreads();
  float cb = 0.0f, total = 0.0f;
  for (int i = 0; i < kBlkGroups; ++i) {
    cb += s_cnt[i];
    total += s_val[i][lane];
  }
  const float mean_b = total / fmaxf(cb, 1.0f);
  __syncthreads();  // s_val is reused below

  float q = 0.0f;
  if (live) {
#pragma unroll 4
    for (int64_t r = r0 + rg; r < r1; r += kBlkGroups) {
      const bool m = mask[r];
      const float c = x[r * d + col] - mean_b;
      q += m ? c * c : 0.0f;
    }
  }
  s_val[rg][lane] = q;
  __syncthreads();
  if (rg == 0 && live) {
    float m2 = 0.0f;
    for (int i = 0; i < kBlkGroups; ++i) m2 += s_val[i][lane];
    work[(0 * nrb + b) * d + col] = cb;
    work[(1 * nrb + b) * d + col] = mean_b;
    work[(2 * nrb + b) * d + col] = m2;
  }
}

// Chan's combine of the partials of each column, in row-block order.  The
// partials of kCombineChunk row blocks are loaded into registers before they
// are combined, so that their loads are in flight together; a padding slot
// past the last row block holds c_b = 0, an exact no-op.
__global__ void bn_stats_combine_kernel(const float* __restrict__ work,
                                        float* __restrict__ mean_out,
                                        float* __restrict__ var_out,
                                        float* __restrict__ cnt_out,
                                        int64_t d, int64_t nrb) {
  const int64_t col = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (col >= d) return;
  float c = 0.0f, mean = 0.0f, m2 = 0.0f;
  for (int64_t b0 = 0; b0 < nrb; b0 += kCombineChunk) {
    float cbs[kCombineChunk], means[kCombineChunk], m2s[kCombineChunk];
#pragma unroll
    for (int i = 0; i < kCombineChunk; ++i) {
      const int64_t b = b0 + i;
      const bool in = b < nrb;
      cbs[i] = in ? work[(0 * nrb + b) * d + col] : 0.0f;
      means[i] = in ? work[(1 * nrb + b) * d + col] : 0.0f;
      m2s[i] = in ? work[(2 * nrb + b) * d + col] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kCombineChunk; ++i) {
      const float cb = cbs[i];
      const float c_new = c + cb;
      const float safe = fmaxf(c_new, 1.0f);
      const float delta = means[i] - mean;
      mean = mean + delta * (cb / safe);  // cb = 0: an exact no-op
      m2 = m2 + m2s[i] + delta * delta * (c * cb / safe);
      c = c_new;
    }
  }
  mean_out[col] = mean;
  var_out[col] = m2 / fmaxf(c, 1.0f);
  if (col == 0) cnt_out[0] = fmaxf(c, 1.0f);
}

// Partial sum g and sum g * xhat over ALL rows of one row block; work is
// [2, nrb, d].
__global__ void __launch_bounds__(kBlkThreads)
bn_bwd_sums_partial_kernel(const float* __restrict__ x,
                           const float* __restrict__ g,
                           const float* __restrict__ mean_in,
                           const float* __restrict__ var_in, float eps,
                           float* __restrict__ work, int64_t n, int64_t d,
                           int64_t nrb) {
  __shared__ float s_g[kBlkGroups][kBlkCols];
  __shared__ float s_gx[kBlkGroups][kBlkCols];
  const int lane = threadIdx.x % kBlkCols;
  const int rg = threadIdx.x / kBlkCols;
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kBlkCols + lane;
  const int64_t b = blockIdx.y;
  const int64_t r0 = b * kBlkRows;
  const int64_t r1 = r0 + kBlkRows < n ? r0 + kBlkRows : n;
  const bool live = col < d;

  float sg = 0.0f, sgx = 0.0f;
  if (live) {
    const float mean = mean_in[col];
    const float rs = rsqrtf(var_in[col] + eps);
    for (int64_t r = r0 + rg; r < r1; r += kBlkGroups) {
      const float gv = g[r * d + col];
      sg += gv;
      sgx += gv * ((x[r * d + col] - mean) * rs);
    }
  }
  s_g[rg][lane] = sg;
  s_gx[rg][lane] = sgx;
  __syncthreads();
  if (rg == 0 && live) {
    float a = 0.0f, c = 0.0f;
    for (int i = 0; i < kBlkGroups; ++i) {
      a += s_g[i][lane];
      c += s_gx[i][lane];
    }
    work[(0 * nrb + b) * d + col] = a;
    work[(1 * nrb + b) * d + col] = c;
  }
}

__global__ void bn_bwd_sums_combine_kernel(const float* __restrict__ work,
                                           float* __restrict__ sum_g,
                                           float* __restrict__ sum_gx,
                                           int64_t d, int64_t nrb) {
  const int64_t col = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (col >= d) return;
  float a = 0.0f, c = 0.0f;
  for (int64_t b0 = 0; b0 < nrb; b0 += kCombineChunk) {
    float as[kCombineChunk], cs[kCombineChunk];
#pragma unroll
    for (int i = 0; i < kCombineChunk; ++i) {
      const int64_t b = b0 + i;
      as[i] = b < nrb ? work[(0 * nrb + b) * d + col] : 0.0f;
      cs[i] = b < nrb ? work[(1 * nrb + b) * d + col] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kCombineChunk; ++i) {
      a += as[i];
      c += cs[i];
    }
  }
  sum_g[col] = a;
  sum_gx[col] = c;
}

__global__ void bn_normalize_kernel(const float* __restrict__ x,
                                    const float* __restrict__ mean,
                                    const float* __restrict__ var,
                                    const float* __restrict__ scale,
                                    const float* __restrict__ bias, float eps,
                                    float* __restrict__ y, int64_t total,
                                    int64_t d) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < total; i += stride) {
    const int64_t col = i % d;
    y[i] = (x[i] - mean[col]) * rsqrtf(var[col] + eps) * scale[col] +
           bias[col];
  }
}

__global__ void bn_dx_kernel(const float* __restrict__ x,
                             const uint8_t* __restrict__ mask,
                             const float* __restrict__ g,
                             const float* __restrict__ scale,
                             const float* __restrict__ mean,
                             const float* __restrict__ var, float eps,
                             const float* __restrict__ sum_g,
                             const float* __restrict__ sum_gx,
                             const float* __restrict__ cnt,
                             float* __restrict__ dx, int64_t total,
                             int64_t d) {
  const float count = cnt[0];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < total; i += stride) {
    const int64_t col = i % d;
    const float rs = rsqrtf(var[col] + eps);
    const float xhat = (x[i] - mean[col]) * rs;
    const float stats =
        mask[i / d] ? (sum_g[col] + xhat * sum_gx[col]) / count : 0.0f;
    dx[i] = scale[col] * rs * (g[i] - stats);
  }
}

int64_t row_blocks(int64_t n) { return (n + kBlkRows - 1) / kBlkRows; }

dim3 partial_grid(int64_t n, int64_t d) {
  return dim3(static_cast<unsigned>((d + kBlkCols - 1) / kBlkCols),
              static_cast<unsigned>(row_blocks(n)));
}

unsigned combine_blocks(int64_t d) {
  return static_cast<unsigned>((d + kCombineThreads - 1) / kCombineThreads);
}

unsigned elementwise_blocks(int64_t total) {
  const int64_t want = (total + kElemThreads - 1) / kElemThreads;
  return static_cast<unsigned>(want < 132 * 16 ? want : 132 * 16);
}

}  // namespace

extern "C" int fused_bn_forward_f32(const void* x, const void* mask,
                                    const void* scale, const void* bias,
                                    float eps, void* y, void* mean, void* var,
                                    int64_t n, int64_t d, void* stream) {
  if (d > 0) {
    bn_forward_kernel<<<blocks_for(d), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const uint8_t*>(mask),
        static_cast<const float*>(scale), static_cast<const float*>(bias), eps,
        static_cast<float*>(y), static_cast<float*>(mean),
        static_cast<float*>(var), n, d);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fused_bn_backward_f32(const void* x, const void* mask,
                                     const void* scale, const void* mean,
                                     const void* var, float eps, const void* g,
                                     void* dx, void* dscale, void* dbias,
                                     int64_t n, int64_t d, void* stream) {
  if (d > 0) {
    bn_backward_kernel<<<blocks_for(d), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const uint8_t*>(mask),
        static_cast<const float*>(scale), static_cast<const float*>(mean),
        static_cast<const float*>(var), eps, static_cast<const float*>(g),
        static_cast<float*>(dx), static_cast<float*>(dscale),
        static_cast<float*>(dbias), n, d);
  }
  return static_cast<int>(cudaGetLastError());
}

// Rows per row block of the blocked pair: the workspace has
// ceil(n / rows) row blocks.
extern "C" int64_t bn_blocked_rows() { return kBlkRows; }

// work: [3, ceil(n / bn_blocked_rows()), d] floats of scratch.
extern "C" int bn_stats_blocked_f32(const void* x, const void* mask,
                                    void* work, void* mean, void* var,
                                    void* cnt, int64_t n, int64_t d,
                                    void* stream) {
  const int64_t nrb = row_blocks(n);
  if (nrb > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d > 0) {
    if (nrb > 0) {
      bn_stats_partial_kernel<<<partial_grid(n, d), kBlkThreads, 0, s>>>(
          static_cast<const float*>(x), static_cast<const uint8_t*>(mask),
          static_cast<float*>(work), n, d, nrb);
    }
    bn_stats_combine_kernel<<<combine_blocks(d), kCombineThreads, 0, s>>>(
        static_cast<const float*>(work), static_cast<float*>(mean),
        static_cast<float*>(var), static_cast<float*>(cnt), d, nrb);
  }
  return static_cast<int>(cudaGetLastError());
}

// work: [2, ceil(n / bn_blocked_rows()), d] floats of scratch.
extern "C" int bn_bwd_sums_blocked_f32(const void* x, const void* g,
                                       const void* mean, const void* var,
                                       float eps, void* work, void* sum_g,
                                       void* sum_gx, int64_t n, int64_t d,
                                       void* stream) {
  const int64_t nrb = row_blocks(n);
  if (nrb > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d > 0) {
    if (nrb > 0) {
      bn_bwd_sums_partial_kernel<<<partial_grid(n, d), kBlkThreads, 0, s>>>(
          static_cast<const float*>(x), static_cast<const float*>(g),
          static_cast<const float*>(mean), static_cast<const float*>(var), eps,
          static_cast<float*>(work), n, d, nrb);
    }
    bn_bwd_sums_combine_kernel<<<combine_blocks(d), kCombineThreads, 0, s>>>(
        static_cast<const float*>(work), static_cast<float*>(sum_g),
        static_cast<float*>(sum_gx), d, nrb);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bn_normalize_f32(const void* x, const void* mean,
                                const void* var, const void* scale,
                                const void* bias, float eps, void* y,
                                int64_t n, int64_t d, void* stream) {
  const int64_t total = n * d;
  if (total > 0) {
    bn_normalize_kernel<<<elementwise_blocks(total), kElemThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(mean),
        static_cast<const float*>(var), static_cast<const float*>(scale),
        static_cast<const float*>(bias), eps, static_cast<float*>(y), total,
        d);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bn_dx_f32(const void* x, const void* mask, const void* g,
                         const void* scale, const void* mean, const void* var,
                         float eps, const void* sum_g, const void* sum_gx,
                         const void* cnt, void* dx, int64_t n, int64_t d,
                         void* stream) {
  const int64_t total = n * d;
  if (total > 0) {
    bn_dx_kernel<<<elementwise_blocks(total), kElemThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const uint8_t*>(mask),
        static_cast<const float*>(g), static_cast<const float*>(scale),
        static_cast<const float*>(mean), static_cast<const float*>(var), eps,
        static_cast<const float*>(sum_g), static_cast<const float*>(sum_gx),
        static_cast<const float*>(cnt), static_cast<float*>(dx), total, d);
  }
  return static_cast<int>(cudaGetLastError());
}
