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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileCols = 8;
constexpr int kThreads = 1024;
constexpr int kRowGroups = kThreads / kTileCols;

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
