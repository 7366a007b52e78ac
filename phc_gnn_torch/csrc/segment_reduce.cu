// Masked segment extremes and moments over a receiver CSR (sm_90a): kernels
// H and I.
//
// Replaces two Pallas kernels of phc_gnn_tpu/ops/stream_scan.py, which the TPU
// runs as segmented prefix scans with gates and a carry between blocks, each
// segment's result read at its last edge:
//
// 1. segment_extreme_f32 <- _scan_kernel with op="max" (H), called through
//    _segmented_scan_max :600 (pallas_call :618) by segment_max_streamed
//    :627 and _seg_extreme_streamed :1012: the max of the real edges of each
//    segment, or their min (JAX takes -max(-m)); 0 for a segment without a
//    real edge (JAX's test is that count, :1018-1021, :648-651);
// 2. segment_moments_f32 <- _scan_kernel_pair (I), called through
//    _segmented_scan_pair :656 (pallas_call :679) by _seg_var_parts :1079:
//    the joint segmented sums of m and m^2 over the real edges, and in the
//    epilogue JAX's XLA glue (:1088-1093): cnt = max(count, 1),
//    mean = s / cnt, var = s2 / cnt - mean * mean.
//
// Semantics:  over e in [rowptr[n], rowptr[n+1]) with mask[e],
//   extreme:  out[n, j] = max (or min) of msgs[e, j], 0 without such an e
//   moments:  mean[n, j] = sum msgs[e, j] / cnt[n]
//             var[n, j]  = sum msgs[e, j]^2 / cnt[n] - mean[n, j]^2
// with rowptr over the receiver-sorted edges (graph/batch.py
// build_csr_rowptr): the trailing padding run lies in no segment, but masked
// edges among real ones stay inside their segment, so both kernels read the
// mask, and the count of real edges is taken from it, not from rowptr.
//
// Design: the walk of kernel C (csrc/segment_sum.cu).  Block n owns segment
// n and its threads run over the D lanes, so each edge's row is one
// coalesced read of D floats; the running max, or the two running sums and
// the count, stay in registers, in edge order: no atomics, deterministic.
// The max starts from -inf and is exact for any finite input (JAX's masked
// rows carry -2^100 and its valid test is the count, which this matches); a
// NaN propagates as jnp.maximum's does.  The moments square, add, divide and
// subtract with the _rn intrinsics: nvcc would otherwise contract
// s2 + v * v and mu2 - mu * mu into FMAs, which round once where JAX's
// formula rounds twice; a one-edge segment then gives var = 0 exactly, as
// JAX's does, and not an FMA's rounding residue, which sqrt(relu(var) +
// 1e-5) would turn into a gradient of the other sign.
//
// Bound on an H100: bytes.  At the PNA path's shapes (6,374 real edges x 200
// lanes of f32, 4,096 receivers) each kernel reads 5.10 MB of msgs plus the
// mask and rowptr (~23 KB); H writes 3.28 MB (~8.4 MB, ~2.5 us at
// 3.35 TB/s), I writes mean and var, 6.55 MB (~11.7 MB, ~3.5 us).
// Arithmetic is 1 (H) or 4 (I) operations per (edge, lane): far under the
// 67 TFLOP/s of the CUDA cores.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

template <bool kMin>
__global__ void segment_extreme_kernel(const float* __restrict__ msgs,
                                       const uint8_t* __restrict__ mask,
                                       const int32_t* __restrict__ rowptr,
                                       float* __restrict__ out, int64_t d) {
  const int64_t n = blockIdx.x;
  const int32_t lo = rowptr[n];
  const int32_t hi = rowptr[n + 1];
  for (int64_t j = threadIdx.x; j < d; j += blockDim.x) {
    float acc = -INFINITY;
    bool any = false;
    for (int32_t e = lo; e < hi; ++e) {
      if (mask[e]) {
        const float v = kMin ? -msgs[static_cast<int64_t>(e) * d + j]
                             : msgs[static_cast<int64_t>(e) * d + j];
        if (v > acc || v != v) acc = v;  // once NaN, nothing is greater
        any = true;
      }
    }
    out[n * d + j] = any ? (kMin ? -acc : acc) : 0.0f;
  }
}

__global__ void segment_moments_kernel(const float* __restrict__ msgs,
                                       const uint8_t* __restrict__ mask,
                                       const int32_t* __restrict__ rowptr,
                                       float* __restrict__ mean,
                                       float* __restrict__ var, int64_t d) {
  const int64_t n = blockIdx.x;
  const int32_t lo = rowptr[n];
  const int32_t hi = rowptr[n + 1];
  for (int64_t j = threadIdx.x; j < d; j += blockDim.x) {
    float s = 0.0f, s2 = 0.0f, count = 0.0f;
    for (int32_t e = lo; e < hi; ++e) {
      if (mask[e]) {
        const float v = msgs[static_cast<int64_t>(e) * d + j];
        s = __fadd_rn(s, v);
        s2 = __fadd_rn(s2, __fmul_rn(v, v));
        count += 1.0f;
      }
    }
    const float cnt = fmaxf(count, 1.0f);
    const float mu = __fdiv_rn(s, cnt);
    const float mu2 = __fdiv_rn(s2, cnt);
    mean[n * d + j] = mu;
    var[n * d + j] = __fsub_rn(mu2, __fmul_rn(mu, mu));
  }
}

int threads_for(int64_t d) {
  int64_t t = ((d + 31) / 32) * 32;
  return static_cast<int>(t < 32 ? 32 : (t > 1024 ? 1024 : t));
}

}  // namespace

// minimum != 0: the min of each segment's real edges, else their max.
extern "C" int segment_extreme_f32(const void* msgs, const void* mask,
                                   const void* rowptr, void* out,
                                   int64_t num_segments, int64_t d,
                                   int minimum, void* stream) {
  if (num_segments > 0 && d > 0) {
    const dim3 grid(static_cast<unsigned>(num_segments));
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* m = static_cast<const float*>(msgs);
    const uint8_t* k = static_cast<const uint8_t*>(mask);
    const int32_t* rp = static_cast<const int32_t*>(rowptr);
    float* o = static_cast<float*>(out);
    if (minimum) {
      segment_extreme_kernel<true><<<grid, threads_for(d), 0, s>>>(m, k, rp, o,
                                                                   d);
    } else {
      segment_extreme_kernel<false><<<grid, threads_for(d), 0, s>>>(m, k, rp,
                                                                    o, d);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int segment_moments_f32(const void* msgs, const void* mask,
                                   const void* rowptr, void* mean, void* var,
                                   int64_t num_segments, int64_t d,
                                   void* stream) {
  if (num_segments > 0 && d > 0) {
    segment_moments_kernel<<<static_cast<unsigned>(num_segments),
                             threads_for(d), 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(msgs), static_cast<const uint8_t*>(mask),
        static_cast<const int32_t*>(rowptr), static_cast<float*>(mean),
        static_cast<float*>(var), d);
  }
  return static_cast<int>(cudaGetLastError());
}
