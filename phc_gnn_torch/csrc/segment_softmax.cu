// Segment softmax aggregation over receiver-sorted CSR segments (sm_90a).
//
// Replaces the two Pallas kernels of the softmax aggregation in
// phc_gnn_tpu/ops/stream_scan.py:
//   segment_logit_max_f32         <- _softmax_suffix_max_kernel (:415)
//   segment_softmax_aggregate_f32 <- _softmax_fused_kernel (:439) and its
//                                    eval variant _softmax_fused_kernel_nw
//                                    (:521), plus the XLA epilogue that
//                                    gathers at last_edge and divides
//                                    (:778-782); the training variant also
//                                    writes w and den_end (:780) for the
//                                    backward
//
// The TPU kernels scan a receiver-sorted edge stream block by block on a
// sequential grid, carrying partial maxima and sums between blocks.  Blocks
// of a GPU grid run in no order, so these kernels walk CSR segments
// instead: block n owns node n and reads rowptr[n]..rowptr[n+1]; its
// threads run over the D feature lanes, so every edge row is one coalesced
// read of D floats.  No carries, no scan gates, no reverse grid.
//
// Semantics (stream_scan.py :287, :467-477, :778-782):
//   logit_e  = mask_e ? beta * m_e : -2^100   (a power of two, exact in bf16)
//   segmax_n = max over the segment of logit_e (-2^100 if empty/all masked)
//   w_e      = mask_e ? exp(logit_e - segmax_n) : 0
//   den_n    = max(sum w_e, 1e-16)
//   out_n    = (sum w_e * m_e) / den_n   (0 for an empty or all-masked
//                                         segment)
// The padding run at the tail of the edge array lies outside every segment
// (rowptr[N] stops at the last real edge), exactly as build_scan_plan
// isolates it.
//
// Bound on an H100: both kernels move bytes and do a few flops per byte,
// so the floor is DRAM bandwidth.  At the flagship shapes (6,374 real edges
// x 200 lanes of f32, 4,096 nodes) the first reads ~5.1 MB and writes
// ~3.3 MB (~2.5 us at 3.35 TB/s), the second reads ~8.4 MB and writes
// ~3.3 MB (~3.5 us); the training variant adds w (~5.1 MB) and den
// (~3.3 MB) to the writes (~6.0 us).  The design reads each message row
// once per kernel with full-width coalesced loads and keeps the per-lane
// running max and sums in registers; at these sizes launch latency
// dominates either bound.
// beta is read from device memory so that no launch waits on the host.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -0x1p100f;  // -2^100

__global__ void segment_logit_max_kernel(const float* __restrict__ msgs,
                                         const uint8_t* __restrict__ mask,
                                         const float* __restrict__ beta_ptr,
                                         const int32_t* __restrict__ rowptr,
                                         float* __restrict__ segmax,
                                         int64_t d) {
  const int64_t n = blockIdx.x;
  const float beta = *beta_ptr;
  const int32_t lo = rowptr[n];
  const int32_t hi = rowptr[n + 1];
  for (int64_t j = threadIdx.x; j < d; j += blockDim.x) {
    float acc = kNeg;
    for (int32_t e = lo; e < hi; ++e) {
      if (mask[e]) acc = fmaxf(acc, beta * msgs[e * d + j]);
    }
    segmax[n * d + j] = acc;
  }
}

__global__ void segment_softmax_aggregate_kernel(
    const float* __restrict__ msgs, const uint8_t* __restrict__ mask,
    const float* __restrict__ beta_ptr, const int32_t* __restrict__ rowptr,
    const float* __restrict__ segmax, float* __restrict__ out,
    float* __restrict__ w_out, float* __restrict__ den_out, int64_t d) {
  const int64_t n = blockIdx.x;
  const float beta = *beta_ptr;
  const int32_t lo = rowptr[n];
  const int32_t hi = rowptr[n + 1];
  for (int64_t j = threadIdx.x; j < d; j += blockDim.x) {
    const float smax = segmax[n * d + j];
    float num = 0.0f;
    float den = 0.0f;
    for (int32_t e = lo; e < hi; ++e) {
      const float m = msgs[e * d + j];
      const float w = mask[e] ? expf(beta * m - smax) : 0.0f;
      num += w * m;
      den += w;
      if (w_out != nullptr) w_out[e * d + j] = w;
    }
    den = fmaxf(den, 1e-16f);
    out[n * d + j] = num / den;
    if (den_out != nullptr) den_out[n * d + j] = den;
  }
}

int threads_for(int64_t d) {
  int64_t t = ((d + 31) / 32) * 32;
  return static_cast<int>(t < 32 ? 32 : (t > 1024 ? 1024 : t));
}

}  // namespace

extern "C" int segment_logit_max_f32(const void* msgs, const void* mask,
                                     const void* beta, const void* rowptr,
                                     void* segmax, int64_t num_nodes,
                                     int64_t d, void* stream) {
  if (num_nodes > 0 && d > 0) {
    segment_logit_max_kernel<<<static_cast<unsigned>(num_nodes),
                               threads_for(d), 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(msgs), static_cast<const uint8_t*>(mask),
        static_cast<const float*>(beta), static_cast<const int32_t*>(rowptr),
        static_cast<float*>(segmax), d);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int segment_softmax_aggregate_f32(const void* msgs,
                                             const void* mask,
                                             const void* beta,
                                             const void* rowptr,
                                             const void* segmax, void* out,
                                             void* w_out, void* den_out,
                                             int64_t num_nodes,
                                             int64_t d, void* stream) {
  if (num_nodes > 0 && d > 0) {
    segment_softmax_aggregate_kernel<<<static_cast<unsigned>(num_nodes),
                                       threads_for(d), 0,
                                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(msgs), static_cast<const uint8_t*>(mask),
        static_cast<const float*>(beta), static_cast<const int32_t*>(rowptr),
        static_cast<const float*>(segmax), static_cast<float*>(out),
        static_cast<float*>(w_out), static_cast<float*>(den_out), d);
  }
  return static_cast<int>(cudaGetLastError());
}
