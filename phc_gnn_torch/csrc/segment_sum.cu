// Segment sum over a permuted CSR (sm_90a): the backward of the message
// gather x[senders].
//
// Replaces the Pallas kernel _scan_kernel with op="add"
// (phc_gnn_tpu/ops/stream_scan.py:373, called through _segmented_scan :572,
// pallas_call :590) as the gather backward _gather_sb_bwd (:854-867) uses
// it: g is permuted into sender order, scanned with segment gates and a carry
// between blocks, and each sender's total is read at its last edge.
//
// Semantics:  dx[n, j] = sum over e in [rowptr[n], rowptr[n+1]) of
//                        g[perm[e], j]
// with rowptr over the sender-sorted edges (graph/batch.py build_sender_csr):
// every masked edge sorts last and lies in no segment, so its cotangent never
// reaches dx; an empty segment gives 0.
//
// Design: block n owns sender n and its threads run over the D lanes, so
// each row of g is one coalesced read of D floats; the row is found through
// perm, which skips the permuted copy of g that the TPU form writes first.
// The sum stays in a register; no atomics, so the result is deterministic.
// The same kernel serves any CSR segment sum of rows (segment_sum_streamed
// and segment_mean_streamed over the receiver CSR, with perm the identity).
//
// Bound on an H100: bytes.  At the flagship shapes (6,374 real edges x 200
// lanes of f32, 4,096 senders) it reads 5.10 MB of g plus the plan (~42 KB)
// and writes 3.28 MB: ~8.4 MB, ~2.5 us at 3.35 TB/s.  Launch latency
// dominates at this size.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void segment_sum_perm_kernel(const float* __restrict__ g,
                                        const int32_t* __restrict__ perm,
                                        const int32_t* __restrict__ rowptr,
                                        float* __restrict__ out, int64_t d) {
  const int64_t n = blockIdx.x;
  const int32_t lo = rowptr[n];
  const int32_t hi = rowptr[n + 1];
  for (int64_t j = threadIdx.x; j < d; j += blockDim.x) {
    float acc = 0.0f;
    for (int32_t e = lo; e < hi; ++e) {
      acc += g[static_cast<int64_t>(perm[e]) * d + j];
    }
    out[n * d + j] = acc;
  }
}

int threads_for(int64_t d) {
  int64_t t = ((d + 31) / 32) * 32;
  return static_cast<int>(t < 32 ? 32 : (t > 1024 ? 1024 : t));
}

}  // namespace

extern "C" int segment_sum_perm_f32(const void* g, const void* perm,
                                    const void* rowptr, void* out,
                                    int64_t num_segments, int64_t d,
                                    void* stream) {
  if (num_segments > 0 && d > 0) {
    segment_sum_perm_kernel<<<static_cast<unsigned>(num_segments),
                              threads_for(d), 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(g), static_cast<const int32_t*>(perm),
        static_cast<const int32_t*>(rowptr), static_cast<float*>(out), d);
  }
  return static_cast<int>(cudaGetLastError());
}
