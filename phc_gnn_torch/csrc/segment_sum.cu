// Segment sums over a CSR (sm_90a), in kernel C's two roles.
//
// Replaces the Pallas kernel _scan_kernel with op="add"
// (phc_gnn_tpu/ops/stream_scan.py:373, called through _segmented_scan :572,
// pallas_call :590), which the TPU runs as a segmented prefix sum with gates
// and a carry between blocks, each segment's total read at its last edge:
//
// 1. segment_sum_perm_f32: the gather backward _gather_sb_bwd (:854-867),
//    over the sender-sorted CSR, the rows found through a permutation;
// 2. segment_sum_masked_f32: the forward of the sum aggregation
//    _seg_sum_streamed (:698-744), over the receiver CSR, masked edges
//    zeroed (:741-742).
//
// Semantics of 1:  dx[n, j] = sum over e in [rowptr[n], rowptr[n+1]) of
//                             g[perm[e], j]
// with rowptr over the sender-sorted edges (graph/batch.py build_sender_csr):
// every masked edge sorts last and lies in no segment, so its cotangent never
// reaches dx; an empty segment gives 0.
//
// Design: block n owns sender n and its threads run over the D lanes, so
// each row of g is one coalesced read of D floats; the row is found through
// perm, which skips the permuted copy of g that the TPU form writes first.
// The sum stays in a register; no atomics, so the result is deterministic.
//
// Semantics of 2:  out[n, j] = sum over e in [rowptr[n], rowptr[n+1]) with
//                              mask[e] of msgs[e, j]
// with rowptr over the receiver-sorted edges (graph/batch.py
// build_csr_rowptr): the trailing padding run lies in no segment, but masked
// edges among real ones stay inside their segment, so the kernel reads the
// mask.  The same walk as 1, without the permutation.
//
// Bound on an H100: bytes.  1 at the flagship shapes (6,374 real edges x 200
// lanes of f32, 4,096 senders) reads 5.10 MB of g plus the plan (~42 KB)
// and writes 3.28 MB: ~8.4 MB, ~2.5 us at 3.35 TB/s.  2 at the pcba shapes
// (6,442 real edges x 512 lanes, 4,096 receivers) reads 13.19 MB and writes
// 8.39 MB: ~21.6 MB, ~6.4 us.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// kPerm: the rows are g[perm[e]] and every edge of a segment counts (1);
// otherwise the rows are g[e] and only the edges whose mask holds (2).
template <bool kPerm>
__global__ void segment_sum_kernel(const float* __restrict__ g,
                                   const int32_t* __restrict__ perm,
                                   const uint8_t* __restrict__ mask,
                                   const int32_t* __restrict__ rowptr,
                                   float* __restrict__ out, int64_t d) {
  const int64_t n = blockIdx.x;
  const int32_t lo = rowptr[n];
  const int32_t hi = rowptr[n + 1];
  for (int64_t j = threadIdx.x; j < d; j += blockDim.x) {
    float acc = 0.0f;
    for (int32_t e = lo; e < hi; ++e) {
      if constexpr (kPerm) {
        acc += g[static_cast<int64_t>(perm[e]) * d + j];
      } else if (mask[e]) {
        acc += g[static_cast<int64_t>(e) * d + j];
      }
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
    segment_sum_kernel<true><<<static_cast<unsigned>(num_segments),
                               threads_for(d), 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(g), static_cast<const int32_t*>(perm),
        nullptr, static_cast<const int32_t*>(rowptr), static_cast<float*>(out),
        d);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int segment_sum_masked_f32(const void* msgs, const void* mask,
                                      const void* rowptr, void* out,
                                      int64_t num_segments, int64_t d,
                                      void* stream) {
  if (num_segments > 0 && d > 0) {
    segment_sum_kernel<false><<<static_cast<unsigned>(num_segments),
                                threads_for(d), 0,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(msgs), nullptr,
        static_cast<const uint8_t*>(mask), static_cast<const int32_t*>(rowptr),
        static_cast<float*>(out), d);
  }
  return static_cast<int>(cudaGetLastError());
}
