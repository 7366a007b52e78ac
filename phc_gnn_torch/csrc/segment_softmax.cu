// Segment softmax aggregation over receiver-sorted CSR segments (sm_90a).
//
// Replaces the two Pallas kernels of the softmax aggregation in
// phc_gnn_tpu/ops/stream_scan.py:
//   segment_logit_max_{f32,bf16}  <- _softmax_suffix_max_kernel (:415)
//   segment_softmax_aggregate_{f32,bf16}
//                                 <- _softmax_fused_kernel (:439) and its
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
//
// bf16 messages (the model's compute_dtype=bf16; stream_scan.py :435, :465
// convert the block at its load): the _bf16 entry points run the same
// kernels on __nv_bfloat16 rows, converted with the intrinsics at the load,
// every max, exp and sum in f32, and write the same f32 outputs; where d is
// even and the rows 4-byte aligned a thread takes a pair of lanes, one
// __nv_bfloat162 load, and moves the pair's f32 segmax, out, w and den as
// one float2 each (tools/time_softmax.py times both bf16 instances).  The
// conversion is exact, so a bf16 launch gives the bits of the f32 kernel
// fed the upcast messages, and it reads half the message bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNeg = -0x1p100f;  // -2^100

// kVec lanes of row e, as floats: thread p holds lanes [p * kVec, p * kVec
// + kVec) of a row of dv = d / kVec packed elements.  ``load`` reads them
// from the message rows; ``read`` and ``store`` move the same lanes of a
// float32 array (segmax, out, w, den) in one access, so that a pair of
// lanes is one 8-byte load or store, not two 4-byte ones at an 8-byte
// stride.
template <typename T, int kVec>
struct Row;

template <typename T>
struct Row<T, 1> {
  __device__ static void load(const T* rows, int64_t e, int64_t dv,
                              int64_t p, float (&m)[1]) {
    if constexpr (std::is_same_v<T, __nv_bfloat16>) {
      m[0] = __bfloat162float(rows[e * dv + p]);
    } else {
      m[0] = rows[e * dv + p];
    }
  }
  __device__ static void read(const float* a, int64_t i, float (&v)[1]) {
    v[0] = a[i];
  }
  __device__ static void store(float* a, int64_t i, const float (&v)[1]) {
    a[i] = v[0];
  }
};

template <>
struct Row<__nv_bfloat16, 2> {
  __device__ static void load(const __nv_bfloat16* rows, int64_t e,
                              int64_t dv, int64_t p, float (&m)[2]) {
    const float2 f = __bfloat1622float2(
        reinterpret_cast<const __nv_bfloat162*>(rows)[e * dv + p]);
    m[0] = f.x;
    m[1] = f.y;
  }
  __device__ static void read(const float* a, int64_t i, float (&v)[2]) {
    const float2 f = reinterpret_cast<const float2*>(a)[i];
    v[0] = f.x;
    v[1] = f.y;
  }
  __device__ static void store(float* a, int64_t i, const float (&v)[2]) {
    reinterpret_cast<float2*>(a)[i] = make_float2(v[0], v[1]);
  }
};

template <typename T, int kVec>
__global__ void segment_logit_max_kernel(const T* __restrict__ msgs,
                                         const uint8_t* __restrict__ mask,
                                         const float* __restrict__ beta_ptr,
                                         const int32_t* __restrict__ rowptr,
                                         float* __restrict__ segmax,
                                         int64_t d) {
  const int64_t n = blockIdx.x;
  const float beta = *beta_ptr;
  const int32_t lo = rowptr[n];
  const int32_t hi = rowptr[n + 1];
  const int64_t dv = d / kVec;
  for (int64_t p = threadIdx.x; p < dv; p += blockDim.x) {
    float acc[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) acc[k] = kNeg;
    for (int32_t e = lo; e < hi; ++e) {
      if (mask[e]) {
        float m[kVec];
        Row<T, kVec>::load(msgs, e, dv, p, m);
#pragma unroll
        for (int k = 0; k < kVec; ++k) acc[k] = fmaxf(acc[k], beta * m[k]);
      }
    }
    Row<T, kVec>::store(segmax, n * dv + p, acc);
  }
}

template <typename T, int kVec>
__global__ void segment_softmax_aggregate_kernel(
    const T* __restrict__ msgs, const uint8_t* __restrict__ mask,
    const float* __restrict__ beta_ptr, const int32_t* __restrict__ rowptr,
    const float* __restrict__ segmax, float* __restrict__ out,
    float* __restrict__ w_out, float* __restrict__ den_out, int64_t d) {
  const int64_t n = blockIdx.x;
  const float beta = *beta_ptr;
  const int32_t lo = rowptr[n];
  const int32_t hi = rowptr[n + 1];
  const int64_t dv = d / kVec;
  for (int64_t p = threadIdx.x; p < dv; p += blockDim.x) {
    float smax[kVec];
    float num[kVec];
    float den[kVec];
    Row<T, kVec>::read(segmax, n * dv + p, smax);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      num[k] = 0.0f;
      den[k] = 0.0f;
    }
    for (int32_t e = lo; e < hi; ++e) {
      float m[kVec];
      Row<T, kVec>::load(msgs, e, dv, p, m);
      const bool live = mask[e] != 0;
      float w[kVec];
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        w[k] = live ? expf(beta * m[k] - smax[k]) : 0.0f;
        num[k] += w[k] * m[k];
        den[k] += w[k];
      }
      if (w_out != nullptr) Row<T, kVec>::store(w_out, e * dv + p, w);
    }
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      den[k] = fmaxf(den[k], 1e-16f);
      num[k] = num[k] / den[k];
    }
    Row<T, kVec>::store(out, n * dv + p, num);
    if (den_out != nullptr) Row<T, kVec>::store(den_out, n * dv + p, den);
  }
}

int threads_for(int64_t lanes) {
  int64_t t = ((lanes + 31) / 32) * 32;
  return static_cast<int>(t < 32 ? 32 : (t > 1024 ? 1024 : t));
}

// Pairs of bf16 lanes where the rows allow them: d even, the rows 4-byte
// aligned and the float32 segmax the caller passes 8-byte aligned (the
// outputs are the wrapper's own allocations).
bool pairs_ok(const void* msgs, const void* segmax, int64_t d) {
  return d % 2 == 0 && reinterpret_cast<uintptr_t>(msgs) % 4 == 0 &&
         reinterpret_cast<uintptr_t>(segmax) % 8 == 0;
}

template <typename T, int kVec>
int launch_max(const void* msgs, const void* mask, const void* beta,
               const void* rowptr, void* segmax, int64_t num_nodes, int64_t d,
               void* stream) {
  segment_logit_max_kernel<T, kVec><<<static_cast<unsigned>(num_nodes),
                                      threads_for(d / kVec), 0,
                                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(msgs), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(beta), static_cast<const int32_t*>(rowptr),
      static_cast<float*>(segmax), d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kVec>
int launch_aggregate(const void* msgs, const void* mask, const void* beta,
                     const void* rowptr, const void* segmax, void* out,
                     void* w_out, void* den_out, int64_t num_nodes, int64_t d,
                     void* stream) {
  segment_softmax_aggregate_kernel<T, kVec>
      <<<static_cast<unsigned>(num_nodes), threads_for(d / kVec), 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(msgs), static_cast<const uint8_t*>(mask),
          static_cast<const float*>(beta), static_cast<const int32_t*>(rowptr),
          static_cast<const float*>(segmax), static_cast<float*>(out),
          static_cast<float*>(w_out), static_cast<float*>(den_out), d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int segment_logit_max_f32(const void* msgs, const void* mask,
                                     const void* beta, const void* rowptr,
                                     void* segmax, int64_t num_nodes,
                                     int64_t d, void* stream) {
  if (num_nodes <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
  return launch_max<float, 1>(msgs, mask, beta, rowptr, segmax, num_nodes, d,
                              stream);
}

extern "C" int segment_logit_max_bf16(const void* msgs, const void* mask,
                                      const void* beta, const void* rowptr,
                                      void* segmax, int64_t num_nodes,
                                      int64_t d, void* stream) {
  if (num_nodes <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
  if (pairs_ok(msgs, segmax, d)) {
    return launch_max<__nv_bfloat16, 2>(msgs, mask, beta, rowptr, segmax,
                                        num_nodes, d, stream);
  }
  return launch_max<__nv_bfloat16, 1>(msgs, mask, beta, rowptr, segmax,
                                      num_nodes, d, stream);
}

extern "C" int segment_softmax_aggregate_f32(const void* msgs,
                                             const void* mask,
                                             const void* beta,
                                             const void* rowptr,
                                             const void* segmax, void* out,
                                             void* w_out, void* den_out,
                                             int64_t num_nodes,
                                             int64_t d, void* stream) {
  if (num_nodes <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
  return launch_aggregate<float, 1>(msgs, mask, beta, rowptr, segmax, out,
                                    w_out, den_out, num_nodes, d, stream);
}

extern "C" int segment_softmax_aggregate_bf16(const void* msgs,
                                              const void* mask,
                                              const void* beta,
                                              const void* rowptr,
                                              const void* segmax, void* out,
                                              void* w_out, void* den_out,
                                              int64_t num_nodes,
                                              int64_t d, void* stream) {
  if (num_nodes <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
  if (pairs_ok(msgs, segmax, d)) {
    return launch_aggregate<__nv_bfloat16, 2>(msgs, mask, beta, rowptr,
                                              segmax, out, w_out, den_out,
                                              num_nodes, d, stream);
  }
  return launch_aggregate<__nv_bfloat16, 1>(msgs, mask, beta, rowptr, segmax,
                                            out, w_out, den_out, num_nodes, d,
                                            stream);
}
