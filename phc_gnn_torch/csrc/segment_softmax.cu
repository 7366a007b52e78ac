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
//   segment_softmax_fused_{f32,bf16}
//                                 <- the two together (A fused into B)
//   segment_softmax_backward_{f32,bf16}
//                                 <- the XLA glue of the custom VJP's
//                                    backward, _softmax_agg_streamed_bwd
//                                    (:794-815)
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
//
// segment_softmax_fused_{f32,bf16}: A fused into B, one launch for both
// (the model runs it instead of A then B on either row type).  A bf16 launch
// of A then B is latency, not bytes: a block a receiver walks ~1.6 edges
// through rowptr, mask and row loads in series, twice, and B reads the
// 3.3 MB segmax that A wrote.  The fused kernel is B's bf16 kernel with A's
// loop over the segment in front of its own, a block a receiver segment
// and a pair of lanes a thread where B's bf16 kernel takes pairs: segmax
// stays in registers, and the second loop reads the segment's rows from
// L1.  (A run of segments a CTA with its rows staged in shared memory by
// one TMA bulk copy timed slower at the flagship's shape: its CTA waits
// for the whole run's copy behind rowptr before any warp starts.)  Each
// lane's arithmetic is A's then B's, the same expressions in the same edge
// order, so out, w and den are bit-equal to A bf16 then B bf16 and to the
// f32 kernels fed the upcast rows.  The training variant zeroes w's rows
// past rowptr[N] itself (the padding run, ~1,800 rows at the flagship's
// shape, at most one a block), so the wrapper allocates w without a fill.
//
// On float32 rows the fused kernel takes four lanes a thread (one float4
// load a row, 16 bytes) where d % 4 == 0 and the rows are 16-byte aligned,
// else two, else one.  The kernel is latency, not bytes (its bound is
// 2.51 us at eval, 5.0 us with w and den): each block walks ~1.6 edges
// through rowptr, mask and row loads in series, so what counts is how
// many segments' chains the card holds at once and how many bytes each
// load brings.  At D = 200 a float4 block is 50 threads in 64; its eval
// instance holds 32 registers, so the SM takes 32 such blocks (its block
// limit) and the flagship's 4,096 segments run in one wave of 132 x 32 =
// 4,224; the training instance holds 40 (25 blocks an SM).  A float2 block
// is 100 threads in 128 (39 and 40 registers: 12 blocks an SM), one lane a
// thread 200 in 224 (9 an SM).  Measured on an H100 (PERF.md,
// tools/time_softmax.py): 4.7-4.8, 5.0 and 5.9 us at eval, 6.5, 6.6 and 8.1
// in training, so four lanes it is.  Each lane's arithmetic is A's then
// B's f32 kernels', the same expressions in the same edge order, so out, w
// and den are bit-equal to A then B.
//
// segment_softmax_backward_{f32,bf16} replaces the XLA glue of JAX's
// backward, _softmax_agg_streamed_bwd (stream_scan.py:794-815), which has no
// Pallas kernel: a block a receiver segment loads den_n, g_n and
// s_n = out_n * g_n once (JAX gathers an [E, 3D] copy of them), and per
// edge reads m_e and w_e and writes
//   dm_e  = (w_e / den_n) * (g_n + beta * (m_e * g_n - s_n))
// in the messages' type; dbeta = sum (w_e / den_n) * m_e * (m_e*g_n - s_n).
// dm is written for all E edges: 0 on the padding run past rowptr[N]
// (zeroed a row a block, as w above), and 0 on masked edges inside a
// segment because w is 0 there.  Every product, sum and the quotient is
// rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn: nvcc would
// otherwise contract a*b - c into one FMA), in the plain version's order,
// so dm is bit-equal to the plain backward on the card.  dbeta's terms are
// summed in float64, deterministically: a thread's in edge order, a
// block's in a fixed shuffle tree, then the last block to finish (a
// counter that wraps back to 0) sums the blocks' partials, a scratch of N
// doubles from torch's allocator, in node order.  No float atomics: two
// launches give the same bits, as the graphed-against-eager checks need.
// Bound at the flagship's shape: it reads m and w over the real edges
// (5.10 MB each), den, g and out (3.28 MB each) and writes dm over all
// 8,192 edges (6.55 MB): 26.6 MB, ~7.9 us at 3.35 TB/s.  beta is read from
// device memory and nothing syncs the host, so CUDA graphs capture it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
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
  // v rounded to T (round to nearest even, as torch's .to(bfloat16))
  __device__ static void put(T* rows, int64_t i, const float (&v)[1]) {
    if constexpr (std::is_same_v<T, __nv_bfloat16>) {
      rows[i] = __float2bfloat16_rn(v[0]);
    } else {
      rows[i] = v[0];
    }
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
  __device__ static void put(__nv_bfloat16* rows, int64_t i,
                             const float (&v)[2]) {
    reinterpret_cast<__nv_bfloat162*>(rows)[i] =
        __floats2bfloat162_rn(v[0], v[1]);
  }
};

template <>
struct Row<float, 2> {
  __device__ static void read(const float* a, int64_t i, float (&v)[2]) {
    const float2 f = reinterpret_cast<const float2*>(a)[i];
    v[0] = f.x;
    v[1] = f.y;
  }
  __device__ static void load(const float* rows, int64_t e, int64_t dv,
                              int64_t p, float (&m)[2]) {
    read(rows, e * dv + p, m);
  }
  __device__ static void store(float* a, int64_t i, const float (&v)[2]) {
    reinterpret_cast<float2*>(a)[i] = make_float2(v[0], v[1]);
  }
  __device__ static void put(float* rows, int64_t i, const float (&v)[2]) {
    store(rows, i, v);
  }
};

template <>
struct Row<float, 4> {
  __device__ static void read(const float* a, int64_t i, float (&v)[4]) {
    const float4 f = reinterpret_cast<const float4*>(a)[i];
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  }
  __device__ static void load(const float* rows, int64_t e, int64_t dv,
                              int64_t p, float (&m)[4]) {
    read(rows, e * dv + p, m);
  }
  __device__ static void store(float* a, int64_t i, const float (&v)[4]) {
    reinterpret_cast<float4*>(a)[i] = make_float4(v[0], v[1], v[2], v[3]);
  }
  __device__ static void put(float* rows, int64_t i, const float (&v)[4]) {
    store(rows, i, v);
  }
};

// Zero the rows [rowptr[N], E) of an [E, d] array: the padding run past the
// last segment, which no segment's loop writes.  Block n takes rows
// rowptr[N] + n, + N, ... (the flagship's ~1,800 rows: at most one a block).
template <typename T, int kVec>
__device__ void zero_tail(T* rows, const int32_t* rowptr, int64_t num_edges,
                          int64_t dv) {
  const int64_t num_nodes = gridDim.x;
  float zero[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) zero[k] = 0.0f;
  for (int64_t e = rowptr[num_nodes] + blockIdx.x; e < num_edges;
       e += num_nodes) {
    for (int64_t p = threadIdx.x; p < dv; p += blockDim.x) {
      Row<T, kVec>::put(rows, e * dv + p, zero);
    }
  }
}

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

// A then B over one segment, a thread a group of kVec lanes, a block a
// segment: the fused kernel.  The training variant (kTrain: w_out and
// den_out) also zeroes w's rows past rowptr[N], so that its caller need not
// clear w first; the eval variant is an instance of its own, without that
// code and the registers it holds.
template <typename T, int kVec, bool kTrain>
__global__ void segment_softmax_fused_kernel(
    const T* __restrict__ msgs, const uint8_t* __restrict__ mask,
    const float* __restrict__ beta_ptr, const int32_t* __restrict__ rowptr,
    float* __restrict__ out, float* __restrict__ w_out,
    float* __restrict__ den_out, int64_t num_edges, int64_t d) {
  using R = Row<T, kVec>;
  const int64_t n = blockIdx.x;
  const float beta = *beta_ptr;
  const int32_t lo = rowptr[n];
  const int32_t hi = rowptr[n + 1];
  const int64_t dv = d / kVec;
  for (int64_t p = threadIdx.x; p < dv; p += blockDim.x) {
    float smax[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) smax[k] = kNeg;
    for (int32_t e = lo; e < hi; ++e) {
      if (mask[e]) {
        float m[kVec];
        R::load(msgs, e, dv, p, m);
#pragma unroll
        for (int k = 0; k < kVec; ++k) smax[k] = fmaxf(smax[k], beta * m[k]);
      }
    }
    float num[kVec];
    float den[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      num[k] = 0.0f;
      den[k] = 0.0f;
    }
    for (int32_t e = lo; e < hi; ++e) {
      float m[kVec];
      R::load(msgs, e, dv, p, m);
      const bool live = mask[e] != 0;
      float w[kVec];
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        w[k] = live ? expf(beta * m[k] - smax[k]) : 0.0f;
        num[k] += w[k] * m[k];
        den[k] += w[k];
      }
      if (kTrain) R::store(w_out, e * dv + p, w);
    }
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      den[k] = fmaxf(den[k], 1e-16f);
      num[k] = num[k] / den[k];
    }
    R::store(out, n * dv + p, num);
    if (kTrain) R::store(den_out, n * dv + p, den);
  }
  if (kTrain) zero_tail<float, kVec>(w_out, rowptr, num_edges, dv);
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

namespace {

template <typename T, int kVec>
int launch_fused(const void* msgs, const void* mask, const void* beta,
                 const void* rowptr, void* out, void* w_out, void* den_out,
                 int64_t num_nodes, int64_t num_edges, int64_t d,
                 void* stream) {
  const auto kernel = w_out != nullptr
                          ? segment_softmax_fused_kernel<T, kVec, true>
                          : segment_softmax_fused_kernel<T, kVec, false>;
  kernel<<<static_cast<unsigned>(num_nodes), threads_for(d / kVec), 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(msgs), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(beta), static_cast<const int32_t*>(rowptr),
      static_cast<float*>(out), static_cast<float*>(w_out),
      static_cast<float*>(den_out), num_edges, d);
  return static_cast<int>(cudaGetLastError());
}

// Lanes a thread on float32 rows: four (one 16-byte access a row) where d
// and every pointer allow it, else two, else one.
int f32_lanes(int64_t d, std::initializer_list<const void*> ptrs) {
  bool a16 = d % 4 == 0, a8 = d % 2 == 0;
  for (const void* q : ptrs) {
    const uintptr_t u = reinterpret_cast<uintptr_t>(q);
    a16 = a16 && u % 16 == 0;
    a8 = a8 && u % 8 == 0;
  }
  return a16 ? 4 : (a8 ? 2 : 1);
}

// The eval variant (no w_out) and an empty grid: nothing of w to write but
// the whole of it, zeroed.
int fused_empty(void* w_out, int64_t num_edges, int64_t d, void* stream) {
  if (w_out != nullptr && num_edges > 0 && d > 0) {
    cudaMemsetAsync(w_out, 0, num_edges * d * sizeof(float),
                    static_cast<cudaStream_t>(stream));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// w_out and den_out are null in the eval variant; pairs of lanes as in
// segment_softmax_aggregate_bf16 (out stands for segmax, which this launch
// does not read: the outputs are the wrapper's own allocations).
extern "C" int segment_softmax_fused_bf16(const void* msgs, const void* mask,
                                          const void* beta,
                                          const void* rowptr, void* out,
                                          void* w_out, void* den_out,
                                          int64_t num_nodes,
                                          int64_t num_edges, int64_t d,
                                          void* stream) {
  if (num_nodes <= 0 || d <= 0) return fused_empty(w_out, num_edges, d, stream);
  if (pairs_ok(msgs, out, d)) {
    return launch_fused<__nv_bfloat16, 2>(msgs, mask, beta, rowptr, out,
                                          w_out, den_out, num_nodes,
                                          num_edges, d, stream);
  }
  return launch_fused<__nv_bfloat16, 1>(msgs, mask, beta, rowptr, out, w_out,
                                        den_out, num_nodes, num_edges, d,
                                        stream);
}

// float32 rows: four lanes a thread where the rows allow it (see the
// header), else two, else one.
extern "C" int segment_softmax_fused_f32(const void* msgs, const void* mask,
                                         const void* beta, const void* rowptr,
                                         void* out, void* w_out,
                                         void* den_out, int64_t num_nodes,
                                         int64_t num_edges, int64_t d,
                                         void* stream) {
  if (num_nodes <= 0 || d <= 0) return fused_empty(w_out, num_edges, d, stream);
  switch (f32_lanes(d, {msgs, out, w_out, den_out})) {
    case 4:
      return launch_fused<float, 4>(msgs, mask, beta, rowptr, out, w_out,
                                    den_out, num_nodes, num_edges, d, stream);
    case 2:
      return launch_fused<float, 2>(msgs, mask, beta, rowptr, out, w_out,
                                    den_out, num_nodes, num_edges, d, stream);
    default:
      return launch_fused<float, 1>(msgs, mask, beta, rowptr, out, w_out,
                                    den_out, num_nodes, num_edges, d, stream);
  }
}

// ------------------------------------------------------------- the backward

namespace {

// Blocks of the backward that have written their dbeta partial; the last to
// arrive sums them and sets it back to 0 (atomicInc wraps at gridDim.x - 1).
// One counter a device in a process: launches of the backward on one device
// must not overlap, which the port's single stream guarantees.
__device__ unsigned int g_backward_arrived = 0;

// Sum of v over the block, in a fixed order: each warp's tree of shuffles,
// then warp 0 over the warps' sums in warp order.  Every thread calls it;
// thread 0 holds the result.
__device__ double block_sum(double v) {
  __shared__ double warp_sums[32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int off = 16; off > 0; off /= 2) v += __shfl_down_sync(~0u, v, off);
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    v = warp_sums[0];
    for (int i = 1; i < (blockDim.x + 31) / 32; ++i) v += warp_sums[i];
  }
  __syncthreads();  // warp_sums may be reused by a second call
  return v;
}

// The closed form of _softmax_agg_streamed_bwd (stream_scan.py:794-815) over
// block n's segment: den_n, g_n and s_n = out_n * g_n read once a node; per
// edge dm_e = (w_e / den_n) * (g_n + beta * (m_e * g_n - s_n)), every product
// and sum rounded on its own (no FMA), in the plain version's order, and
// the terms (w_e / den_n) * m_e * (m_e * g_n - s_n) of dbeta summed in
// float64: a thread's lanes in edge order, the block's threads in a fixed
// tree, then the last block over the blocks' partials in node order.
template <typename T, int kVec>
__global__ void segment_softmax_backward_kernel(
    const T* __restrict__ msgs, const float* __restrict__ beta_ptr,
    const float* __restrict__ w, const float* __restrict__ den,
    const float* __restrict__ out, const float* __restrict__ g,
    const int32_t* __restrict__ rowptr, T* __restrict__ dm,
    double* __restrict__ partials, float* __restrict__ dbeta,
    int64_t num_edges, int64_t d) {
  using R = Row<T, kVec>;
  using F = Row<float, kVec>;
  const int64_t n = blockIdx.x;
  const float beta = *beta_ptr;
  const int32_t lo = rowptr[n];
  const int32_t hi = rowptr[n + 1];
  const int64_t dv = d / kVec;
  double part = 0.0;
  for (int64_t p = threadIdx.x; p < dv; p += blockDim.x) {
    float dn[kVec], gn[kVec], sn[kVec];
    F::read(den, n * dv + p, dn);
    F::read(g, n * dv + p, gn);
    F::read(out, n * dv + p, sn);
#pragma unroll
    for (int k = 0; k < kVec; ++k) sn[k] = __fmul_rn(sn[k], gn[k]);
    for (int32_t e = lo; e < hi; ++e) {
      float m[kVec], we[kVec], dme[kVec];
      R::load(msgs, e, dv, p, m);
      F::read(w, e * dv + p, we);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const float wt = __fdiv_rn(we[k], dn[k]);
        const float diff = __fsub_rn(__fmul_rn(m[k], gn[k]), sn[k]);
        dme[k] = __fmul_rn(wt, __fadd_rn(gn[k], __fmul_rn(beta, diff)));
        part += static_cast<double>(__fmul_rn(__fmul_rn(wt, m[k]), diff));
      }
      R::put(dm, e * dv + p, dme);
    }
  }
  zero_tail<T, kVec>(dm, rowptr, num_edges, dv);

  __shared__ bool last;
  part = block_sum(part);
  if (threadIdx.x == 0) {
    partials[n] = part;
    __threadfence();
    last = atomicInc(&g_backward_arrived, gridDim.x - 1) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // kLoads partials in flight a thread, then added in their fixed order: a
  // loop of one load and one add would wait out the L2's latency N /
  // blockDim.x times in a row
  constexpr int kLoads = 16;
  double total = 0.0;
  for (int64_t base = threadIdx.x; base < gridDim.x;
       base += kLoads * blockDim.x) {
    double v[kLoads];
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int64_t i = base + j * static_cast<int64_t>(blockDim.x);
      v[j] = i < gridDim.x ? __ldcg(partials + i) : 0.0;
    }
#pragma unroll
    for (int j = 0; j < kLoads; ++j) total += v[j];
  }
  total = block_sum(total);
  if (threadIdx.x == 0) *dbeta = static_cast<float>(total);
}

template <typename T, int kVec>
int launch_backward(const void* msgs, const void* beta, const void* w,
                    const void* den, const void* out, const void* g,
                    const void* rowptr, void* dm, void* partials, void* dbeta,
                    int64_t num_nodes, int64_t num_edges, int64_t d,
                    void* stream) {
  segment_softmax_backward_kernel<T, kVec>
      <<<static_cast<unsigned>(num_nodes), threads_for(d / kVec), 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(msgs), static_cast<const float*>(beta),
          static_cast<const float*>(w), static_cast<const float*>(den),
          static_cast<const float*>(out), static_cast<const float*>(g),
          static_cast<const int32_t*>(rowptr), static_cast<T*>(dm),
          static_cast<double*>(partials), static_cast<float*>(dbeta),
          num_edges, d);
  return static_cast<int>(cudaGetLastError());
}

// No node or no lane: dm is all padding, dbeta an empty sum.
int backward_empty(void* dm, void* dbeta, int64_t num_edges, int64_t d,
                   size_t elem, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_edges > 0 && d > 0) cudaMemsetAsync(dm, 0, num_edges * d * elem, s);
  cudaMemsetAsync(dbeta, 0, sizeof(float), s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dm [E, d] in the messages' type, dbeta one float; partials holds
// num_nodes doubles of scratch.  w, den, out and g are float32.
extern "C" int segment_softmax_backward_f32(
    const void* msgs, const void* beta, const void* w, const void* den,
    const void* out, const void* g, const void* rowptr, void* dm,
    void* partials, void* dbeta, int64_t num_nodes, int64_t num_edges,
    int64_t d, void* stream) {
  if (num_nodes <= 0 || d <= 0) {
    return backward_empty(dm, dbeta, num_edges, d, sizeof(float), stream);
  }
  switch (f32_lanes(d, {msgs, w, den, out, g, dm})) {
    case 4:
      return launch_backward<float, 4>(msgs, beta, w, den, out, g, rowptr,
                                       dm, partials, dbeta, num_nodes,
                                       num_edges, d, stream);
    case 2:
      return launch_backward<float, 2>(msgs, beta, w, den, out, g, rowptr,
                                       dm, partials, dbeta, num_nodes,
                                       num_edges, d, stream);
    default:
      return launch_backward<float, 1>(msgs, beta, w, den, out, g, rowptr,
                                       dm, partials, dbeta, num_nodes,
                                       num_edges, d, stream);
  }
}

// bf16 rows: pairs of lanes where d is even, msgs and dm 4-byte aligned and
// the float32 arrays 8-byte aligned.
extern "C" int segment_softmax_backward_bf16(
    const void* msgs, const void* beta, const void* w, const void* den,
    const void* out, const void* g, const void* rowptr, void* dm,
    void* partials, void* dbeta, int64_t num_nodes, int64_t num_edges,
    int64_t d, void* stream) {
  if (num_nodes <= 0 || d <= 0) {
    return backward_empty(dm, dbeta, num_edges, d, sizeof(__nv_bfloat16),
                          stream);
  }
  if (pairs_ok(msgs, w, d) && pairs_ok(dm, den, d) && pairs_ok(dm, out, d) &&
      pairs_ok(dm, g, d)) {
    return launch_backward<__nv_bfloat16, 2>(msgs, beta, w, den, out, g,
                                             rowptr, dm, partials, dbeta,
                                             num_nodes, num_edges, d, stream);
  }
  return launch_backward<__nv_bfloat16, 1>(msgs, beta, w, den, out, g, rowptr,
                                           dm, partials, dbeta, num_nodes,
                                           num_edges, d, stream);
}
