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
// Semantics of 2:  out[n, j] = sum over e in [rowptr[n], rowptr[n+1]) with
//                              mask[e] of msgs[e, j]
// with rowptr over the receiver-sorted edges (graph/batch.py
// build_csr_rowptr): the trailing padding run lies in no segment, but masked
// edges among real ones stay inside their segment and are skipped; an empty
// or all-masked segment gives 0.
//
// Bound on an H100: bytes.  Each live row is read once and each output row
// written once: 2 at pcba's eval shape (25,978 live rows of 512 f32 into
// 16,384 receivers) moves 53.2 MB in and 33.6 MB out, 86.9 MB, ~25.9 us at
// 3.35 TB/s; at pcba's train shape (6,442 rows into 4,096) 21.6 MB, ~6.4
// us; 1 at the flagship's (6,374 rows of 200 into 4,096) 8.4 MB, ~2.5 us.
// Molecules give a segment ~1.6 live rows, so a segment is ~1 KB-3 KB of
// loads and the time goes to latency unless many segments' rows are in
// flight at once: at 3.35 TB/s and ~0.6 us a load, the card needs ~2 MB
// outstanding, ~15 KB an SM.  The CSR, the mask and the permutation are
// tiny; reading them edge by edge puts their latency in front of every row.
//
// Design: a warp a segment, the CSR staged, 16-byte loads.
//   A CTA of kWarps warps owns a run of `run` consecutive segments (the plan,
//   ops/segment_sum.py::segment_sum_plan, computed in Python and checked
//   here).  Its edges are the one range [rowptr[s0], rowptr[s0 + run]).  In
//   one coalesced pass the CTA stages the slice of rowptr, then, before any
//   row load, the range's mask bytes (2) or perm entries (1), up to `stage`
//   of them, in shared memory; an edge past the staged ones (a segment
//   longer than the molecules') reads its entry from global memory.
//   Warp w takes the run's segments w, w + kWarps, ...; a lane holds
//   `chunks` accumulators of kVec floats: float4 where d % 4 == 0 and the
//   rows are 16-byte aligned, a float otherwise (the wrapper picks the
//   instance from d and the pointers, the plan says which), so a warp reads
//   512 bytes of a row per instruction.  Wider rows take column blocks
//   (blockIdx.y), each the same run over its columns.
//   The edge loop is unrolled by kUnroll: the entries of kUnroll edges come
//   from shared memory, every row load of the group is issued (a masked
//   row's load is predicated off, so masked rows are not read), then the
//   adds run in edge order from 0.0f.  So each output is bit-equal to a
//   sequential f32 sum in edge order, whatever the plan; no atomics, and a
//   relaunch gives the same bits.  A long segment runs serially in one
//   warp: splitting it would change the order.
//   With runs sized so that the grid holds several CTAs an SM (the plan),
//   an SM has ~16 warps with their segments' rows in flight, ~50 KB at
//   pcba's eval shape, while other CTAs stage.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                 // warps a CTA, each a segment
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 4;                // edges whose rows are in flight
constexpr int kMaxRun = 64;               // segments a CTA
constexpr int kMaxSmem = 48 * 1024;       // without an opt-in

__device__ __forceinline__ void add_to(float4& acc, const float4& v) {
  acc.x += v.x;
  acc.y += v.y;
  acc.z += v.z;
  acc.w += v.w;
}

__device__ __forceinline__ void add_to(float& acc, float v) { acc += v; }

template <int kVec>
struct Lanes;

template <>
struct Lanes<4> {
  using T = float4;
  __device__ static T zero() { return make_float4(0.0f, 0.0f, 0.0f, 0.0f); }
};

template <>
struct Lanes<1> {
  using T = float;
  __device__ static T zero() { return 0.0f; }
};

// kPerm: the rows are g[perm[e]] and every edge of a segment counts (1);
// otherwise the rows are g[e] and only the edges whose mask holds (2).
// Shared memory: rowptr[s0 .. s0 + segs] (int32), then the staged entries
// (perm int32 or mask bytes).
template <bool kPerm, int kVec, int kChunks>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const float* __restrict__ g,
                   const int32_t* __restrict__ perm,
                   const uint8_t* __restrict__ mask,
                   const int32_t* __restrict__ rowptr,
                   float* __restrict__ out, int64_t n, int64_t d, int run,
                   int stage) {
  using V = typename Lanes<kVec>::T;
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* srp = reinterpret_cast<int32_t*>(smem);
  int32_t* sperm = srp + run + 1;
  uint8_t* smask = reinterpret_cast<uint8_t*>(srp + run + 1);

  const int64_t s0 = static_cast<int64_t>(blockIdx.x) * run;
  const int segs = static_cast<int>(n - s0 < run ? n - s0 : run);
  for (int i = threadIdx.x; i <= segs; i += kThreads) srp[i] = rowptr[s0 + i];
  __syncthreads();
  const int32_t e0 = srp[0];
  const int64_t range = static_cast<int64_t>(srp[segs]) - e0;
  const int staged = static_cast<int>(range < stage ? range : stage);
  for (int i = threadIdx.x; i < staged; i += kThreads) {
    if constexpr (kPerm) {
      sperm[i] = perm[e0 + i];
    } else {
      smask[i] = mask[e0 + i];
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t dv = d / kVec;  // vectors a row
  const int64_t c0 = static_cast<int64_t>(blockIdx.y) * (kChunks * 32) + lane;
  const V* __restrict__ gv = reinterpret_cast<const V*>(g);
  V* __restrict__ ov = reinterpret_cast<V*>(out);
  bool col_live[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) col_live[c] = c0 + c * 32 < dv;

  for (int i = warp; i < segs; i += kWarps) {
    const int32_t lo = srp[i];
    const int32_t hi = srp[i + 1];
    V acc[kChunks];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) acc[c] = Lanes<kVec>::zero();
    for (int32_t e = lo; e < hi; e += kUnroll) {
      bool live[kUnroll];
      int64_t row[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int32_t ee = e + u;
        live[u] = ee < hi;
        row[u] = ee;
        if (live[u]) {
          const int k = ee - e0;  // the edge's place in the staged range
          if constexpr (kPerm) {
            row[u] = k < staged ? sperm[k] : perm[ee];
          } else {
            live[u] = (k < staged ? smask[k] : mask[ee]) != 0;
          }
        }
      }
      V v[kUnroll][kChunks];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          v[u][c] = live[u] && col_live[c] ? gv[row[u] * dv + c0 + c * 32]
                                           : Lanes<kVec>::zero();
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          if (live[u]) add_to(acc[c], v[u][c]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if (col_live[c]) ov[(s0 + i) * dv + c0 + c * 32] = acc[c];
    }
  }
}

// The plan of segment_sum_plan, checked: float4 lanes only where d % 4 == 0
// and g and out are 16-byte aligned, the fewest chunks a lane that cover a
// row (more than one column block only at 4 chunks), column blocks that
// cover d, runs of whole warps that cover n, and the shared memory of its
// rowptr slice and staged entries.
bool plan_ok(const void* g, const void* out, int64_t n, int64_t d,
             bool perm, int64_t vec, int64_t chunks, int64_t col_blocks,
             int64_t run, int64_t stage, int64_t smem, int64_t grid) {
  if (vec == 4) {
    if (d % 4 != 0 || reinterpret_cast<uintptr_t>(g) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(out) % 16 != 0) {
      return false;
    }
  } else if (vec != 1) {
    return false;
  }
  const int64_t cols = chunks * 32 * vec;  // floats a column block
  return (chunks == 1 || chunks == 2 || chunks == 4) && n > 0 && d > 0 &&
         (chunks == 1 || 16 * chunks * vec < d) &&
         (col_blocks == 1 || chunks == 4) && col_blocks >= 1 && col_blocks <= 65535 && col_blocks * cols >= d &&
         (col_blocks - 1) * cols < d && run >= kWarps && run <= kMaxRun &&
         run % kWarps == 0 && grid >= 1 && grid < (int64_t{1} << 31) &&
         grid * run >= n && (grid - 1) * run < n && stage >= 0 &&
         smem == 4 * (run + 1) + stage * (perm ? 4 : 1) && smem <= kMaxSmem;
}

template <bool kPerm, int kVec, int kChunks>
cudaError_t launch_instance(const float* g, const int32_t* perm,
                            const uint8_t* mask, const int32_t* rowptr,
                            float* out, int64_t n, int64_t d,
                            int64_t col_blocks, int64_t run, int64_t stage,
                            int64_t smem, int64_t grid, void* stream) {
  segment_sum_kernel<kPerm, kVec, kChunks>
      <<<dim3(static_cast<unsigned>(grid), static_cast<unsigned>(col_blocks)),
         kThreads, static_cast<size_t>(smem),
         static_cast<cudaStream_t>(stream)>>>(g, perm, mask, rowptr, out, n, d,
                                              static_cast<int>(run),
                                              static_cast<int>(stage));
  return cudaGetLastError();
}

template <bool kPerm>
int launch(const void* g, const void* perm, const void* mask,
           const void* rowptr, void* out, int64_t n, int64_t d, int64_t vec,
           int64_t chunks, int64_t col_blocks, int64_t run, int64_t stage,
           int64_t smem, int64_t grid, void* stream) {
  if (n == 0 || d == 0) return static_cast<int>(cudaSuccess);
  if (!plan_ok(g, out, n, d, kPerm, vec, chunks, col_blocks, run, stage, smem,
               grid)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* gf = static_cast<const float*>(g);
  const int32_t* pi = static_cast<const int32_t*>(perm);
  const uint8_t* mb = static_cast<const uint8_t*>(mask);
  const int32_t* rp = static_cast<const int32_t*>(rowptr);
  float* of = static_cast<float*>(out);
#define SEGMENT_SUM_CASE(V, C)                                               \
  if (vec == V && chunks == C) {                                             \
    return static_cast<int>(launch_instance<kPerm, V, C>(                    \
        gf, pi, mb, rp, of, n, d, col_blocks, run, stage, smem, grid,        \
        stream));                                                            \
  }
  SEGMENT_SUM_CASE(4, 1)
  SEGMENT_SUM_CASE(4, 2)
  SEGMENT_SUM_CASE(4, 4)
  SEGMENT_SUM_CASE(1, 1)
  SEGMENT_SUM_CASE(1, 2)
  SEGMENT_SUM_CASE(1, 4)
#undef SEGMENT_SUM_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The plan arguments (vec, chunks, col_blocks, run, stage, smem, grid) are
// those of ops/segment_sum.py::segment_sum_plan; a plan this file cannot run
// returns cudaErrorInvalidValue and launches nothing.
extern "C" int segment_sum_perm_f32(const void* g, const void* perm,
                                    const void* rowptr, void* out,
                                    int64_t num_segments, int64_t d,
                                    int64_t vec, int64_t chunks,
                                    int64_t col_blocks, int64_t run,
                                    int64_t stage, int64_t smem, int64_t grid,
                                    void* stream) {
  return launch<true>(g, perm, nullptr, rowptr, out, num_segments, d, vec,
                      chunks, col_blocks, run, stage, smem, grid, stream);
}

extern "C" int segment_sum_masked_f32(const void* msgs, const void* mask,
                                      const void* rowptr, void* out,
                                      int64_t num_segments, int64_t d,
                                      int64_t vec, int64_t chunks,
                                      int64_t col_blocks, int64_t run,
                                      int64_t stage, int64_t smem,
                                      int64_t grid, void* stream) {
  return launch<false>(msgs, nullptr, mask, rowptr, out, num_segments, d, vec,
                       chunks, col_blocks, run, stage, smem, grid, stream);
}

