// twc_bin_relax: one whole ALB pass over one degree bin of the
// vertex-binned (TWC-analog) path, fused, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/twc_gather.py:54
// (twc_bin_map) together with the gather / msg / scatter-combine
// epilogue that src/repro/kernels/ops.py:179 (twc_bin_apply) runs
// around it.  For bin row r with vid = vidx[r] < V and its edges
// e = row_start[r] + chunk*W + l, l < min(W, deg[r] - chunk*W), and
// every query b:
//
//   push:  labels[b, col_idx[e]] = combine(.., msg(values[b, vid], w[e]))
//          where fmask[b, vid]
//   pull:  labels[b, vid] = combine(.., msg(values[b, col_idx[e]], w[e]))
//          over the e with fmask[b, col_idx[e]]
//
// msg is the operator's enum (relax.cuh); combine is an atomicMin on
// int32 or an atomicAdd on int32 / float32.  `labels` must not alias
// `values`: the round hands the kernel a private copy of the labels and
// reads the round-entry values.
//
// What bounds it on this card: bytes, and the latency of dependent
// loads.  A live edge reads its 4-byte col_idx (and 4-byte weight for
// v + w) and, per live query, touches one 4-byte value or label; the
// row costs 12 bytes.  The unfused route wrote a 5-byte [N, W] index
// tile per slot to HBM, read it back, built [B, N, W] candidate and
// index tensors and copied the whole [B, V + 4096] label array in every
// pass: none of that exists here.
//
// Design: the bin width picks the group that owns a row, so that no
// thread divides: W <= 8 eight lanes (four rows per warp), W <= 128 one
// warp, wider one block of 256 threads; each lane strides the row's
// slots by the group size, so a group's col_idx loads are coalesced.
// The group's first lane loads the row's vidx, deg and row_start and
// broadcasts them (shuffle, or shared memory for a block); a sentinel
// row (vid >= V) or a row with deg <= chunk*W leaves before any edge
// load.  Push strides the slots on the outside and the queries inside:
// each lane reads its col_idx (and weight) once, then does one atomic
// per live query at dst; the row's value and fmask bit are one address
// per query for the whole group.  A min reads the label first and
// skips atomics that cannot win (relax.cuh).  Pull keeps each lane's
// in-neighbours and weights in registers (up to 4 slots a lane, which
// covers every ALB bin row), so each query costs only the value and
// fmask gathers; it combines the lane's slots in order, reduces the
// group in a fixed shuffle tree (then the block's warps in order), and
// one lane combines the row's result into labels[b, vid].
// Under ALB (threshold 1024 = the widest bin's cap) every bin row ends
// in one pass, so a pull float add (pagerank) writes each row once per
// query in a fixed order: deterministic.  `chunk` comes from a host
// integer or, when `chunk_ptr` is non-null, from one int32 on the
// device, and so does the number of passes (`passes_ptr`): a launch
// runs chunks chunk .. chunk + passes - 1 of each row, in order.  The
// static-shape round gives an unbounded bin (twc's large bin, the
// vertex strategy) its pass count ceil(max_deg / W) this way, computed
// on the device, so the bin costs one launch a round and no host read.
// The static round lists each bin's members once a round on the card
// (csrc/twc_list.cu) and hands the kernel a bin's list with its member
// count as `rows_ptr`, one int32 on the device.  Then a resident grid,
// as many blocks as the card holds at once and fixed by the list's
// length (so a captured round replays for any count), hands out rows
// [0, *rows_ptr) one group per row, as the host round launches them:
// group g takes rows g,
// g + groups, ...; for W > 128 a block takes rows in block stride.  No
// row is loaded that is no member, and no group waits for another's
// row: the walk ends when the group's last row does.  (Before the
// listing kernel, each bin's launch walked all V rows of the frontier
// in tiles of 256, balloted the members into shared memory and ended
// each tile at a block barrier; three bins loaded each frontier row
// three times.)  A list may still hold sentinel rows below the count:
// they leave before any edge load, as in the host layout.
// The kernel allocates nothing and launches on the caller's stream.
#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "device_count.cuh"
#include "relax.cuh"

namespace {

using relax::combine;
using relax::combine_at;
using relax::msg_of;
using relax::neutral;

constexpr int kThreads = 256;
// slots a pull lane keeps in registers: 4 per lane covers a 128-wide
// row on a warp and a 1024-wide row on a block (8-lane groups take
// rows of at most 8, so one)
constexpr int kSlots = 4;

// One bin row's passes chunk0 .. chunk0 + passes - 1, by its group of
// G lanes (`lane` = this thread's place in the group); every lane of the
// group calls it together, and for G == kThreads the whole block.
template <typename T, bool ADD, bool PULL, int G>
__device__ __forceinline__ void relax_row(
    const T* __restrict__ values, T* labels, const bool* __restrict__ fmask,
    const int32_t* __restrict__ col_idx, const int32_t* __restrict__ edge_w,
    int32_t vid, int32_t d, int32_t rs, int32_t lane, int32_t chunk0,
    int32_t passes, int32_t width, int32_t nb, int32_t v, int32_t kind) {
  if (vid >= v) return;                        // uniform in the group
  const bool use_w = kind == relax::MSG_ADD_W;
  // passes chunk0 .. chunk0 + passes - 1, in order, as that many
  // launches of one pass would run them: a pass reads only the round's
  // values and fmask, never a label it wrote, so the row's later chunks
  // see what they would see in a later launch
  for (int32_t p = 0; p < passes; ++p) {
    const int32_t off0 = (chunk0 + p) * width;
    if (d <= off0) return;                     // uniform in the group
    const int32_t cnt = min(width, d - off0);
    const int32_t base = rs + off0;

    if constexpr (!PULL) {
      // slots outside, queries inside: a lane loads its col_idx and
      // weight once; the row's value and fmask bit sit at one address
      // for the whole group (a broadcast, from L1 after the first slot)
      for (int32_t k = lane; k < cnt; k += G) {
        const int32_t e = base + k;
        const int32_t dst = __ldg(col_idx + e);
        const int32_t w = use_w ? __ldg(edge_w + e) : 0;
        for (int32_t b = 0; b < nb; ++b) {
          const int64_t o = (int64_t)b * v;
          if (fmask[o + vid])
            combine_at<ADD>(labels + o + dst,
                            msg_of(kind, values[o + vid], w));
        }
      }
    } else {
      // pull: a lane keeps its slots' in-neighbours and weights in
      // registers when the chunk fits in kSlots per lane (every chunk of
      // the ALB bins), so a query costs no index load; a wider chunk
      // reloads them per query.  Both visit a lane's slots in the same
      // order, and the row's result for the chunk is combined into
      // labels[b, vid] by one lane: the row is the only writer of its
      // anchor (the bins are disjoint), so with several passes a float
      // add still sums chunk by chunk in the order of separate launches.
      constexpr int S = G == 8 ? 1 : kSlots;
      const bool cached = cnt <= S * G;          // uniform in the group
      int32_t src_r[S], w_r[S];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int32_t k = lane + s * G;
        const bool in = cached && k < cnt;
        src_r[s] = in ? __ldg(col_idx + base + k) : -1;
        w_r[s] = in && use_w ? __ldg(edge_w + base + k) : 0;
      }
      for (int32_t b = 0; b < nb; ++b) {
        const int64_t o = (int64_t)b * v;
        T acc = neutral<T, ADD>();
        int any = 0;
        if (cached) {
#pragma unroll
          for (int s = 0; s < S; ++s) {
            if (src_r[s] >= 0 && fmask[o + src_r[s]]) {
              acc = combine<ADD>(acc, msg_of(kind, values[o + src_r[s]],
                                             w_r[s]));
              any = 1;
            }
          }
        } else {
          for (int32_t k = lane; k < cnt; k += G) {
            const int32_t e = base + k;
            const int32_t src = __ldg(col_idx + e);
            if (fmask[o + src]) {
              const int32_t w = use_w ? __ldg(edge_w + e) : 0;
              acc = combine<ADD>(acc, msg_of(kind, values[o + src], w));
              any = 1;
            }
          }
        }
        if constexpr (G <= 32) {
          unsigned gmask = 0xffffffffu;          // the group's lanes
          if constexpr (G < 32)
            gmask = ((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1));
          for (int s = G / 2; s > 0; s >>= 1) {
            acc = combine<ADD>(acc, __shfl_down_sync(gmask, acc, s, G));
            any |= __shfl_down_sync(gmask, any, s, G);
          }
          if (lane == 0 && any) combine_at<ADD>(labels + o + vid, acc);
        } else {
          __shared__ T red[kThreads / 32];
          __shared__ int red_any[kThreads / 32];
          for (int s = 16; s > 0; s >>= 1) {
            acc = combine<ADD>(acc, __shfl_down_sync(0xffffffffu, acc, s));
            any |= __shfl_down_sync(0xffffffffu, any, s);
          }
          if ((threadIdx.x & 31) == 0) {
            red[threadIdx.x / 32] = acc;
            red_any[threadIdx.x / 32] = any;
          }
          __syncthreads();
          if (threadIdx.x == 0) {
            for (int i = 1; i < kThreads / 32; ++i) {
              red[0] = combine<ADD>(red[0], red[i]);
              red_any[0] |= red_any[i];
            }
            if (red_any[0]) combine_at<ADD>(labels + o + vid, red[0]);
          }
          __syncthreads();                     // red is reused for b + 1
        }
      }
    }
  }
}

// Row `row`'s vidx, deg and row_start, loaded by the group's first lane
// and broadcast to its G lanes (through shared memory for a block); a
// row at or past n reads as a sentinel.  Every lane of the group calls
// it together, and for G == kThreads the whole block.
template <int G>
__device__ __forceinline__ void row_meta(
    const int32_t* __restrict__ vidx, const int32_t* __restrict__ deg,
    const int32_t* __restrict__ row_start, int64_t row, int64_t n,
    int32_t lane, int32_t v, int32_t& vid, int32_t& d, int32_t& rs) {
  if constexpr (G == kThreads) {
    __shared__ int32_t meta[3];
    if (threadIdx.x == 0) {
      const bool in = row < n;
      meta[0] = in ? __ldg(vidx + row) : v;
      meta[1] = in ? __ldg(deg + row) : 0;
      meta[2] = in ? __ldg(row_start + row) : 0;
    }
    __syncthreads();
    vid = meta[0], d = meta[1], rs = meta[2];
  } else {
    vid = v, d = 0, rs = 0;
    if (lane == 0 && row < n) {
      vid = __ldg(vidx + row);
      d = __ldg(deg + row);
      rs = __ldg(row_start + row);
    }
    unsigned gmask = 0xffffffffu;              // the group's lanes
    if constexpr (G < 32)
      gmask = ((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1));
    vid = __shfl_sync(gmask, vid, 0, G);
    d = __shfl_sync(gmask, d, 0, G);
    rs = __shfl_sync(gmask, rs, 0, G);
  }
}

template <typename T, bool ADD, bool PULL, int G>
__global__ void __launch_bounds__(kThreads) twc_bin_relax_kernel(
    const T* __restrict__ values, T* labels, const bool* __restrict__ fmask,
    const int32_t* __restrict__ col_idx, const int32_t* __restrict__ edge_w,
    const int32_t* __restrict__ vidx, const int32_t* __restrict__ deg,
    const int32_t* __restrict__ row_start,
    const int32_t* __restrict__ chunk_ptr,
    const int32_t* __restrict__ passes_ptr,
    const int32_t* __restrict__ rows_ptr, int32_t chunk_host,
    int32_t passes_host, int32_t n, int32_t width, int32_t nb, int32_t v,
    int32_t kind) {
  device_count::count_launch();
  const int32_t lane = threadIdx.x % G;
  const int32_t chunk0 = chunk_ptr != nullptr ? *chunk_ptr : chunk_host;
  const int32_t passes = passes_ptr != nullptr ? *passes_ptr : passes_host;
  const int64_t first = (int64_t)blockIdx.x * (kThreads / G) + threadIdx.x / G;
  int32_t vid, d, rs;
  if (rows_ptr != nullptr) {
    // the static round's list: rows [0, *rows_ptr), one group per row on
    // a resident grid (the row is uniform in the group, and for
    // G == kThreads in the block)
    const int32_t limit = *rows_ptr;
    const int64_t rows = limit < 0 ? 0 : (limit < n ? limit : n);
    const int64_t groups = (int64_t)gridDim.x * (kThreads / G);
    for (int64_t row = first; row < rows; row += groups) {
      row_meta<G>(vidx, deg, row_start, row, n, lane, v, vid, d, rs);
      relax_row<T, ADD, PULL, G>(values, labels, fmask, col_idx, edge_w,
                                 vid, d, rs, lane, chunk0, passes, width,
                                 nb, v, kind);
      if constexpr (G == kThreads) __syncthreads();  // meta is rewritten
    }
    return;
  }
  // the host round's layout: compacted members, one group per row
  row_meta<G>(vidx, deg, row_start, first, n, lane, v, vid, d, rs);
  relax_row<T, ADD, PULL, G>(values, labels, fmask, col_idx, edge_w, vid, d,
                             rs, lane, chunk0, passes, width, nb, v, kind);
}

// Blocks of a launch over n rows, kThreads / G groups a block: one group
// a row for the host round's layout; for the static round's list
// (rows_ptr set) as many as fit on the card at once, at most one group
// a row, so that the grid is fixed by n and every block is resident.
template <typename T, bool ADD, bool PULL, int G>
unsigned grid(int n, const void* rows_ptr) {
  const int64_t need = ((int64_t)n + kThreads / G - 1) / (kThreads / G);
  if (rows_ptr == nullptr) return (unsigned)need;
  static const int resident = [] {
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, twc_bin_relax_kernel<T, ADD, PULL, G>, kThreads, 0);
    return relax::sm_count() * std::max(per_sm, 1);
  }();
  return (unsigned)std::min<int64_t>(need, resident);
}

template <typename T, bool ADD, bool PULL>
int launch(const void* values, void* labels, const void* fmask,
           const void* col_idx, const void* edge_w, const void* vidx,
           const void* deg, const void* row_start, const void* chunk_ptr,
           const void* passes_ptr, const void* rows_ptr, int chunk_host,
           int passes_host, int n, int width, int nb, int v, int kind,
           cudaStream_t stream) {
#define TWC_RELAX_ARGS                                                    \
  static_cast<const T*>(values), static_cast<T*>(labels),                 \
      static_cast<const bool*>(fmask),                                    \
      static_cast<const int32_t*>(col_idx),                               \
      static_cast<const int32_t*>(edge_w),                                \
      static_cast<const int32_t*>(vidx), static_cast<const int32_t*>(deg), \
      static_cast<const int32_t*>(row_start),                             \
      static_cast<const int32_t*>(chunk_ptr),                             \
      static_cast<const int32_t*>(passes_ptr),                            \
      static_cast<const int32_t*>(rows_ptr), chunk_host, passes_host, n,   \
      width, nb, v, kind
  if (width <= 8) {                        // 8 lanes per row
    twc_bin_relax_kernel<T, ADD, PULL, 8>
        <<<grid<T, ADD, PULL, 8>(n, rows_ptr), kThreads, 0, stream>>>(
            TWC_RELAX_ARGS);
  } else if (width <= 128) {               // a warp per row
    twc_bin_relax_kernel<T, ADD, PULL, 32>
        <<<grid<T, ADD, PULL, 32>(n, rows_ptr), kThreads, 0, stream>>>(
            TWC_RELAX_ARGS);
  } else {                                 // a block per row
    twc_bin_relax_kernel<T, ADD, PULL, kThreads>
        <<<grid<T, ADD, PULL, kThreads>(n, rows_ptr), kThreads, 0,
           stream>>>(TWC_RELAX_ARGS);
  }
#undef TWC_RELAX_ARGS
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 int32, 1 float32; add: 0 min, 1 add (float32 takes add only)
extern "C" int twc_bin_relax_launch(
    const void* values, void* labels, const void* fmask, const void* col_idx,
    const void* edge_w, const void* vidx, const void* deg,
    const void* row_start, const void* chunk_ptr, const void* passes_ptr,
    const void* rows_ptr, int chunk_host, int passes_host, int n, int width,
    int nb, int v, int dtype, int add, int pull, int kind, void* stream) {
  if (n == 0 || nb == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TWC_RELAX_CALL(T, ADD, PULL)                                        \
  launch<T, ADD, PULL>(values, labels, fmask, col_idx, edge_w, vidx, deg,   \
                       row_start, chunk_ptr, passes_ptr, rows_ptr,          \
                       chunk_host, passes_host, n, width, nb, v, kind, s)
  if (dtype == 0 && !add) return pull ? TWC_RELAX_CALL(int32_t, false, true)
                                      : TWC_RELAX_CALL(int32_t, false, false);
  if (dtype == 0) return pull ? TWC_RELAX_CALL(int32_t, true, true)
                              : TWC_RELAX_CALL(int32_t, true, false);
  if (dtype == 1 && add) return pull ? TWC_RELAX_CALL(float, true, true)
                                     : TWC_RELAX_CALL(float, true, false);
#undef TWC_RELAX_CALL
  return (int)cudaErrorInvalidValue;
}
