// edge_lb_relax: one whole ALB pass over the huge bin, edge-balanced
// (the paper's SSSP_LB), fused, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/edge_lb.py:105
// (edge_lb_map) together with the gather / msg / scatter-combine
// epilogue that src/repro/kernels/ops.py:83 (edge_lb_apply) runs around
// it.  Every enumerated id eid0 in [0, span) is mapped as edge_lb_map
// maps it:
//
//   eid  = blocked ? (eid0 % T) * w_per + eid0 / T : eid0
//   live = eid < total                      (eid0 < span by the launch)
//   j    = clip(upper_bound(start_e, eid) - 1, 0, H-1)
//   e    = row_start[j] + (eid - start_e[j]),   src = hvidx[j]
//
// and, for every query b, a live id does
//
//   push:  labels[b, col_idx[e]] = combine(.., msg(values[b, src'], w[e]))
//          where fmask[b, src']   (src' = src < V ? src : 0, as the plain
//          version gathers)
//   pull:  labels[b, src] = combine(.., msg(values[b, col_idx[e]], w[e]))
//          where fmask[b, col_idx[e]] and src < V
//
// Ids at or past span are never enumerated: span = w_per * T is the
// exact domain of the blocked permutation, so nothing past it can alias
// a real edge and an add-combine operator never takes an edge twice
// (edge_lb.cu, DESIGN.md "exact span").  `labels` must not alias
// `values`.
//
// What bounds it on this card: bytes, and the latency of the slot
// search.  A live id reads its 4-byte col_idx (and weight for v + w)
// and touches one value or label per live query; the [H] inputs are
// read once.  The unfused route wrote 13 bytes per id to HBM (edge id,
// slot, a batch-0 value nobody used, mask), read them back, gathered
// `hval`, and copied the whole [B, V + 4096] label array: none of that
// exists here.
//
// Design: the deal of ids to threads is kept, so cyclic and blocked
// still differ in access order (the paper's Fig. 8).  Cyclic: contiguous
// tiles of 2048 ids, walked by tile_relax.cuh, which merge_path_relax.cu
// shares (co-rank searches bound each tile's slot window, the block
// stages start_e over it in shared memory, each id searches only that
// window there).  Blocked: a block's ids are w_per apart and share no
// window, so each id searches start_e in global memory.  The per-id
// body (push, and pull's warp-run reduction before the atomic) is
// tile_relax.cuh's for both deals.
// `total` comes from the host or, when `total_ptr` is non-null, from one
// int32 on the device: the static-shape round (JAX's edge_lb_apply_static,
// src/repro/kernels/ops.py:52) enumerates a span of E ids and knows its
// total only on the card.  The grid then comes from the span alone, a
// few blocks per SM that walk the tiles (cyclic) or ids (blocked) below
// the total they read, so a round whose huge bin is empty (total 0)
// costs one launch whose blocks exit at once.  A grid of span / 2048
// blocks would cost the card that many block launches every round.
// The slots H come from the host or, when `rows_ptr` is non-null, from
// one int32 on the device, which bounds every search to [0, *rows_ptr):
// the static round hands the kernel its LB list (csrc/twc_list.cu: the
// members in frontier order, their degree prefix and total) with its
// member count, where the JAX package lays the huge bin over V rows.
// Every listed member owns an edge when the plan's threshold is at
// least 1 (the alb and edge_lb plans at any such threshold), so a tile
// of 2048 ids spans at most 2049 slots and its window always fits the
// stage.  A window wider than the stage needs runs of zero-degree slots:
// a layout over V rows (the index-map route's, or a caller's own), or a
// list at a threshold below 1; such a tile searches its window in global
// memory instead.
// The kernel allocates nothing and launches on the caller's stream.
#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "device_count.cuh"
#include "tile_relax.cuh"

namespace {

using tiles::kThreads;
using tiles::Pass;

constexpr int kTile = 2048;          // ids per tile on the cyclic deal

// The total comes from the host or from the device (`total_ptr`), and
// is 0 when the device row bound leaves no slot.  A live id i has
// eid >= i / T, so i / T < min(total, w_per): no id at or past
// T * min(total, w_per) is live, and the walk stops there.
template <typename T, bool ADD, bool PULL>
__global__ void __launch_bounds__(kThreads) edge_lb_relax_blocked(
    Pass p, const T* __restrict__ values, T* labels,
    const bool* __restrict__ fmask, const int32_t* __restrict__ start_e,
    const int32_t* __restrict__ row_start, int32_t h_host,
    int32_t total_host, const int32_t* __restrict__ total_ptr,
    const int32_t* __restrict__ rows_ptr, int32_t w_per, int32_t num_tiles,
    int32_t span) {
  device_count::count_launch();
  const int32_t h = tiles::slots(h_host, rows_ptr);
  const int32_t total =
      h == 0 ? 0 : total_ptr != nullptr ? *total_ptr : total_host;
  const int64_t live_rows = max(0, min(total, w_per));
  const int64_t lim = (int64_t)num_tiles * live_rows < span
                          ? (int64_t)num_tiles * live_rows
                          : (int64_t)span;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  // the loop bound is block-uniform, so whole warps run each step
  for (int64_t base = (int64_t)blockIdx.x * kThreads; base < lim;
       base += stride) {
    const int64_t eid0 = base + threadIdx.x;
    int32_t j = 0, e = 0;
    bool live = false;
    if (eid0 < lim) {
      const int32_t i = (int32_t)eid0;
      const int32_t eid = (i % num_tiles) * w_per + i / num_tiles;
      live = eid < total;
      if (live) {
        j = min(max(tiles::upper_bound(start_e, 0, h, eid) - 1, 0), h - 1);
        e = __ldg(row_start + j) + (eid - __ldg(start_e + j));
      }
    }
    tiles::relax_id<T, ADD, PULL>(p, values, labels, fmask, live, j, e);
  }
}

template <typename T, bool ADD, bool PULL>
int launch(const Pass& p, const void* values, void* labels,
           const void* fmask, const void* start_e, const void* row_start,
           const void* total_ptr, const void* rows_ptr, int h, int total,
           int w_per, int num_tiles, int span, int blocked,
           cudaStream_t stream) {
  if (!blocked)
    return tiles::launch_tiles<T, ADD, PULL>(p, values, labels, fmask,
                                             start_e, row_start, total_ptr,
                                             rows_ptr, h, total, span, kTile,
                                             stream);
  const int32_t* tp = static_cast<const int32_t*>(total_ptr);
  // a device total: the grid comes from the static span alone, a few
  // blocks per SM that walk the live ids (an empty huge bin costs one
  // short launch, not span / 256 blocks that each exit)
  int64_t blocks = ((int64_t)span + kThreads - 1) / kThreads;
  blocks = std::min<int64_t>(blocks, tp != nullptr
                                         ? (int64_t)relax::sm_count() * 8
                                         : (int64_t)1 << 20);
  if (blocks == 0) return 0;
  edge_lb_relax_blocked<T, ADD, PULL><<<(unsigned)blocks, kThreads, 0,
                                        stream>>>(
      p, static_cast<const T*>(values), static_cast<T*>(labels),
      static_cast<const bool*>(fmask), static_cast<const int32_t*>(start_e),
      static_cast<const int32_t*>(row_start), h, total, tp,
      static_cast<const int32_t*>(rows_ptr), w_per, num_tiles, span);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 int32, 1 float32; add: 0 min, 1 add (float32 takes add only).
// total_ptr: null, or one int32 on the device that replaces `total`;
// rows_ptr: null, or one int32 on the device that bounds the slots to
// [0, min(h, *rows_ptr)) (a list's member count).
extern "C" int edge_lb_relax_launch(
    const void* values, void* labels, const void* fmask, const void* col_idx,
    const void* edge_w, const void* hvidx, const void* start_e,
    const void* row_start, const void* total_ptr, const void* rows_ptr,
    int h, int total,
    int w_per, int num_tiles, int span, int blocked, int nb, int v,
    int dtype, int add, int pull, int kind, void* stream) {
  if (nb == 0 || span <= 0 || h <= 0) return 0;
  if (total_ptr == nullptr && total <= 0) return 0;
  const Pass p{static_cast<const int32_t*>(col_idx),
               static_cast<const int32_t*>(edge_w),
               static_cast<const int32_t*>(hvidx), nb, v, kind};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LB_RELAX_CALL(T, ADD, PULL)                                          \
  launch<T, ADD, PULL>(p, values, labels, fmask, start_e, row_start,         \
                       total_ptr, rows_ptr, h, total, w_per, num_tiles,      \
                       span, blocked, s)
  if (dtype == 0 && !add) return pull ? LB_RELAX_CALL(int32_t, false, true)
                                      : LB_RELAX_CALL(int32_t, false, false);
  if (dtype == 0) return pull ? LB_RELAX_CALL(int32_t, true, true)
                              : LB_RELAX_CALL(int32_t, true, false);
  if (dtype == 1 && add) return pull ? LB_RELAX_CALL(float, true, true)
                                     : LB_RELAX_CALL(float, true, false);
#undef LB_RELAX_CALL
  return (int)cudaErrorInvalidValue;
}
