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
// still differ in access order (the paper's Fig. 8).  Cyclic: one block
// per tile of 2048 contiguous ids; two threads in different warps find
// the tile's slot window by co-rank searches over start_e (as
// merge_path.cu does), the block stages start_e over the window in
// shared memory, and each id searches only that window there.  Blocked:
// a block's ids are w_per apart and share no window, so each id
// searches start_e in global memory.  Push reads values[b, src] per
// query: one huge vertex's ids are neighbours, so those loads are L1
// hits.  Pull combines at the anchor, which a whole run of neighbouring
// lanes shares: each warp first reduces every run of lanes with one
// anchor into its first lane (shuffles), and only that lane does the
// atomic.  So a float add here is order-dependent (atomics), as
// index_add_ is.
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
#include "relax.cuh"

namespace {

using relax::combine;
using relax::combine_at;
using relax::msg_of;
using relax::neutral;

constexpr int kThreads = 256;
constexpr int kTile = 2048;          // ids per block on the cyclic deal
constexpr int kStage = kTile + 1;    // start_e entries staged per block
constexpr unsigned kFull = 0xffffffffu;

// first index in [lo, hi) whose pivot is > x (hi if none)
__device__ __forceinline__ int32_t upper_bound(const int32_t* a, int32_t lo,
                                               int32_t hi, int32_t x) {
  while (lo < hi) {
    const int32_t mid = lo + ((hi - lo) >> 1);
    if (a[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// the slots a launch searches: the host's H, or min(H, *rows_ptr)
__device__ __forceinline__ int32_t slots(int32_t h,
                                         const int32_t* rows_ptr) {
  return rows_ptr != nullptr ? max(0, min(h, *rows_ptr)) : h;
}

struct Pass {
  const int32_t* col_idx;
  const int32_t* edge_w;
  const int32_t* hvidx;
  int32_t nb, v, kind;
};

// One id per lane; every lane of the warp calls it together (pull
// shuffles across the warp).  `e` is the CSR edge and `j` the slot.
template <typename T, bool ADD, bool PULL>
__device__ __forceinline__ void relax_id(const Pass& p,
                                         const T* __restrict__ values,
                                         T* labels,
                                         const bool* __restrict__ fmask,
                                         bool live, int32_t j, int32_t e) {
  int32_t dst = 0, w = 0, src = 0;
  if (live) {
    dst = __ldg(p.col_idx + e);
    if (p.kind == relax::MSG_ADD_W) w = __ldg(p.edge_w + e);
    src = __ldg(p.hvidx + j);
  }
  if constexpr (!PULL) {
    if (!live) return;                 // no collective follows in push
    const int32_t s = src < p.v ? src : 0;
    for (int32_t b = 0; b < p.nb; ++b) {
      const int64_t o = (int64_t)b * p.v;
      if (fmask[o + s])
        combine_at<ADD>(labels + o + dst, msg_of(p.kind, values[o + s], w));
    }
  } else {
    // runs of neighbouring lanes with one anchor (key); dead lanes -1
    const int lane = threadIdx.x & 31;
    const int32_t key = live && src < p.v ? src : -1;
    const int32_t nxt = __shfl_down_sync(kFull, key, 1);
    const unsigned ends = __ballot_sync(kFull, lane == 31 || nxt != key);
    const int run_end = __ffs(ends & (kFull << lane));   // exclusive
    const int32_t prv = __shfl_up_sync(kFull, key, 1);
    const bool head = key >= 0 && (lane == 0 || prv != key);
    for (int32_t b = 0; b < p.nb; ++b) {
      const int64_t o = (int64_t)b * p.v;
      T c = neutral<T, ADD>();
      int any = 0;
      if (key >= 0 && fmask[o + dst]) {
        c = msg_of(p.kind, values[o + dst], w);
        any = 1;
      }
      // after the step of stride s, a lane holds its run's lanes in
      // [lane, min(lane + 2s, run_end)); the head ends with its run
      for (int s = 1; s < 32; s <<= 1) {
        const T oc = __shfl_down_sync(kFull, c, s);
        const int oa = __shfl_down_sync(kFull, any, s);
        if (lane + s < run_end) {
          c = combine<ADD>(c, oc);
          any |= oa;
        }
      }
      if (head && any) combine_at<ADD>(labels + o + key, c);
    }
  }
}

// `lim` = min(span, total), the live ids [0, lim): from the host, or
// read here from the device total (`total_ptr`); 0 when the device row
// bound (`rows_ptr`) leaves no slot.  A block takes tiles
// blockIdx.x, blockIdx.x + gridDim.x, ...: one tile when the host sized
// the grid to lim, a grid-stride walk over [0, lim) when the grid was
// sized from the static span alone.
template <typename T, bool ADD, bool PULL>
__global__ void __launch_bounds__(kThreads) edge_lb_relax_cyclic(
    Pass p, const T* __restrict__ values, T* labels,
    const bool* __restrict__ fmask, const int32_t* __restrict__ start_e,
    const int32_t* __restrict__ row_start, int32_t h_host, int32_t lim_host,
    const int32_t* __restrict__ total_ptr,
    const int32_t* __restrict__ rows_ptr, int32_t span) {
  __shared__ int32_t stage[kStage];
  __shared__ int32_t window[2];
  device_count::count_launch();
  const int32_t h = slots(h_host, rows_ptr);
  const int32_t lim =
      h == 0 ? 0
      : total_ptr != nullptr ? max(0, min(span, *total_ptr)) : lim_host;
  for (int64_t t0 = (int64_t)blockIdx.x * kTile; t0 < lim;
       t0 += (int64_t)gridDim.x * kTile) {
    const int32_t t_lo = (int32_t)t0;
    const int32_t t_last =
        (int32_t)(t0 + kTile < lim ? t0 + kTile : (int64_t)lim) - 1;
    if (threadIdx.x == 0 || threadIdx.x == 32) {
      const int32_t x = threadIdx.x == 0 ? t_lo : t_last;
      const int32_t j = upper_bound(start_e, 0, h, x) - 1;
      window[threadIdx.x == 0 ? 0 : 1] = min(max(j, 0), h - 1);
    }
    __syncthreads();
    const int32_t lo_j = window[0];
    const int32_t win = window[1] - lo_j + 1;
    const bool staged = win <= kStage;
    if (staged)
      for (int32_t i = threadIdx.x; i < win; i += kThreads)
        stage[i] = __ldg(start_e + lo_j + i);
    __syncthreads();
    const int32_t* sw = staged ? stage : start_e + lo_j;
    for (int32_t k = threadIdx.x; k < kTile; k += kThreads) {
      const int32_t eid = t_lo + k;
      const bool live = eid <= t_last;
      int32_t j = 0, e = 0;
      if (live) {
        const int32_t r = max(upper_bound(sw, 0, win, eid) - 1, 0);
        j = lo_j + r;
        e = __ldg(row_start + j) + (eid - sw[r]);
      }
      relax_id<T, ADD, PULL>(p, values, labels, fmask, live, j, e);
    }
    __syncthreads();                 // the next tile rewrites the stage
  }
}

// The total comes from the host or from the device (`total_ptr`), and
// is 0 when the device row bound leaves no slot.  A live id i has eid >= i / T, so i / T < min(total, w_per): no id at or
// past T * min(total, w_per) is live, and the walk stops there.
template <typename T, bool ADD, bool PULL>
__global__ void __launch_bounds__(kThreads) edge_lb_relax_blocked(
    Pass p, const T* __restrict__ values, T* labels,
    const bool* __restrict__ fmask, const int32_t* __restrict__ start_e,
    const int32_t* __restrict__ row_start, int32_t h_host,
    int32_t total_host, const int32_t* __restrict__ total_ptr,
    const int32_t* __restrict__ rows_ptr, int32_t w_per, int32_t num_tiles,
    int32_t span) {
  device_count::count_launch();
  const int32_t h = slots(h_host, rows_ptr);
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
        j = min(max(upper_bound(start_e, 0, h, eid) - 1, 0), h - 1);
        e = __ldg(row_start + j) + (eid - __ldg(start_e + j));
      }
    }
    relax_id<T, ADD, PULL>(p, values, labels, fmask, live, j, e);
  }
}

template <typename T, bool ADD, bool PULL>
int launch(const Pass& p, const void* values, void* labels,
           const void* fmask, const void* start_e, const void* row_start,
           const void* total_ptr, const void* rows_ptr, int h, int total,
           int w_per, int num_tiles, int span, int blocked,
           cudaStream_t stream) {
  const T* val = static_cast<const T*>(values);
  T* lab = static_cast<T*>(labels);
  const bool* fm = static_cast<const bool*>(fmask);
  const int32_t* se = static_cast<const int32_t*>(start_e);
  const int32_t* rs = static_cast<const int32_t*>(row_start);
  const int32_t* tp = static_cast<const int32_t*>(total_ptr);
  const int32_t* rp = static_cast<const int32_t*>(rows_ptr);
  // a device total: the grid comes from the static span alone, a few
  // blocks per SM that walk the live ids (an empty huge bin costs one
  // short launch, not span / 2048 blocks that each exit)
  const int64_t resident = (int64_t)relax::sm_count() * 8;
  if (blocked) {
    int64_t blocks = ((int64_t)span + kThreads - 1) / kThreads;
    blocks = std::min<int64_t>(blocks,
                               tp != nullptr ? resident : (int64_t)1 << 20);
    if (blocks == 0) return 0;
    edge_lb_relax_blocked<T, ADD, PULL><<<(unsigned)blocks, kThreads, 0,
                                          stream>>>(
        p, val, lab, fm, se, rs, h, total, tp, rp, w_per, num_tiles, span);
  } else {
    const int32_t lim = tp != nullptr ? span : std::min(span, total);
    int64_t blocks = ((int64_t)lim + kTile - 1) / kTile;
    if (tp != nullptr) blocks = std::min(blocks, resident);
    if (blocks == 0) return 0;
    edge_lb_relax_cyclic<T, ADD, PULL><<<(unsigned)blocks, kThreads, 0,
                                         stream>>>(
        p, val, lab, fm, se, rs, h, lim, tp, rp, span);
  }
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
