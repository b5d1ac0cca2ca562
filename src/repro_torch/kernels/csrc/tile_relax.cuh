// tile_relax.cuh: the fused relax body of the edge-balanced kernels
// (edge_lb_relax.cu, merge_path_relax.cu) and the contiguous tile walk
// they share.
//
// An id maps to a slot j of a slot list (hvidx / start_e / row_start:
// the enumerated vertices, the exclusive prefix of their degrees and
// their CSR row starts) and to the CSR edge
//
//   j = clip(upper_bound(start_e[0:H), id) - 1, 0, H-1)
//   e = row_start[j] + (id - start_e[j]),   src = hvidx[j]
//
// and, for every query b, a live id does
//
//   push:  labels[b, col_idx[e]] = combine(.., msg(values[b, src'], w[e]))
//          where fmask[b, src']   (src' = src < V ? src : 0, as the plain
//          version gathers)
//   pull:  labels[b, src] = combine(.., msg(values[b, col_idx[e]], w[e]))
//          where fmask[b, col_idx[e]] and src < V
//
// `tile_relax` walks contiguous tiles of `tile` ids below a limit: the
// merge-path scheme (Merrill & Garland; src/repro/kernels/merge_path.py),
// which edge_lb_relax's cyclic deal also is, at a fixed tile of 2048
// ids.  The two kernels share this one walk, stage and id loop, so that
// a change to any of them is measured on both and the two stay bitwise
// alike; what differs stays in each source (edge_lb_relax's blocked
// deal, merge_path_relax's configured tile).  Per tile, two threads in
// different warps find the slot window by co-rank searches over
// start_e, the block stages start_e over the window in dynamic shared
// memory (`stage_cap` entries, given by the launch), and each id
// searches only that window there.  A window wider than the stage
// searches it in global memory: over a slot list whose every slot owns
// an edge a tile spans at most tile + 1 slots, so only runs of
// zero-degree slots (a layout over V rows, a host round's bucket
// padding) or a tile past what shared memory holds get there.
//
// The id loop: a thread owns ids k, k + 256, ... of a tile and takes
// them one at a time, a chain of loads (row_start, col_idx, edge_w,
// hvidx, then a value and, for a min, a label probe) and an atomic.
// Taking 2, 4 or 8 ids at a time, their loads and probes before the
// first atomic, was measured against it (PERF.md, section 6): within
// 3% either way at 2 and 4, and 8-61% slower at 8, whose 80-111
// registers a thread (against 29-32) leave a quarter to three eighths
// of the resident warps that hide the chains' latency.  Push reads
// values[b, src] per query: one slot's ids are neighbours, so those
// loads are L1 hits.  Pull combines at the anchor, which a whole run of
// neighbouring lanes shares: each warp first reduces every run of lanes
// with one anchor into its first lane (shuffles), and only that lane
// does the atomic.  So a float add here is order-dependent (atomics),
// as index_add_ is.
//
// The limit comes from the host or, when `total_ptr` is non-null, from
// one int32 on the device (the static-shape round's total); the slots H
// from the host or, when `rows_ptr` is non-null, are bounded by one
// int32 on the device (a slot list's member count).  With a device
// total the launch sizes the grid from the span alone, the blocks the
// card holds at once, which walk the tiles below the total they read:
// a round whose total is 0 costs one launch whose blocks exit at once.
#pragma once
#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "device_count.cuh"
#include "relax.cuh"

namespace tiles {

using relax::combine;
using relax::combine_at;
using relax::msg_of;
using relax::neutral;

constexpr int kThreads = 256;
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
// bound (`rows_ptr`) leaves no slot.  A block takes tiles blockIdx.x,
// blockIdx.x + gridDim.x, ...: one tile when the host sized the grid to
// lim, a grid-stride walk over [0, lim) when the grid was sized from
// the static span alone.  `tile` is a multiple of 128, so the lanes of
// a warp agree on which of their ids lie in the tile.
template <typename T, bool ADD, bool PULL>
__global__ void __launch_bounds__(kThreads) tile_relax(
    Pass p, const T* __restrict__ values, T* labels,
    const bool* __restrict__ fmask, const int32_t* __restrict__ start_e,
    const int32_t* __restrict__ row_start, int32_t h_host, int32_t lim_host,
    const int32_t* __restrict__ total_ptr,
    const int32_t* __restrict__ rows_ptr, int32_t span, int32_t tile,
    int32_t stage_cap) {
  extern __shared__ int32_t stage[];
  __shared__ int32_t window[2];
  device_count::count_launch();
  const int32_t h = slots(h_host, rows_ptr);
  const int32_t lim =
      h == 0 ? 0
      : total_ptr != nullptr ? max(0, min(span, *total_ptr)) : lim_host;
  for (int64_t t0 = (int64_t)blockIdx.x * tile; t0 < lim;
       t0 += (int64_t)gridDim.x * tile) {
    const int32_t t_lo = (int32_t)t0;
    const int32_t t_last =
        (int32_t)(t0 + tile < lim ? t0 + tile : (int64_t)lim) - 1;
    if (threadIdx.x == 0 || threadIdx.x == 32) {
      const int32_t x = threadIdx.x == 0 ? t_lo : t_last;
      const int32_t j = upper_bound(start_e, 0, h, x) - 1;
      window[threadIdx.x == 0 ? 0 : 1] = min(max(j, 0), h - 1);
    }
    __syncthreads();
    const int32_t lo_j = window[0];
    const int32_t win = window[1] - lo_j + 1;
    const bool staged = win <= stage_cap;
    if (staged)
      for (int32_t i = threadIdx.x; i < win; i += kThreads)
        stage[i] = __ldg(start_e + lo_j + i);
    __syncthreads();
    const int32_t* sw = staged ? stage : start_e + lo_j;
    for (int32_t k = threadIdx.x; k < tile; k += kThreads) {
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

// Launch tile_relax over ids [0, min(span, total)) in tiles of `tile`.
// A host total sizes the grid to its tiles; a device total (`total_ptr`)
// to the blocks the card holds at once.  The stage takes tile + 1
// entries where the block's shared memory holds them, else as many as
// it holds.
template <typename T, bool ADD, bool PULL>
int launch_tiles(const Pass& p, const void* values, void* labels,
                 const void* fmask, const void* start_e,
                 const void* row_start, const void* total_ptr,
                 const void* rows_ptr, int h, int total, int span, int tile,
                 cudaStream_t stream) {
  const auto kernel = tile_relax<T, ADD, PULL>;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  const int64_t room = std::max<int64_t>(optin - 64, 0) / 4;
  const int32_t stage_cap = (int32_t)std::min<int64_t>((int64_t)tile + 1,
                                                       room);
  const size_t smem = (size_t)stage_cap * 4;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  const int32_t* tp = static_cast<const int32_t*>(total_ptr);
  const int32_t lim = tp != nullptr ? span : std::min(span, total);
  int64_t blocks = ((int64_t)lim + tile - 1) / tile;
  if (tp != nullptr) {
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                  smem);
    blocks = std::min<int64_t>(blocks,
                               (int64_t)relax::sm_count() *
                                   std::max(per_sm, 1));
  }
  if (blocks == 0) return 0;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      p, static_cast<const T*>(values), static_cast<T*>(labels),
      static_cast<const bool*>(fmask), static_cast<const int32_t*>(start_e),
      static_cast<const int32_t*>(row_start), h, lim, tp,
      static_cast<const int32_t*>(rows_ptr), span, tile, stage_cap);
  return (int)cudaGetLastError();
}

}  // namespace tiles
