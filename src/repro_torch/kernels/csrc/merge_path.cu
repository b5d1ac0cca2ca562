// merge_path_map: equal-work edge tiles of the merge-path executor, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/merge_path.py:107
// (merge_path_map; kernel body _kernel at :53).  The ids 0..n-1 are cut
// into tiles of `tile` consecutive ids; for every id e of tile t:
//
//   mask = e < total
//   j    = clip(upper_bound(start_e, e) - 1, 0, H-1)   (mask only)
//   ge   = mask ? row_start[j] + (e - start_e[j]) : 0
//   slot = mask ? j : 0
//
// Runs of zero-degree slots share one start_e value, so upper_bound - 1
// lands on the LAST slot of the run with start_e <= e: the
// searchsorted-right rule of the TPU kernel and of the plain version.
//
// What bounds it on this card: bytes.  Each id writes 9 bytes (ge and
// slot as 4-byte words, a 1-byte mask); the two [H] inputs are read at
// most once from HBM (8 bytes per slot), then served from L1/L2 to the
// searches.  The floor is 8*H + 9*n bytes over 3.35 TB/s.
//
// Design: one block per tile.  Two threads in different warps do the
// tile's two co-rank searches over the whole [0, H) in global memory
// (start_e can be 16 MB at H = 4 M, so it is not staged in shared
// memory) and leave the slot window [lo_j, hi_j] in shared memory.
// Every thread then maps its ids, one id per thread per step so the
// stores coalesce, by an upper-bound search restricted to
// [lo_j, hi_j + 1): the window is a handful of slots unless degrees are
// tiny, so the per-id search is short and its loads hit the same few
// cache lines across the block.  Ids at or past `total` are masked
// before any load, and a tile wholly past `total` does no search at
// all.  `total` comes from the host or, when `total_ptr` is non-null,
// from one int32 on the device (the static-shape round: JAX's
// merge_path_apply_static, src/repro/kernels/ops.py:96, enumerates a
// static span of E ids).  Then the grid comes from the span alone: a
// few blocks per SM walk its tiles, and a tile past the total writes
// its masked zeros without a search.  The kernel allocates nothing and
// launches on the caller's stream.
#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "device_count.cuh"

namespace {

// first index in [lo, hi) whose pivot is > x (hi if none)
__device__ __forceinline__ int32_t upper_bound(const int32_t* __restrict__ a,
                                               int32_t lo, int32_t hi,
                                               int32_t x) {
  while (lo < hi) {
    const int32_t mid = lo + ((hi - lo) >> 1);
    if (__ldg(a + mid) <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void merge_path_map_kernel(const int32_t* __restrict__ start_e,
                                      const int32_t* __restrict__ row_start,
                                      int32_t h, int32_t total_host,
                                      const int32_t* __restrict__ total_ptr,
                                      int32_t tile, int32_t n_tiles,
                                      int32_t* __restrict__ ge,
                                      int32_t* __restrict__ slot,
                                      bool* __restrict__ mask) {
  device_count::count_launch();
  __shared__ int32_t window[2];
  const int32_t total = total_ptr != nullptr ? *total_ptr : total_host;
  for (int32_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int32_t t_lo = t * tile;
    const bool live = t_lo < total;
    // co-rank of the tile's first and last live id, one thread each
    if (live && (threadIdx.x == 0 || threadIdx.x == 32)) {
      const int32_t x =
          threadIdx.x == 0 ? t_lo : min(total - 1, t_lo + tile - 1);
      const int32_t j = upper_bound(start_e, 0, h, x) - 1;
      window[threadIdx.x == 0 ? 0 : 1] = min(max(j, 0), h - 1);
    }
    __syncthreads();
    const int32_t lo_j = live ? window[0] : 0;
    const int32_t hi_j = live ? window[1] : 0;
    for (int32_t k = threadIdx.x; k < tile; k += blockDim.x) {
      const int32_t e = t_lo + k;
      const bool m = e < total;
      int32_t j = 0, g = 0;
      if (m) {
        j = min(max(upper_bound(start_e, lo_j, hi_j + 1, e) - 1, 0), h - 1);
        g = __ldg(row_start + j) + (e - __ldg(start_e + j));
      }
      ge[e] = g;
      slot[e] = j;
      mask[e] = m;
    }
    __syncthreads();                   // the next tile rewrites window
  }
}

}  // namespace

// total_ptr: null, or one int32 on the device that replaces `total`
extern "C" int merge_path_map_launch(const void* start_e,
                                     const void* row_start,
                                     const void* total_ptr, int h, int total,
                                     int tile, int n_tiles, void* ge,
                                     void* slot, void* mask, void* stream) {
  if (n_tiles == 0) return 0;
  // the block needs threads 0 and 32 for the two co-rank searches
  const int threads = 256;
  int blocks = n_tiles;
  if (total_ptr != nullptr) {          // grid-stride over the static span
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    blocks = std::min(n_tiles, std::max(sms, 1) * 8);
  }
  merge_path_map_kernel<<<blocks, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(start_e),
      static_cast<const int32_t*>(row_start), h, total,
      static_cast<const int32_t*>(total_ptr), tile, n_tiles,
      static_cast<int32_t*>(ge), static_cast<int32_t*>(slot),
      static_cast<bool*>(mask));
  return (int)cudaGetLastError();
}
