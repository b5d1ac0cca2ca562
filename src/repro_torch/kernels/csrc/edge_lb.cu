// edge_lb_map: edge-balanced renumbering of the ALB huge bin (the
// paper's SSSP_LB mapping), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/edge_lb.py:105
// (edge_lb_map; kernel body _kernel at :55).  For every enumerated id
// eid0 in [0, n_pad):
//
//   enum_ok = eid0 < span                  (span = w_per * num_tiles)
//   eid     = blocked ? (eid0 % T) * w_per + eid0 / T : eid0
//   mask    = enum_ok && eid < total
//   j       = clip(upper_bound(start_e, mask ? eid : 0) - 1, 0, H-1)
//   ge      = mask ? row_start[j] + (eid - start_e[j]) : 0
//   slot, val = j, hval[j]
//
// The span test comes BEFORE the blocked permutation: ids past the
// exact bijection domain must never alias a real edge, or an
// add-combine operator would process it twice (edge_lb.py:20-27).
//
// What bounds it on this card: bytes.  Each id writes 13 bytes (three
// 4-byte words and a 1-byte mask); the three [H] inputs are read once
// from HBM and then served from L1/L2 to the binary searches, whose
// ~log2(H) dependent loads per id are latency that the number of ids
// in flight hides.  The floor is n_pad*13 + 12*H bytes over 3.35 TB/s.
//
// Design: one thread per id, grid-stride.  Cyclic ids are contiguous,
// so neighbouring threads search for neighbouring ids along the same
// root-to-leaf path (the same cache lines) and their stores coalesce.
// start_e is searched in global memory: H can exceed shared memory on
// real graphs, so it is not staged there.  The kernel allocates
// nothing and launches on the caller's stream.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void edge_lb_map_kernel(const int32_t* __restrict__ start_e,
                                   const int32_t* __restrict__ row_start,
                                   const uint32_t* __restrict__ hval,
                                   const int32_t* __restrict__ total_ptr,
                                   int32_t h, int32_t total_host,
                                   int32_t w_per,
                                   int32_t num_tiles, int32_t span,
                                   int32_t n_pad, int32_t blocked,
                                   int32_t* __restrict__ ge,
                                   int32_t* __restrict__ slot,
                                   uint32_t* __restrict__ val_out,
                                   bool* __restrict__ mask) {
  const int32_t total = total_ptr != nullptr ? *total_ptr : total_host;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_pad; i += stride) {
    const int32_t eid0 = (int32_t)i;
    const bool enum_ok = eid0 < span;
    const int32_t eid =
        blocked ? (eid0 % num_tiles) * w_per + eid0 / num_tiles : eid0;
    const bool m = enum_ok && (eid < total);
    const int32_t e = m ? eid : 0;
    // searchsorted(start_e, e, side="right"): first index with a pivot > e
    int32_t lo = 0, hi = h;
    while (lo < hi) {
      const int32_t mid = (lo + hi) >> 1;
      if (__ldg(start_e + mid) <= e) lo = mid + 1; else hi = mid;
    }
    const int32_t j = min(max(lo - 1, 0), h - 1);
    ge[eid0] = m ? __ldg(row_start + j) + (e - __ldg(start_e + j)) : 0;
    slot[eid0] = j;
    val_out[eid0] = __ldg(hval + j);
    mask[eid0] = m;
  }
}

}  // namespace

// total_ptr: null, or one int32 on the device that replaces `total`
extern "C" int edge_lb_map_launch(const void* start_e, const void* row_start,
                                  const void* hval, const void* total_ptr,
                                  int h, int total,
                                  int w_per, int num_tiles, int span,
                                  int n_pad, int blocked, void* ge,
                                  void* slot, void* val_out, void* mask,
                                  void* stream) {
  if (n_pad == 0) return 0;
  const int threads = 256;
  int blocks = (n_pad + threads - 1) / threads;
  if (blocks > (1 << 20)) blocks = 1 << 20;   // grid-stride beyond this
  edge_lb_map_kernel<<<blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(start_e),
      static_cast<const int32_t*>(row_start),
      static_cast<const uint32_t*>(hval),
      static_cast<const int32_t*>(total_ptr), h, total, w_per, num_tiles, span,
      n_pad, blocked, static_cast<int32_t*>(ge),
      static_cast<int32_t*>(slot), static_cast<uint32_t*>(val_out),
      static_cast<bool*>(mask));
  return (int)cudaGetLastError();
}
