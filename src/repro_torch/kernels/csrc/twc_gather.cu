// twc_bin_map: expand one degree bin of the vertex-binned (TWC-analog)
// path into per-edge slots, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/twc_gather.py:54
// (twc_bin_map; kernel body _kernel at :34).  For bin member row r and
// lane l < W, with off = chunk*W + l:
//
//   mask[r,l]   = off < deg[r]  &&  vidx[r] < sentinel
//   ge[r,l]     = mask ? row_start[r] + off : 0     (CSR edge id)
//
// The contract's other two outputs, anchor[r,l] = vidx[r] and
// val[r,l] = val[r], are constant along each row: the wrapper returns
// them as stride-0 views of its inputs, as the plain version does, so
// the kernel neither reads val nor writes them.
//
// What bounds it on this card: bytes.  Each slot writes 5 bytes (the
// 4-byte edge id and a 1-byte mask) and does a handful of integer
// operations, so the floor is N*W*5 + N*12 bytes (three int32 [N]
// inputs) over the 3.35 TB/s of HBM3.
//
// Design: one thread per (row, lane) slot in row-major order, so a
// warp's stores are contiguous for both outputs (W = 8 puts four rows
// in one warp; W >= 32 gives each warp a run of one row).  The TPU
// kernel's padding of the lane axis to 128 is a VPU constraint and is
// dropped: outputs are exactly [N, W].  `chunk` comes from a host
// integer or, when `chunk_ptr` is non-null, from one int32 on the
// device, so a device-driven loop can advance it without a host sync.
// The kernel allocates nothing and launches on the caller's stream.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void twc_bin_map_kernel(const int32_t* __restrict__ vidx,
                                   const int32_t* __restrict__ deg,
                                   const int32_t* __restrict__ row_start,
                                   const int32_t* __restrict__ chunk_ptr,
                                   int32_t chunk_host, int64_t n_slots,
                                   int32_t width, int32_t sentinel,
                                   int32_t* __restrict__ ge,
                                   bool* __restrict__ mask) {
  const int32_t chunk = chunk_ptr != nullptr ? *chunk_ptr : chunk_host;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_slots; i += stride) {
    const int64_t row = i / width;
    const int32_t lane = (int32_t)(i - row * width);
    const int32_t off = chunk * width + lane;
    const bool m = (off < __ldg(deg + row)) && (__ldg(vidx + row) < sentinel);
    ge[i] = m ? __ldg(row_start + row) + off : 0;
    mask[i] = m;
  }
}

}  // namespace

extern "C" int twc_bin_map_launch(const void* vidx, const void* deg,
                                  const void* row_start,
                                  const void* chunk_ptr, int chunk_host,
                                  int n, int width, int sentinel,
                                  void* ge, void* mask, void* stream) {
  const int64_t n_slots = (int64_t)n * width;
  if (n_slots == 0) return 0;
  const int threads = 256;
  int64_t blocks = (n_slots + threads - 1) / threads;
  if (blocks > (1 << 20)) blocks = 1 << 20;   // grid-stride beyond this
  twc_bin_map_kernel<<<(unsigned)blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(vidx), static_cast<const int32_t*>(deg),
      static_cast<const int32_t*>(row_start),
      static_cast<const int32_t*>(chunk_ptr), chunk_host, n_slots, width,
      sentinel, static_cast<int32_t*>(ge), static_cast<bool*>(mask));
  return (int)cudaGetLastError();
}
