// device_count.cuh: a kernel's launches counted on the card.
//
// A launch recorded into a CUDA graph runs each time the graph is
// replayed, and a kernel inside a WHILE node once per turn, with no
// host call to count it.  So the kernels that the static-shape round
// and the fused loop run (twc_relax.cu, twc_list.cu, edge_lb_relax.cu,
// merge_path_relax.cu, merge_path.cu, round_turn.cu) count their own
// launches here:
// thread 0 of block 0 adds one (a single atomic a launch).  Each source
// is built into a library of its own, so each has its own counter;
// `device_launches` reads it and may reset it (a copy from device
// memory: it syncs).  The Python wrappers read it through
// build.device_launches.
#pragma once
#include <cuda_runtime.h>

namespace device_count {

__device__ unsigned long long g_launches;

// call once at the start of every kernel that the source launches
__device__ __forceinline__ void count_launch() {
  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 &&
      threadIdx.x == 0 && threadIdx.y == 0 && threadIdx.z == 0)
    atomicAdd(&g_launches, 1ull);
}

}  // namespace device_count

// launches counted since the last reset (reads device memory: syncs)
extern "C" int device_launches(unsigned long long* n, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(n, device_count::g_launches,
                                       sizeof(*n));
  if (e != cudaSuccess || !reset) return (int)e;
  const unsigned long long zero = 0;
  return (int)cudaMemcpyToSymbol(device_count::g_launches, &zero,
                                 sizeof(zero));
}
