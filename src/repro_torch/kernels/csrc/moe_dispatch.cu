// positions_in_expert: arrival rank of each MoE token slot within its
// expert, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/moe_dispatch.py:45
// (positions_in_expert_kernel; kernel body _kernel at :25):
//
//   pos[i] = #{ j < i : flat_expert[j] == flat_expert[i] }
//
// for ids in [0, E); any other id (the TPU wrapper pads with E + 1)
// gets pos = 0 and is counted for nothing.
//
// The TPU kernel walks token tiles in grid order and carries E running
// counters in VMEM from one grid step to the next.  CUDA blocks run in
// no fixed order, so that carry cannot be copied.  This kernel is
// order-free instead, in three passes over tiles of 1024 slots:
//
//   1. tile_rank (one block of 1024 threads per tile, one slot a
//      thread): the stable rank of each slot among the tile's slots of
//      the same expert -- __match_any_sync groups the lanes of a warp
//      by expert, a popcount of the lower peers gives the rank inside
//      the warp, and an exclusive scan of the per-warp counts over the
//      tile's 32 warps (one thread per expert, in shared memory) gives
//      each warp's base.  The tile's per-expert totals go to
//      hist[E][tiles];
//   2. tile_scan (one block per expert): an exclusive scan of that
//      expert's row of hist over the tiles, in place;
//   3. add_base (one thread per slot): pos += hist[e][tile].
//
// A single tile (N <= 1024, every decode step) needs pass 1 only.  The
// three passes were chosen over a decoupled look-back scan because
// each is a plain block-local step with no inter-block protocol, and
// over one block looping over the tiles in order because that runs on
// one SM: at N = 24,576 (prefill) it would serialize 24 tiles.
//
// What bounds it on this card: bytes.  The function reads 4 bytes and
// writes 4 bytes per slot (8N); the passes move about 20N bytes plus
// the [E, tiles] counts (8 E N / 1024), all far below a microsecond at
// the main path's N, so launch latency dominates.  Shared memory per
// tile block: 32 warps x kMaxExperts counts = 32 KB.  The kernels
// allocate nothing and launch on the caller's stream.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 1024;               // slots per tile = threads
constexpr int kWarps = kTile / 32;
constexpr int kMaxExperts = 256;          // the wrapper checks E
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kTile)
tile_rank_kernel(const int32_t* __restrict__ eid, int32_t n,
                 int32_t num_experts, int32_t* __restrict__ pos,
                 int32_t* __restrict__ hist, int32_t tiles) {
  __shared__ int32_t warp_cnt[kWarps][kMaxExperts];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int k = threadIdx.x; k < kWarps * kMaxExperts; k += kTile)
    (&warp_cnt[0][0])[k] = 0;
  __syncthreads();

  const int64_t i = (int64_t)blockIdx.x * kTile + threadIdx.x;
  int32_t e = i < n ? eid[i] : -1;
  const bool valid = e >= 0 && e < num_experts;
  if (!valid) e = -1;                     // one group, counted for nothing
  const unsigned peers = __match_any_sync(kFull, e);
  const int rank = __popc(peers & ((1u << lane) - 1u));
  if (valid && lane == __ffs(peers) - 1) warp_cnt[warp][e] = __popc(peers);
  __syncthreads();

  // exclusive scan of the per-warp counts over the tile, per expert
  for (int x = threadIdx.x; x < num_experts; x += kTile) {
    int32_t run = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int32_t c = warp_cnt[w][x];
      warp_cnt[w][x] = run;
      run += c;
    }
    if (hist != nullptr) hist[(int64_t)x * tiles + blockIdx.x] = run;
  }
  __syncthreads();
  if (i < n) pos[i] = valid ? warp_cnt[warp][e] + rank : 0;
}

__global__ void __launch_bounds__(kTile)
tile_scan_kernel(int32_t* __restrict__ hist, int32_t tiles) {
  __shared__ int32_t warp_sum[kWarps];
  __shared__ int32_t carry;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int32_t* row = hist + (int64_t)blockIdx.x * tiles;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < tiles; base += kTile) {
    const int t = base + threadIdx.x;
    const int32_t v = t < tiles ? row[t] : 0;
    int32_t x = v;                        // inclusive scan in the warp
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t y = __shfl_up_sync(kFull, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) warp_sum[warp] = x;
    __syncthreads();
    if (warp == 0) {                      // scan of the 32 warp sums
      int32_t s = warp_sum[lane];
      for (int d = 1; d < 32; d <<= 1) {
        const int32_t y = __shfl_up_sync(kFull, s, d);
        if (lane >= d) s += y;
      }
      warp_sum[lane] = s;
    }
    __syncthreads();
    const int32_t excl = carry + (warp > 0 ? warp_sum[warp - 1] : 0) + x - v;
    if (t < tiles) row[t] = excl;
    __syncthreads();                      // every thread has read carry
    if (threadIdx.x == kTile - 1) carry = excl + v;
    __syncthreads();
  }
}

__global__ void add_base_kernel(const int32_t* __restrict__ eid, int32_t n,
                                int32_t num_experts,
                                const int32_t* __restrict__ hist,
                                int32_t tiles, int32_t* __restrict__ pos) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t tile = (int32_t)(i / kTile);
  const int32_t e = eid[i];
  if (tile == 0 || e < 0 || e >= num_experts) return;
  pos[i] += hist[(int64_t)e * tiles + tile];
}

}  // namespace

extern "C" int positions_in_expert_max_experts() { return kMaxExperts; }

extern "C" int positions_in_expert_launch(const void* eid, int n,
                                          int num_experts, void* pos,
                                          void* hist, void* stream) {
  if (n == 0) return 0;
  if (num_experts < 1 || num_experts > kMaxExperts) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = (n + kTile - 1) / kTile;
  const int32_t* e = static_cast<const int32_t*>(eid);
  int32_t* p = static_cast<int32_t*>(pos);
  int32_t* h = tiles > 1 ? static_cast<int32_t*>(hist) : nullptr;
  tile_rank_kernel<<<tiles, kTile, 0, st>>>(e, n, num_experts, p, h, tiles);
  if (tiles > 1) {
    tile_scan_kernel<<<num_experts, kTile, 0, st>>>(h, tiles);
    const int threads = 256;
    add_base_kernel<<<(n + threads - 1) / threads, threads, 0, st>>>(
        e, n, num_experts, h, tiles, p);
  }
  return (int)cudaGetLastError();
}
