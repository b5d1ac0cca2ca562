// moe_plan: the whole MoE dispatch plan of one layer in one launch, for
// Hopper (sm_90a).
//
// Replaces, on the main path, the Pallas TPU kernel
// src/repro/kernels/moe_dispatch.py:45 (positions_in_expert_kernel)
// together with the plan that src/repro/models/moe.py:58
// (dispatch_plan) runs around it in XLA.  For each of G groups of Tg
// tokens over E experts (probs: float32 [G, Tg, E]) and each token t:
//
//   1. top-k: the K largest probabilities, ties to the lower index (the
//      stable descending sort of kernels/ref.py _top_k: a NaN first,
//      +0.0 and -0.0 equal);
//   2. gates: value / clamp(sum, min=1e-9), the sum added left to right
//      over k (_row_sum), the clamp passing NaN on as torch.clamp does,
//      the division IEEE (no --use_fast_math);
//   3. pos[s]: the arrival rank of slot s = t*K + k among the group's
//      slots of its expert, in slot order;
//   4. when `adaptive`, the ALB rebalance (_rebalance): load[e] =
//      min(count_e, cap), free = cap - load, start = exclusive prefix
//      sum of free; the overflow slots (pos >= cap), ranked in slot
//      order, are dealt over the free capacity: j = the last expert with
//      start[j] <= rank (searchsorted, side right, minus 1), new pos
//      load[j] + rank - start[j], new gate probs[t, j]; a slot whose
//      rank reaches total_free keeps its expert and its pos;
//   5. keep = pos < cap.
//
// Outputs [G, Tg*K]: flat_expert (int32), pos (int32), gate (float32),
// keep (bool).  They equal kernels/ref.py moe_plan_ref bitwise.
//
// What bounds it on this card: launch latency.  The function reads the
// probabilities once (4*G*Tg*E bytes) and writes 13 bytes a slot: about
// 1.4 MB at prefill (T = 4096, E = 64, K = 6; 0.4 us at 3.35 TB/s) and
// 1.4 KB at decode.  The plan it replaces was a chain of about 45 small
// torch ops (sort, cumsums, searchsorted, index_add_, gathers, wheres)
// plus the positions_in_expert kernel; here each group is one thread
// block cluster and the whole plan one launch.
//
// Design: group g is the cluster of CTAs [g*c, g*c + c), c = 1..8 by
// the group's slot count (the wrapper picks it); CTA r owns a
// contiguous range of tokens, so a contiguous range of slots.
//   pass 1 (one warp per token): the lanes hold the token's E
//     probabilities (kPer = 1, 2, 4 or 8 a lane, by E) as unsigned keys
//     of the sort's order and take K rounds of a warp argmax: each lane
//     its best untaken key, then __reduce_max_sync for the key and
//     __reduce_min_sync for the lowest index that holds it (two
//     instructions where a shuffle tree takes ten); lane k keeps round
//     k's winner and reloads its value.  Every lane forms the sum in
//     order from shuffles; lane k writes flat_expert and its gate and
//     counts its expert in the CTA's shared counts.
//   cluster.sync(); then each CTA reads every CTA's counts through
//     distributed shared memory (cluster.map_shared_rank): the sum over
//     lower ranks is its per-expert rank base, the sum over all gives
//     load; the overflow slots of the lower ranks follow from the same
//     counts (of a CTA's n slots of expert x from base b, those at rank
//     >= cap: n - min(n, max(0, cap - b))), so one exchange serves both.
//     One warp scans free into start.  A second cluster.sync() keeps
//     every CTA's counts alive until all have read them.
//   pass 3 (tiles of blockDim slots, in slot order): a warp groups its
//     lanes by expert (__match_any_sync), a popcount of the lower peers
//     ranks them inside the warp; the warps' counts (a [warps][E] table)
//     are scanned per expert from a running carry.  A ballot and a scan
//     of the warps' counts rank the overflow slots from the CTA's
//     overflow base; each searches start in shared memory.
// There is no global histogram, no second launch, and nothing is
// allocated but the outputs.  The kernel launches on the caller's stream.
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxExperts = 256;
constexpr int kMaxTopK = 16;
constexpr int kMaxCluster = 8;
constexpr unsigned kFull = 0xffffffffu;

// The order of torch.sort(descending=True, stable=True) as an unsigned
// key, largest first: a NaN above every number, -0.0 equal to +0.0, the
// other floats by value.  No number maps to 0, which marks "none".
__device__ __forceinline__ unsigned order_key(float v) {
  if (v != v) return 0xffffffffu;                // NaN (no fast math)
  if (v == 0.0f) v = 0.0f;                       // -0.0 ties +0.0
  const unsigned b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// kPer: the probabilities a lane holds, ceil(E / 32) rounded up to a
// power of two (the launcher picks the instance)
template <int kPer>
__global__ void __launch_bounds__(1024)
moe_plan_kernel(const float* __restrict__ probs, int tg, int e, int k,
                int cap, int adaptive, int32_t* flat_expert,
                int32_t* __restrict__ pos, float* gate,
                bool* __restrict__ keep) {
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.num_blocks();
  const int r = (int)cluster.block_rank();
  const int grp = blockIdx.x / c;
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1u;

  extern __shared__ int32_t smem[];
  int32_t* cnt = smem;                   // [E] this CTA's slots per expert
  int32_t* carry = cnt + e;              // [E] running rank per expert
  int32_t* load = carry + e;             // [E] min(count, cap)
  int32_t* start = load + e;             // [E] exclusive sum of free
  int32_t* warp_ov = start + e;          // [32] overflow slots per warp
  int32_t* scal = warp_ov + 32;          // total_free, ovf base, tile ovf
  int32_t* warp_cnt = scal + 4;          // [warps][E]

  const int n = tg * k;
  const int per_cta = (tg + c - 1) / c;
  const int t_lo = min(tg, r * per_cta);
  const int t_hi = min(tg, t_lo + per_cta);
  const float* P = probs + (int64_t)grp * tg * e;
  int32_t* FE = flat_expert + (int64_t)grp * n;
  int32_t* POS = pos + (int64_t)grp * n;
  float* GATE = gate + (int64_t)grp * n;
  bool* KEEP = keep + (int64_t)grp * n;

  for (int x = threadIdx.x; x < e; x += blockDim.x) cnt[x] = 0;
  for (int x = threadIdx.x; x < warps * e; x += blockDim.x) warp_cnt[x] = 0;
  if (threadIdx.x < 4) scal[threadIdx.x] = 0;
  __syncthreads();

  // ---- pass 1: top-k, gates and counts, one warp per token ------------
  for (int t = t_lo + warp; t < t_hi; t += warps) {
    const float* row = P + (int64_t)t * e;
    unsigned key[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = lane + 32 * j;
      key[j] = i < e ? order_key(__ldg(row + i)) : 0u;
    }
    unsigned taken = 0;
    int mine = 0;                        // lane kk: round kk's expert
    for (int kk = 0; kk < k; ++kk) {
      unsigned best = 0;                 // the lane's best untaken value,
      int bi = e;                        // the lower index on ties
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        if (!((taken >> j) & 1u) && key[j] > best) {
          best = key[j];
          bi = lane + 32 * j;
        }
      }
      const unsigned top = __reduce_max_sync(kFull, best);
      const unsigned win =
          __reduce_min_sync(kFull, best == top ? (unsigned)bi : 0xffffffffu);
      if ((int)(win & 31u) == lane) taken |= 1u << (win >> 5);
      if (lane == kk) mine = (int)win;
    }
    // the values themselves (a key has lost -0.0 and a NaN's bits)
    const float mine_v = lane < k ? __ldg(row + mine) : 0.0f;
    float sum = __shfl_sync(kFull, mine_v, 0);
    for (int kk = 1; kk < k; ++kk) sum = sum + __shfl_sync(kFull, mine_v, kk);
    const float den = sum < 1e-9f ? 1e-9f : sum;   // NaN stays NaN
    if (lane < k) {
      const int s = t * k + lane;
      FE[s] = mine;
      GATE[s] = mine_v / den;
      atomicAdd(&cnt[mine], 1);
    }
  }
  cluster.sync();                        // every CTA's counts are final

  // ---- the group's loads, this CTA's rank bases and overflow base -----
  int ovf_before = 0;
  for (int x = threadIdx.x; x < e; x += blockDim.x) {
    int tot = 0;
    for (int q = 0; q < c; ++q) {
      const int nq = *cluster.map_shared_rank(cnt + x, q);
      if (q < r) ovf_before += nq - min(nq, max(0, cap - tot));
      if (q == r) carry[x] = tot;
      tot += nq;
    }
    load[x] = min(tot, cap);
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    ovf_before += __shfl_xor_sync(kFull, ovf_before, d);
  if (lane == 0 && ovf_before) atomicAdd(&scal[1], ovf_before);
  __syncthreads();
  if (warp == 0) {                       // start: exclusive sum of free
    const int per = (e + 31) >> 5;
    int own = 0;
    for (int j = 0; j < per; ++j) {
      const int x = lane * per + j;
      if (x < e) own += cap - load[x];
    }
    int incl = own;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += y;
    }
    int run = incl - own;
    for (int j = 0; j < per; ++j) {
      const int x = lane * per + j;
      if (x < e) {
        start[x] = run;
        run += cap - load[x];
      }
    }
    if (lane == 31) scal[0] = incl;      // total_free
  }
  cluster.sync();                        // no CTA leaves while read

  // ---- pass 3: ranks in slot order, and the rebalance -----------------
  const int total_free = scal[0];
  int ov_carry = scal[1];
  for (int base = t_lo * k; base < t_hi * k; base += blockDim.x) {
    const int s = base + threadIdx.x;
    const bool valid = s < t_hi * k;
    const int ex = valid ? FE[s] : -1;   // written in pass 1 by this CTA
    const unsigned peers = __match_any_sync(kFull, ex);
    const bool leader = valid && lane == __ffs(peers) - 1;
    if (leader) warp_cnt[warp * e + ex] = __popc(peers);
    __syncthreads();
    for (int x = threadIdx.x; x < e; x += blockDim.x) {
      int run = carry[x];                // exclusive scan over the warps
      for (int w = 0; w < warps; ++w) {
        const int v = warp_cnt[w * e + x];
        if (v) {
          warp_cnt[w * e + x] = run;
          run += v;
        }
      }
      carry[x] = run;
    }
    __syncthreads();
    int p = valid ? warp_cnt[warp * e + ex] + __popc(peers & lower) : 0;
    __syncwarp();
    if (leader) warp_cnt[warp * e + ex] = 0;   // the table is zero again
    if (adaptive) {
      const bool ov = valid && p >= cap;
      const unsigned bal = __ballot_sync(kFull, ov);
      if (lane == 0) warp_ov[warp] = __popc(bal);
      __syncthreads();
      if (warp == 0) {
        const int v = lane < warps ? warp_ov[lane] : 0;
        int incl = v;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int y = __shfl_up_sync(kFull, incl, d);
          if (lane >= d) incl += y;
        }
        if (lane < warps) warp_ov[lane] = incl - v;
        if (lane == 31) scal[2] = incl;
      }
      __syncthreads();
      if (ov) {
        const int rank = ov_carry + warp_ov[warp] + __popc(bal & lower);
        if (rank < total_free) {
          int lo = 0, hi = e;            // first expert with start > rank
          while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (start[mid] <= rank) lo = mid + 1; else hi = mid;
          }
          const int j = lo - 1;          // >= 0: start[0] = 0 <= rank
          FE[s] = j;
          GATE[s] = __ldg(P + (int64_t)(s / k) * e + j);
          p = load[j] + (rank - start[j]);
        }
      }
      ov_carry += scal[2];
    }
    if (valid) {
      POS[s] = p;
      KEEP[s] = p < cap;
    }
  }
}

}  // namespace

extern "C" int moe_plan_max_experts() { return kMaxExperts; }
extern "C" int moe_plan_max_top_k() { return kMaxTopK; }
extern "C" int moe_plan_max_cluster() { return kMaxCluster; }

extern "C" int moe_plan_launch(const void* probs, int groups, int tg,
                               int e, int k, int cap, int adaptive,
                               int cluster, void* flat_expert, void* pos,
                               void* gate, void* keep, void* stream) {
  if (groups == 0 || tg == 0) return 0;
  if (e < 1 || e > kMaxExperts || k < 1 || k > kMaxTopK || k > e ||
      cluster < 1 || cluster > kMaxCluster || cap < 0)
    return (int)cudaErrorInvalidValue;
  const int per_cta = (tg + cluster - 1) / cluster;
  const int warps = per_cta < 32 ? per_cta : 32;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(groups * cluster, 1, 1);
  cfg.blockDim = dim3(32 * warps, 1, 1);
  cfg.dynamicSmemBytes = sizeof(int32_t) * ((size_t)(warps + 4) * e + 36);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void (*kernel)(const float*, int, int, int, int, int, int32_t*, int32_t*,
                 float*, bool*) =
      e <= 32 ? moe_plan_kernel<1> : e <= 64 ? moe_plan_kernel<2>
      : e <= 128 ? moe_plan_kernel<4> : moe_plan_kernel<8>;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const float*>(probs), tg, e, k, cap,
      adaptive, static_cast<int32_t*>(flat_expert),
      static_cast<int32_t*>(pos), static_cast<float*>(gate),
      static_cast<bool*>(keep));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
