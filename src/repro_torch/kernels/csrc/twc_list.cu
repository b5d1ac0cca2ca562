// twc_bin_list: the static-shape round's degree bins and its LB bin,
// listed once a round, for Hopper (sm_90a).
//
// Replaces no TPU kernel.  It stands for the layout the JAX package's
// static round builds with jnp.where (src/repro/core/balancer.py:999,
// and the huge bin's prefix sum that src/repro/kernels/ops.py:52,
// edge_lb_apply_static, takes over V rows): there every bin is laid
// out over V rows, member or sentinel, in frontier order, and each
// bin's kernel walks all V rows.  Here one launch reads the frontier
// layout's rows [0, *n_ptr) once (fidx, deg, row_start as
// balancer._frontier_meta gives them), puts each row in the bin whose
// degree range holds it (lo[b] < deg <= hi[b]; a row with fidx >= N, or
// in no range, is in none) and writes, for every bin b,
//
//   out_vidx / out_deg / out_row [b, 0 .. count[b])   the members, in
//                                                     frontier order
//   scratch[1 + b]        = count[b]
//   scratch[1 + nb + b]   = the largest member degree (0 when empty)
//
// and, when the caller names an LB bin (the plan's edge-balanced path:
// the huge bin, or every vertex with an edge),
//
//   out_start [0 .. count[lb])   the exclusive prefix of its members'
//                                degrees, in list order
//   scratch[1 + 2 nb]            = its edge total
//
// Rows past a bin's count are left as they were: twc_bin_relax and
// edge_lb_relax read rows [0, count[b]) of a list and no further.
// Frontier order is the order the host round gathers a bin in
// (balancer._assemble_bins), so a static launch then runs the same rows
// in the same order as the host round's, and the LB list with its
// prefix maps every edge id to the same (slot, CSR edge) as the V-row
// layout's prefix does: a zero-degree slot owns no id.
//
// What bounds it on this card: bytes.  A listed row is read once (12
// bytes), a member written once per array (12 bytes, 16 in the LB
// bin); at rmat 22 with every vertex listed (pagerank) that is about
// 100 MB, 0.03 ms at 3.35 TB/s.  One listing pass replaces the V-row
// walks of every bin and the LB bin's V-row mask, gathers, prefix sum
// and sums.
//
// Design: a tile of 1,024 rows goes to one block of 256 threads, four
// consecutive rows a thread (one 16-byte load of each input where the
// pointers allow it).  Each thread counts its members per bin, packed
// 16 bits a bin in one 64-bit word (a tile holds at most 1,024 of a
// bin), and sums its LB members' degrees, so one shuffle scan over the
// warp and a serial scan over the block's eight warps rank every member
// within the tile and give each LB member its degree prefix there.  The
// tiles are ranked against each other by a decoupled look-back: a block
// takes its tile from a ticket counter, so every earlier tile is held
// by a block that is running; it publishes its tile's per-bin
// aggregate, then one warp per bin reads the earlier tiles' status
// words 32 at a time, waits until all 32 are published, and sums back
// to the nearest inclusive prefix, which it adds to its aggregate and
// publishes.  A status word is 64 bits: two flags, then the member
// count and, for the LB bin, the degree sum, 31 bits each.  So one
// look-back gives the LB bin's rank and edge prefix together, and any
// total of an int32 CSR fits (a frontier layout lists each vertex
// once: its degrees sum to at most E < 2^31).  No block waits on a
// later tile, so the walk always ends.  A resident grid, as many blocks
// as the SMs hold at once, loops over the tickets; it is fixed by N, so
// a captured round replays for any *n_ptr.  (Counting each block's
// contiguous chunk first and summing every earlier chunk's count, with
// no look-back chain, was a little faster with every row of rmat 22
// listed and slower on sssp's small frontiers, which are most
// launches.)
// The ticket, the counts, the largest degrees, the LB total and the
// status words live in `scratch`, which the caller zeroes before each
// launch; the kernel allocates nothing and launches on the caller's
// stream.
#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "device_count.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;                  // consecutive rows a thread
static_assert(kItems % 4 == 0, "rows a thread come in 16-byte loads");
constexpr int kTile = kThreads * kItems;   // rows a tile
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBins = 4;
// scratch ints before the status words: ticket, counts, largest degrees,
// LB total; 16 keeps the 64-bit status words 8-byte aligned
constexpr int kHeader = 16;
static_assert(2 + 2 * kMaxBins <= kHeader, "the header holds the scalars");
// a status word: bit 63 an inclusive prefix, bit 62 a tile's aggregate,
// then the degree sum (bits 31..61) and the member count (bits 0..30);
// 0 = not yet published
constexpr unsigned long long kPrefix = 1ull << 63;
constexpr unsigned long long kAggregate = 1ull << 62;
constexpr int kDegShift = 31;
constexpr uint32_t kField = (1u << 31) - 1u;

struct Bins {
  int32_t lo[kMaxBins];
  int32_t hi[kMaxBins];
};

__device__ __forceinline__ uint32_t field(unsigned long long x, int b) {
  return (uint32_t)(x >> (16 * b)) & 0xffffu;
}

__global__ void __launch_bounds__(kThreads) twc_bin_list_kernel(
    const int32_t* __restrict__ fidx, const int32_t* __restrict__ deg,
    const int32_t* __restrict__ row_start,
    const int32_t* __restrict__ n_ptr, int32_t n_host,
    int32_t* __restrict__ out_vidx, int32_t* __restrict__ out_deg,
    int32_t* __restrict__ out_row, int32_t* __restrict__ out_start,
    int32_t* scratch, Bins bins, int32_t nb, int32_t lb, int32_t n) {
  device_count::count_launch();
  const int32_t limit = n_ptr != nullptr ? *n_ptr : n_host;
  const int64_t rows = limit < 0 ? 0 : (limit < n ? limit : n);
  const int64_t ntiles = (rows + kTile - 1) / kTile;
  int32_t* ticket = scratch;
  int32_t* counts = scratch + 1;
  int32_t* maxdeg = scratch + 1 + nb;
  int32_t* lb_total = scratch + 1 + 2 * nb;
  volatile unsigned long long* status =
      reinterpret_cast<volatile unsigned long long*>(scratch + kHeader);
  const bool vec = ((reinterpret_cast<uintptr_t>(fidx) |
                     reinterpret_cast<uintptr_t>(deg) |
                     reinterpret_cast<uintptr_t>(row_start)) & 15) == 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;

  __shared__ int32_t s_tile;
  __shared__ unsigned long long s_warp[kWarps];
  __shared__ uint32_t s_wdeg[kWarps];
  __shared__ int32_t s_base[kMaxBins];
  __shared__ int32_t s_max[kMaxBins];
  __shared__ uint32_t s_dbase;
  for (;;) {
    if (threadIdx.x == 0) s_tile = atomicAdd(ticket, 1);
    if (threadIdx.x < kMaxBins) s_max[threadIdx.x] = 0;
    __syncthreads();
    const int64_t t = s_tile;                  // uniform in the block
    if (t >= ntiles) return;
    const int64_t r0 = t * kTile + (int64_t)threadIdx.x * kItems;

    int32_t vid[kItems], d[kItems], rs[kItems];
    if (vec && r0 + kItems <= rows) {
#pragma unroll
      for (int j = 0; j < kItems / 4; ++j) {
        const int4 a = __ldg(reinterpret_cast<const int4*>(fidx + r0) + j);
        const int4 b = __ldg(reinterpret_cast<const int4*>(deg + r0) + j);
        const int4 c =
            __ldg(reinterpret_cast<const int4*>(row_start + r0) + j);
        vid[4 * j] = a.x, vid[4 * j + 1] = a.y, vid[4 * j + 2] = a.z,
                vid[4 * j + 3] = a.w;
        d[4 * j] = b.x, d[4 * j + 1] = b.y, d[4 * j + 2] = b.z,
              d[4 * j + 3] = b.w;
        rs[4 * j] = c.x, rs[4 * j + 1] = c.y, rs[4 * j + 2] = c.z,
               rs[4 * j + 3] = c.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const bool in = r0 + i < rows;
        vid[i] = in ? __ldg(fidx + r0 + i) : n;
        d[i] = in ? __ldg(deg + r0 + i) : 0;
        rs[i] = in ? __ldg(row_start + r0 + i) : 0;
      }
    }
    // each row's bin (-1: none) and the thread's members, 16 bits a bin
    int bin[kItems];
    unsigned long long mine = 0;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      bin[i] = -1;
#pragma unroll
      for (int b = kMaxBins - 1; b >= 0; --b)   // bins are disjoint
        if (b < nb && vid[i] < n && d[i] > bins.lo[b] && d[i] <= bins.hi[b])
          bin[i] = b;
      if (bin[i] >= 0) mine += 1ull << (16 * bin[i]);
    }
    // the largest degree of each bin in the tile
#pragma unroll
    for (int b = 0; b < kMaxBins; ++b) {
      if (b >= nb) break;
      unsigned m = 0;
#pragma unroll
      for (int i = 0; i < kItems; ++i)
        if (bin[i] == b) m = max(m, (unsigned)d[i]);
      m = __reduce_max_sync(0xffffffffu, m);
      if (lane == 0 && m > 0) atomicMax(&s_max[b], (int32_t)m);
    }
    // the degrees of the thread's LB members (0 without an LB bin)
    uint32_t dsum = 0;
#pragma unroll
    for (int i = 0; i < kItems; ++i)
      if (lb >= 0 && bin[i] == lb) dsum += (uint32_t)d[i];
    // rank the thread's members within the tile, and prefix its LB
    // degrees there: inclusive scans over the warp, then the warps
    // before this one
    unsigned long long incl = mine;
    uint32_t dincl = dsum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned long long y = __shfl_up_sync(0xffffffffu, incl, o);
      const uint32_t z = __shfl_up_sync(0xffffffffu, dincl, o);
      if (lane >= o) incl += y, dincl += z;
    }
    if (lane == 31) s_warp[warp] = incl, s_wdeg[warp] = dincl;
    __syncthreads();
    unsigned long long before = 0, total = 0;
    uint32_t dbefore = 0, dtotal = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) before += s_warp[w], dbefore += s_wdeg[w];
      total += s_warp[w];
      dtotal += s_wdeg[w];
    }
    unsigned long long at = before + incl - mine;    // exclusive rank
    uint32_t dat = dbefore + dincl - dsum;           // exclusive degrees

    // the tile's place among the tiles: warp b looks back for bin b, 32
    // earlier tiles at a time (lane l reads tile p - l), until a window
    // holds an inclusive prefix; the nearest one ends the sum
    if (warp < nb) {
      const int b = warp;
      const unsigned long long agg =
          field(total, b) |
          (b == lb ? (unsigned long long)dtotal << kDegShift : 0ull);
      volatile unsigned long long* mine_st = status + t * nb + b;
      uint32_t base = 0, dbase = 0;
      if (t == 0) {
        if (lane == 0) *mine_st = kPrefix | agg;
      } else {
        if (lane == 0) *mine_st = kAggregate | agg;
        for (int64_t p = t - 1;; p -= 32) {
          const int64_t q = p - lane;
          unsigned long long s = kPrefix;       // below tile 0: a prefix 0
          if (q >= 0) s = status[q * nb + b];
          while (__any_sync(0xffffffffu, s == 0))
            if (s == 0) s = status[q * nb + b];
          const unsigned pre =
              __ballot_sync(0xffffffffu, (s & kPrefix) != 0ull);
          const int stop = pre ? __ffs(pre) - 1 : 31;
          const bool in = lane <= stop;
          base += __reduce_add_sync(0xffffffffu,
                                    in ? (uint32_t)s & kField : 0u);
          dbase += __reduce_add_sync(
              0xffffffffu, in ? (uint32_t)(s >> kDegShift) & kField : 0u);
          if (pre) break;
        }
        if (lane == 0)
          *mine_st = kPrefix |
                     (agg + (base | (unsigned long long)dbase << kDegShift));
      }
      if (lane == 0) {
        s_base[b] = (int32_t)base;
        if (b == lb) s_dbase = dbase;
        if (t == ntiles - 1) {
          counts[b] = (int32_t)(base + field(total, b));
          if (b == lb) *lb_total = (int32_t)(dbase + dtotal);
        }
        if (s_max[b] > 0) atomicMax(maxdeg + b, s_max[b]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int b = bin[i];
      if (b < 0) continue;
      const int32_t r = s_base[b] + (int32_t)field(at, b);
      const int64_t o = (int64_t)b * n + r;
      out_vidx[o] = vid[i];
      out_deg[o] = d[i];
      out_row[o] = rs[i];
      if (b == lb) {
        out_start[r] = (int32_t)(s_dbase + dat);
        dat += (uint32_t)d[i];
      }
      at += 1ull << (16 * b);
    }
    __syncthreads();         // s_tile, s_warp, s_base, s_dbase are reused
  }
}

}  // namespace

// Scratch ints the caller zeroes before a launch over n rows and nb bins:
// the header (ticket, counts, largest degrees, LB total), then two ints
// a status word.
extern "C" int twc_bin_list_scratch(int n, int nb) {
  return kHeader + 2 * (int)(((int64_t)n + kTile - 1) / kTile) * nb;
}

// bounds: 2 * nb host ints, lo[0..nb) then hi[0..nb) (INT32_MAX: no cap);
// lb: the LB bin's index (its prefix goes to out_start), or -1 for none
extern "C" int twc_bin_list_launch(
    const void* fidx, const void* deg, const void* row_start,
    const void* n_ptr, void* out_vidx, void* out_deg, void* out_row,
    void* out_start, void* scratch, const int* bounds, int n_host, int n,
    int nb, int lb, void* stream) {
  if (nb < 1 || nb > kMaxBins || n < 0 || lb < -1 || lb >= nb ||
      (lb >= 0 && out_start == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Bins bins;
  for (int b = 0; b < kMaxBins; ++b) {
    bins.lo[b] = b < nb ? bounds[b] : 0;
    bins.hi[b] = b < nb ? bounds[nb + b] : 0;
  }
  // as many blocks as the SMs hold at once, at most one a tile
  static const int resident = [] {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, twc_bin_list_kernel, kThreads, 0);
    return std::max(sms, 1) * std::max(per_sm, 1);
  }();
  const unsigned grid = (unsigned)std::min<int64_t>(
      ((int64_t)n + kTile - 1) / kTile, resident);
  twc_bin_list_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(fidx), static_cast<const int32_t*>(deg),
      static_cast<const int32_t*>(row_start),
      static_cast<const int32_t*>(n_ptr), n_host,
      static_cast<int32_t*>(out_vidx), static_cast<int32_t*>(out_deg),
      static_cast<int32_t*>(out_row), static_cast<int32_t*>(out_start),
      static_cast<int32_t*>(scratch), bins, nb, lb, n);
  return (int)cudaGetLastError();
}
