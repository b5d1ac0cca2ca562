// twc_bin_list: the static-shape round's frontier inspector for Hopper
// (sm_90a): the round's degree bins and its LB bin, listed once a round
// straight from the dense frontier and the CSR's row_ptr.
//
// Replaces no TPU kernel.  It stands for the layout the JAX package's
// static round builds with XLA ops: the frontier compacted to V rows
// (jnp.nonzero, src/repro/core/frontier.py:44), each row's degree and
// row start gathered from row_ptr (_frontier_meta,
// src/repro/core/balancer.py:462), every bin laid out over those V rows
// with jnp.where (:999), and the huge bin's prefix sum that
// src/repro/kernels/ops.py:52, edge_lb_apply_static, takes over V rows.
// Here one launch reads mask [R, V] (bool, OR-ed over its R rows: a
// batch's frontiers, or a pull round's one row, the reverse CSR's
// in-degree mask) and row_ptr [V + 1] once, puts each listed vertex v
// in the bin whose degree range holds it (deg = row_ptr[v + 1] -
// row_ptr[v], lo[b] < deg <= hi[b]; a vertex in no range is in none)
// and writes, for every bin b,
//
//   out_vidx / out_deg / out_row [b, 0 .. count[b])   the members, in
//                                                     vertex order
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
// Vertex order is the order the compacted frontier lists vertices in,
// and so the order the host round gathers a bin in
// (balancer._assemble_bins): a static launch then runs the same rows in
// the same order as the host round's, and the LB list with its prefix
// maps every edge id to the same (slot, CSR edge) as the V-row layout's
// prefix does (a zero-degree slot owns no id).
//
// What bounds it on this card: bytes.  The mask is read once (R V
// bytes), row_ptr only where a thread holds a listed vertex, and a
// member written once per array (12 bytes, 16 in the LB bin).  At rmat
// 22 with every vertex listed (pagerank: about half of them members)
// that is about 45 MB, 0.013 ms at 3.35 TB/s; a sparse sssp round is
// its 4 MB mask, 0.0013 ms.
//
// Design: a tile of 4,096 vertices goes to one block of 256 threads,
// 16 consecutive vertices a thread: one 16-byte load of each mask row
// (where a row starts unaligned, the two aligned 16-byte words around
// the thread's bytes, shifted; a scalar tail past V), turned into 16
// bits with a byte compare, and, for a thread with a listed vertex, its
// 17 row_ptr entries as one contiguous run (four 16-byte loads and one
// more).  (8,192-vertex tiles of 512 threads, timed against these before
// the members were staged: 3% slower on a sparse sssp round, 7% faster
// with every vertex listed.)
// Each thread counts its members per bin, packed 16 bits a bin in one
// 64-bit word (a tile holds at most 4,096 of a bin), and sums its LB
// members' degrees, so one shuffle scan over the warp and a serial scan
// over the block's warps rank every member within the tile and give
// each LB member its degree prefix there.  The members are staged in
// shared memory, bin after bin, and written out from there, consecutive
// threads on consecutive rows.  The tiles are ranked against each other
// by a decoupled look-back: a block takes its tile from a ticket
// counter, so every earlier tile is held by a block that is running; it
// publishes its tile's per-bin aggregate, then one warp per bin reads
// the earlier tiles' status words 32 at a time, waits until all 32 are
// published, and sums back to the nearest inclusive prefix, which it
// adds to its aggregate and publishes.  A tile with no listed vertex
// publishes a zero aggregate at once and then its prefix, so a later
// tile's look-back ends there and not at the last non-empty tile (most
// of a sparse round's tiles are empty).  (On an H100, writing each
// member from its own thread, 16 rows from the next thread's, with empty
// tiles publishing only their aggregate, took 0.095 ms with every vertex
// of rmat 22 listed and 0.036 ms on a sparse sssp round; this takes
// 0.046 and 0.031.)  A status word is 64 bits: two
// flags, then the member count and, for the LB bin, the degree sum, 31
// bits each.  So one look-back gives the LB bin's rank and edge prefix
// together, and any total of an int32 CSR fits (each vertex is listed
// once: its degrees sum to at most E < 2^31).  No block waits on a
// later tile, so the walk always ends.  The counts, the largest degrees
// and the LB total are summed with one atomic a non-empty tile and bin.
// A resident grid, as many blocks as the SMs hold at once, loops over
// the tickets; it is fixed by V, and nothing is read on the host, so a
// captured round replays for any frontier.
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
constexpr int kItems = 16;         // consecutive vertices a thread: one
                                   // 16-byte load of each mask row
constexpr int kTile = kThreads * kItems;   // 4,096 vertices a tile
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

// four mask bytes -> four bits (bit i: byte i != 0)
__device__ __forceinline__ uint32_t nz4(uint32_t x) {
  const uint32_t y = __vcmpne4(x, 0u) & 0x01010101u;
  return (y | y >> 7 | y >> 14 | y >> 21) & 0xfu;
}

// sixteen mask bytes at a 16-byte aligned p -> sixteen bits
__device__ __forceinline__ uint32_t nz16(const uint8_t* p) {
  const uint4 w = __ldg(reinterpret_cast<const uint4*>(p));
  return nz4(w.x) | nz4(w.y) << 4 | nz4(w.z) << 8 | nz4(w.w) << 12;
}

// bit i: row[s + i] != 0, for the thread's vertices [s, s + 16) below n.
// A row that starts unaligned (V not a multiple of 16) reads the two
// aligned 16-byte words around its bytes; each holds a byte of the row,
// so neither leaves the mask's allocation.
__device__ __forceinline__ uint32_t row_bits(const uint8_t* row, int64_t s,
                                             int64_t n) {
  const uint8_t* p = row + s;
  if (s + kItems <= n) {
    const int off = (int)(reinterpret_cast<uintptr_t>(p) & 15);
    if (off == 0) return nz16(p);
    const uint8_t* q = p - off;
    return ((nz16(q + 16) << 16 | nz16(q)) >> off) & 0xffffu;
  }
  uint32_t f = 0;                                 // the tail past V
#pragma unroll
  for (int i = 0; i < kItems; ++i)
    if (s + i < n && __ldg(p + i) != 0) f |= 1u << i;
  return f;
}

// Bin b's exclusive prefix before tile t, by the look-back: lane l reads
// the status word of tile p - l, 32 earlier tiles at a time; the warp
// waits until all 32 are published and sums back to the nearest
// inclusive prefix.  Publishes tile t's aggregate `agg` first and its
// inclusive prefix last.  Returns the member count (low 32 bits) and
// the degree sum (high 32 bits) of the tiles before t.
__device__ __forceinline__ unsigned long long look_back(
    volatile unsigned long long* status, int64_t t, int nb, int b,
    int lane, unsigned long long agg) {
  volatile unsigned long long* mine_st = status + t * nb + b;
  if (t == 0) {
    if (lane == 0) *mine_st = kPrefix | agg;
    return 0ull;
  }
  if (lane == 0) *mine_st = kAggregate | agg;
  uint32_t base = 0, dbase = 0;
  for (int64_t p = t - 1;; p -= 32) {
    const int64_t q = p - lane;
    unsigned long long s = kPrefix;             // below tile 0: a prefix 0
    if (q >= 0) s = status[q * nb + b];
    while (__any_sync(0xffffffffu, s == 0))
      if (s == 0) s = status[q * nb + b];
    const unsigned pre = __ballot_sync(0xffffffffu, (s & kPrefix) != 0ull);
    const int stop = pre ? __ffs(pre) - 1 : 31;
    const bool in = lane <= stop;
    base += __reduce_add_sync(0xffffffffu, in ? (uint32_t)s & kField : 0u);
    dbase += __reduce_add_sync(
        0xffffffffu, in ? (uint32_t)(s >> kDegShift) & kField : 0u);
    if (pre) break;
  }
  if (lane == 0)
    *mine_st = kPrefix |
               (agg + (base | (unsigned long long)dbase << kDegShift));
  return (unsigned long long)base | (unsigned long long)dbase << 32;
}

__global__ void __launch_bounds__(kThreads) twc_bin_list_kernel(
    const uint8_t* __restrict__ mask, int32_t nrows,
    const int32_t* __restrict__ row_ptr,
    int32_t* __restrict__ out_vidx, int32_t* __restrict__ out_deg,
    int32_t* __restrict__ out_row, int32_t* __restrict__ out_start,
    int32_t* scratch, Bins bins, int32_t nb, int32_t lb, int32_t n) {
  device_count::count_launch();
  const int64_t ntiles = ((int64_t)n + kTile - 1) / kTile;
  int32_t* ticket = scratch;
  int32_t* counts = scratch + 1;
  int32_t* maxdeg = scratch + 1 + nb;
  int32_t* lb_total = scratch + 1 + 2 * nb;
  volatile unsigned long long* status =
      reinterpret_cast<volatile unsigned long long*>(scratch + kHeader);
  const bool vec = (reinterpret_cast<uintptr_t>(row_ptr) & 15) == 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;

  __shared__ int32_t s_tile;
  __shared__ unsigned long long s_warp[kWarps];
  __shared__ uint32_t s_wdeg[kWarps];
  __shared__ int32_t s_base[kMaxBins];
  __shared__ int32_t s_max[kMaxBins];
  __shared__ uint32_t s_dbase;
  // the tile's members, bin after bin, in vertex order, and each LB
  // member's degree prefix within the tile, staged so that the lists
  // are written with consecutive threads on consecutive rows
  __shared__ int32_t s_vid[kTile];
  __shared__ uint32_t s_dex[kTile];
  for (;;) {
    if (threadIdx.x == 0) s_tile = atomicAdd(ticket, 1);
    if (threadIdx.x < kMaxBins) s_max[threadIdx.x] = 0;
    __syncthreads();
    const int64_t t = s_tile;                  // uniform in the block
    if (t >= ntiles) return;
    const int64_t v0 = t * kTile + (int64_t)threadIdx.x * kItems;

    // the thread's listed vertices: bit i for v0 + i, over the R rows
    uint32_t listed = 0;
    if (v0 < n)
      for (int32_t r = 0; r < nrows; ++r)
        listed |= row_bits(mask + (int64_t)r * n, v0, n);
    if (!__syncthreads_or(listed != 0u)) {
      // an empty tile: its zero aggregate at once, then its prefix, so
      // that a later tile's look-back ends here
      if (warp < nb) look_back(status, t, nb, warp, lane, 0ull);
      continue;        // s_tile was read by all before the barrier
    }
    // row_ptr[v0 .. v0 + 16]: one contiguous run
    int32_t rp[kItems + 1];
#pragma unroll
    for (int i = 0; i <= kItems; ++i) rp[i] = 0;
    if (listed != 0u) {
      if (vec && v0 + kItems <= n) {
#pragma unroll
        for (int j = 0; j < kItems / 4; ++j) {
          const int4 a =
              __ldg(reinterpret_cast<const int4*>(row_ptr + v0) + j);
          rp[4 * j] = a.x, rp[4 * j + 1] = a.y, rp[4 * j + 2] = a.z,
                 rp[4 * j + 3] = a.w;
        }
        rp[kItems] = __ldg(row_ptr + v0 + kItems);
      } else {
#pragma unroll
        for (int i = 0; i <= kItems; ++i)
          if (v0 + i <= n) rp[i] = __ldg(row_ptr + v0 + i);
      }
    }
    // each vertex's bin (-1: none) and the thread's members, 16 bits a bin
    int bin[kItems];
    unsigned long long mine = 0;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      bin[i] = -1;
      const int32_t d = rp[i + 1] - rp[i];
#pragma unroll
      for (int b = kMaxBins - 1; b >= 0; --b)   // bins are disjoint
        if (b < nb && ((listed >> i) & 1u) && d > bins.lo[b] &&
            d <= bins.hi[b])
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
        if (bin[i] == b) m = max(m, (unsigned)(rp[i + 1] - rp[i]));
      m = __reduce_max_sync(0xffffffffu, m);
      if (lane == 0 && m > 0) atomicMax(&s_max[b], (int32_t)m);
    }
    // the degrees of the thread's LB members (0 without an LB bin)
    uint32_t dsum = 0;
#pragma unroll
    for (int i = 0; i < kItems; ++i)
      if (lb >= 0 && bin[i] == lb) dsum += (uint32_t)(rp[i + 1] - rp[i]);
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
    // each bin's first slot of the stage (the members of the bins before
    // it), packed 16 bits a bin
    unsigned long long first = 0;
#pragma unroll
    for (int b = 1; b < kMaxBins; ++b)
      first |= (unsigned long long)(field(first, b - 1) +
                                    field(total, b - 1)) << (16 * b);

    // the tile's place among the tiles: warp b looks back for bin b
    if (warp < nb) {
      const int b = warp;
      const uint32_t cnt = field(total, b);
      const unsigned long long pre = look_back(
          status, t, nb, b, lane,
          cnt | (b == lb ? (unsigned long long)dtotal << kDegShift : 0ull));
      if (lane == 0) {
        s_base[b] = (int32_t)(uint32_t)pre;
        if (b == lb) s_dbase = (uint32_t)(pre >> 32);
        if (cnt > 0) atomicAdd(counts + b, (int32_t)cnt);
        if (b == lb && dtotal > 0) atomicAdd(lb_total, (int32_t)dtotal);
        if (s_max[b] > 0) atomicMax(maxdeg + b, s_max[b]);
      }
    }
    // stage the members, bin after bin, in vertex order
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int b = bin[i];
      if (b < 0) continue;
      const uint32_t slot = field(first, b) + field(at, b);
      s_vid[slot] = (int32_t)(v0 + i);
      if (b == lb) {
        s_dex[slot] = dat;
        dat += (uint32_t)(rp[i + 1] - rp[i]);
      }
      at += 1ull << (16 * b);
    }
    __syncthreads();
    // each bin's members written out, consecutive threads on consecutive
    // rows (row_ptr read again: lines this block has just read)
    for (int b = 0; b < nb; ++b) {
      const int32_t cnt = (int32_t)field(total, b);
      const uint32_t f = field(first, b);
      const int32_t r0 = s_base[b];
      int32_t* vo = out_vidx + (int64_t)b * n + r0;
      int32_t* dgo = out_deg + (int64_t)b * n + r0;
      int32_t* ro = out_row + (int64_t)b * n + r0;
      for (int32_t j = threadIdx.x; j < cnt; j += kThreads) {
        const int32_t v = s_vid[f + j];
        const int32_t rs = __ldg(row_ptr + v);
        vo[j] = v;
        dgo[j] = __ldg(row_ptr + v + 1) - rs;
        ro[j] = rs;
        if (b == lb) out_start[r0 + j] = (int32_t)(s_dbase + s_dex[f + j]);
      }
    }
    __syncthreads();   // s_tile, s_warp, s_base, s_dbase, the stage reused
  }
}

}  // namespace

// Scratch ints the caller zeroes before a launch over n vertices and nb
// bins: the header (ticket, counts, largest degrees, LB total), then two
// ints a status word.
extern "C" int twc_bin_list_scratch(int n, int nb) {
  return kHeader + 2 * (int)(((int64_t)n + kTile - 1) / kTile) * nb;
}

// mask: bool [nrows, n], contiguous; row_ptr: int32 [n + 1];
// bounds: 2 * nb host ints, lo[0..nb) then hi[0..nb) (INT32_MAX: no cap);
// lb: the LB bin's index (its prefix goes to out_start), or -1 for none
extern "C" int twc_bin_list_launch(
    const void* mask, const void* row_ptr, void* out_vidx, void* out_deg,
    void* out_row, void* out_start, void* scratch, const int* bounds,
    int nrows, int n, int nb, int lb, void* stream) {
  if (nb < 1 || nb > kMaxBins || n < 0 || nrows < 1 || lb < -1 ||
      lb >= nb || (lb >= 0 && out_start == nullptr))
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
      static_cast<const uint8_t*>(mask), nrows,
      static_cast<const int32_t*>(row_ptr), static_cast<int32_t*>(out_vidx),
      static_cast<int32_t*>(out_deg), static_cast<int32_t*>(out_row),
      static_cast<int32_t*>(out_start), static_cast<int32_t*>(scratch), bins,
      nb, lb, n);
  return (int)cudaGetLastError();
}
