// round_turn: the turn of a fused min-combine round for Hopper (sm_90a):
// the next frontier, the labels brought level with the round's relaxed
// copy, and the next round's census, in one pass.
//
// Replaces no TPU kernel.  It stands for the elementwise control that XLA
// compiles around the JAX package's fused loop: the census that
// relax_fused_round takes of the round's frontier
// (src/repro/core/balancer.py:1107-1109: the union over the batch, n_f
// its size, m_f the out-degrees it holds, for the Beamer rule) and the
// turn of run_fused's loop body (:1179: `new < lab` as the next frontier,
// `new` as the next labels).  For [R, V] labels L (the loop carry's:
// int32, float32, int64 or float64),
// the round's new labels N and the frontier F (bool [R, V]):
//
//   F[r, v] = N[r, v] < L[r, v]
//   L[r, v] = N[r, v]                written only where the bits differ
//   census[0] = n_f = |{v : F[r, v] for some r}|
//   census[1] = m_f = sum over those v of row_ptr[v + 1] - row_ptr[v]
//                     (int32, wrapping as torch's int32 sum does)
//
// so the next round starts from N == L and knows its n_f, m_f before it
// reads anything V-wide.  The fused loop relaxes an in-place kernel pair
// into N, a second buffer it keeps equal to L (the loop carry's shadow),
// reading L as the round-entry values; the torch-ops pair hands its fresh
// labels as N.  With L and N null (the census entry) F is only read: the
// census of the loop's first frontier.  census[2..4] are the kernel's
// scratch (the blocks' two sums and the count of blocks done), which each
// launch leaves at 0; the caller zeroes them once when it makes the
// buffer.
//
// What bounds it on this card: bytes.  L and N are read once (8 R V
// bytes, 16 R V for 64-bit labels), F written once (R V), L written where a 32-byte sector holds a
// changed label, and row_ptr read at the next frontier's vertices only.
// A kron 26 sssp round (V = 2^26, R = 1) reads 537 MB of labels and
// writes the 67 MB frontier: about 0.6 GB before the changed sectors and
// row_ptr, 0.18 ms at 3.35 TB/s.  The torch ops it replaces moved about
// 3.75 GB a round (the out-degrees, the union, its count and degree sum,
// the labels clone, `new < lab`, the carry's copies and `any`).
//
// Design: a tile of 4,096 vertices goes to one block of 256 threads; a
// thread takes four groups of four consecutive vertices, 1,024 vertices
// apart, so each of its 16-byte loads of L and N is coalesced with its
// warp's (all eight loads of a row issued before the first compare), its
// four frontier bytes are one 4-byte store, and L is written back as one
// 16-byte store where any of its four labels changed.  64-bit labels take
// the same walk with two 16-byte loads (and stores) for each four.  A row of the
// batch after another, the thread ORs its vertices' bits, so the union
// costs nothing more; it then counts them and sums their degrees from
// row_ptr.  Where V is not a multiple of 4, or a row is not 16-byte
// aligned, the same walk loads and stores one element at a time.  A warp
// shuffle and the block's shared memory reduce the census to one atomic
// pair a block; the last block to finish (a ticket counter, after a
// fence) writes census[0..1] and zeroes the scratch.  A resident grid,
// as many blocks as the card holds at once and fixed by V, loops over the
// tiles: nothing depends on the frontier, so a captured round replays
// for any frontier.  The kernel allocates nothing and launches on the
// caller's stream.
#include <algorithm>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "device_count.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kQuads = 4;                         // groups of 4 a thread
constexpr int kTile = kThreads * kQuads * 4;      // 4,096 vertices a tile
constexpr int kWarps = kThreads / 32;
// census: n_f, m_f, the blocks' n_f sum, their m_f sum, blocks done
constexpr int kSumN = 2, kSumM = 3, kDone = 4;

// a label's raw word: the turn copies words and compares them as T
template <typename T>
using Word = std::conditional_t<sizeof(T) == 8, unsigned long long,
                                uint32_t>;

// N < L on raw words, as torch compares the label dtype
template <typename T>
__device__ __forceinline__ uint32_t lt(Word<T> n, Word<T> l) {
  if constexpr (std::is_same_v<T, float>)
    return __uint_as_float(n) < __uint_as_float(l);
  else if constexpr (std::is_same_v<T, double>)
    return __longlong_as_double((long long)n) <
           __longlong_as_double((long long)l);
  else
    return static_cast<T>(n) < static_cast<T>(l);
}

// four consecutive label words
template <typename W>
struct Quad {
  W x, y, z, w;
};

// the four words at p (16-byte aligned): one 16-byte load of 32-bit
// words, two of 64-bit ones; NC through the read-only path
template <typename W, bool NC>
__device__ __forceinline__ Quad<W> load4(const W* p) {
  if constexpr (sizeof(W) == 4) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
    uint4 a;
    if constexpr (NC) a = __ldg(q); else a = *q;
    return {a.x, a.y, a.z, a.w};
  } else {
    const ulonglong2* q = reinterpret_cast<const ulonglong2*>(p);
    ulonglong2 a, b;
    if constexpr (NC) {
      a = __ldg(q);
      b = __ldg(q + 1);
    } else {
      a = q[0];
      b = q[1];
    }
    return {a.x, a.y, b.x, b.y};
  }
}

template <typename W>
__device__ __forceinline__ void store4(W* p, const Quad<W>& a) {
  if constexpr (sizeof(W) == 4) {
    *reinterpret_cast<uint4*>(p) = make_uint4(a.x, a.y, a.z, a.w);
  } else {
    ulonglong2* q = reinterpret_cast<ulonglong2*>(p);
    q[0] = make_ulonglong2(a.x, a.y);
    q[1] = make_ulonglong2(a.z, a.w);
  }
}

// four frontier bytes -> four bits (bit j: byte j != 0)
__device__ __forceinline__ uint32_t nz4(uint32_t x) {
  const uint32_t y = __vcmpne4(x, 0u) & 0x01010101u;
  return (y | y >> 7 | y >> 14 | y >> 21) & 0xfu;
}

// four bits -> four frontier bytes (0 or 1)
__device__ __forceinline__ uint32_t bytes4(uint32_t f) {
  return (f & 1u) | (f & 2u) << 7 | (f & 4u) << 14 | (f & 8u) << 21;
}

// the bits of one row's quads: with TURN, F = N < L written and L = N
// where they differ; else F read.  `first` is the thread's first vertex,
// quad q at first + 4 q kThreads; bit 4 q + j is vertex j of quad q.
template <typename T, bool TURN, bool VEC>
__device__ __forceinline__ uint32_t row_bits(Word<T>* lab,
                                             const Word<T>* nw,
                                             uint8_t* fr, int64_t first,
                                             int64_t n) {
  using W = Word<T>;
  uint32_t bits = 0;
  if constexpr (VEC) {
    // n is a multiple of 4: a quad lies wholly inside the row or past it
    if constexpr (TURN) {
      Quad<W> l[kQuads], w[kQuads];
#pragma unroll
      for (int q = 0; q < kQuads; ++q) {
        const int64_t v = first + 4 * q * kThreads;
        if (v < n) {
          l[q] = load4<W, false>(lab + v);
          w[q] = load4<W, true>(nw + v);
        }
      }
#pragma unroll
      for (int q = 0; q < kQuads; ++q) {
        const int64_t v = first + 4 * q * kThreads;
        if (v >= n) continue;
        const uint32_t f = lt<T>(w[q].x, l[q].x) |
                           lt<T>(w[q].y, l[q].y) << 1 |
                           lt<T>(w[q].z, l[q].z) << 2 |
                           lt<T>(w[q].w, l[q].w) << 3;
        *reinterpret_cast<uint32_t*>(fr + v) = bytes4(f);
        if (w[q].x != l[q].x || w[q].y != l[q].y || w[q].z != l[q].z ||
            w[q].w != l[q].w)
          store4(lab + v, w[q]);
        bits |= f << (4 * q);
      }
    } else {
#pragma unroll
      for (int q = 0; q < kQuads; ++q) {
        const int64_t v = first + 4 * q * kThreads;
        if (v < n)
          bits |= nz4(__ldg(reinterpret_cast<const uint32_t*>(fr + v)))
                  << (4 * q);
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < kQuads; ++q) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t v = first + 4 * q * kThreads + j;
        if (v >= n) continue;
        uint32_t f;
        if constexpr (TURN) {
          const W l = lab[v], w = __ldg(nw + v);
          f = lt<T>(w, l);
          fr[v] = (uint8_t)f;
          if (w != l) lab[v] = w;
        } else {
          f = fr[v] != 0;
        }
        bits |= f << (4 * q + j);
      }
    }
  }
  return bits;
}

template <typename T, bool TURN, bool VEC>
__global__ void __launch_bounds__(kThreads)
round_turn_kernel(Word<T>* __restrict__ lab,
                  const Word<T>* __restrict__ nw,
                  const int32_t* __restrict__ row_ptr,
                  uint8_t* __restrict__ fr, int32_t* __restrict__ census,
                  int rows, int64_t n) {
  device_count::count_launch();
  uint32_t cnt = 0, deg = 0;
  const int64_t tiles = (n + kTile - 1) / kTile;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t first = t * kTile + 4 * (int64_t)threadIdx.x;
    uint32_t any = 0;           // the union over the rows
    for (int r = 0; r < rows; ++r) {
      const int64_t off = (int64_t)r * n;
      any |= row_bits<T, TURN, VEC>(TURN ? lab + off : nullptr,
                                    TURN ? nw + off : nullptr, fr + off,
                                    first, n);
    }
    cnt += __popc(any);
    while (any) {
      const int b = __ffs(any) - 1;
      any &= any - 1;
      const int64_t v = first + 4 * (b >> 2) * kThreads + (b & 3);
      deg += (uint32_t)(__ldg(row_ptr + v + 1) - __ldg(row_ptr + v));
    }
  }
  // the census: a warp's sums, the block's, one atomic pair a block
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    cnt += __shfl_down_sync(0xffffffffu, cnt, o);
    deg += __shfl_down_sync(0xffffffffu, deg, o);
  }
  __shared__ uint32_t s_cnt[kWarps], s_deg[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_cnt[warp] = cnt;
    s_deg[warp] = deg;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int w = 1; w < kWarps; ++w) {
    cnt += s_cnt[w];
    deg += s_deg[w];
  }
  unsigned* acc = reinterpret_cast<unsigned*>(census);
  if (cnt) atomicAdd(acc + kSumN, cnt);
  if (deg) atomicAdd(acc + kSumM, deg);
  __threadfence();
  if (atomicAdd(acc + kDone, 1u) != gridDim.x - 1) return;
  // the last block: every other block's sums are in
  __threadfence();
  census[0] = (int32_t)atomicExch(acc + kSumN, 0u);
  census[1] = (int32_t)atomicExch(acc + kSumM, 0u);
  atomicExch(acc + kDone, 0u);
}

template <typename T, bool TURN, bool VEC>
int launch(void* labels, const void* new_labels, const void* row_ptr,
           void* frontier, void* census, int rows, int64_t n,
           cudaStream_t stream) {
  auto* kernel = round_turn_kernel<T, TURN, VEC>;
  // as many blocks as the SMs hold at once, at most one a tile (and one
  // for an empty V, which writes a zero census)
  static const int resident = [kernel] {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                  kThreads, 0);
    return std::max(sms, 1) * std::max(per_sm, 1);
  }();
  const unsigned grid = (unsigned)std::max<int64_t>(
      1, std::min<int64_t>((n + kTile - 1) / kTile, resident));
  kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<Word<T>*>(labels),
      static_cast<const Word<T>*>(new_labels),
      static_cast<const int32_t*>(row_ptr), static_cast<uint8_t*>(frontier),
      static_cast<int32_t*>(census), rows, n);
  return (int)cudaGetLastError();
}

}  // namespace

// labels, new_labels: [rows, n] of dtype 0 (int32), 1 (float32), 2
// (int64) or 3 (float64), both null for the census entry; row_ptr: int32 [n + 1]; frontier: bool
// [rows, n]; census: int32 [5], census[2..4] zero.  All contiguous.
extern "C" int round_turn_launch(void* labels, const void* new_labels,
                                 const void* row_ptr, void* frontier,
                                 void* census, int rows, int n, int dtype,
                                 void* stream) {
  const bool turn = labels != nullptr;
  if (rows < 1 || n < 0 || dtype < 0 || dtype > 3 ||
      turn != (new_labels != nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t words = reinterpret_cast<uintptr_t>(labels) |
                          reinterpret_cast<uintptr_t>(new_labels);
  const bool vec = n % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(frontier) % 4 == 0 &&
                   words % 16 == 0;
  if (!turn)
    return vec ? launch<int32_t, false, true>(labels, new_labels, row_ptr,
                                              frontier, census, rows, n, s)
               : launch<int32_t, false, false>(labels, new_labels, row_ptr,
                                               frontier, census, rows, n, s);
#define ROUND_TURN_CALL(T)                                                  \
  (vec ? launch<T, true, true>(labels, new_labels, row_ptr, frontier,       \
                               census, rows, n, s)                          \
       : launch<T, true, false>(labels, new_labels, row_ptr, frontier,      \
                                census, rows, n, s))
  switch (dtype) {
    case 0: return ROUND_TURN_CALL(int32_t);
    case 1: return ROUND_TURN_CALL(float);
    case 2: return ROUND_TURN_CALL(int64_t);
    default: return ROUND_TURN_CALL(double);
  }
#undef ROUND_TURN_CALL
}
