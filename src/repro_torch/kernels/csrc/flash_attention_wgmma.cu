// flash_attention_wgmma: causal or non-causal attention forward in bf16
// for head widths 64, 80, 128 and 256, on Hopper's tensor cores (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:68
// (flash_attention; kernel body _flash_kernel at :28) on the bf16 route;
// flash_attention.cu keeps float32 and the other head widths.  For q
// [B,S,H,hd] and k, v [B,S,Hkv,hd] (bf16, contiguous, 16-byte aligned),
// query head h reads KV head h / (H / Hkv) -- the repeat is never
// materialized -- and
//
//   out[b,s,h] = sum_c softmax_c(q.k_c / sqrt(hd)) v_c       (c <= s if causal)
//
// with float32 scores, softmax and sums, written in bf16.  Any S: TMA
// zero-fills rows and keys past S, keys past S are masked and rows past
// S are not stored.
//
// What bounds it on this card: bytes, closely followed by operations.
// At the prefill shape (B=4, S=1024, H=16, hd=128, causal) it must read
// q, k, v and write out, 67.1 MB, 0.0200 ms at 3.35 TB/s; its 17.2
// GFLOP of q.k and p.v over the lower triangle take 0.0174 ms at 989
// TFLOP/s (at hd 256 with GQA 8:1 the operations bound).  So the design
// keeps the products on the tensor cores, the loads off the threads and
// the softmax in the products' shadow:
//
// * A persistent grid, one block of three warpgroups per SM.  The work
//   items (batch*head, 128-query block) are ordered heaviest query
//   block first and dealt to the blocks in a snake (Work::item).
// * Warpgroup 0 is the producer: one thread issues the TMA loads (each
//   item's Q once, into a buffer that an mbarrier releases after the
//   item's last q.k; K and V tiles into a two-stage ring, each tile with
//   its own "full" mbarrier and K and V each released by an "empty"
//   mbarrier that lane 0 of every consumer warp arrives on), running
//   ahead across items, so the next item's loads overlap this item's
//   last tile and its stores.  The warpgroup gives its registers to the
//   consumers (setmaxnreg 24 / 240).  Warpgroups 1 and 2 each own 64
//   query rows of the item, and store them through a shared staging
//   buffer by TMA, asynchronously.
// * Tile geometry by head width (Geo), every width exact, none padded:
//   a tile row is TMA boxes of 64 lanes (128 bytes) in the 128-byte
//   swizzle where 64 divides hd (64: one box, 128: two, 256: four), and
//   of 16 lanes (32 bytes) in the 32-byte swizzle at hd 80 (five
//   boxes: 80 = 5 x 16, a depth and a width that wgmma takes).  Each
//   wgmma descriptor carries its box's layout type and row stride.  K
//   and V tiles are 128 keys, and 64 at hd 256, where 128-key tiles
//   would need 384 KB; at 64 keys q 64 KB + K 64 KB + V 64 KB and O
//   staged in two passes of 16 KB per consumer take 231,424 of the
//   232,448 bytes a block may use (a static_assert holds every width).
// * Tensor maps over the tensors' real strides, [B, S, H(kv), hd], with
//   the head in the box coordinate; encoded on the host
//   (cuTensorMapEncodeTiled through the runtime's driver entry point),
//   cached per (pointer, shape, box width, box height) and passed as
//   __grid_constant__ parameters.
// * S = Q K^T: wgmma m64nBKk16 (BK = 128 or 64 keys), hd / 16 steps,
//   with Q and K both K-major in shared memory.  O += P V: P goes from
//   the score registers to bf16 pairs in registers as the A operand (the
//   accumulator layout is the A layout); V is read from shared memory as
//   an MN-major B with the transpose bit, its boxes a leading byte
//   offset apart: m64n64k16, n80 (five 16-lane boxes), n128, or two
//   n128 at hd 256.  Tile kt's q.k is issued with tile kt-1's p.v, and
//   tile kt's softmax runs while that p.v is on the tensor cores; the
//   two consumer warpgroups take turns to issue (named barriers 1 and
//   2, FA3's ping-pong), so one's softmax overlaps the other's
//   products.
// * The online softmax keeps (max, sum) per row in float32 registers
//   and computes exp2(s * log2(e) / sqrt(hd) - max) with one FMA.  A
//   masked score is -inf and contributes exactly 0 (a row with nothing
//   visible yet keeps max -inf, sum 0, acc 0: the guard of
//   layers.chunked_attention).  Causal: key tiles wholly above the
//   item's last row are not loaded; a warpgroup masks the tiles that
//   reach past S or past its first row (the diagonal; with 64-key tiles
//   warpgroup 0's last tile is masked whole).  Output = acc / max(sum,
//   1e-30).
//
// Not done (ROADMAP): a dynamic tile scheduler, overlap of one item's
// first q.k with the last p.v of the one before, and skipping the part
// of the diagonal tiles that lies above warpgroup 0's rows (a branch
// around wgmma there makes ptxas serialize every wgmma of the kernel).
// The kernel allocates nothing and launches on the caller's stream.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <cstring>
#include <initializer_list>
#include <mutex>

namespace {

constexpr int kBQ = 128;                 // query rows per work item
constexpr int kStages = 2;               // K/V ring depth
constexpr int kThreads = 384;            // producer + 2 consumer warpgroups
constexpr float kLog2e = 1.4426950408889634f;
constexpr size_t kSmemMax = 232448;      // shared memory a block may use

// The tile geometry of one head width.  A row of a tile is kNB TMA
// boxes of kBox lanes, each box row kBox * 2 bytes in the swizzle of
// that span: 64 lanes in the 128-byte swizzle where 64 divides hd, else
// 16 lanes in the 32-byte swizzle (hd 80 = 5 x 16, a wgmma depth and
// width).  K/V tiles hold kBK keys: 64 at hd 256, where 128 would not
// fit in shared memory, else 128.  O leaves in kOPass passes through a
// staging buffer of kNB / kOPass boxes per consumer.
template <int HD>
struct Geo {
  static constexpr int kBox = HD % 64 == 0 ? 64 : 16;
  static constexpr int kRowBytes = kBox * 2;
  static constexpr int kNB = HD / kBox;
  static constexpr int kBK = HD > 128 ? 64 : 128;
  static constexpr int kOPass = HD > 128 ? 2 : 1;
  // wgmma descriptor layout type (1 = B128, 3 = B32) and the stride of
  // eight rows of a box
  static constexpr uint32_t kLayout = kBox == 64 ? 1 : 3;
  static constexpr uint32_t kSBO = 8 * kRowBytes;
  static_assert(HD % kBox == 0 && kNB % kOPass == 0, "tile geometry");
};

template <int HD>
struct alignas(1024) Smem {
  using G = Geo<HD>;
  __nv_bfloat16 q[G::kNB][kBQ * G::kBox];
  __nv_bfloat16 k[kStages][G::kNB][G::kBK * G::kBox];
  __nv_bfloat16 v[kStages][G::kNB][G::kBK * G::kBox];
  __nv_bfloat16 o[2][G::kNB / G::kOPass][64 * G::kBox];   // per consumer
  uint64_t q_full, q_empty, k_full[kStages], v_full[kStages];
  uint64_t k_empty[kStages], v_empty[kStages];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// spin until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

// one 4-D TMA box {lane, head, row, batch} into shared memory,
// completing bytes on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int lane, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(lane), "r"(head), "r"(row), "r"(batch)
      : "memory");
}

// one 4-D TMA box of 64 rows from shared memory to the output; rows
// past the tensor's end are not written
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int lane,
                                          int head, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.tile.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)),
         "r"(lane), "r"(head), "r"(row), "r"(batch)
      : "memory");
}

// wait until this thread's TMA stores have read their shared memory
__device__ __forceinline__ void tma_store_drain() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// wgmma shared-memory descriptor of a swizzled tile: start address,
// leading and stride byte offsets (all >> 4), layout type (Geo::kLayout)
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo, uint32_t layout) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 |
         static_cast<uint64_t>(layout) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
}
// one consumer warpgroup's 128 threads (named barriers 3 and 4)
__device__ __forceinline__ void warpgroup_sync(int cw) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(3 + cw) : "memory");
}
// wait until at most N committed groups of this warpgroup are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keep the compiler from moving accesses of registers that an
// asynchronous product reads or writes across the wait that ends it
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N, int M>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

// 2^x on the special-function unit; 2^-inf = +0
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the float32 accumulator operands of a wgmma, eight at a time
#define WG_ACC8(i)                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_ACC32(i) WG_ACC8(i), WG_ACC8(i + 8), WG_ACC8(i + 16), WG_ACC8(i + 24)

// D[64 x 128] (+)= A[64 x 16] B[16 x 128]: A and B K-major in shared
// memory (descriptors), D float32 in registers; accumulate = 0 sets D
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
      "%27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_ACC32(0), WG_ACC32(32)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64]: as wgmma_ss_n128, for 64 keys
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
      "%27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_ACC32(0)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 128] += A[64 x 16] B[16 x 128]: A in registers (bf16 pairs in
// the accumulator layout), B MN-major in shared memory (transpose bit)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
      "%27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_ACC32(0), WG_ACC32(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 80] += A[64 x 16] B[16 x 80]: as wgmma_rs_n128, 80 lanes
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
      "%27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, "
      "%39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : WG_ACC32(0), WG_ACC8(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 64] += A[64 x 16] B[16 x 64]: as wgmma_rs_n128, 64 lanes
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
      "%27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_ACC32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// a float[N] window of a larger accumulator, as a wgmma operand
template <int N, int M>
__device__ __forceinline__ float (&part(float (&d)[M], int at))[N] {
  return *reinterpret_cast<float(*)[N]>(&d[at]);
}

// ---- one consumer warpgroup's steps over a tile of BK keys ----

// S = Q K^T over hd in steps of 16 lanes (32 bytes of a box row)
template <int HD>
__device__ __forceinline__ void issue_qk(float (&s)[Geo<HD>::kBK / 2],
                                         const __nv_bfloat16* q_rows,
                                         const __nv_bfloat16* k_tile) {
  using G = Geo<HD>;
  constexpr int kSteps = G::kBox / 16;   // k16 steps in a box row
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int box = kk / kSteps, off = (kk % kSteps) * 16;
    const uint64_t da = smem_desc(q_rows + box * kBQ * G::kBox + off, 16,
                                  G::kSBO, G::kLayout);
    const uint64_t db = smem_desc(k_tile + box * G::kBK * G::kBox + off, 16,
                                  G::kSBO, G::kLayout);
    if constexpr (G::kBK == 128)
      wgmma_ss_n128(s, da, db, kk > 0);
    else
      wgmma_ss_n64(s, da, db, kk > 0);
  }
  wgmma_commit();
}

// O += P V over the tile's keys in steps of 16 (16 rows of each V box);
// V is MN-major: the leading byte offset steps from box to box
template <int HD>
__device__ __forceinline__ void issue_pv(
    float (&acc)[HD / 2], const uint32_t (&p)[Geo<HD>::kBK / 16][4],
    const __nv_bfloat16* v_tile) {
  using G = Geo<HD>;
  constexpr uint32_t kBoxBytes = G::kBK * G::kRowBytes;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < G::kBK / 16; ++kk) {
    const __nv_bfloat16* rows = v_tile + kk * 16 * G::kBox;
    const uint64_t dv = smem_desc(rows, kBoxBytes, G::kSBO, G::kLayout);
    if constexpr (HD == 256) {           // two n128 halves, two boxes each
      wgmma_rs_n128(part<64>(acc, 0), p[kk], dv);
      wgmma_rs_n128(part<64>(acc, 64), p[kk],
                    smem_desc(rows + 2 * G::kBK * G::kBox, kBoxBytes,
                              G::kSBO, G::kLayout));
    } else if constexpr (HD == 128) {
      wgmma_rs_n128(acc, p[kk], dv);
    } else if constexpr (HD == 80) {
      wgmma_rs_n80(acc, p[kk], dv);
    } else {
      wgmma_rs_n64(acc, p[kk], dv);
    }
  }
  wgmma_commit();
}

// One online-softmax step in float32 on a tile's scores: scale, mask
// (edge tiles only), and turn s into the bf16-rounded probabilities
// exp2(s - max) that P V multiplies; the row sums take those same values,
// so the output stays a weighted average of V's rows.  `rescale` is the
// factor that takes the output to the new max.  This thread's rows are
// r0 and r0 + 8; its columns in each 8-wide group c0 and c0 + 1.
template <int BK>
__device__ __forceinline__ void softmax_step(float (&s)[BK / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&rescale)[2], bool edge,
                                             int k0, int r0, int c0, int S,
                                             int causal, float qscale) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int r = 0; r < BK / 2; ++r) {
    float x = s[r];
    if (edge) {
      const int col = k0 + 8 * (r / 4) + c0 + (r & 1);
      const int row = r0 + 8 * ((r >> 1) & 1);
      if (col >= S || (causal && col > row)) x = -INFINITY;
    }
    s[r] = x;
    mx[(r >> 1) & 1] = fmaxf(mx[(r >> 1) & 1], x);
  }
  float m_use[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i] * qscale);
    m_use[i] = m_new == -INFINITY ? 0.f : m_new;
    rescale[i] = exp2_approx(m[i] - m_use[i]);       // 0 from -inf
    m[i] = m_new;
    l[i] *= rescale[i];                  // this thread's part of the sum
  }
#pragma unroll
  for (int r = 0; r < BK / 2; r += 2) {
    const int i = (r >> 1) & 1;
    const float2 pf = __bfloat1622float2(__floats2bfloat162_rn(
        exp2_approx(fmaf(s[r], qscale, -m_use[i])),      // masked: 0
        exp2_approx(fmaf(s[r + 1], qscale, -m_use[i]))));
    s[r] = pf.x;
    s[r + 1] = pf.y;
    l[i] += pf.x + pf.y;
  }
}

// the probabilities as wgmma A fragments: the accumulator layout of 16
// keys is the A layout, so fragment kk is registers 8kk .. 8kk + 7
template <int BK>
__device__ __forceinline__ void pack_p(const float (&s)[BK / 2],
                                       uint32_t (&p)[BK / 16][4]) {
#pragma unroll
  for (int r = 0; r < BK / 2; r += 2) {
    const __nv_bfloat162 pb = __floats2bfloat162_rn(s[r], s[r + 1]);
    memcpy(&p[r / 8][(r / 2) % 4], &pb, 4);          // exact: already bf16
  }
}

// The work items of one launch, (batch*head, 128-query block), heaviest
// query blocks first; block c of a persistent grid of G takes items
// c, 2G-1-c, 2G+c, 4G-1-c, ... (a snake, so the blocks' sums of causal
// tiles stay within a few percent of each other).
struct Work {
  int n_items, n_bh, nqb, S, H, Hkv, causal;

  __device__ __forceinline__ int item(int j) const {
    const int G = gridDim.x, c = blockIdx.x;
    return j * G + ((j & 1) ? G - 1 - c : c);
  }
};

struct Item {
  int b, h, hk, q0, n_tiles;
};

// an item and its count of BK-key tiles: up to its last row if causal
template <int BK>
__device__ __forceinline__ Item decode(const Work& w, int item) {
  Item it;
  const int bh = item % w.n_bh;
  it.b = bh / w.H;
  it.h = bh % w.H;
  it.hk = it.h / (w.H / w.Hkv);
  it.q0 = (w.nqb - 1 - item / w.n_bh) * kBQ;
  const int q_last = min(it.q0 + kBQ, w.S) - 1;
  it.n_tiles = w.causal ? q_last / BK + 1 : (w.S + BK - 1) / BK;
  return it;
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap to, const Work w,
                   float qscale) {
  using G = Geo<HD>;
  constexpr int BK = G::kBK, NB = G::kNB, kBox = G::kBox;
  constexpr uint32_t kTileBytes = BK * HD * 2;
  extern __shared__ unsigned char smem_raw[];
  Smem<HD>& sm = *reinterpret_cast<Smem<HD>*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int S = w.S, causal = w.causal;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    mbar_init(&sm.q_empty, 8);           // lane 0 of each consumer warp
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&sm.k_full[st], 1);
      mbar_init(&sm.v_full[st], 1);
      mbar_init(&sm.k_empty[st], 8);
      mbar_init(&sm.v_empty[st], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps the TMA loads in flight, across
    // work items: the next item's Q as soon as the last q.k of this one
    // is done, its K and V tiles into the same two-stage ring ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid != 0) return;
    int g = 0;                           // ring position of the next tile
    for (int j = 0; w.item(j) < w.n_items; ++j) {
      const Item it = decode<BK>(w, w.item(j));
      if (j > 0) mbar_wait(&sm.q_empty, (j - 1) & 1);
      mbar_expect_tx(&sm.q_full, kBQ * HD * 2);
#pragma unroll
      for (int i = 0; i < NB; ++i)
        tma_load(sm.q[i], &tq, &sm.q_full, i * kBox, it.h, it.q0, it.b);
      for (int kt = 0; kt < it.n_tiles; ++kt, ++g) {
        const int st = g % kStages;
        const uint32_t parity = ((g / kStages) & 1) ^ 1;
        if (g >= kStages)                // K of tile g - kStages read
          mbar_wait(&sm.k_empty[st], parity);
        mbar_expect_tx(&sm.k_full[st], kTileBytes);
#pragma unroll
        for (int i = 0; i < NB; ++i)
          tma_load(sm.k[st][i], &tk, &sm.k_full[st], i * kBox, it.hk,
                   kt * BK, it.b);
        if (g >= kStages)                // V of tile g - kStages read
          mbar_wait(&sm.v_empty[st], parity);
        mbar_expect_tx(&sm.v_full[st], kTileBytes);
#pragma unroll
        for (int i = 0; i < NB; ++i)
          tma_load(sm.v[st][i], &tv, &sm.v_full[st], i * kBox, it.hk,
                   kt * BK, it.b);
      }
    }
    return;
  }

  // ---- consumers: 64 query rows per warpgroup.  Tile kt's q.k is
  // issued together with tile kt-1's p.v, and tile kt's softmax runs
  // while that p.v is on the tensor cores.  Named barriers 1 and 2 make
  // the two warpgroups take turns to issue (FA3's ping-pong), so one's
  // softmax overlaps the other's products ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int cw = wg - 1;
  const int warp = tid / 32, lane = tid % 32;
  const int c0 = 2 * (lane % 4);
  const __nv_bfloat16* q_rows = &sm.q[0][64 * cw * kBox];
  // a warp's shared-memory reads by wgmma are over once its
  // wgmma.wait_group returns, in all its lanes at once
  auto release = [&](uint64_t* bar) {
    if (lane == 0) mbar_arrive(bar);
  };
  if (cw == 1) bar_arrive(1);            // warpgroup 0 issues first
  int g0 = 0;                            // ring position of the item's tile 0
  for (int j = 0; w.item(j) < w.n_items; ++j) {
    const Item it = decode<BK>(w, w.item(j));
    const int n = it.n_tiles;
    // warpgroup 1 lets warpgroup 0 issue after each of its issues, but
    // the very last: each bar.sync then meets one bar.arrive
    const bool final_item = w.item(j + 1) >= w.n_items;
    auto hand_over = [&](int kt) {
      if (cw == 0 || !final_item || kt < n - 1) bar_arrive(2 - cw);
    };
    // a tile is masked if it holds keys past S or, causal, keys past
    // this warpgroup's first row (with 64-key tiles that is the last two
    // tiles of warpgroup 0, whose last one is masked whole: both
    // warpgroups issue every tile of the item)
    const int row0 = it.q0 + 64 * cw;
    auto edge = [&](int kt) {
      const int k_end = (kt + 1) * BK;
      return k_end > S || (causal && k_end - 1 > row0);
    };
    const int r0 = row0 + 16 * warp + lane / 4;
    float acc[HD / 2], s[BK / 2];
    uint32_t p[BK / 16][4];
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, rescale[2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

    mbar_wait(&sm.q_full, j & 1);
    mbar_wait(&sm.k_full[g0 % kStages], (g0 / kStages) & 1);
    bar_sync(1 + cw);
    issue_qk<HD>(s, q_rows, sm.k[g0 % kStages][0]);
    hand_over(0);
    wgmma_wait<0>();
    fence_regs(s);
    release(&sm.k_empty[g0 % kStages]);
    if (n == 1) release(&sm.q_empty);
    softmax_step<BK>(s, m, l, rescale, edge(0), 0, r0, c0, S, causal,
                     qscale);
    pack_p<BK>(s, p);

    for (int kt = 1; kt < n; ++kt) {
      const int g = g0 + kt;
      const int st = g % kStages, pst = (g - 1) % kStages;
      mbar_wait(&sm.k_full[st], (g / kStages) & 1);
      bar_sync(1 + cw);
      issue_qk<HD>(s, q_rows, sm.k[st][0]);
#pragma unroll
      for (int r = 0; r < HD / 2; ++r) acc[r] *= rescale[(r >> 1) & 1];
      mbar_wait(&sm.v_full[pst], ((g - 1) / kStages) & 1);
      issue_pv<HD>(acc, p, sm.v[pst][0]);
      hand_over(kt);
      wgmma_wait<1>();                   // q.k of tile kt is done
      fence_regs(s);
      release(&sm.k_empty[st]);
      if (kt == n - 1) release(&sm.q_empty);
      softmax_step<BK>(s, m, l, rescale, edge(kt), kt * BK, r0, c0, S,
                       causal, qscale);
      wgmma_wait<0>();                   // p.v of tile kt-1 is done
      fence_regs(acc);
      fence_regs(p);
      release(&sm.v_empty[pst]);
      pack_p<BK>(s, p);
    }

    // the last tile's p.v
    const int gl = g0 + n - 1;
#pragma unroll
    for (int r = 0; r < HD / 2; ++r) acc[r] *= rescale[(r >> 1) & 1];
    mbar_wait(&sm.v_full[gl % kStages], (gl / kStages) & 1);
    issue_pv<HD>(acc, p, sm.v[gl % kStages][0]);
    wgmma_wait<0>();
    fence_regs(acc);
    release(&sm.v_empty[gl % kStages]);
    g0 += n;

    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      inv[i] = 1.f / fmaxf(l[i], 1e-30f);
    }
    // O goes through shared memory in the swizzle the output's tensor
    // map reads (16-byte chunk ^ its 128-byte line's index within the
    // swizzle span: no bank conflicts), kOPass boxes at a time, and one
    // thread stores it by TMA, which drops rows past S
    constexpr int kChunks = kBox / 8;    // 16-byte chunks in a box row
    constexpr int kOB = NB / G::kOPass;  // boxes a pass
#pragma unroll
    for (int ps = 0; ps < G::kOPass; ++ps) {
      if (tid == 0) tma_store_drain();   // the last store has read
      warpgroup_sync(cw);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = 16 * warp + lane / 4 + 8 * i;   // of this warpgroup
        const int swz = (row * G::kRowBytes / 128) % kChunks;
#pragma unroll
        for (int jj = 0; jj < kOB * kChunks; ++jj) {
          const int col8 = ps * kOB * kChunks + jj;     // 8-lane group
          unsigned char* dst =
              reinterpret_cast<unsigned char*>(sm.o[cw][jj / kChunks]) +
              row * G::kRowBytes + ((jj % kChunks) ^ swz) * 16 + 2 * c0;
          *reinterpret_cast<__nv_bfloat162*>(dst) =
              __floats2bfloat162_rn(acc[4 * col8 + 2 * i] * inv[i],
                                    acc[4 * col8 + 2 * i + 1] * inv[i]);
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      warpgroup_sync(cw);
      if (tid == 0) {
#pragma unroll
        for (int bx = 0; bx < kOB; ++bx)
          tma_store(&to, sm.o[cw][bx], (ps * kOB + bx) * kBox, it.h, row0,
                    it.b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
  }
  if (tid == 0) tma_store_drain();       // before the block's memory goes
}

// ---- host side: tensor maps and launch ----

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// tensor maps by (pointer, shape, box): a map depends on nothing else
struct MapEntry {
  const void* ptr;
  int B, S, heads, hd, lanes, rows;
  CUtensorMap map;
};
constexpr int kMapCache = 64;
MapEntry g_maps[kMapCache];
int g_next_map = 0;
std::mutex g_maps_mu;

// the map of a contiguous bf16 [B, S, heads, hd] tensor, boxes of
// `lanes` lanes (64: 128-byte swizzle, 16: 32-byte) x `rows` rows of one
// head; 0, or -CUresult on failure
int tensor_map(const void* ptr, int B, int S, int heads, int hd, int lanes,
               int rows, CUtensorMap* out) {
  std::lock_guard<std::mutex> lock(g_maps_mu);
  for (const MapEntry& e : g_maps)
    if (e.ptr == ptr && e.B == B && e.S == S && e.heads == heads &&
        e.hd == hd && e.lanes == lanes && e.rows == rows) {
      *out = e.map;
      return 0;
    }
  const EncodeTiled encode = encode_fn();
  if (encode == nullptr) return -(int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)S * heads * hd * 2};
  const cuuint32_t box[4] = {(cuuint32_t)lanes, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  CUtensorMap map;
  const CUresult r = encode(
      &map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
      dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      lanes == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return -(int)r;
  MapEntry& slot = g_maps[g_next_map];
  g_next_map = (g_next_map + 1) % kMapCache;
  slot = {ptr, B, S, heads, hd, lanes, rows, map};
  *out = map;
  return 0;
}

int sm_count() {
  static const int n = [] {
    int dev = 0, count = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                               dev) != cudaSuccess)
      return 0;
    return count;
  }();
  return n;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int Hkv, int causal, cudaStream_t st) {
  using G = Geo<HD>;
  constexpr size_t bytes = sizeof(Smem<HD>) + 1024;   // + alignment
  static_assert(bytes <= kSmemMax, "tiles exceed a block's shared memory");
  static bool attr_set = false;          // once per instantiation
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int n_sm = sm_count();
  if (n_sm < 1) return (int)cudaErrorInvalidDevice;
  CUtensorMap mq, mk, mv, mo;
  int err = tensor_map(q, B, S, H, HD, G::kBox, kBQ, &mq);
  if (err == 0) err = tensor_map(k, B, S, Hkv, HD, G::kBox, G::kBK, &mk);
  if (err == 0) err = tensor_map(v, B, S, Hkv, HD, G::kBox, G::kBK, &mv);
  if (err == 0) err = tensor_map(o, B, S, H, HD, G::kBox, 64, &mo);
  if (err != 0) return err;
  const int nqb = (S + kBQ - 1) / kBQ;
  const Work w{B * H * nqb, B * H, nqb, S, H, Hkv, causal};
  const float qscale = kLog2e / sqrtf((float)HD);
  flash_wgmma_kernel<HD><<<min(n_sm, w.n_items), kThreads, bytes, st>>>(
      mq, mk, mv, mo, w, qscale);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 only, hd 64, 80, 128 or 256, pointers 16-byte aligned.  Returns
// 0, a CUDA runtime error, or minus the CUresult of a failed tensor-map
// encoding.
extern "C" int flash_attention_wgmma_launch(const void* q, const void* k,
                                            const void* v, void* o, int B,
                                            int S, int H, int Hkv, int hd,
                                            int causal, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (Hkv < 1 || H % Hkv != 0 ||
      (int64_t)B * H * ((S + kBQ - 1) / kBQ) > INT32_MAX / 2)
    return (int)cudaErrorInvalidValue;
  for (const void* p : {q, k, v, static_cast<const void*>(o)})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return launch<64>(q, k, v, o, B, S, H, Hkv, causal, st);
    case 80: return launch<80>(q, k, v, o, B, S, H, Hkv, causal, st);
    case 128: return launch<128>(q, k, v, o, B, S, H, Hkv, causal, st);
    case 256: return launch<256>(q, k, v, o, B, S, H, Hkv, causal, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
