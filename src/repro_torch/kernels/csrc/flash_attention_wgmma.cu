// flash_attention_wgmma: causal or non-causal attention forward in bf16
// for head widths 64 and 128, on Hopper's tensor cores (sm_90a).
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
// What bounds it on this card: bytes.  At the prefill shape (B=4,
// S=1024, H=16, hd=128, causal) it must read q, k, v and write out,
// 67.1 MB, 0.0200 ms at 3.35 TB/s; its 17.2 GFLOP of q.k and p.v over
// the lower triangle take 0.0174 ms at 989 TFLOP/s.  Both are close, so
// the design keeps the products on the tensor cores, the loads off the
// threads and the softmax in the products' shadow:
//
// * A persistent grid, one block of three warpgroups per SM.  The work
//   items (batch*head, 128-query block) are ordered heaviest query
//   block first and dealt to the blocks in a snake (Work::item).
// * Warpgroup 0 is the producer: one thread issues the TMA loads (each
//   item's Q once, into a buffer that an mbarrier releases after the
//   item's last q.k; K and V tiles of 128 keys into a two-stage ring,
//   each tile with its own "full" mbarrier and K and V each released by
//   an "empty" mbarrier that lane 0 of every consumer warp arrives on),
//   running ahead across items, so the next item's loads overlap this
//   item's last tile and its stores.  The warpgroup gives its registers
//   to the consumers (setmaxnreg 24 / 240).  Warpgroups 1 and 2 each
//   own 64 query rows of the item, and store them through a shared
//   staging buffer by TMA, asynchronously.
// * Tensor maps over the tensors' real strides, [B, S, H(kv), hd], with
//   the head in the box coordinate, 64-lane boxes (128 bytes) in the
//   128-byte swizzle that wgmma reads; hd = 128 is two boxes.  They are
//   encoded on the host (cuTensorMapEncodeTiled through the runtime's
//   driver entry point), cached per (pointer, shape, box height) and
//   passed as __grid_constant__ parameters.
// * S = Q K^T: wgmma m64n128k16 with Q and K both K-major in shared
//   memory.  O += P V: P goes from the score registers to bf16 pairs in
//   registers as the A operand (the accumulator layout is the A
//   layout); V is read from shared memory as an MN-major B with the
//   transpose bit.  Tile kt's q.k is issued with tile kt-1's p.v, and
//   tile kt's softmax runs while that p.v is on the tensor cores; the
//   two consumer warpgroups take turns to issue (named barriers 1 and
//   2, FA3's ping-pong), so one's softmax overlaps the other's
//   products.
// * The online softmax keeps (max, sum) per row in float32 registers
//   and computes exp2(s * log2(e) / sqrt(hd) - max) with one FMA.  A
//   masked score is -inf and contributes exactly 0 (a row with nothing
//   visible yet keeps max -inf, sum 0, acc 0: the guard of
//   layers.chunked_attention).  Causal: key tiles wholly above the
//   diagonal are not loaded; only the last tile (the diagonal, or the
//   keys past S) is masked.  Output = acc / max(sum, 1e-30).
//
// Not done (ROADMAP): a dynamic tile scheduler, overlap of one item's
// first q.k with the last p.v of the one before, and skipping the half
// of the diagonal tile that lies above warpgroup 0's rows (a branch
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

constexpr int kBQ = 128;                 // query rows per block
constexpr int kBK = 128;                 // keys per tile
constexpr int kStages = 2;               // K/V ring depth
constexpr int kThreads = 384;            // producer + 2 consumer warpgroups
constexpr int kBox = 64;                 // lanes per TMA box: 128 bytes
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct alignas(1024) Smem {
  __nv_bfloat16 q[HD / kBox][kBQ * kBox];            // 16 KB boxes
  __nv_bfloat16 k[kStages][HD / kBox][kBK * kBox];
  __nv_bfloat16 v[kStages][HD / kBox][kBK * kBox];
  __nv_bfloat16 o[2][HD / kBox][64 * kBox];          // per consumer, 8 KB
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

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (all >> 4), layout 1 = B128
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
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

// D[64 x 128] (+)= A[64 x 16] B[16 x 128]: A and B K-major in shared
// memory (descriptors), D float32 in registers; accumulate = 0 sets D
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
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
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 64] += A[64 x 16] B[16 x 64]: A in registers (bf16 pairs in
// the accumulator layout), B MN-major in shared memory (transpose bit)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---- one consumer warpgroup's steps over a 128-key tile ----

// S = Q K^T over hd in steps of 16 (32 bytes into a 128-byte row)
template <int HD>
__device__ __forceinline__ void issue_qk(float (&s)[kBK / 2],
                                         const __nv_bfloat16* q_rows,
                                         const __nv_bfloat16* k_tile) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int box = kk / 4, off = (kk % 4) * 16;
    wgmma_ss_n128(s, smem_desc(q_rows + box * kBQ * kBox + off, 16, 1024),
                  smem_desc(k_tile + box * kBK * kBox + off, 16, 1024),
                  kk > 0);
  }
  wgmma_commit();
}

// O += P V over the tile's keys in steps of 16 (2 KB of V rows)
template <int HD>
__device__ __forceinline__ void issue_pv(float (&acc)[HD / 2],
                                         const uint32_t (&p)[kBK / 16][4],
                                         const __nv_bfloat16* v_tile) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    const uint64_t dv =
        smem_desc(v_tile + kk * 16 * kBox, kBK * kBox * 2, 1024);
    if constexpr (HD == 128)
      wgmma_rs_n128(acc, p[kk], dv);
    else
      wgmma_rs_n64(acc, p[kk], dv);
  }
  wgmma_commit();
}

// One online-softmax step in float32 on a tile's scores: scale, mask
// (the edge tile only), and turn s into the bf16-rounded probabilities
// exp2(s - max) that P V multiplies; the row sums take those same values,
// so the output stays a weighted average of V's rows.  `rescale` is the
// factor that takes the output to the new max.  This thread's rows are
// r0 and r0 + 8; its columns in each 8-wide group c0 and c0 + 1.
__device__ __forceinline__ void softmax_step(float (&s)[kBK / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&rescale)[2], bool edge,
                                             int k0, int r0, int c0, int S,
                                             int causal, float qscale) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int r = 0; r < kBK / 2; ++r) {
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
  for (int r = 0; r < kBK / 2; r += 2) {
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
__device__ __forceinline__ void pack_p(const float (&s)[kBK / 2],
                                       uint32_t (&p)[kBK / 16][4]) {
#pragma unroll
  for (int r = 0; r < kBK / 2; r += 2) {
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

__device__ __forceinline__ Item decode(const Work& w, int item) {
  Item it;
  const int bh = item % w.n_bh;
  it.b = bh / w.H;
  it.h = bh % w.H;
  it.hk = it.h / (w.H / w.Hkv);
  it.q0 = (w.nqb - 1 - item / w.n_bh) * kBQ;
  const int q_last = min(it.q0 + kBQ, w.S) - 1;
  it.n_tiles = w.causal ? q_last / kBK + 1 : (w.S + kBK - 1) / kBK;
  return it;
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap to, const Work w,
                   float qscale) {
  constexpr int NB = HD / kBox;          // boxes per row of a tile
  constexpr uint32_t kTileBytes = kBK * HD * 2;
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
      const Item it = decode(w, w.item(j));
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
                   kt * kBK, it.b);
        if (g >= kStages)                // V of tile g - kStages read
          mbar_wait(&sm.v_empty[st], parity);
        mbar_expect_tx(&sm.v_full[st], kTileBytes);
#pragma unroll
        for (int i = 0; i < NB; ++i)
          tma_load(sm.v[st][i], &tv, &sm.v_full[st], i * kBox, it.hk,
                   kt * kBK, it.b);
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
    const Item it = decode(w, w.item(j));
    const int n = it.n_tiles;
    // warpgroup 1 lets warpgroup 0 issue after each of its issues, but
    // the very last: each bar.sync then meets one bar.arrive
    const bool final_item = w.item(j + 1) >= w.n_items;
    auto hand_over = [&](int kt) {
      if (cw == 0 || !final_item || kt < n - 1) bar_arrive(2 - cw);
    };
    auto edge = [&](int kt) {
      return kt == n - 1 && (causal || S % kBK != 0);
    };
    const int r0 = it.q0 + 64 * cw + 16 * warp + lane / 4;
    float acc[HD / 2], s[kBK / 2];
    uint32_t p[kBK / 16][4];
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
    softmax_step(s, m, l, rescale, edge(0), 0, r0, c0, S, causal, qscale);
    pack_p(s, p);

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
      softmax_step(s, m, l, rescale, edge(kt), kt * kBK, r0, c0, S, causal,
                   qscale);
      wgmma_wait<0>();                   // p.v of tile kt-1 is done
      fence_regs(acc);
      fence_regs(p);
      release(&sm.v_empty[pst]);
      pack_p(s, p);
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
    // O goes through shared memory in the 128-byte swizzle the output's
    // tensor map reads (16-byte chunk ^ row % 8: no bank conflicts), and
    // one thread stores it by TMA, which drops rows past S
    if (tid == 0) tma_store_drain();     // the last item's store has read
    warpgroup_sync(cw);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = 16 * warp + lane / 4 + 8 * i;   // of this warpgroup
#pragma unroll
      for (int jj = 0; jj < HD / 8; ++jj) {
        unsigned char* dst =
            reinterpret_cast<unsigned char*>(sm.o[cw][jj / 8]) + row * 128 +
            ((jj % 8) ^ (row & 7)) * 16 + 2 * c0;
        *reinterpret_cast<__nv_bfloat162*>(dst) =
            __floats2bfloat162_rn(acc[4 * jj + 2 * i] * inv[i],
                                  acc[4 * jj + 2 * i + 1] * inv[i]);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    warpgroup_sync(cw);
    if (tid == 0) {
#pragma unroll
      for (int bx = 0; bx < HD / kBox; ++bx)
        tma_store(&to, sm.o[cw][bx], bx * kBox, it.h, it.q0 + 64 * cw,
                  it.b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
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

// tensor maps by (pointer, shape): a map depends on nothing else
struct MapEntry {
  const void* ptr;
  int B, S, heads, hd, rows;
  CUtensorMap map;
};
constexpr int kMapCache = 64;
MapEntry g_maps[kMapCache];
int g_next_map = 0;
std::mutex g_maps_mu;

// the map of a contiguous bf16 [B, S, heads, hd] tensor, boxes of 64
// lanes x `rows` rows of one head; 0, or -CUresult on failure
int tensor_map(const void* ptr, int B, int S, int heads, int hd, int rows,
               CUtensorMap* out) {
  std::lock_guard<std::mutex> lock(g_maps_mu);
  for (const MapEntry& e : g_maps)
    if (e.ptr == ptr && e.B == B && e.S == S && e.heads == heads &&
        e.hd == hd && e.rows == rows) {
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
  const cuuint32_t box[4] = {kBox, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  CUtensorMap map;
  const CUresult r = encode(
      &map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
      dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return -(int)r;
  MapEntry& slot = g_maps[g_next_map];
  g_next_map = (g_next_map + 1) % kMapCache;
  slot = {ptr, B, S, heads, hd, rows, map};
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
  static_assert(kBQ == kBK, "Q and K/V share one box shape");
  constexpr size_t bytes = sizeof(Smem<HD>) + 1024;   // + alignment
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
  int err = tensor_map(q, B, S, H, HD, kBQ, &mq);
  if (err == 0) err = tensor_map(k, B, S, Hkv, HD, kBK, &mk);
  if (err == 0) err = tensor_map(v, B, S, Hkv, HD, kBK, &mv);
  if (err == 0) err = tensor_map(o, B, S, H, HD, 64, &mo);
  if (err != 0) return err;
  const int nqb = (S + kBQ - 1) / kBQ;
  const Work w{B * H * nqb, B * H, nqb, S, H, Hkv, causal};
  const float qscale = kLog2e / sqrtf((float)HD);
  flash_wgmma_kernel<HD><<<min(n_sm, w.n_items), kThreads, bytes, st>>>(
      mq, mk, mv, mo, w, qscale);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 only, hd 64 or 128, pointers 16-byte aligned.  Returns 0, a CUDA
// runtime error, or minus the CUresult of a failed tensor-map encoding.
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
  if (hd == 64) return launch<64>(q, k, v, o, B, S, H, Hkv, causal, st);
  if (hd == 128) return launch<128>(q, k, v, o, B, S, H, Hkv, causal, st);
  return (int)cudaErrorInvalidValue;
}
