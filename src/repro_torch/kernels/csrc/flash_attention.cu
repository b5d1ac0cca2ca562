// flash_attention: causal or non-causal attention forward with an
// online softmax, grouped-query heads, for Hopper (sm_90a), on the CUDA
// cores: the "simt" route of kernels/flash_attention.py, which takes
// float32 and the head widths other than 64, 80, 128 and 256 (bf16 at
// those takes flash_attention_wgmma.cu).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:68
// (flash_attention; kernel body _flash_kernel at :28).  For q [B,S,H,hd]
// and k, v [B,S,Hkv,hd] (bf16 or f32, contiguous), query head h reads
// KV head h / (H / Hkv) -- the repeat is never materialized -- and
//
//   out[b,s,h] = sum_c softmax_c(q.k_c / sqrt(hd)) v_c       (c <= s if causal)
//
// in float32, written in the input type.  Any S: rows and keys past S
// are masked here (the TPU kernel needed S % block == 0).  hd up to 256:
// the kernel is instantiated for padded widths 16, 32, 64, 128 and 256,
// and the lanes past hd are zeros in shared memory (zamba2's hd 80 runs
// at 128, paligemma's hd 256 at 256).  At 256 the float32 variant's
// tiles take 64 x 257 x 4 (q) + 2 x 64 x 257 x 4 (K, V) + 64 x 80 x 4
// (p) = 217,856 bytes of the 232,448 a block may have, so one block
// runs per SM; the bf16 variant takes 152,320.
//
// Design: one block of 256 threads per (batch*head, 64-query block).
// The block keeps its 64 scaled query rows in shared memory (float32)
// and streams 64-key tiles of K and V through shared memory (in the
// input type).  Each thread owns a 4 x 4 patch of the 64 x 64 score
// tile (rows tr + 16i, keys tc + 16j) and a 4 x (HD/16) patch of the
// output (rows tr + 16i, lanes tc + 16k), so a row's 16 owners are the
// 16 lanes of one half-warp and the row max and row sum are two
// 4-step shuffle reductions.  The online softmax keeps (max, sum, acc)
// per row in registers and uses exp2 with log2(e) folded into the
// query scale.  A masked score is -inf and contributes exactly 0 (the
// guard of layers.chunked_attention: a row with nothing visible yet
// keeps max -inf, sum 0, acc 0).  Causal: the key tiles wholly above
// the block's last query row are not visited; the heaviest query
// blocks are scheduled first.  Output = acc / max(sum, 1e-30).
//
// What bounds it on this card: bytes, closely followed by operations.
// Causal attention does about 2*B*H*S^2*hd FLOPs (q.k and p.v over the
// lower triangle) and must read q, k, v and write out once,
// 4*B*S*H*hd elements; at B=4, S=1024, H=16, hd=128 in bf16 that is
// 17.2 GFLOP (0.0174 ms at 989 TFLOP/s) against 67.1 MB (0.0200 ms at
// 3.35 TB/s).  This kernel runs its products on the CUDA cores in
// float32 (a TF32 product would not hold float32's tolerance), so it
// sits far from that bound.  Padding keeps every shared-memory access of
// the inner loops free of bank conflicts (row strides HD+1 floats,
// HD+2 halves, 80 floats for the probability tile).  The kernel
// allocates nothing and launches on the caller's stream.
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;                  // query rows per block
constexpr int kBK = 64;                  // keys per tile
constexpr int kThreads = 256;
constexpr int kPStride = kBK + 16;       // probability tile row stride
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);            // round to nearest even
}

// row stride of the K/V tiles, in elements: odd in 32-bit words
template <typename T, int HD> struct KVStride {
  static constexpr int value = sizeof(T) == 4 ? HD + 1 : HD + 2;
};

template <typename T, int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * kBQ * (HD + 1) +
         2 * sizeof(T) * kBK * KVStride<T, HD>::value +
         sizeof(float) * kBQ * kPStride;
}

// every instantiation fits a block's dynamic shared memory on sm_90
static_assert(smem_bytes<float, 256>() <= 232448, "hd 256 tiles");

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int32_t S,
                 int32_t H, int32_t Hkv, int32_t hd, int32_t causal,
                 float qscale) {
  constexpr int QS = HD + 1;
  constexpr int KS = KVStride<T, HD>::value;
  constexpr int NK = HD / 16;            // output lanes per thread
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  T* Ks = reinterpret_cast<T*>(Qs + kBQ * QS);
  T* Vs = Ks + kBK * KS;
  float* Ps = reinterpret_cast<float*>(Vs + kBK * KS);

  const int tid = threadIdx.x;
  const int tr = tid >> 4;               // 0..15
  const int tc = tid & 15;               // 0..15
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / (H / Hkv);
  const int qb = gridDim.y - 1 - blockIdx.y;   // heaviest blocks first
  const int q0 = qb * kBQ;

  // query tile, scaled by log2(e) / sqrt(hd), float32
  for (int idx = tid; idx < kBQ * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    const int s = q0 + r;
    float x = 0.f;
    if (s < S && d < hd)
      x = to_f(q[(((int64_t)b * S + s) * H + h) * hd + d]) * qscale;
    Qs[r * QS + d] = x;
  }

  float m[4], l[4], acc[4][NK];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) acc[i][kk] = 0.f;
  }

  const int q_last = min(q0 + kBQ, S) - 1;
  const int n_tiles = causal ? q_last / kBK + 1 : (S + kBK - 1) / kBK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                     // last tile's readers are done
    for (int idx = tid; idx < kBK * HD; idx += kThreads) {
      const int r = idx / HD, d = idx % HD;
      const int s = k0 + r;
      T kx = from_f<T>(0.f), vx = from_f<T>(0.f);
      if (s < S && d < hd) {
        const int64_t off = (((int64_t)b * S + s) * Hkv + hk) * hd + d;
        kx = k[off];
        vx = v[off];
      }
      Ks[r * KS + d] = kx;
      Vs[r * KS + d] = vx;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(tr + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = to_f(Ks[(tc + 16 * j) * KS + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + tr + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tc + 16 * j;
        if (kpos >= S || (causal && kpos > qpos)) sc[i][j] = -INFINITY;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float scale = m[i] == -INFINITY ? 0.f : exp2f(m[i] - m_use);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = sc[i][j] == -INFINITY ? 0.f
                                              : exp2f(sc[i][j] - m_use);
        Ps[(tr + 16 * i) * kPStride + tc + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * scale + rs;
      m[i] = m_new;
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) acc[i][kk] *= scale;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[4], vv[NK];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(tr + 16 * i) * kPStride + c];
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) vv[kk] = to_f(Vs[c * KS + tc + 16 * kk]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int kk = 0; kk < NK; ++kk)
          acc[i][kk] = fmaf(pv[i], vv[kk], acc[i][kk]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + tr + 16 * i;
    if (s >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      const int d = tc + 16 * kk;
      if (d < hd)
        o[(((int64_t)b * S + s) * H + h) * hd + d] =
            from_f<T>(acc[i][kk] * inv);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int Hkv, int hd, int causal, cudaStream_t st) {
  constexpr size_t bytes = smem_bytes<T, HD>();
  static bool attr_set = false;          // once per instantiation
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid(B * H, (S + kBQ - 1) / kBQ);
  const float qscale = kLog2e / sqrtf((float)hd);
  flash_fwd_kernel<T, HD><<<grid, kThreads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, Hkv, hd, causal,
      qscale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, void* o, int B,
                int S, int H, int Hkv, int hd, int causal, cudaStream_t st) {
  if (hd <= 16) return launch<T, 16>(q, k, v, o, B, S, H, Hkv, hd, causal, st);
  if (hd <= 32) return launch<T, 32>(q, k, v, o, B, S, H, Hkv, hd, causal, st);
  if (hd <= 64) return launch<T, 64>(q, k, v, o, B, S, H, Hkv, hd, causal, st);
  if (hd <= 128)
    return launch<T, 128>(q, k, v, o, B, S, H, Hkv, hd, causal, st);
  if (hd <= 256)
    return launch<T, 256>(q, k, v, o, B, S, H, Hkv, hd, causal, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int H, int Hkv, int hd, int causal,
                                      int dtype, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (hd < 1 || hd > 256 || Hkv < 1 || H % Hkv != 0 ||
      (S + kBQ - 1) / kBQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(q, k, v, o, B, S, H, Hkv, hd, causal, st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(q, k, v, o, B, S, H, Hkv, hd, causal,
                                      st);
  return (int)cudaErrorInvalidValue;
}
