// relax.cuh: what the fused relax kernels (twc_relax.cu, edge_lb_relax.cu,
// merge_path_relax.cu) share: the operator's msg as an enum, and the
// combine into the labels.
//
// Label types and combines the kernels take (the wrapper raises on any
// other): int32 min, int32 add, float32 add.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace relax {

// repro_torch.core.operators.MSG_KINDS, in the same order
enum Msg : int32_t {
  MSG_ADD_W = 0,   // v + w
  MSG_ADD_1 = 1,   // v + 1
  MSG_COPY = 2,    // v
  MSG_NEG_1 = 3,   // -1
};

// candidate from the propagated value v and the edge weight w, as the
// operator's torch msg computes it (int32 wraps, as torch's int32 does)
__device__ __forceinline__ int32_t msg_of(int32_t kind, int32_t v, int32_t w) {
  switch (kind) {
    case MSG_ADD_W: return (int32_t)((uint32_t)v + (uint32_t)w);
    case MSG_ADD_1: return (int32_t)((uint32_t)v + 1u);
    case MSG_COPY: return v;
    default: return -1;
  }
}

__device__ __forceinline__ float msg_of(int32_t kind, float v, int32_t w) {
  switch (kind) {
    case MSG_ADD_W: return v + (float)w;   // torch promotes w to float32
    case MSG_ADD_1: return v + 1.0f;
    case MSG_COPY: return v;
    default: return -1.0f;
  }
}

template <typename T, bool ADD>
__device__ __forceinline__ T neutral() {
  return ADD ? (T)0 : (T)INT32_MAX;     // min is taken on int32 only
}

template <bool ADD, typename T>
__device__ __forceinline__ T combine(T a, T b) {
  if constexpr (ADD) return a + b;
  else return a < b ? a : b;
}

// labels[i] = combine(labels[i], c) with an atomic.  A min first reads
// the label and skips the atomic when c cannot win: labels only fall
// during a min pass, so even a stale read is >= the current value, and
// a skipped candidate could never have won.  PERF.md records what the
// probe saves on sssp's passes.
template <bool ADD, typename T>
__device__ __forceinline__ void combine_at(T* p, T c) {
  if constexpr (ADD) {
    atomicAdd(p, c);
  } else {
    if (c < *p) atomicMin(p, c);
  }
}

// SMs of the current device: grids sized to keep a few blocks on each
inline int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

}  // namespace relax
