// graph_loop: the conditional nodes of a CUDA graph, for the port's
// device-side control flow (repro_torch/core/graph_loop.py), on Hopper
// (sm_90a).  CUDA 12.4 or later: IF and WHILE nodes, nested.
//
// No TPU kernel is replaced here.  On the TPU, XLA compiles
// lax.while_loop and lax.cond (src/repro/core/balancer.py: the fused
// traversal loop, the unbounded bin's chunk loop, the direction choice)
// into device control flow.  The port records the torch ops of a round
// as CUDA graphs (torch.cuda.CUDAGraph, keep_graph=True), and these host
// functions assemble them into one graph of its own: each recorded piece
// becomes a child graph node, and each branch or loop a conditional node
// whose body holds the pieces recorded inside it.
//
// A conditional node reads its handle, which a kernel upstream of it in
// the same graph, or the last node of a WHILE body, sets on the device
// from one bool in device memory: set_cond below.  So a branch is taken,
// or a loop goes round again, with no value crossing to the host.
//
// What bounds set_cond: launch latency.  It reads one byte and is
// launched as one thread; a WHILE iteration costs the conditional
// node's turn-around on the card, not bytes.  It also counts its runs in
// a device counter (one atomic), so a run can show how many branch and
// loop decisions the card took.
//
// span_stamp, the graph's other tiny kernel, times a traced traversal
// from the inside (repro_torch/core/spans.py): one thread reads
// %globaltimer and writes it, with up to kCounts int32 device counts the
// round already has, into a ring of stamp rows, row base + *r % cap for
// the round r it reads from the loop's carry on the device, so the fixed
// arguments of a captured launch land in each round's own row.  It is
// captured always and gated by a device flag: off, it returns at once.
// What bounds it: launch latency (one thread, at most 48 bytes written).
//
// The host functions return cudaError_t as an int, as every C entry of
// this package does; none of them but gl_stamp launches work.
#include <cstdint>
#include <cuda_runtime.h>

#if CUDART_VERSION < 12040
#error "graph_loop.cu needs CUDA 12.4 or later (conditional graph nodes)"
#endif

namespace {

__device__ unsigned long long g_set_runs;

// handle := (*flag != 0) != negate
__global__ void set_cond(cudaGraphConditionalHandle handle,
                         const bool* flag, int negate) {
  cudaGraphSetConditional(handle, (*flag ? 1 : 0) != negate ? 1u : 0u);
  atomicAdd(&g_set_runs, 1ull);
}

constexpr int kCounts = 5;

struct Counts {
  const int* p[kCounts];
};

// ring[at][col] := {%globaltimer, *counts.p[0..kCounts)} (0 for a null
// count), at = row + *r % cap (r null: `row`); nothing while *flag == 0
__global__ void span_stamp(long long* ring, int cap, int points, int row,
                           const int* r, int col, const int* flag,
                           Counts counts) {
  if (flag != nullptr && *flag == 0) return;
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  const long long at = row + (r != nullptr ? (long long)(*r % cap) : 0);
  long long* out = ring + (at * points + col) * (1 + kCounts);
  out[0] = (long long)t;
  for (int i = 0; i < kCounts; ++i)
    out[1 + i] = counts.p[i] != nullptr ? *counts.p[i] : 0;
}

cudaError_t add_set(cudaGraph_t graph, cudaGraphNode_t dep,
                    cudaGraphConditionalHandle handle, const void* flag,
                    int negate, cudaGraphNode_t* node) {
  void* args[] = {&handle, const_cast<void**>(&flag), &negate};
  cudaKernelNodeParams p = {};
  p.func = reinterpret_cast<void*>(set_cond);
  p.gridDim = dim3(1);
  p.blockDim = dim3(1);
  p.sharedMemBytes = 0;
  p.kernelParams = args;
  p.extra = nullptr;
  return cudaGraphAddKernelNode(node, graph, dep ? &dep : nullptr,
                                dep ? 1 : 0, &p);
}

}  // namespace

extern "C" int gl_graph_create(void** graph) {
  cudaGraph_t g = nullptr;
  const cudaError_t e = cudaGraphCreate(&g, 0);
  *graph = g;
  return (int)e;
}

extern "C" int gl_graph_destroy(void* graph) {
  return (int)cudaGraphDestroy(static_cast<cudaGraph_t>(graph));
}

// nodes in `graph` (its top level)
extern "C" int gl_graph_nodes(void* graph, long long* n) {
  size_t count = 0;
  const cudaError_t e =
      cudaGraphGetNodes(static_cast<cudaGraph_t>(graph), nullptr, &count);
  *n = (long long)count;
  return (int)e;
}

// a copy of `child` as a node of `graph` after `dep` (null: first node)
extern "C" int gl_add_child(void* graph, void* dep, void* child,
                            void** node) {
  cudaGraphNode_t d = static_cast<cudaGraphNode_t>(dep), n = nullptr;
  const cudaError_t e = cudaGraphAddChildGraphNode(
      &n, static_cast<cudaGraph_t>(graph), d ? &d : nullptr, d ? 1 : 0,
      static_cast<cudaGraph_t>(child));
  *node = n;
  return (int)e;
}

// set_cond(handle, flag, negate) -> a conditional node of `type` (0 IF,
// 1 WHILE) over a new handle, both appended to `graph` after `dep`.
// Returns the conditional node, its body graph (owned by the node) and
// the handle, which a WHILE body sets again as its last node (gl_add_set).
extern "C" int gl_add_conditional(void* graph, void* dep, int type,
                                  const void* flag, int negate, void** node,
                                  void** body,
                                  unsigned long long* handle) {
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  cudaGraphConditionalHandle h = 0;
  cudaError_t e = cudaGraphConditionalHandleCreate(&h, g, 0, 0);
  if (e != cudaSuccess) return (int)e;
  cudaGraphNode_t set = nullptr;
  e = add_set(g, static_cast<cudaGraphNode_t>(dep), h, flag, negate, &set);
  if (e != cudaSuccess) return (int)e;
  cudaGraphNodeParams p = {};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = h;
  p.conditional.type = type ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  p.conditional.size = 1;
  cudaGraphNode_t n = nullptr;
#if CUDART_VERSION >= 13000
  e = cudaGraphAddNode(&n, g, &set, nullptr, 1, &p);
#else
  e = cudaGraphAddNode(&n, g, &set, 1, &p);
#endif
  if (e != cudaSuccess) return (int)e;
  *node = n;
  *body = p.conditional.phGraph_out[0];
  *handle = h;
  return 0;
}

// set_cond(handle, flag, 0) appended to `graph` after `dep`
extern "C" int gl_add_set(void* graph, void* dep, unsigned long long handle,
                          const void* flag, void** node) {
  cudaGraphNode_t n = nullptr;
  const cudaError_t e = add_set(static_cast<cudaGraph_t>(graph),
                                static_cast<cudaGraphNode_t>(dep), handle,
                                flag, 0, &n);
  *node = n;
  return (int)e;
}

extern "C" int gl_instantiate(void* graph, void** exec) {
  cudaGraphExec_t x = nullptr;
  const cudaError_t e =
      cudaGraphInstantiate(&x, static_cast<cudaGraph_t>(graph), 0);
  *exec = x;
  return (int)e;
}

extern "C" int gl_launch(void* exec, void* stream) {
  return (int)cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                              static_cast<cudaStream_t>(stream));
}

extern "C" int gl_exec_destroy(void* exec) {
  return (int)cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
}

// runs of set_cond since the last reset (reads device memory: syncs)
extern "C" int gl_set_runs(unsigned long long* runs, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(runs, g_set_runs, sizeof(*runs));
  if (e != cudaSuccess || !reset) return (int)e;
  const unsigned long long zero = 0;
  return (int)cudaMemcpyToSymbol(g_set_runs, &zero, sizeof(zero));
}

// span_stamp on `stream` (recorded while the stream is captured); counts
// holds ncounts device addresses of int32s (at most kCounts)
extern "C" int gl_stamp(void* ring, int cap, int points, int row,
                        const void* r, int col, const void* flag,
                        void* const* counts, int ncounts, void* stream) {
  if (ncounts < 0 || ncounts > kCounts || cap < 1 || col < 0 ||
      col >= points)
    return (int)cudaErrorInvalidValue;
  Counts c = {};
  for (int i = 0; i < ncounts; ++i)
    c.p[i] = static_cast<const int*>(counts[i]);
  span_stamp<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(ring), cap, points, row,
      static_cast<const int*>(r), col, static_cast<const int*>(flag), c);
  return (int)cudaGetLastError();
}
