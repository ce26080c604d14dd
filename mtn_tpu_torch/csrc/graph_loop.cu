// A decode batch's whole loop as one executable CUDA graph, bound to Python
// with ctypes: the counterpart of the lax.while_loop that JAX compiles into
// one program (mtn_tpu/decode/beam.py: beam_fn's early-stopped loop, and
// greedy_fn / sample_fn's).
//
// Replaces no TPU kernel: it is the loop around the kernels. The Python side
// (mtn_tpu_torch/ops/graph_loop.py) assembles one parent graph per program
// set of mtn_tpu_torch/decode/graphs.py out of PyTorch captures:
//
//     prefix (child graph)
//     -> loop_test(h, flag, l, maxlen - k)      sets h for the first pass
//     -> WHILE h { chunk of k steps (child graph)
//                  -> loop_test(h, flag, l, maxlen - k) }
//     -> loop_test(t, flag, l, maxlen - r)       [with a tail of r steps]
//     -> IF t { tail of r steps (child graph) }
//
// `flag` is the exit test that each chunk program leaves on the device (the
// beam loop's open test, or "some row has not emitted <eos>"), `l` the
// loop's 0-d int64 position, which every step advances. loop_test sets the
// conditional handle to `flag != 0 && l <= limit`: a chunk of n steps runs
// only while its first step's test holds and it does not step past
// maxlen - 1. Nothing reads the device from the host between the launch of
// the graph and the fetch of its outputs.
//
// Bound: one thread and two loads per test; a test costs a kernel node's
// launch inside the graph, a few microseconds, once per chunk.
//
// The child graphs are copied into the parent (cudaGraphAddChildGraphNode):
// the PyTorch captures they come from must stay alive, since their nodes
// read and write the captures' memory pool.

#include <cuda_runtime.h>

#include <cstring>

__global__ void loop_test(cudaGraphConditionalHandle handle, const void* flag,
                          int flag_bytes, const long long* l,
                          long long limit) {
  const long long f = flag_bytes == 1
                          ? static_cast<long long>(
                                *static_cast<const unsigned char*>(flag))
                          : *static_cast<const long long*>(flag);
  cudaGraphSetConditional(handle, (f != 0 && *l <= limit) ? 1u : 0u);
}

namespace {

// cudaGraphNodeParams is a union whose members have constructors, so its
// own default constructor is deleted: zeroed raw storage stands in for it.
struct NodeParams {
  alignas(cudaGraphNodeParams) unsigned char raw[sizeof(cudaGraphNodeParams)];
  NodeParams() { std::memset(raw, 0, sizeof(raw)); }
  cudaGraphNodeParams* operator->() {
    return reinterpret_cast<cudaGraphNodeParams*>(raw);
  }
  cudaGraphNodeParams* get() {
    return reinterpret_cast<cudaGraphNodeParams*>(raw);
  }
};

cudaError_t add_after(cudaGraphNode_t* out, cudaGraph_t graph, void* dep,
                      cudaGraphNodeParams* params) {
  cudaGraphNode_t d = static_cast<cudaGraphNode_t>(dep);
  return cudaGraphAddNode(out, graph, d ? &d : nullptr, d ? 1 : 0, params);
}

}  // namespace

extern "C" {

const char* mtn_gl_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int mtn_gl_create(void** graph) {
  cudaGraph_t g = nullptr;
  cudaError_t e = cudaGraphCreate(&g, 0);
  *graph = g;
  return e;
}

int mtn_gl_destroy(void* graph, void* exec) {
  cudaError_t e = cudaSuccess;
  if (exec) e = cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
  if (graph) {
    cudaError_t f = cudaGraphDestroy(static_cast<cudaGraph_t>(graph));
    if (e == cudaSuccess) e = f;
  }
  return e;
}

// A copy of `child` as a node of `graph` after `dep` (null: no dependency).
int mtn_gl_add_child(void* graph, void* dep, void* child, void** node) {
  cudaGraphNode_t d = static_cast<cudaGraphNode_t>(dep);
  cudaGraphNode_t n = nullptr;
  cudaError_t e = cudaGraphAddChildGraphNode(
      &n, static_cast<cudaGraph_t>(graph), d ? &d : nullptr, d ? 1 : 0,
      static_cast<cudaGraph_t>(child));
  *node = n;
  return e;
}

// A conditional handle of `graph` (the graph that holds its node), 0 at
// each launch until a test sets it.
int mtn_gl_handle(void* graph, unsigned long long* handle) {
  cudaGraphConditionalHandle h = 0;
  cudaError_t e = cudaGraphConditionalHandleCreate(
      &h, static_cast<cudaGraph_t>(graph), 0, cudaGraphCondAssignDefault);
  *handle = h;
  return e;
}

// A one-thread loop_test node of `graph` after `dep`.
int mtn_gl_add_test(void* graph, void* dep, unsigned long long handle,
                    void* flag, int flag_bytes, void* l, long long limit,
                    void** node) {
  cudaGraphConditionalHandle h = handle;
  const void* f = flag;
  const long long* pl = static_cast<const long long*>(l);
  void* args[] = {&h, &f, &flag_bytes, &pl, &limit};
  NodeParams p;
  p->type = cudaGraphNodeTypeKernel;
  p->kernel.func = reinterpret_cast<void*>(loop_test);
  p->kernel.gridDim = dim3(1);
  p->kernel.blockDim = dim3(1);
  p->kernel.sharedMemBytes = 0;
  p->kernel.kernelParams = args;
  cudaGraphNode_t n = nullptr;
  cudaError_t e =
      add_after(&n, static_cast<cudaGraph_t>(graph), dep, p.get());
  *node = n;
  return e;
}

// A WHILE (`is_while`) or IF node of `graph` after `dep` on `handle`; its
// body graph, empty, in `body`.
int mtn_gl_add_conditional(void* graph, void* dep, unsigned long long handle,
                           int is_while, void** node, void** body) {
  NodeParams p;
  p->type = cudaGraphNodeTypeConditional;
  p->conditional.handle = handle;
  p->conditional.type =
      is_while ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  p->conditional.size = 1;
  cudaGraphNode_t n = nullptr;
  cudaError_t e =
      add_after(&n, static_cast<cudaGraph_t>(graph), dep, p.get());
  *node = n;
  *body = e == cudaSuccess ? p->conditional.phGraph_out[0] : nullptr;
  return e;
}

// The executable graph of `graph`; on failure `result` holds the
// instantiation's cudaGraphInstantiateResult.
int mtn_gl_instantiate(void* graph, void** exec, int* result) {
  cudaGraphInstantiateParams p;
  std::memset(&p, 0, sizeof(p));
  cudaError_t e = cudaGraphInstantiateWithParams(
      reinterpret_cast<cudaGraphExec_t*>(exec),
      static_cast<cudaGraph_t>(graph), &p);
  *result = static_cast<int>(p.result_out);
  return e;
}

int mtn_gl_launch(void* exec, void* stream) {
  return cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                         static_cast<cudaStream_t>(stream));
}

}  // extern "C"
