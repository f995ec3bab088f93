// The lockstep solver's loop on the device: a CUDA graph whose conditional
// WHILE node runs a solve's step, captured into its body, until the loop's
// condition fails, and the kernel that evaluates that condition, written by hand for
// Hopper (sm_90a).
//
// Replaces: no TPU kernel. The JAX package runs its solver's loop as
// lax.while_loop (gpmpc_tpu/mpc/solver.py), which XLA compiles into one
// device program whose condition, t < max_iters and any lane not done, is
// read on the device. The port's host loop (mpc/solver.py `_go_on`) reads
// all(done) on the host once an iteration; this graph is its counterpart:
// one launch runs the whole loop and reads nothing back.
//
// The graph (CUDA 12.4 or later: conditional nodes, a capture into their
// body):
//
//   cond kernel -> WHILE(handle) { the step's nodes -> cond kernel }
//
// The step is captured straight into the WHILE node's body graph: the
// caller's stream captures into it between gpmpc_loop_begin and
// gpmpc_loop_end (loop_cond.py routes the capture's allocations into the
// solve's memory pool, as a PyTorch capture does).
//
// The cond kernel sets the node's handle to (t < max_iters and some lane
// not done), from the solve's own t (int64 scalar) and done (B bools) on the
// device. It runs once before the node, so a solve whose lanes are all done
// after its init runs no iteration, and again at the end of each pass.
//
// Bound on an H100: neither bytes nor operations. A launch reads B + 8
// bytes and does B comparisons; what it costs is its launch, about the
// latency of one kernel node. The kernel is one block that strides over the
// lanes and reduces with __syncthreads_or.
//
// The same kernel, given an `out` pointer, writes the condition there
// instead of setting a handle: the plain launch that the checks hold
// against the torch expression of the predicate (loop_cond.py).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    loop_cond_kernel(cudaGraphConditionalHandle handle, const int64_t* t,
                     const bool* done, int b, int64_t max_iters, int* out) {
  int live = 0;
  for (int i = threadIdx.x; i < b; i += kThreads) live |= !done[i];
  live = __syncthreads_or(live);
  if (threadIdx.x != 0) return;
  const unsigned int go = (*t < max_iters && live) ? 1u : 0u;
  if (out != nullptr) {
    *out = static_cast<int>(go);
  } else {
    cudaGraphSetConditional(handle, go);
  }
}

cudaError_t add_cond_node(cudaGraphNode_t* node, cudaGraph_t graph,
                          const cudaGraphNode_t* deps, size_t n_deps,
                          cudaGraphConditionalHandle handle, const int64_t* t,
                          const bool* done, int b, int64_t max_iters) {
  int* out = nullptr;
  void* args[] = {&handle, &t, &done, &b, &max_iters, &out};
  cudaKernelNodeParams p = {};
  p.func = reinterpret_cast<void*>(loop_cond_kernel);
  p.gridDim = dim3(1);
  p.blockDim = dim3(kThreads);
  p.sharedMemBytes = 0;
  p.kernelParams = args;
  p.extra = nullptr;
  return cudaGraphAddKernelNode(node, graph, deps, n_deps, &p);
}

}  // namespace

#define GPMPC_TRY(call)                  \
  do {                                   \
    const cudaError_t err_ = (call);     \
    if (err_ != cudaSuccess) return err_; \
  } while (0)

// The loop graph's frame: the first condition node and the WHILE node,
// whose body graph `stream` then captures into (cudaStreamBeginCaptureToGraph)
// until gpmpc_loop_end. The step is recorded straight into the body: the
// loop graph holds the only copy of it. *graph_out and *handle_out are set
// on success; on failure nothing is left.
extern "C" int gpmpc_loop_begin(const int64_t* t, const bool* done, int b,
                                long long max_iters, void* stream,
                                void** graph_out,
                                unsigned long long* handle_out) {
  cudaGraph_t graph = nullptr;
  cudaError_t err = cudaGraphCreate(&graph, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphConditionalHandle handle;
  auto build = [&]() -> cudaError_t {
    GPMPC_TRY(cudaGraphConditionalHandleCreate(&handle, graph, 0, 0));
    cudaGraphNode_t first;
    GPMPC_TRY(add_cond_node(&first, graph, nullptr, 0, handle, t, done, b,
                            max_iters));
    cudaGraphNodeParams cp = {};
    cp.type = cudaGraphNodeTypeConditional;
    cp.conditional.handle = handle;
    cp.conditional.type = cudaGraphCondTypeWhile;
    cp.conditional.size = 1;
    cudaGraphNode_t loop;
#if CUDART_VERSION >= 13000
    GPMPC_TRY(cudaGraphAddNode(&loop, graph, &first, nullptr, 1, &cp));
#else
    GPMPC_TRY(cudaGraphAddNode(&loop, graph, &first, 1, &cp));
#endif
    return cudaStreamBeginCaptureToGraph(
        static_cast<cudaStream_t>(stream), cp.conditional.phGraph_out[0],
        nullptr, nullptr, 0, cudaStreamCaptureModeGlobal);
  };
  err = build();
  if (err != cudaSuccess) {
    cudaGraphDestroy(graph);
    return static_cast<int>(err);
  }
  *graph_out = graph;
  *handle_out = static_cast<unsigned long long>(handle);
  return 0;
}

// Ends the body's capture, appends the condition node after what it
// captured, and instantiates the loop graph into *exec_out. *body_out is the
// body graph (owned by the loop graph). On failure the caller destroys the
// graph (gpmpc_loop_destroy with a null exec).
extern "C" int gpmpc_loop_end(void* stream, void* graph,
                              unsigned long long handle, const int64_t* t,
                              const bool* done, int b, long long max_iters,
                              void** body_out, void** exec_out) {
  const auto s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
#if CUDART_VERSION >= 13000
  GPMPC_TRY(cudaStreamGetCaptureInfo(s, &status, nullptr, nullptr, &deps,
                                     nullptr, &n_deps));
#else
  GPMPC_TRY(cudaStreamGetCaptureInfo(s, &status, nullptr, nullptr, &deps,
                                     &n_deps));
#endif
  // The capture's open ends, copied: the pointer lives until the next call
  // on the stream.
  cudaGraphNode_t* tails = new cudaGraphNode_t[n_deps + 1];
  for (size_t i = 0; i < n_deps; ++i) tails[i] = deps[i];
  cudaGraph_t body = nullptr;
  cudaError_t err = cudaStreamEndCapture(s, &body);
  if (err == cudaSuccess) {
    cudaGraphNode_t again;
    err = add_cond_node(&again, body, tails, n_deps,
                        static_cast<cudaGraphConditionalHandle>(handle), t,
                        done, b, max_iters);
  }
  delete[] tails;
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphExec_t exec;
  GPMPC_TRY(cudaGraphInstantiate(&exec, static_cast<cudaGraph_t>(graph), 0));
  *body_out = body;
  *exec_out = exec;
  return 0;
}

// Ends a capture that failed on the host (its graph is dropped).
extern "C" int gpmpc_loop_abort(void* stream) {
  cudaGraph_t body = nullptr;
  return static_cast<int>(
      cudaStreamEndCapture(static_cast<cudaStream_t>(stream), &body));
}

extern "C" int gpmpc_loop_launch(void* exec, void* stream) {
  return static_cast<int>(cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                                          static_cast<cudaStream_t>(stream)));
}

extern "C" int gpmpc_loop_destroy(void* graph, void* exec) {
  const cudaError_t err =
      exec == nullptr
          ? cudaSuccess
          : cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
  const cudaError_t err2 = cudaGraphDestroy(static_cast<cudaGraph_t>(graph));
  return static_cast<int>(err != cudaSuccess ? err : err2);
}

// The condition written to *out (an int on the device): the kernel's plain
// launch.
extern "C" int gpmpc_loop_cond(const int64_t* t, const bool* done, int b,
                               long long max_iters, int* out, void* stream) {
  cudaGraphConditionalHandle none = 0;
  loop_cond_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      none, t, done, b, max_iters, out);
  return static_cast<int>(cudaGetLastError());
}

// The CUDA runtime this library was built with and the CUDA driver's version
// (each as 1000 * major + 10 * minor).
extern "C" int gpmpc_loop_versions(int* runtime, int* driver) {
  *runtime = CUDART_VERSION;
  return static_cast<int>(cudaDriverGetVersion(driver));
}

extern "C" const char* gpmpc_loop_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
