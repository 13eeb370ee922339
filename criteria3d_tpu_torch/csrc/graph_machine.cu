// The device-resident loop of the water solver's state machine: one CUDA
// graph that runs the machine's units (solver/step.py, solver/device_loop.py)
// while a phase flag on the card selects them, with no host round trip.
//
// It takes the place of the nested lax.while_loops that the JAX package
// compiles into one program (criteria3d_tpu/solver/step.py:677 the period,
// :622 the step retries, :478 Picard, :222 CG, :133 per-sweep Jacobi,
// pallas_jacobi.py:250 the bundles). PyTorch captures each unit as a graph
// of its own; this file joins them:
//
//   outer graph:  reset(count) -> WHILE(h_w)
//   WHILE body:   set_switch(h_s, *phase) -> SWITCH(h_s){case c: unit c}
//                 -> set_while(h_w, *phase != done && ++count < limit)
//
// so one launch runs up to `limit` units, each the one the phase names when
// its turn comes, and returns when the phase reads `done`. A phase code
// with no unit (and `done` itself) selects an empty case. Each unit costs
// two one-thread kernels and the switch node besides its own work; they
// read 8 bytes and write a 4-byte handle, so launch latency, not bytes or
// operations, bounds them.
//
// SWITCH nodes need CUDA 12.8; every unit graph must hold only kernel,
// memcpy and memset nodes on device memory (what PyTorch captures). Each C
// entry point returns a cudaError_t (0 = success).

#include <cuda_runtime.h>

__global__ void set_switch_kernel(cudaGraphConditionalHandle handle, const long long* phase,
                                  long long n_cases) {
  const long long p = *phase;
  cudaGraphSetConditional(handle, (p >= 0 && p < n_cases) ? static_cast<unsigned>(p)
                                                          : static_cast<unsigned>(n_cases));
}

__global__ void set_while_kernel(cudaGraphConditionalHandle handle, const long long* phase,
                                 long long done, int* count, int limit) {
  const int n = *count + 1;
  *count = n;
  cudaGraphSetConditional(handle, (*phase != done && n < limit) ? 1u : 0u);
}

__global__ void reset_kernel(int* passes) { *passes = 0; }

namespace {

cudaError_t add_kernel(cudaGraphNode_t* node, cudaGraph_t graph, const cudaGraphNode_t* deps,
                       size_t n_deps, void* func, void** args) {
  cudaKernelNodeParams p = {};
  p.func = func;
  p.gridDim = dim3(1, 1, 1);
  p.blockDim = dim3(1, 1, 1);
  p.sharedMemBytes = 0;
  p.kernelParams = args;
  p.extra = nullptr;
  return cudaGraphAddKernelNode(node, graph, deps, n_deps, &p);
}

cudaError_t add_conditional(cudaGraphNode_t* node, cudaGraph_t graph, const cudaGraphNode_t* deps,
                            size_t n_deps, cudaGraphConditionalHandle handle,
                            cudaGraphConditionalNodeType type, unsigned size,
                            cudaGraph_t** bodies) {
  cudaGraphNodeParams p = {};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = handle;
  p.conditional.type = type;
  p.conditional.size = size;
  cudaError_t err = cudaGraphAddNode(node, graph, deps, n_deps, &p);
  if (err == cudaSuccess) *bodies = p.conditional.phGraph_out;
  return err;
}

}  // namespace

#define C3D_TRY(expr)                          \
  do {                                         \
    cudaError_t e_ = (expr);                   \
    if (e_ != cudaSuccess) {                   \
      if (outer) cudaGraphDestroy(outer);      \
      return static_cast<int>(e_);             \
    }                                          \
  } while (0)

// Builds and instantiates the machine graph: `n_cases` phase codes 0 ..
// n_cases - 1, code c running unit_graphs[c] (a cudaGraph_t, cloned as a
// child graph; NULL for a code with no unit). `count` is a device int the
// loop counts units in, `limit` the most units one launch runs. Writes the
// executable graph to *exec_out.
extern "C" int c3d_machine_build(int n_cases, void* const* unit_graphs, void* phase,
                                 long long done, void* count, int limit, void** exec_out) {
  if (n_cases < 1 || limit < 1 || !unit_graphs || !phase || !count || !exec_out)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGraph_t outer = nullptr;
  C3D_TRY(cudaGraphCreate(&outer, 0));
  int* count_i = static_cast<int*>(count);
  const long long* phase_p = static_cast<const long long*>(phase);
  long long cases = n_cases;

  cudaGraphNode_t reset;
  void* reset_args[] = {&count_i};
  C3D_TRY(add_kernel(&reset, outer, nullptr, 0, reinterpret_cast<void*>(reset_kernel),
                     reset_args));

  // the loop runs its body once per launch before it tests
  cudaGraphConditionalHandle h_while;
  C3D_TRY(cudaGraphConditionalHandleCreate(&h_while, outer, 1, cudaGraphCondAssignDefault));
  cudaGraphNode_t loop;
  cudaGraph_t* loop_body = nullptr;
  C3D_TRY(add_conditional(&loop, outer, &reset, 1, h_while, cudaGraphCondTypeWhile, 1,
                          &loop_body));
  cudaGraph_t body = loop_body[0];

  cudaGraphConditionalHandle h_switch;
  C3D_TRY(cudaGraphConditionalHandleCreate(&h_switch, body, 0, 0));
  void* switch_args[] = {&h_switch, &phase_p, &cases};
  cudaGraphNode_t set;
  C3D_TRY(add_kernel(&set, body, nullptr, 0, reinterpret_cast<void*>(set_switch_kernel),
                     switch_args));
  cudaGraphNode_t branch;
  cudaGraph_t* cases_body = nullptr;
  C3D_TRY(add_conditional(&branch, body, &set, 1, h_switch, cudaGraphCondTypeSwitch,
                          static_cast<unsigned>(n_cases), &cases_body));
  for (int c = 0; c < n_cases; ++c) {
    if (!unit_graphs[c]) continue;
    cudaGraphNode_t child;
    C3D_TRY(cudaGraphAddChildGraphNode(&child, cases_body[c], nullptr, 0,
                                       static_cast<cudaGraph_t>(unit_graphs[c])));
  }
  void* while_args[] = {&h_while, &phase_p, &done, &count_i, &limit};
  cudaGraphNode_t tail;
  C3D_TRY(add_kernel(&tail, body, &branch, 1, reinterpret_cast<void*>(set_while_kernel),
                     while_args));

  cudaGraphExec_t exec = nullptr;
  C3D_TRY(cudaGraphInstantiate(&exec, outer, 0));
  cudaGraphDestroy(outer);
  *exec_out = static_cast<void*>(exec);
  return static_cast<int>(cudaSuccess);
}

// One launch of the machine on `stream` (PyTorch's current stream).
extern "C" int c3d_machine_launch(void* exec, void* stream) {
  return static_cast<int>(
      cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec), static_cast<cudaStream_t>(stream)));
}

extern "C" int c3d_machine_destroy(void* exec) {
  return static_cast<int>(cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec)));
}
