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
// On a mesh whose blocks several machines run (solver/device_loop.py's
// rounds driver), each machine's units are cut at their joins into
// segments, and each machine gets one graph that runs ONE segment per
// launch:
//
//   set_switch(h_s, *segment) -> SWITCH(h_s){case c: segment c}
//
// c3d_rounds enqueues the rounds from the host: in each, every machine's
// graph on its own stream, then each machine's copies of the other
// machines' posts into its own board, ordered by events between the
// streams (a copy waits for the segment that wrote its source; a machine's
// next segment waits until every other machine has copied from it). So the
// order between machines, on one card or several, is CUDA's own: no kernel
// waits on memory that another machine writes. A machine's switch kernel
// counts the rounds in which it ran a segment; every few rounds machine 0's
// code is copied to the host, and the host stops enqueuing once a copy that
// has landed reads "no segment" (it never waits for one).
//
// SWITCH nodes need CUDA 12.8; every unit graph must hold only kernel,
// memcpy and memset nodes on device memory (what PyTorch captures). Each C
// entry point returns a cudaError_t (0 = success).

#include <cuda_runtime.h>

// `ran` (may be null) counts the launches that selected a case
__global__ void set_switch_kernel(cudaGraphConditionalHandle handle, const long long* phase,
                                  long long n_cases, long long* ran) {
  const long long p = *phase;
  const bool run = p >= 0 && p < n_cases;
  if (run && ran) *ran += 1;
  cudaGraphSetConditional(handle, run ? static_cast<unsigned>(p) : static_cast<unsigned>(n_cases));
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
  long long* no_count = nullptr;
  void* switch_args[] = {&h_switch, &phase_p, &cases, &no_count};
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

// Builds one machine's segment graph of the rounds driver: `n_cases`
// segment codes, code c running seg_graphs[c] (cloned as a child graph);
// the segment the device int64 at `code` names runs, and any other value
// selects none; the device int64 at `ran` counts the launches that ran a
// segment. Built on the current device (the machine's card).
extern "C" int c3d_switch_build(int n_cases, void* const* seg_graphs, void* code, void* ran,
                                void** exec_out) {
  if (n_cases < 1 || !seg_graphs || !code || !ran || !exec_out)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGraph_t outer = nullptr;
  C3D_TRY(cudaGraphCreate(&outer, 0));
  const long long* code_p = static_cast<const long long*>(code);
  long long* ran_p = static_cast<long long*>(ran);
  long long cases = n_cases;
  cudaGraphConditionalHandle h_switch;
  C3D_TRY(cudaGraphConditionalHandleCreate(&h_switch, outer, 0, 0));
  void* switch_args[] = {&h_switch, &code_p, &cases, &ran_p};
  cudaGraphNode_t set;
  C3D_TRY(add_kernel(&set, outer, nullptr, 0, reinterpret_cast<void*>(set_switch_kernel),
                     switch_args));
  cudaGraphNode_t branch;
  cudaGraph_t* cases_body = nullptr;
  C3D_TRY(add_conditional(&branch, outer, &set, 1, h_switch, cudaGraphCondTypeSwitch,
                          static_cast<unsigned>(n_cases), &cases_body));
  for (int c = 0; c < n_cases; ++c) {
    if (!seg_graphs[c]) continue;
    cudaGraphNode_t child;
    C3D_TRY(cudaGraphAddChildGraphNode(&child, cases_body[c], nullptr, 0,
                                       static_cast<cudaGraph_t>(seg_graphs[c])));
  }
  cudaGraphExec_t exec = nullptr;
  C3D_TRY(cudaGraphInstantiate(&exec, outer, 0));
  cudaGraphDestroy(outer);
  *exec_out = static_cast<void*>(exec);
  return static_cast<int>(cudaSuccess);
}

// An event on card `device` that orders streams only (no timing).
extern "C" int c3d_event_create(int device, void** out) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaSetDevice(device);
  if (err == cudaSuccess) {
    cudaEvent_t ev;
    err = cudaEventCreateWithFlags(&ev, cudaEventDisableTiming);
    if (err == cudaSuccess) *out = static_cast<void*>(ev);
  }
  cudaSetDevice(prev);
  return static_cast<int>(err);
}

extern "C" int c3d_event_destroy(void* ev) {
  return static_cast<int>(cudaEventDestroy(static_cast<cudaEvent_t>(ev)));
}

// Lets card `device` reach card `peer`'s memory directly (an already
// enabled access is no error).
extern "C" int c3d_peer(int device, int peer) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaSetDevice(device);
  if (err == cudaSuccess) {
    err = cudaDeviceEnablePeerAccess(peer, 0);
    if (err == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();
      err = cudaSuccess;
    }
  }
  cudaSetDevice(prev);
  return static_cast<int>(err);
}

// Enqueues up to `n_rounds` rounds of `n_machines` machines, machine g on
// card devices[g] with its segment graph execs[g] and its stream
// streams[g]:
//
//   for each g: wait free[h] for h != g; launch execs[g]; record done[g]
//   for each g: wait done[h] for h != g; its copies; record free[g]
//
// copy k (copy_group[k] = g, enqueued on g's stream) moves copy_bytes[k]
// from copy_src[k] to copy_dst[k] (cudaMemcpyDefault: peer to peer where
// enabled, else through the host). After every `poll_every`-th round
// machine 0's stream copies the int64 at `poll_src` (its segment code) to
// the next of the `n_polls` pinned host slots at `poll_host` and records
// the next of `poll_events` (on card devices[0]); before each round the host
// looks at the copies that have landed (cudaEventQuery, no wait) and stops
// enqueuing once one reads a negative code (machine 0 runs no segment any
// more). Then, on machine 0's stream after every machine's last round, the
// `n_gather` copies (gather_bytes[k] from gather_src[k] to gather_dst[k],
// the machines' status for the host to read once). Writes the rounds
// enqueued to *enqueued. The host thread's current device is restored.
extern "C" int c3d_rounds(int n_rounds, int n_machines, const int* devices,
                          void* const* execs, void* const* streams, void* const* done,
                          void* const* free_, int n_copies, const int* copy_group,
                          void* const* copy_dst, void* const* copy_src,
                          const long long* copy_bytes, int poll_every, int n_polls,
                          const void* poll_src, void* poll_host, void* const* poll_events,
                          int n_gather, void* const* gather_dst, void* const* gather_src,
                          const long long* gather_bytes, int* enqueued) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const volatile long long* polled = static_cast<const volatile long long*>(poll_host);
  int posted = 0, seen = 0, r = 0;
  bool ended = false;
#define C3D_RTRY(expr)                   \
  do {                                   \
    err = (expr);                        \
    if (err != cudaSuccess) goto out;    \
  } while (0)
  for (; r < n_rounds && !ended; ++r) {
    for (int g = 0; g < n_machines; ++g) {
      cudaStream_t s = static_cast<cudaStream_t>(streams[g]);
      C3D_RTRY(cudaSetDevice(devices[g]));
      for (int h = 0; h < n_machines; ++h)
        if (h != g) C3D_RTRY(cudaStreamWaitEvent(s, static_cast<cudaEvent_t>(free_[h]), 0));
      C3D_RTRY(cudaGraphLaunch(static_cast<cudaGraphExec_t>(execs[g]), s));
      C3D_RTRY(cudaEventRecord(static_cast<cudaEvent_t>(done[g]), s));
    }
    for (int g = 0; g < n_machines; ++g) {
      cudaStream_t s = static_cast<cudaStream_t>(streams[g]);
      C3D_RTRY(cudaSetDevice(devices[g]));
      for (int h = 0; h < n_machines; ++h)
        if (h != g) C3D_RTRY(cudaStreamWaitEvent(s, static_cast<cudaEvent_t>(done[h]), 0));
      for (int k = 0; k < n_copies; ++k)
        if (copy_group[k] == g)
          C3D_RTRY(cudaMemcpyAsync(copy_dst[k], copy_src[k], static_cast<size_t>(copy_bytes[k]),
                                   cudaMemcpyDefault, s));
      C3D_RTRY(cudaEventRecord(static_cast<cudaEvent_t>(free_[g]), s));
    }
    if (poll_every > 0 && (r + 1) % poll_every == 0 && posted < n_polls) {
      cudaStream_t s0 = static_cast<cudaStream_t>(streams[0]);
      C3D_RTRY(cudaSetDevice(devices[0]));
      C3D_RTRY(cudaMemcpyAsync(const_cast<long long*>(polled) + posted, poll_src,
                               sizeof(long long), cudaMemcpyDefault, s0));
      C3D_RTRY(cudaEventRecord(static_cast<cudaEvent_t>(poll_events[posted]), s0));
      ++posted;
    }
    while (seen < posted) {
      const cudaError_t q = cudaEventQuery(static_cast<cudaEvent_t>(poll_events[seen]));
      if (q == cudaErrorNotReady) {
        cudaGetLastError();  // not an error: the copy has not landed yet
        break;
      }
      C3D_RTRY(q);
      if (polled[seen] < 0) {
        ended = true;
        break;
      }
      ++seen;
    }
  }
  {
    cudaStream_t s0 = static_cast<cudaStream_t>(streams[0]);
    C3D_RTRY(cudaSetDevice(devices[0]));
    for (int h = 1; h < n_machines; ++h)
      C3D_RTRY(cudaStreamWaitEvent(s0, static_cast<cudaEvent_t>(free_[h]), 0));
    for (int k = 0; k < n_gather; ++k)
      C3D_RTRY(cudaMemcpyAsync(gather_dst[k], gather_src[k], static_cast<size_t>(gather_bytes[k]),
                               cudaMemcpyDefault, s0));
  }
out:
  *enqueued = r;
#undef C3D_RTRY
  cudaSetDevice(prev);
  return static_cast<int>(err);
}
