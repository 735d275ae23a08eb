// Conditional (IF and WHILE) nodes for a CUDA graph being captured from
// a stream: the counterpart, on the card, of jax.lax.while_loop inside a
// jitted step (repas_tpu_torch/core/jit.py::while_loop): an IF node per
// trip, or one WHILE node for the whole loop. Not a port of a TPU
// kernel: PyTorch 2.11 has no Python API for conditional nodes, so the
// port records them through the CUDA runtime (12.4 or later, in the
// runtime and the driver).
//
// repas_if_begin, on a stream that is capturing into graph G:
//   1. creates a conditional handle of G;
//   2. records set_if, one thread that sets the handle from a device
//      bool (the loop condition, computed before it on the stream);
//   3. adds an IF node after set_if and makes the stream's later work
//      depend on it;
//   4. starts capturing a second stream into the node's body graph.
// The caller issues the body's work on that stream, then calls
// repas_if_end, which ends the body's capture. When G replays, the body
// runs only where the bool was true; nothing is read on the host.
//
// repas_while_begin does the same with a WHILE node and hands the
// conditional handle back; the caller issues one trip of the loop on the
// body stream, computes the condition again there, and calls
// repas_while_end, which records set_if on the body stream (the body's
// last node), ends the body's capture and counts its nodes. When G
// replays, the body runs again and again while the bool it last computed
// is true. repas_capture_nodes counts the nodes a capture has recorded.

#include <cuda_runtime.h>

namespace {

__global__ void set_if(cudaGraphConditionalHandle handle, const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

// Adds a conditional node of `type` after set_if(pred) to the graph that
// `stream` captures, and starts capturing `body_stream` into its body.
int begin_node(cudaGraphConditionalNodeType type, const void* pred,
               void* body_stream, int device, void* stream,
               cudaGraphConditionalHandle* handle_out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return (int)err;
  if (status != cudaStreamCaptureStatusActive)
    return (int)cudaErrorStreamCaptureImplicit;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return (int)err;
  set_if<<<1, 1, 0, s>>>(handle, (const bool*)pred);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // the node depends on set_if, the stream's last captured node
  err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return (int)err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = type;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1,
                                            cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return (int)err;
  *handle_out = handle;
  return (int)cudaStreamBeginCaptureToGraph(
      (cudaStream_t)body_stream, params.conditional.phGraph_out[0], nullptr,
      nullptr, 0, cudaStreamCaptureModeGlobal);
}

}  // namespace

extern "C" int repas_if_begin(const void* pred, void* body_stream, int device,
                              void* stream) {
  cudaGraphConditionalHandle handle;
  return begin_node(cudaGraphCondTypeIf, pred, body_stream, device, stream,
                    &handle);
}

extern "C" int repas_while_begin(const void* pred, void* body_stream,
                                 int device, void* stream,
                                 unsigned long long* handle_out) {
  cudaGraphConditionalHandle handle = 0;
  const int err = begin_node(cudaGraphCondTypeWhile, pred, body_stream,
                             device, stream, &handle);
  *handle_out = (unsigned long long)handle;
  return err;
}

extern "C" int repas_while_end(const void* pred, unsigned long long handle,
                               void* body_stream, int device,
                               unsigned long long* body_nodes) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  set_if<<<1, 1, 0, (cudaStream_t)body_stream>>>(
      (cudaGraphConditionalHandle)handle, (const bool*)pred);
  err = cudaGetLastError();
  cudaGraph_t body;
  const cudaError_t end = cudaStreamEndCapture((cudaStream_t)body_stream,
                                               &body);
  if (err != cudaSuccess) return (int)err;
  if (end != cudaSuccess) return (int)end;
  size_t n = 0;
  err = cudaGraphGetNodes(body, nullptr, &n);
  *body_nodes = n;
  return (int)err;
}

// The number of nodes, at the top level, of the graph that `stream` is
// capturing into.
extern "C" int repas_capture_nodes(void* stream, int device,
                                   unsigned long long* nodes) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  err = cudaStreamGetCaptureInfo((cudaStream_t)stream, &status, nullptr,
                                 &graph, nullptr, nullptr);
  if (err != cudaSuccess) return (int)err;
  if (status != cudaStreamCaptureStatusActive)
    return (int)cudaErrorStreamCaptureImplicit;
  size_t n = 0;
  err = cudaGraphGetNodes(graph, nullptr, &n);
  *nodes = n;
  return (int)err;
}

extern "C" int repas_if_end(void* body_stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaGraph_t body;
  return (int)cudaStreamEndCapture((cudaStream_t)body_stream, &body);
}
