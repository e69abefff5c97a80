// graph_cond: an IF node inside a CUDA graph capture.
//
// The SMSCC update step runs on the card as one captured CUDA graph
// (core/step_graph.py), as the JAX package runs it as one compiled program
// (src/repro/core/dynamic.py:373-400).  Inside that program the repair
// gate is a lax.cond (dynamic.py:302-319) and the repair tier a nested
// lax.cond / lax.switch (dynamic.py:230-297): the branch is chosen on the
// device from a device value.  A CUDA graph does the same with a
// conditional node (CUDA 12.4 and later): its body graph runs on a replay
// only where a handle, set by a kernel earlier in the same replay, is
// nonzero.  PyTorch's CUDAGraph offers no way to add one in the versions
// the port runs on, so this file does it with the runtime's own calls.
//
// graph_if_begin, on a stream that is capturing: creates a conditional
// handle in the graph being captured, captures a one-thread kernel that
// sets the handle from a device bool, adds an IF node after the stream's
// current dependencies, makes that node the stream's only dependency, and
// starts capturing ``body`` (another stream) into the node's body graph.
// graph_if_end ends the body's capture.  graph_stream_create makes a
// stream that is the caller's alone: a capture's streams must not be
// PyTorch's pooled ones, which other code may be handed too (a pooled
// stream capturing into a body could then be asked to capture again).
// Work captured on ``body`` between
// the two runs on a replay only where the bool was true when the set
// kernel ran; work captured on the outer stream after graph_if_begin runs
// after the node.  Nothing here allocates: the body's buffers come from
// the caller's allocator, routed into the graph's own pool.
//
// Bound: the set kernel reads one byte; a conditional node costs the
// graph's launch a few microseconds at most.  It replaces no TPU kernel.
#include <cuda_runtime.h>

namespace {

__global__ void set_if(cudaGraphConditionalHandle handle,
                       const unsigned char* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

}  // namespace

// Returns the first CUDA error, or 0.
extern "C" int graph_if_begin(void* stream, const void* pred, void* body) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph,
                                             &deps, &n_deps);
  if (err != cudaSuccess) return (int)err;
  if (status != cudaStreamCaptureStatusActive)
    return (int)cudaErrorStreamCaptureImplicit;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return (int)err;
  set_if<<<1, 1, 0, s>>>(handle, static_cast<const unsigned char*>(pred));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps,
                                 &n_deps);
  if (err != cudaSuccess) return (int)err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamUpdateCaptureDependencies(
      s, &node, 1, cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(body), params.conditional.phGraph_out[0],
      nullptr, nullptr, 0, cudaStreamCaptureModeThreadLocal);
}

extern "C" int graph_if_end(void* body) {
  cudaGraph_t graph;
  return (int)cudaStreamEndCapture(static_cast<cudaStream_t>(body), &graph);
}

extern "C" int graph_stream_create(void** stream) {
  return (int)cudaStreamCreateWithFlags(
      reinterpret_cast<cudaStream_t*>(stream), cudaStreamNonBlocking);
}
