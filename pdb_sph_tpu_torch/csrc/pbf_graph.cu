// Node counts of a CUDA graph: the source of a captured step's stage map.
//
// While a stream captures, the graph under construction can be inspected:
// cudaStreamGetCaptureInfo hands it out, and cudaGraphGetNodes /
// cudaGraphNodeGetType read it without adding a node. utils/timing.py calls
// this at each stage boundary of the capture (core/step.CapturedStep), so
// the stage map costs nothing at replay. Given a graph instead of a stream,
// it counts that graph's nodes (a finished capture kept by the caller).

#include <cuda_runtime.h>

#include <vector>

// counts[0..3] = kernel, memset, memcpy and other nodes of `graph`, or of
// the graph that `stream` is capturing when `graph` is null. Returns a
// cudaError_t; cudaErrorStreamCaptureImplicit if the stream is not
// capturing.
extern "C" int pbf_graph_node_counts(void* stream, void* graph,
                                     long long* counts) {
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  cudaError_t err = cudaSuccess;
  if (g == nullptr) {
    cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
    unsigned long long id = 0;
    err = cudaStreamGetCaptureInfo(static_cast<cudaStream_t>(stream),
                                   &status, &id, &g);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (status != cudaStreamCaptureStatusActive || g == nullptr)
      return static_cast<int>(cudaErrorStreamCaptureImplicit);
  }
  size_t count = 0;
  err = cudaGraphGetNodes(g, nullptr, &count);
  if (err != cudaSuccess) return static_cast<int>(err);
  std::vector<cudaGraphNode_t> nodes(count);
  if (count > 0) {
    err = cudaGraphGetNodes(g, nodes.data(), &count);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  for (int i = 0; i < 4; ++i) counts[i] = 0;
  for (size_t i = 0; i < count; ++i) {
    cudaGraphNodeType type;
    err = cudaGraphNodeGetType(nodes[i], &type);
    if (err != cudaSuccess) return static_cast<int>(err);
    switch (type) {
      case cudaGraphNodeTypeKernel:
        ++counts[0];
        break;
      case cudaGraphNodeTypeMemset:
        ++counts[1];
        break;
      case cudaGraphNodeTypeMemcpy:
        ++counts[2];
        break;
      default:
        ++counts[3];
    }
  }
  return static_cast<int>(cudaSuccess);
}
