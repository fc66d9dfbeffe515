// Error text for the error codes the other entry points return.
#include <cuda_runtime.h>

#include "errors.cuh"

extern "C" const char* dss_error_string(int err) {
  if (err == DSS_ERR_TENSOR_MAP)
    return "cuTensorMapEncodeTiled is missing or refused a tensor layout";
  if (err == DSS_ERR_PLAN)
    return "the Chebyshev filter's plan does not fit the kernel's layout";
  if (err == DSS_ERR_OCCUPANCY)
    return "the card holds no thread-block cluster of the plan's size and shared memory";
  if (err == DSS_ERR_HEAD_DIM)
    return "the kernel has no build of this head dim";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
