// Error text for the error codes the other entry points return.
#include <cuda_runtime.h>

#include "errors.cuh"

extern "C" const char* dss_error_string(int err) {
  if (err == DSS_ERR_TENSOR_MAP)
    return "cuTensorMapEncodeTiled is missing or refused a q/k/v/do layout";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
