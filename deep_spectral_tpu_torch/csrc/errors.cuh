// Error codes the C entry points return beside CUDA's own (cudaError_t).
#pragma once

// cuTensorMapEncodeTiled was not found or refused a q/k/v/do layout.
#define DSS_ERR_TENSOR_MAP 10001
