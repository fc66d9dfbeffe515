// Error codes the C entry points return beside CUDA's own (cudaError_t).
#pragma once

// cuTensorMapEncodeTiled was not found or refused a tensor's layout.
#define DSS_ERR_TENSOR_MAP 10001
// The filter's plan (cluster, rows, shared bytes, CTAs, key window) does not
// fit the kernel's layout or the card's limits.
#define DSS_ERR_PLAN 10002
// The card holds no cluster of the plan's size at the plan's shared memory.
#define DSS_ERR_OCCUPANCY 10003
// A kernel was asked for a head dim it has no build of.
#define DSS_ERR_HEAD_DIM 10004
