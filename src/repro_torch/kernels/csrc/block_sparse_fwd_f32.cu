// fp32 entry point of the block-sparse forward (see block_sparse_fwd.cuh).
#include "block_sparse_fwd.cuh"

SPION_DEFINE_FWD_ENTRY(spion_block_sparse_fwd_f32, float)

extern "C" const char* spion_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
