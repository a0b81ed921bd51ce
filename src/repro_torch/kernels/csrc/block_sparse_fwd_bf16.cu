// bf16 entry point of the block-sparse forward (see block_sparse_fwd.cuh).
#include "block_sparse_fwd.cuh"

SPION_DEFINE_FWD_ENTRY(spion_block_sparse_fwd_bf16, __nv_bfloat16)
