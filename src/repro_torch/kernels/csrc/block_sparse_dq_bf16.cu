// bf16 entry point of the block-sparse dQ backward (see block_sparse_dq.cuh).
#include "block_sparse_dq.cuh"

SPION_DEFINE_BWD_ENTRY(spion_block_sparse_dq_bf16, __nv_bfloat16, spion::launch_dq)
