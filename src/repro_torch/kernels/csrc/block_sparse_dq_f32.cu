// fp32 entry point of the block-sparse dQ backward (see block_sparse_dq.cuh).
#include "block_sparse_dq.cuh"

SPION_DEFINE_BWD_ENTRY(spion_block_sparse_dq_f32, float, spion::launch_dq)
