// fp32 entry point of the block-sparse dK/dV backward (see block_sparse_dkv.cuh).
#include "block_sparse_dkv.cuh"

SPION_DEFINE_BWD_ENTRY(spion_block_sparse_dkv_f32, float, spion::launch_dkv)
