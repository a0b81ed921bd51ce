// bf16 entry point of the block-sparse dQ backward: the Hopper kernel of
// block_sparse_dq_sm90.cuh (wgmma + TMA), at the default ring depth with key
// tiles of 64 built here and of 128 in block_sparse_dq_bf16_bn128.cu, at
// any other depth in the _anydepth files.
#include "block_sparse_dq_sm90.cuh"

namespace spion {

int launch_dq_sm90_bn64(const BwdParams& p, int hd, cudaStream_t stream) {
  SPION_DQ_SM90_HD_SWITCH(64, kDefaultDepth, hd, p, stream)
}

}  // namespace spion

SPION_DEFINE_BWD_ENTRY(spion_block_sparse_dq_bf16, __nv_bfloat16,
                       spion::launch_dq_sm90)
