// bf16 entry point of the block-sparse dK/dV backward: the Hopper kernel of
// block_sparse_dkv_sm90.cuh (wgmma + TMA), at the default ring depth with
// one warpgroup of keys (block <= 64) built here and two in
// block_sparse_dkv_bf16_wg2.cu, at any other depth in the _anydepth files.
#include "block_sparse_dkv_sm90.cuh"

namespace spion {

int launch_dkv_sm90_wg1(const BwdParams& p, int hd, cudaStream_t stream) {
  SPION_DKV_SM90_HD_SWITCH(1, kDefaultDepth, hd, p, stream)
}

}  // namespace spion

SPION_DEFINE_BWD_ENTRY(spion_block_sparse_dkv_bf16, __nv_bfloat16,
                       spion::launch_dkv_sm90)
