// Two warpgroups of keys (blocks 80 to 128) of the bf16 block-sparse dK/dV
// backward (see block_sparse_dkv_sm90.cuh and block_sparse_dkv_bf16.cu).
#include "block_sparse_dkv_sm90.cuh"

namespace spion {

int launch_dkv_sm90_wg2(const BwdParams& p, int hd, cudaStream_t stream) {
  SPION_DKV_SM90_HD_SWITCH(2, hd, p, stream)
}

}  // namespace spion
