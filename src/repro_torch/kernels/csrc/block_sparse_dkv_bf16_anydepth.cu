// The bf16 block-sparse dK/dV backward (block_sparse_dkv_sm90.cuh) with the
// ring depth read at launch, one warpgroup of keys: the launches of a
// config whose depth is not the default (block_sparse_dkv_bf16.cu fixes
// that one).
#include "block_sparse_dkv_sm90.cuh"

namespace spion {

int launch_dkv_sm90_wg1_anydepth(const BwdParams& p, int hd,
                                 cudaStream_t stream) {
  SPION_DKV_SM90_HD_SWITCH(1, 0, hd, p, stream)
}

}  // namespace spion
