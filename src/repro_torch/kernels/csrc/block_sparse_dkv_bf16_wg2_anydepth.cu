// The bf16 block-sparse dK/dV backward with the ring depth read at launch,
// two warpgroups of keys (see block_sparse_dkv_bf16_anydepth.cu).
#include "block_sparse_dkv_sm90.cuh"

namespace spion {

int launch_dkv_sm90_wg2_anydepth(const BwdParams& p, int hd,
                                 cudaStream_t stream) {
  SPION_DKV_SM90_HD_SWITCH(2, 0, hd, p, stream)
}

}  // namespace spion
