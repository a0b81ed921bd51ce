// The bf16 block-sparse dQ backward (block_sparse_dq_sm90.cuh) with the
// ring depth read at launch, key tiles of 64: the launches of a config
// whose depth is not the default (block_sparse_dq_bf16.cu fixes that one).
#include "block_sparse_dq_sm90.cuh"

namespace spion {

int launch_dq_sm90_bn64_anydepth(const BwdParams& p, int hd,
                                 cudaStream_t stream) {
  SPION_DQ_SM90_HD_SWITCH(64, 0, hd, p, stream)
}

}  // namespace spion
