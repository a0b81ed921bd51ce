// Key tiles of 128 (blocks 80 to 128) of the bf16 block-sparse dQ backward
// (see block_sparse_dq_sm90.cuh and block_sparse_dq_bf16.cu).
#include "block_sparse_dq_sm90.cuh"

namespace spion {

int launch_dq_sm90_bn128(const BwdParams& p, int hd, cudaStream_t stream) {
  SPION_DQ_SM90_HD_SWITCH(128, hd, p, stream)
}

}  // namespace spion
