// The bf16 block-sparse dQ backward with the ring depth read at launch,
// key tiles of 128 (see block_sparse_dq_bf16_anydepth.cu).
#include "block_sparse_dq_sm90.cuh"

namespace spion {

int launch_dq_sm90_bn128_anydepth(const BwdParams& p, int hd,
                                  cudaStream_t stream) {
  SPION_DQ_SM90_HD_SWITCH(128, 0, hd, p, stream)
}

}  // namespace spion
