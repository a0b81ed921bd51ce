// Key tiles of 128 (blocks 80 to 128) of the bf16 block-sparse forward
// (see block_sparse_fwd_sm90.cuh and block_sparse_fwd_bf16.cu).
#include "block_sparse_fwd_sm90.cuh"

namespace spion {

int launch_fwd_sm90_bn128(const Sm90FwdParams& p, int hd,
                          const CUtensorMap& map_k, const CUtensorMap& map_v,
                          cudaStream_t stream) {
  SPION_SM90_HD_SWITCH(128, hd, p, map_k, map_v, stream)
}

}  // namespace spion
