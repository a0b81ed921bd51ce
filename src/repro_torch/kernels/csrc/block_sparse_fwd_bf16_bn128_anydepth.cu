// The bf16 block-sparse forward with the ring depth read at launch, key
// tiles of 128 (see block_sparse_fwd_bf16_anydepth.cu).
#include "block_sparse_fwd_sm90.cuh"

namespace spion {

int launch_fwd_sm90_bn128_anydepth(const Sm90FwdParams& p, int hd,
                                   const CUtensorMap& map_k,
                                   const CUtensorMap& map_v,
                                   cudaStream_t stream) {
  SPION_SM90_HD_SWITCH(128, 0, hd, p, map_k, map_v, stream)
}

}  // namespace spion
