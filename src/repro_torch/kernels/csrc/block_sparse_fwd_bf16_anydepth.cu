// The bf16 block-sparse forward (block_sparse_fwd_sm90.cuh) with the ring
// depth read at launch, key tiles of 64: the launches of a config whose
// depth is not the default (block_sparse_fwd_bf16.cu fixes that one).
#include "block_sparse_fwd_sm90.cuh"

namespace spion {

int launch_fwd_sm90_bn64_anydepth(const Sm90FwdParams& p, int hd,
                                  const CUtensorMap& map_k,
                                  const CUtensorMap& map_v,
                                  cudaStream_t stream) {
  SPION_SM90_HD_SWITCH(64, 0, hd, p, map_k, map_v, stream)
}

}  // namespace spion
