// bf16 entry point of the block-sparse forward: the Hopper kernel of
// block_sparse_fwd_sm90.cuh (wgmma + TMA), at the default ring depth with
// key tiles of 64 built here and of 128 in block_sparse_fwd_bf16_bn128.cu,
// at any other depth in the _anydepth files.
#include "block_sparse_fwd_sm90.cuh"

namespace spion {

int launch_fwd_sm90_bn64(const Sm90FwdParams& p, int hd,
                         const CUtensorMap& map_k, const CUtensorMap& map_v,
                         cudaStream_t stream) {
  SPION_SM90_HD_SWITCH(64, kDefaultDepth, hd, p, map_k, map_v, stream)
}

}  // namespace spion

extern "C" int spion_block_sparse_fwd_bf16(
    const void* q, const void* k, const void* v, const void* col_idx,
    const void* nvalid, void* o, void* lse, int N, int G, int S, int Sk,
    int hd, int nrb, int K, int block, int causal, int sliding_window,
    int seq_len, int row0, int col0, int depth, int nwg, float scale,
    void* stream) {
  if (block < 16 || block > 128 || block % 16 != 0 || K < 0 || depth < 1 ||
      depth > spion::kMaxDepth || nwg < 0 || nwg > 2)
    return (int)cudaErrorInvalidValue;
  if (nrb == 0 || G == 0 || N == 0) return (int)cudaSuccess;
  (void)cudaGetLastError();  // report only what this launch raises
  spion::Sm90FwdParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.col_idx = static_cast<const int*>(col_idx);
  p.nvalid = static_cast<const int*>(nvalid);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.N = N;
  p.G = G;
  p.S = S;
  p.Sk = Sk;
  p.nrb = nrb;
  p.K = K;
  p.block = block;
  p.causal = causal;
  p.sliding_window = sliding_window;
  p.seq_len = seq_len;
  p.row0 = row0;
  p.col0 = col0;
  p.scale = scale;
  p.nwg = nwg ? nwg : spion::sm90_warpgroups(G, block);
  p.depth = depth;
  p.chunks = (G * block + 64 * p.nwg - 1) / (64 * p.nwg);
  const int bn = spion::sm90_key_tile(block);
  CUtensorMap map_k, map_v;
  const int panel = spion::sm90_panel_bytes(hd);
  int rc = spion::sm90::encode_rows(&map_k, k, (uint64_t)N * Sk, hd, bn, panel);
  if (rc) return rc;
  rc = spion::sm90::encode_rows(&map_v, v, (uint64_t)N * Sk, hd, bn, panel);
  if (rc) return rc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (depth == spion::kDefaultDepth)
    return bn == 64 ? spion::launch_fwd_sm90_bn64(p, hd, map_k, map_v, st)
                    : spion::launch_fwd_sm90_bn128(p, hd, map_k, map_v, st);
  return bn == 64
             ? spion::launch_fwd_sm90_bn64_anydepth(p, hd, map_k, map_v, st)
             : spion::launch_fwd_sm90_bn128_anydepth(p, hd, map_k, map_v, st);
}

// Dynamic shared memory of a launch of the bf16 kernel `kind` (0 forward,
// 1 dQ, 2 dK/dV) at head dim hd, plan block `block`, G query heads a kv
// head, ring depth `depth` (already clamped to the width), `nwg`
// warpgroups (0: the default rule; dK/dV's follow the block) and table
// width `width`: the bytes the launcher asks for, or -1 for a bad kind.
extern "C" long long spion_sm90_smem_bytes(int kind, int hd, int block, int G,
                                           int depth, int nwg, int width) {
  const int bn = spion::sm90_key_tile(block);
  const int wg = nwg ? nwg : spion::sm90_warpgroups(G, block);
  switch (kind) {
    case 0: return (long long)spion::sm90_fwd_smem_bytes(hd, bn, wg, depth,
                                                         width);
    case 1: return (long long)spion::sm90_dq_smem_bytes(hd, bn, wg, depth,
                                                        width);
    case 2: return (long long)spion::sm90_dkv_smem_bytes(
        hd, spion::dkv_warpgroups(block), depth, width);
    default: return -1;
  }
}
