// Block-sparse flash-attention backward, dQ, for bf16 on Hopper (sm_90a):
// tensor cores (wgmma) fed by asynchronous copies (TMA) through a ring of
// K/V tiles.
//
// Replaces the TPU kernel `_dq_kernel` of the JAX package
// (src/repro/kernels/block_sparse_attn.py, host function `_fused_dq`) for
// bf16 inputs; fp32 inputs keep the scalar kernel of block_sparse_dq.cuh (a
// parity path, with TF32 off). Same function: for query rows of row-block r
// of (kv-head n, query head g) it walks the K/V tiles listed in
// col_idx[r, :nvalid[r]] and accumulates, in fp32,
//   p  = exp(scale * q k^T - lse)      (0 where the tile mask is false)
//   dp = dO v^T,   ds = p * (dp - delta),   dq += scale * ds k,
// with lse the forward's log-sum-exp (Alg. 6 correction included, +inf on
// an empty row, so p = 0 there) and delta = rowsum(dO * O). dq is fp32; the
// caller casts it to q's type.
//
// Design (the forward's skeleton, block_sparse_fwd_sm90.cuh):
//   - Work. One program per (n, row block r, chunk): the G * block query
//     rows of (n, r), head-major (row i of head g at g * block + i), cut
//     into 64-row warpgroup tiles, NWG = 2 a program when G * block >= 128,
//     else one, unless the launch asks for 1 or 2 (p.nwg); below block 64
//     several heads share one K/V load. Rows past G * block are zero and
//     never stored.
//   - Order. Row blocks by rank in (nvalid descending, r ascending), from a
//     histogram of nvalid in shared memory.
//   - Loads. The K/V ring of the forward (p.depth stages of BN keys, 2 by
//     default, TMA into swizzled panels, a `full` mbarrier a stage, refilled
//     by the last warp done with it); Q and dO once by 16-byte cp.async into
//     the same layout; lse and delta of a thread's two rows in registers.
//     Entries i >= nvalid[r] and column ids outside [0, Sk / block) are
//     dropped before any load.
//   - Products, in rounds of 64 keys of a tile (two at BN 128): S = Q K^T
//     and dP = dO V^T by wgmma m64n64k16 from shared memory (exact products
//     of bf16 inputs); P and dS = P (dP - delta) scale in fp32 registers;
//     dQ += dS K by wgmma m64nHDk16, dS from registers in three bf16 terms
//     (24 bits, as the reference's fp32), K as the N-major B operand, in
//     rounds of 16 keys at hd <= 32 (fewer registers) and 64 above.
//   - Store. dq in fp32 from the accumulator layout, the live rows only; a
//     row block with nothing listed stores 0.
//
// Shared memory (sm90_dq_smem_bytes): the ring depth * 2 * BN * HD * 2
// bytes, Q and dO 2 * NWG * 64 * HD * 2, depth mbarriers, 2 width + 3 +
// depth ints and up to 1 KB to align; at depth 2: 13 KB at hd 16 / block
// 64, 193 KB at hd 128 / block 128 / NWG 2 (depth 3 there would need 257
// KB: the host refuses it). As in the forward, neither knob changes a
// result.
//
// Bound on the H100: 6 block^2 hd flop a listed tile (three products)
// against one K and one V tile, so at the training shape (block 64, hd 16,
// ~1.6 listed tiles a row block) the bytes of q, dO, dq and the tiles bound
// it; at the serving shape (block 128, hd 128) the operations would.
#pragma once

#include "block_sparse_common.cuh"
#include "block_sparse_sm90.cuh"

namespace spion {

// four programs of one warpgroup an SM at hd <= 32 (128 registers a
// thread), else one
template <int HD, int BN>
__host__ __device__ constexpr int dq_min_blocks() {
  return HD <= 32 && BN == 64 ? 2 : 1;
}

template <int HD, int BN, int kDepth>
__global__ void __launch_bounds__(256, (dq_min_blocks<HD, BN>()))
    block_sparse_dq_kernel_sm90(const __grid_constant__ CUtensorMap map_k,
                                const __grid_constant__ CUtensorMap map_v,
                                const BwdParams p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  constexpr int W = sm90_panel_bytes(HD);
  constexpr int kTile = 64 * HD * 2;          // bytes of a 64-row tile
  const int nwg = blockDim.x >> 7;
  const int depth = kDepth ? kDepth : p.depth;   // kDepth 0: any depth
  unsigned char* ring =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* q_s = ring + (size_t)depth * 2 * BN * HD * 2;
  unsigned char* do_s = q_s + (size_t)nwg * kTile;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(do_s + (size_t)nwg * kTile);
  int* done = reinterpret_cast<int*>(full + depth);       // warps done a stage
  int* tiles = done + depth;                               // width
  int* hist = tiles + p.width;                             // width + 1
  int* shared_int = hist + p.width + 1;                    // row block, tiles

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int block = p.block;
  const int rows_total = p.G * block;
  const int chunks = (rows_total + 64 * nwg - 1) / (64 * nwg);
  const int chunk = blockIdx.x % chunks;
  const int n = (blockIdx.x / chunks) % p.N;
  const int rank = blockIdx.x / chunks / p.N;

  if (tid == 0) {
    for (int s = 0; s < depth; ++s) {
      sm90::mbar_init(&full[s], 1);
      done[s] = 0;
    }
    sm90::mbar_fence_init();
  }
  const int r = row_block_by_rank(p.nidx, p.nrb, p.width, rank, hist,
                                  shared_int);
  // Q and dO of this program's tiles (zero past the row set), in flight
  // while warp 0 lists the tiles and thread 0 starts the first K/V loads
  const int first_row = chunk * nwg * 64;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q);
  const __nv_bfloat16* dout = static_cast<const __nv_bfloat16*>(p.dout);
  constexpr int kPieces = 64 * HD / 8;        // 16-byte pieces of a tile
  for (int idx = tid; idx < nwg * kPieces; idx += blockDim.x) {
    const int t = idx / kPieces;
    const int row = (idx - t * kPieces) / (HD / 8);
    const int c = idx % (HD / 8);
    const int flat = first_row + t * 64 + row;
    const bool valid = flat < rows_total;
    const int g = valid ? flat / block : 0;
    const int i = valid ? flat - g * block : 0;
    const size_t off =
        (((size_t)n * p.G + g) * p.S + (size_t)r * block + i) * HD + c * 8;
    const uint32_t dst = t * kTile + sm90::swizzled<W>(64, row, c);
    sm90::cp_async_16(q_s + dst, q + off, valid);
    sm90::cp_async_16(do_s + dst, dout + off, valid);
  }
  // the listed entries with an in-range column, in table order
  const int ncb = p.ncb;
  if (tid < 32) {
    const int nv = clamp_nvalid(p.nidx[r], p.width);
    int count = 0;
    for (int base = 0; base < nv; base += 32) {
      const int i = base + lane;
      const int c = i < nv ? p.idx[(size_t)r * p.width + i] : -1;
      const bool ok = c >= 0 && c < ncb;
      const unsigned m = __ballot_sync(0xffffffffu, ok);
      if (ok) tiles[count + __popc(m & ((1u << lane) - 1))] = c;
      count += __popc(m);
    }
    __syncwarp();
    if (lane == 0) {
      shared_int[1] = count;
      for (int i = 0; i < min(count, depth); ++i)
        issue_tile<HD, BN>(ring, full, &map_k, &map_v, i,
                           n * p.Sk + tiles[i] * block);
    }
  }
  // the two rows this thread holds in the accumulator layout
  bool live[2];
  int qpos[2];
  size_t orow[2];
  float lse[2], delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int flat = first_row + wg * 64 + warp * 16 + (lane >> 2) + 8 * h;
    live[h] = flat < rows_total;
    const int g = live[h] ? flat / block : 0;
    const int i = flat - g * block;
    qpos[h] = (r + p.row0) * block + i;
    orow[h] = ((size_t)n * p.G + g) * p.S + (size_t)r * block + i;
    lse[h] = live[h] ? p.lse[orow[h]] : 0.f;
    delta[h] = live[h] ? p.delta[orow[h]] : 0.f;
  }
  sm90::cp_async_wait_all();
  sm90::fence_proxy_async();
  __syncthreads();
  const int nt = shared_int[1];
  const int kq = (lane & 3) * 2;    // first key (or column) of a pair

  float dq[HD / 2];
#pragma unroll
  for (int x = 0; x < HD / 2; ++x) dq[x] = 0.f;
  const uint32_t q_addr = sm90::smem_u32(q_s + (size_t)wg * kTile);
  const uint32_t do_addr = sm90::smem_u32(do_s + (size_t)wg * kTile);
  constexpr int kRoundKeys = round_keys<HD>();
  constexpr int kSteps = kRoundKeys / 16;

  for (int i = 0; i < nt; ++i) {
    // the stage, and the use of it: the k-th use of a stage waits for the
    // phase of parity k & 1
    const int s = i % depth;
    const uint32_t parity = (i / depth) & 1;
    const int kcol0 = (tiles[i] + p.col0) * block;
    const uint32_t k_addr = sm90::smem_u32(ring + (size_t)2 * s * BN * HD * 2);
    const uint32_t v_addr = k_addr + BN * HD * 2;
    sm90::mbar_wait(&full[s], parity);

#pragma unroll 1
    for (int kr = 0; kr < BN / 64; ++kr) {
      // S = Q K^T and dP = dO V^T over keys 64 kr .. 64 kr + 63
      float sc[32], dp[32];
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        sc[x] = 0.f;
        dp[x] = 0.f;
      }
      sm90::wgmma_fence();
      sm90::fence_regs(sc);
      sm90::fence_regs(dp);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        sm90::wgmma_ss<64>(sc, sm90::desc_k_major<W>(q_addr, 64, kk),
                           sm90::desc_k_major<W>(k_addr + kr * 64 * W, BN,
                                                 kk),
                           kk > 0);
        sm90::wgmma_ss<64>(dp, sm90::desc_k_major<W>(do_addr, 64, kk),
                           sm90::desc_k_major<W>(v_addr + kr * 64 * W, BN,
                                                 kk),
                           kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_regs(sc);
      sm90::fence_regs(dp);

      // dS (scaled for dQ) into sc; masked positions, keys past the block
      // and rows past the row set give 0
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const int key = kr * 64 + 8 * j + kq + (e & 1);
          const bool ok = live[h] && key < block &&
                          tile_ok(qpos[h], kcol0 + key, p.causal,
                                  p.sliding_window);
          const float pr = ok ? expf(sc[4 * j + e] * p.scale - lse[h]) : 0.f;
          sc[4 * j + e] = pr * (dp[4 * j + e] - delta[h]) * p.scale;
        }

      // dQ += dS K, kRoundKeys keys at a time, dS in three bf16 terms
#pragma unroll
      for (int round = 0; round < 64 / kRoundKeys; ++round) {
        uint32_t sf[3][kSteps][4];
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk)
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int x = 8 * (kSteps * round + kk) + 2 * u;
            sm90::split3(sc[x], sc[x + 1], sf[0][kk][u], sf[1][kk][u],
                         sf[2][kk][u]);
          }
        sm90::wgmma_fence();
        sm90::fence_regs(dq);
#pragma unroll
        for (int part = 0; part < 3; ++part)
#pragma unroll
          for (int kk = 0; kk < kSteps; ++kk)
            sm90::wgmma_rs<HD>(
                dq, sf[part][kk],
                sm90::desc_mn_major<W>(k_addr, BN,
                                       kr * 4 + kSteps * round + kk));
        sm90::wgmma_commit();
        sm90::wgmma_wait_all();
        sm90::fence_regs(dq);
      }
    }

    // release the stage: the last warp done with it refills it with tile
    // i + depth, so that no warp waits for another
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();
      if (atomicAdd(&done[s], 1) == 4 * nwg - 1) {
        done[s] = 0;
        __threadfence_block();
        if (i + depth < nt)
          issue_tile<HD, BN>(ring, full, &map_k, &map_v, s,
                             n * p.Sk + tiles[i + depth] * block);
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!live[h]) continue;
    float* out = p.out0 + orow[h] * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<float2*>(out + 8 * j + kq) =
          make_float2(dq[4 * j + 2 * h], dq[4 * j + 2 * h + 1]);
  }
}

template <int HD, int BN, int kDepth>
int launch_dq_sm90_hd(const BwdParams& p, cudaStream_t stream) {
  constexpr int W = sm90_panel_bytes(HD);
  CUtensorMap map_k, map_v;
  const uint64_t keys = (uint64_t)p.N * p.Sk;
  int rc = sm90::encode_rows(&map_k, p.k, keys, HD, BN, W);
  if (!rc) rc = sm90::encode_rows(&map_v, p.v, keys, HD, BN, W);
  if (rc) return rc;
  const int nwg = p.nwg ? p.nwg : sm90_warpgroups(p.G, p.block);
  const int chunks = (p.G * p.block + 64 * nwg - 1) / (64 * nwg);
  const size_t smem = sm90_dq_smem_bytes(HD, BN, nwg, p.depth, p.width);
  if (smem > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  auto kernel = block_sparse_dq_kernel_sm90<HD, BN, kDepth>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)p.nrb * p.N * chunks;
  kernel<<<grid, 128 * nwg, smem, stream>>>(map_k, map_v, p);
  return (int)cudaGetLastError();
}

// One launcher per key-tile width and ring (the default depth fixed at
// compile time, or any depth: _anydepth), each in its own file so that the
// four sets of head dims compile in parallel.
int launch_dq_sm90_bn64(const BwdParams& p, int hd, cudaStream_t stream);
int launch_dq_sm90_bn128(const BwdParams& p, int hd, cudaStream_t stream);
int launch_dq_sm90_bn64_anydepth(const BwdParams& p, int hd,
                                 cudaStream_t stream);
int launch_dq_sm90_bn128_anydepth(const BwdParams& p, int hd,
                                  cudaStream_t stream);

// The bf16 entry point's launcher (SPION_DEFINE_BWD_ENTRY): key tiles of 64
// for block <= 64, 128 above.
template <typename T>
int launch_dq_sm90(const BwdParams& p, int hd, cudaStream_t stream) {
  if (p.block < 16 || p.block > 128 || p.block % 16 != 0 || p.width < 0 ||
      p.depth < 1 || p.depth > kMaxDepth || p.nwg < 0 || p.nwg > 2)
    return (int)cudaErrorInvalidValue;
  if (p.nrb == 0 || p.G == 0 || p.N == 0) return (int)cudaSuccess;
  (void)cudaGetLastError();  // report only what this launch raises
  const bool fixed = p.depth == kDefaultDepth;
  if (sm90_key_tile(p.block) == 64)
    return fixed ? launch_dq_sm90_bn64(p, hd, stream)
                 : launch_dq_sm90_bn64_anydepth(p, hd, stream);
  return fixed ? launch_dq_sm90_bn128(p, hd, stream)
               : launch_dq_sm90_bn128_anydepth(p, hd, stream);
}

}  // namespace spion

// Dispatch a runtime head dim to launch_dq_sm90_hd<HD, BN, DEPTH>.
#define SPION_DQ_SM90_HD_SWITCH(BN, DEPTH, hd, ...)                           \
  switch (hd) {                                                               \
    case 16: return launch_dq_sm90_hd<16, BN, DEPTH>(__VA_ARGS__);            \
    case 32: return launch_dq_sm90_hd<32, BN, DEPTH>(__VA_ARGS__);            \
    case 48: return launch_dq_sm90_hd<48, BN, DEPTH>(__VA_ARGS__);            \
    case 64: return launch_dq_sm90_hd<64, BN, DEPTH>(__VA_ARGS__);            \
    case 80: return launch_dq_sm90_hd<80, BN, DEPTH>(__VA_ARGS__);            \
    case 96: return launch_dq_sm90_hd<96, BN, DEPTH>(__VA_ARGS__);            \
    case 112: return launch_dq_sm90_hd<112, BN, DEPTH>(__VA_ARGS__);          \
    case 128: return launch_dq_sm90_hd<128, BN, DEPTH>(__VA_ARGS__);          \
    default: return (int)cudaErrorInvalidValue;                               \
  }
