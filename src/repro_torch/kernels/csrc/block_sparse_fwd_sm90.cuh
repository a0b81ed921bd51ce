// Block-sparse flash-attention forward for bf16 on Hopper (sm_90a): tensor
// cores (wgmma) fed by asynchronous copies (TMA) through a ring of tiles.
//
// Replaces the TPU kernel `_fwd_kernel` of the JAX package
// (src/repro/kernels/block_sparse_attn.py) for bf16 inputs; fp32 inputs
// keep the scalar kernel of block_sparse_fwd.cuh (a parity path, with TF32
// off). Same function: for kv-head n and row-block r, the K/V tiles listed in
// col_idx[r, :nvalid[r]] with an online softmax in fp32 and the Alg. 6
// zero-correction denom = l + max(rt - stored, 0) * exp(-m).
//
// Design:
//   - Work. The G * block query rows of one (n, r), head-major (row i of
//     head g at g * block + i), are cut into 64-row tiles, one per
//     warpgroup (128 threads); a program runs NWG = 2 consecutive tiles
//     when G * block >= 128, else one. The heads of a kv head read the same
//     K/V tiles, so below block 64 several heads share one tile and one
//     load; rows past G * block are zero and never stored. The last rows of
//     blocks 80, 96 and 112 sit in a tile with rows of the next head.
//   - Order. Program x takes the row block of rank x / (N * chunks) in
//     (nvalid descending, r ascending), found in every program from a
//     histogram of nvalid: the row blocks with the most tiles start first.
//   - Loads. A ring of kStages = 2 stages, each a K and a V tile of BN
//     rows (separate buffers), filled by TMA: one box per swizzled panel
//     (block_sparse_sm90.cuh: 128-byte rows at hd 64 and 128, 64 or 32 below),
//     the layout wgmma's descriptors read, completing a `full` mbarrier by
//     its transaction bytes. The last warp done with a stage (a shared
//     counter) refills it at once, so no warp waits for another. BN is 64
//     for block <= 64, else 128; keys past the block are masked (rows past
//     the tensor read as zero). Q comes once, by 16-byte cp.async into the
//     same swizzled layout, while warp 0 lists the tiles. Entries i >=
//     nvalid[r] and column ids outside [0, Sk / block) are dropped before
//     any load.
//   - Products. S = Q K^T by wgmma m64nBNk16 (both from shared memory); the
//     masks, the online softmax (in log2 units, one ex2 a score) and the
//     stored-position count in fp32 registers (a row lives on the 4 threads
//     of a quad; warps whose rows see the whole tile skip the per-key
//     test); then O += P V by wgmma m64nHDk16 with P from registers, in
//     rounds of 64 keys (16 at hd <= 32, where 80 registers a thread let 6
//     programs share an SM). P is split into three bf16 terms, p0 =
//     bf16(p), p1 = bf16(p - p0), p2 = bf16(p - p0 - p1), three products:
//     24 bits of p, as the reference's fp32 p @ v: with two terms (16 bits)
//     chip_smoke.py's sweep finds an element of o 1.22 times its 2-ulp +
//     1e-6 limit away, with one term 118 times (PERF.md). q k^T of
//     bf16 inputs is exact in its products.
//   - Zero-correction. `stored` is counted from the same tile masks
//     (tile_ok), per thread, and summed over the quad at the end, as is l.
//
// Shared memory: K/V ring 2 * 2 * BN * HD * 2 bytes, Q NWG * 64 * HD * 2,
// 2 mbarriers, 2K + 6 ints and up to 1 KB to align: 161 KB at hd 128 /
// block 128 / NWG 2 (one program an SM), 11 KB at hd 16 / block 64 / NWG 1.
//
// Bound on the H100 (989e12 bf16 flop/s, 3.35e12 B/s), on the function's
// work (4 block^2 hd flop a listed tile, not the split's extra products): at
// the serving shape (block 128, hd 128, G 7) a listed tile is 8.4 Mflop per
// 64 KB of K/V, so the tensor cores bound it; at the training shape (block
// 64, hd 16, G 1, ~1.6 listed tiles a row block) the bytes of q, o and the
// tiles do, and each program is short: 128 threads and 11 KB of shared
// memory let many of them wait on their loads at once.
//
// Semantics kept from the reference (as block_sparse_fwd.cuh):
//   - masked scores never enter m, l or acc; m starts at -1e30, so a row
//     with nothing stored ends with denom = +inf, o = 0 and lse = +inf;
//   - rt is row + 1 when causal (capped at the sliding window), else the
//     global seq_len; positions are global through (row0, col0);
//   - o = acc * (1 / denom) (denom 0 divides by 1), lse = m + log(denom).
#pragma once

#include "block_sparse_common.cuh"
#include "block_sparse_sm90.cuh"

namespace spion {

struct Sm90FwdParams {
  const __nv_bfloat16* q;   // (N, G, S, HD)
  const int* col_idx;       // (nrb, K)
  const int* nvalid;        // (nrb,)
  __nv_bfloat16* o;         // (N, G, S, HD)
  float* lse;               // (N, G, S)
  int N, G, S, Sk, nrb, K, block;
  int causal;
  int sliding_window;       // < 0: none
  int seq_len;              // global row total when not causal
  int row0, col0;           // global block of local row-block 0 / K block 0
  int nwg;                  // warpgroups (64-row tiles) a program
  int chunks;               // programs a (n, r)
  float scale;
};

template <int HD, int BN>
inline size_t sm90_fwd_smem_bytes(int nwg, int K) {
  return 1024 +   // the swizzled tiles start on a 1024-byte boundary
         (size_t)kStages * 2 * BN * HD * 2 + (size_t)nwg * 64 * HD * 2 +
         kStages * sizeof(uint64_t) +
         (size_t)(2 * K + 4 + kStages) * sizeof(int);
}

// Small head dims: P V in rounds of 16 keys (round_keys) and at most 80
// registers a thread, so that 6 programs of one warpgroup share an SM (a cap of 64
// spilled more and ran slower at the training shape); else
// rounds of 64 keys (the three terms of a round live in registers until its
// products complete) and all the registers wgmma's accumulators want.
template <int HD, int BN>
__host__ __device__ constexpr int min_blocks() {
  return HD <= 32 && BN == 64 ? 3 : 1;
}

template <int HD, int BN>
__global__ void __launch_bounds__(256, (min_blocks<HD, BN>()))
    block_sparse_fwd_kernel_sm90(const __grid_constant__ CUtensorMap map_k,
                                 const __grid_constant__ CUtensorMap map_v,
                                 const Sm90FwdParams p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  constexpr int W = sm90_panel_bytes(HD);
  unsigned char* ring =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* q_s = ring + (size_t)kStages * 2 * BN * HD * 2;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(q_s + (size_t)p.nwg * 64 * HD * 2);
  int* done = reinterpret_cast<int*>(full + kStages);     // warps done a stage
  int* tiles = done + kStages;                             // K
  int* hist = tiles + p.K;                                 // K + 1
  int* shared_int = hist + p.K + 1;                        // row block, tiles

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int chunk = blockIdx.x % p.chunks;
  const int n = (blockIdx.x / p.chunks) % p.N;
  const int rank = blockIdx.x / p.chunks / p.N;
  const int block = p.block;
  const int ncb = p.Sk / block;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      done[s] = 0;
    }
    sm90::mbar_fence_init();
  }
  const int r = row_block_by_rank(p.nvalid, p.nrb, p.K, rank, hist,
                                  shared_int);
  // Q of this program's tiles (zero past the row set), in flight while
  // warp 0 lists the tiles and thread 0 starts the first K/V loads
  const int rows_total = p.G * block;
  const int first_row = chunk * p.nwg * 64;
  constexpr int kPieces = 64 * HD / 8;          // 16-byte pieces of a tile
  for (int idx = tid; idx < p.nwg * kPieces; idx += blockDim.x) {
    const int t = idx / kPieces;
    const int row = (idx - t * kPieces) / (HD / 8);
    const int c = idx % (HD / 8);
    const int flat = first_row + t * 64 + row;
    const bool valid = flat < rows_total;
    const int g = valid ? flat / block : 0;
    const int i = valid ? flat - g * block : 0;
    sm90::cp_async_16(
        q_s + (size_t)t * 64 * HD * 2 + sm90::swizzled<W>(64, row, c),
        p.q + (((size_t)n * p.G + g) * p.S + (size_t)r * block + i) * HD +
            c * 8,
        valid);
  }
  // the listed entries with an in-range column, in table order
  if (tid < 32) {
    const int nv = clamp_nvalid(p.nvalid[r], p.K);
    int count = 0;
    for (int base = 0; base < nv; base += 32) {
      const int i = base + lane;
      const int c = i < nv ? p.col_idx[(size_t)r * p.K + i] : -1;
      const bool ok = c >= 0 && c < ncb;
      const unsigned m = __ballot_sync(0xffffffffu, ok);
      if (ok) tiles[count + __popc(m & ((1u << lane) - 1))] = c;
      count += __popc(m);
    }
    __syncwarp();
    if (lane == 0) {
      shared_int[1] = count;
      for (int i = 0; i < min(count, kStages); ++i)
        issue_tile<HD, BN>(ring, full, &map_k, &map_v, i,
                           n * p.Sk + tiles[i] * block);
    }
  }
  sm90::cp_async_wait_all();
  sm90::fence_proxy_async();
  __syncthreads();
  const int nt = shared_int[1];

  // the two rows this thread holds in the accumulator layout
  bool live[2];
  int qpos[2];
  size_t orow[2];
  float rt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int flat = first_row + wg * 64 + warp * 16 + (lane >> 2) + 8 * h;
    live[h] = flat < rows_total;
    const int g = live[h] ? flat / block : 0;
    const int i = flat - g * block;
    qpos[h] = (r + p.row0) * block + i;
    orow[h] = ((size_t)n * p.G + g) * p.S + (size_t)r * block + i;
    if (p.causal) {
      rt[h] = (float)(qpos[h] + 1);
      if (p.sliding_window >= 0) rt[h] = fminf(rt[h], (float)p.sliding_window);
    } else {
      rt[h] = (float)p.seq_len;
    }
  }
  const int kq = (lane & 3) * 2;    // first key (or column) of a pair

  float o_acc[HD / 2];
#pragma unroll
  for (int x = 0; x < HD / 2; ++x) o_acc[x] = 0.f;
  // m in log2 units; it starts at the reference's -1e30 all the same
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f}, cnt[2] = {0.f, 0.f};
  const float scale2 = p.scale * 1.4426950408889634f;   // log2 e
  const uint32_t q_addr = sm90::smem_u32(q_s + (size_t)wg * 64 * HD * 2);
  constexpr int kRoundKeys = round_keys<HD>();

  for (int i = 0; i < nt; ++i) {
    const int s = i % kStages;
    const uint32_t parity = (i / kStages) & 1;
    const int kcol0 = (tiles[i] + p.col0) * block;
    const uint32_t k_addr = sm90::smem_u32(ring + (size_t)2 * s * BN * HD * 2);
    const uint32_t v_addr = k_addr + BN * HD * 2;
    sm90::mbar_wait(&full[s], parity);

    float sc[BN / 2];
#pragma unroll
    for (int x = 0; x < BN / 2; ++x) sc[x] = 0.f;
    sm90::wgmma_fence();
    sm90::fence_regs(sc);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      sm90::wgmma_ss<BN>(sc, sm90::desc_k_major<W>(q_addr, 64, kk),
                         sm90::desc_k_major<W>(k_addr, BN, kk), kk > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(sc);

    // masks, row maxima and stored counts, scores in log2 units (s * scale
    // * log2 e, so that exp is one ex2). A warp whose rows see every key of
    // the tile (below the causal diagonal, inside the window) skips the
    // per-key test: all its keys are stored.
    bool whole[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      whole[h] = live[h] &&
                tile_ok(qpos[h], kcol0, p.causal, p.sliding_window) &&
                tile_ok(qpos[h], kcol0 + block - 1, p.causal,
                        p.sliding_window);
    float mx[2] = {-INFINITY, -INFINITY};
    if (block == BN && __all_sync(0xffffffffu, whole[0] && whole[1])) {
#pragma unroll
      for (int x = 0; x < BN / 2; ++x) {
        sc[x] *= scale2;
        mx[(x >> 1) & 1] = fmaxf(mx[(x >> 1) & 1], sc[x]);
      }
      cnt[0] += BN / 4;
      cnt[1] += BN / 4;
    } else {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const int key = 8 * j + kq + (e & 1);
          const bool ok = live[h] && key < block &&
                          tile_ok(qpos[h], kcol0 + key, p.causal,
                                  p.sliding_window);
          const float x = ok ? sc[4 * j + e] * scale2 : -INFINITY;
          sc[4 * j + e] = x;
          cnt[h] += ok ? 1.f : 0.f;
          mx[h] = fmaxf(mx[h], x);
        }
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      alpha[h] = exp2f(m[h] - m_new);
      m[h] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int x = 0; x < BN / 2; ++x) {
      sc[x] = exp2f(sc[x] - m[(x >> 1) & 1]);   // masked: 0
      sum[(x >> 1) & 1] += sc[x];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + sum[h];
    if (!__all_sync(0xffffffffu, alpha[0] == 1.f && alpha[1] == 1.f)) {
#pragma unroll
      for (int x = 0; x < HD / 2; ++x) o_acc[x] *= alpha[(x >> 1) & 1];
    }

    // O += P V, kRoundKeys keys at a time: p = p0 + p1 + p2, three bf16
    // terms in the A-operand layout (24 bits, as fp32 p), three products
#pragma unroll
    for (int round = 0; round < BN / kRoundKeys; ++round) {
      constexpr int kSteps = kRoundKeys / 16;
      uint32_t pf[3][kSteps][4];
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk)
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          float x0 = sc[8 * (kSteps * round + kk) + 2 * t];
          float x1 = sc[8 * (kSteps * round + kk) + 2 * t + 1];
#pragma unroll
          for (int part = 0; part < 3; ++part) {
            const uint32_t b = sm90::pack_bf16(x0, x1);
            pf[part][kk][t] = b;
            x0 -= sm90::bf16_lo(b);     // exact in fp32
            x1 -= sm90::bf16_hi(b);
          }
        }
      sm90::wgmma_fence();
      sm90::fence_regs(o_acc);
#pragma unroll
      for (int part = 0; part < 3; ++part)
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk)
          sm90::wgmma_rs<HD>(
              o_acc, pf[part][kk],
              sm90::desc_mn_major<W>(v_addr, BN, kSteps * round + kk));
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_regs(o_acc);
    }

    // release the stage: the last warp done with it refills it with tile
    // i + kStages, so that no warp waits for another
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();
      if (atomicAdd(&done[s], 1) == 4 * p.nwg - 1) {
        done[s] = 0;
        __threadfence_block();
        if (i + kStages < nt)
          issue_tile<HD, BN>(ring, full, &map_k, &map_v, s,
                             n * p.Sk + tiles[i + kStages] * block);
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    cnt[h] += __shfl_xor_sync(0xffffffffu, cnt[h], 1);
    cnt[h] += __shfl_xor_sync(0xffffffffu, cnt[h], 2);
    if (!live[h]) continue;
    const float denom = l[h] + fmaxf(rt[h] - cnt[h], 0.f) * exp2f(-m[h]);
    const float safe = denom == 0.f ? 1.f : denom;
    const float inv = 1.f / safe;
    __nv_bfloat16* orow_p = p.o + orow[h] * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow_p + 8 * j + kq) = sm90::pack_bf16(
          o_acc[4 * j + 2 * h] * inv, o_acc[4 * j + 2 * h + 1] * inv);
    if ((lane & 3) == 0)
      p.lse[orow[h]] =
          denom > 0.f ? m[h] * 0.6931471805599453f + logf(safe) : INFINITY;
  }
}

template <int HD, int BN>
int launch_hd_sm90(const Sm90FwdParams& p, const CUtensorMap& map_k,
                   const CUtensorMap& map_v, cudaStream_t stream) {
  const size_t smem = sm90_fwd_smem_bytes<HD, BN>(p.nwg, p.K);
  auto kernel = block_sparse_fwd_kernel_sm90<HD, BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)p.nrb * p.N * p.chunks;
  kernel<<<grid, 128 * p.nwg, smem, stream>>>(map_k, map_v, p);
  return (int)cudaGetLastError();
}

// One launcher per key-tile width, each in its own file so that the two
// sets of head dims compile in parallel.
int launch_fwd_sm90_bn64(const Sm90FwdParams& p, int hd,
                         const CUtensorMap& map_k, const CUtensorMap& map_v,
                         cudaStream_t stream);
int launch_fwd_sm90_bn128(const Sm90FwdParams& p, int hd,
                          const CUtensorMap& map_k, const CUtensorMap& map_v,
                          cudaStream_t stream);

}  // namespace spion

// Dispatch a runtime head dim to launch_hd_sm90<HD, BN>.
#define SPION_SM90_HD_SWITCH(BN, hd, ...)                                     \
  switch (hd) {                                                               \
    case 16: return launch_hd_sm90<16, BN>(__VA_ARGS__);                      \
    case 32: return launch_hd_sm90<32, BN>(__VA_ARGS__);                      \
    case 48: return launch_hd_sm90<48, BN>(__VA_ARGS__);                      \
    case 64: return launch_hd_sm90<64, BN>(__VA_ARGS__);                      \
    case 80: return launch_hd_sm90<80, BN>(__VA_ARGS__);                      \
    case 96: return launch_hd_sm90<96, BN>(__VA_ARGS__);                      \
    case 112: return launch_hd_sm90<112, BN>(__VA_ARGS__);                    \
    case 128: return launch_hd_sm90<128, BN>(__VA_ARGS__);                    \
    default: return (int)cudaErrorInvalidValue;                               \
  }
