// Block-sparse flash-attention backward, dK/dV, for bf16 on Hopper
// (sm_90a): tensor cores (wgmma) fed by asynchronous copies (TMA) through a
// ring of query tiles.
//
// Replaces the TPU kernel `_dkv_kernel` of the JAX package
// (src/repro/kernels/block_sparse_attn.py, host function `_fused_dkv`) for
// bf16 inputs; fp32 inputs keep the scalar kernel of block_sparse_dkv.cuh
// (a parity path, with TF32 off). Same function: for keys of column-block c
// of kv-head n it walks the transposed tables row_idx[c, :nvalid_t[c]] (the
// row blocks whose pattern lists c) and, over the G query heads that share
// the kv head, accumulates in fp32
//   p  = exp(scale * q k^T - lse)      (0 where the tile mask is false)
//   ds = p * (dO v^T - delta),   dv += p^T dO,   dk += scale * ds^T q.
// The order is the reference's: for each g in turn, a partial sum over the
// listed row blocks, then added into the running total (`dk_acc += dk`).
// No atomics, so the result does not depend on scheduling. dk and dv are
// fp32; the caller casts them.
//
// Design (the forward's of block_sparse_fwd_sm90.cuh with the roles of rows
// and keys swapped):
//   - Work. One program per (n, c). Its keys are wgmma's M dimension: one
//     warpgroup (128 threads) of 64 keys for block <= 64, two for block >
//     64, which share every query tile; keys past the block (block 16, 32,
//     48, 80, 96, 112) are computed, masked by nothing and never stored.
//   - Order. Program x takes kv head x % N and the column block of rank
//     x / N in (nvalid_t descending, c ascending), found from a histogram
//     of nvalid_t in shared memory: the columns listed by the most row
//     blocks (the trained plan's vertical stripe: 19 where the mean is 1.6)
//     start in the first wave instead of forming the tail.
//   - Loads. K and V of the column block come once, by TMA, into swizzled
//     panels (block_sparse_sm90.cuh). Then, for g = 0..G-1 and each listed
//     row block r (entries past nvalid_t and ids outside [0, nrb) dropped
//     before any load) in chunks of QN query rows: the Q and dO tiles (rows
//     of the (N G S, hd) matrices) by TMA, and the rows' lse and delta by
//     bulk copies, all completing one `full` mbarrier of a kStages = 2 ring;
//     the last warp done with a stage refills it. Rows past the tensor read
//     as zero (TMA) or are not copied (lse, delta); rows past the block are
//     masked.
//   - Products, fp32 accumulation throughout. S^T = K Q^T and dP^T = V dO^T
//     by wgmma m64nQNk16, both operands K-major from shared memory (exact
//     products of bf16 inputs); P^T and dS^T in registers (a key row lives
//     on the 4 threads of a quad, a query row is a column); then dV += P^T
//     dO and dK += dS^T Q by wgmma m64nHDk16 with the A operand from
//     registers and Q / dO as the N-major B operand, 16 query rows a round.
//     P^T and dS^T are each split into three bf16 terms (24 bits, as the
//     reference's fp32): the forward found two terms 1.22x past a 2-ulp
//     gate (PERF.md), three within it.
//   - Registers. dK and dV take HD / 2 floats a thread each, S^T and dP^T
//     QN / 2 each: QN = 64 up to hd 64, 32 above, so that hd 128 (128
//     registers of accumulators) still fits with 3 x 2 x 4 of terms.
//   - Sums over g. This g's partials stay in registers until its last
//     listed row block; each thread then adds them into the elements of dk
//     and dv that only it owns in the accumulator layout (the same for
//     every g), reading them back from the output from g = 1 on.
//
// Shared memory: K and V 2 * 64 NWG * HD * 2 bytes, the ring 2 * 2 * QN *
// HD * 2, lse and delta 2 * 2 * QN * 4, 3 mbarriers, 2 width + 5 ints and
// up to 1 KB to align: 14 KB at hd 16 / block 64 (many programs an SM),
// 97 KB at hd 128 / block 128.
//
// Bound on the H100: 8 block^2 hd flop a listed (row block, head) against
// one Q and one dO tile: at the training shape (block 64, hd 16, G 1, ~1.6
// listed row blocks a column) the bytes bound it, and each program is
// short, so many of them wait on their loads at once; the split's extra
// products are tensor work the bound does not count.
#pragma once

#include "block_sparse_common.cuh"
#include "block_sparse_sm90.cuh"

namespace spion {

// query rows a ring tile holds
template <int HD>
__host__ __device__ constexpr int dkv_query_rows() {
  return HD <= 64 ? 64 : 32;
}

// programs an SM the register cap allows: four of one warpgroup at hd 16
// (128 registers a thread), else one (255)
template <int HD, int NWG>
__host__ __device__ constexpr int dkv_min_blocks() {
  return NWG == 1 && HD <= 16 ? 4 : 1;
}

template <int HD, int NWG>
inline size_t dkv_sm90_smem_bytes(int width) {
  constexpr int QN = dkv_query_rows<HD>();
  return 1024 +   // the swizzled tiles start on a 1024-byte boundary
         (size_t)2 * 64 * NWG * HD * 2 + (size_t)kStages * 2 * QN * HD * 2 +
         (size_t)kStages * 2 * QN * sizeof(float) +
         (kStages + 1) * sizeof(uint64_t) +
         (size_t)(2 * width + 3 + kStages) * sizeof(int);
}

// One thread: ring item `item` (head g, listed row block t, chunk ch) into
// stage `s`: the Q and dO tiles of QN rows by TMA, one box per panel, and
// the rows' lse and delta by bulk copies clamped to the tensor's end.
template <int HD>
__device__ __forceinline__ void issue_rows(
    unsigned char* ring, float* rowv, uint64_t* full, const CUtensorMap* map_q,
    const CUtensorMap* map_do, const BwdParams& p, const int* tiles, int n,
    int nch, int per_g, int s, int item) {
  constexpr int W = sm90_panel_bytes(HD);
  constexpr int QN = dkv_query_rows<HD>();
  const int g = item / per_g;
  const int t = (item - g * per_g) / nch;
  const int ch = item - g * per_g - t * nch;
  const size_t row = ((size_t)n * p.G + g) * p.S +
                     (size_t)tiles[t] * p.block + (size_t)ch * QN;
  const size_t rows_total = (size_t)p.N * p.G * p.S;
  const uint32_t vbytes =
      (uint32_t)(rows_total - row < (size_t)QN ? rows_total - row : QN) * 4;
  unsigned char* qt = ring + (size_t)2 * s * QN * HD * 2;
  unsigned char* dt = qt + QN * HD * 2;
  float* lse_s = rowv + 2 * s * QN;
  sm90::mbar_expect_tx(&full[s], 2 * QN * HD * 2 + 2 * vbytes);
#pragma unroll
  for (int c = 0; c < HD * 2 / W; ++c) {
    sm90::tma_load_2d(qt + c * QN * W, map_q, &full[s], c * W / 2, (int)row);
    sm90::tma_load_2d(dt + c * QN * W, map_do, &full[s], c * W / 2, (int)row);
  }
  sm90::bulk_load_1d(lse_s, p.lse + row, vbytes, &full[s]);
  sm90::bulk_load_1d(lse_s + QN, p.delta + row, vbytes, &full[s]);
}

template <int HD, int NWG>
__global__ void __launch_bounds__(128 * NWG, (dkv_min_blocks<HD, NWG>()))
    block_sparse_dkv_kernel_sm90(const __grid_constant__ CUtensorMap map_k,
                                 const __grid_constant__ CUtensorMap map_v,
                                 const __grid_constant__ CUtensorMap map_q,
                                 const __grid_constant__ CUtensorMap map_do,
                                 const BwdParams p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  constexpr int W = sm90_panel_bytes(HD);
  constexpr int QN = dkv_query_rows<HD>();
  constexpr int R = 64 * NWG;                 // keys a program holds
  unsigned char* k_s =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* v_s = k_s + R * HD * 2;
  unsigned char* ring = v_s + R * HD * 2;     // stage s: Q, then dO
  float* rowv = reinterpret_cast<float*>(ring + (size_t)kStages * 2 * QN *
                                                    HD * 2);  // lse, delta
  uint64_t* full = reinterpret_cast<uint64_t*>(rowv + kStages * 2 * QN);
  uint64_t* kv_bar = full + kStages;
  int* done = reinterpret_cast<int*>(kv_bar + 1);     // warps done a stage
  int* tiles = done + kStages;                         // width
  int* hist = tiles + p.width;                         // width + 1
  int* shared_int = hist + p.width + 1;                // column block, tiles

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int n = blockIdx.x % p.N;
  const int rank = blockIdx.x / p.N;
  const int block = p.block;
  const int nch = (block + QN - 1) / QN;      // chunks of a row block

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      done[s] = 0;
    }
    sm90::mbar_init(kv_bar, 1);
    sm90::mbar_fence_init();
  }
  const int c = row_block_by_rank(p.nidx, p.ncb, p.width, rank, hist,
                                  shared_int);
  const size_t key0 = (size_t)n * p.Sk + (size_t)c * block;
  // the listed row blocks with an in-range id, in table order; K and V,
  // then the first query tiles, on their way
  if (tid < 32) {
    const int nv = clamp_nvalid(p.nidx[c], p.width);
    int count = 0;
    for (int base = 0; base < nv; base += 32) {
      const int i = base + lane;
      const int r = i < nv ? p.idx[(size_t)c * p.width + i] : -1;
      const bool ok = r >= 0 && r < p.nrb;
      const unsigned m = __ballot_sync(0xffffffffu, ok);
      if (ok) tiles[count + __popc(m & ((1u << lane) - 1))] = r;
      count += __popc(m);
    }
    __syncwarp();
    if (lane == 0) {
      shared_int[1] = count;
      sm90::mbar_expect_tx(kv_bar, 2 * R * HD * 2);
#pragma unroll
      for (int pc = 0; pc < HD * 2 / W; ++pc) {
        sm90::tma_load_2d(k_s + pc * R * W, &map_k, kv_bar, pc * W / 2,
                          (int)key0);
        sm90::tma_load_2d(v_s + pc * R * W, &map_v, kv_bar, pc * W / 2,
                          (int)key0);
      }
      const int total = p.G * count * nch;
      for (int i = 0; i < min(total, kStages); ++i)
        issue_rows<HD>(ring, rowv, full, &map_q, &map_do, p, tiles, n, nch,
                       count * nch, i, i);
    }
  }
  __syncthreads();
  const int nt = shared_int[1];
  const int per_g = nt * nch;
  const int total = p.G * per_g;

  // the two key rows this thread holds in the accumulator layout
  int key[2], kpos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    key[h] = wg * 64 + warp * 16 + (lane >> 2) + 8 * h;
    kpos[h] = (c + p.col0) * block + key[h];
  }
  const int kq = (lane & 3) * 2;    // first query row (or column) of a pair
  float* dk_out = p.out0 + key0 * HD;
  float* dv_out = p.out1 + key0 * HD;

  float dk[HD / 2], dv[HD / 2];
#pragma unroll
  for (int x = 0; x < HD / 2; ++x) {
    dk[x] = 0.f;
    dv[x] = 0.f;
  }
  const uint32_t k_addr = sm90::smem_u32(k_s) + wg * 64 * W;
  const uint32_t v_addr = sm90::smem_u32(v_s) + wg * 64 * W;
  sm90::mbar_wait(kv_bar, 0);

  for (int i = 0; i < total; ++i) {
    const int s = i % kStages;
    const uint32_t parity = (i / kStages) & 1;
    const int g = i / per_g;
    const int t = (i - g * per_g) / nch;
    const int ch = i - g * per_g - t * nch;
    const int row0 = ch * QN;                       // first row in the block
    const int qpos0 = (tiles[t] + p.row0) * block + row0;
    const uint32_t q_addr =
        sm90::smem_u32(ring + (size_t)2 * s * QN * HD * 2);
    const uint32_t do_addr = q_addr + QN * HD * 2;
    const float* lse_s = rowv + 2 * s * QN;
    const float* dl_s = lse_s + QN;
    sm90::mbar_wait(&full[s], parity);

    // S^T = K Q^T and dP^T = V dO^T: keys down, query rows across
    float st[QN / 2], dpt[QN / 2];
#pragma unroll
    for (int x = 0; x < QN / 2; ++x) {
      st[x] = 0.f;
      dpt[x] = 0.f;
    }
    sm90::wgmma_fence();
    sm90::fence_regs(st);
    sm90::fence_regs(dpt);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      sm90::wgmma_ss<QN>(st, sm90::desc_k_major<W>(k_addr, R, kk),
                         sm90::desc_k_major<W>(q_addr, QN, kk), kk > 0);
      sm90::wgmma_ss<QN>(dpt, sm90::desc_k_major<W>(v_addr, R, kk),
                         sm90::desc_k_major<W>(do_addr, QN, kk), kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(st);
    sm90::fence_regs(dpt);

    // P^T into st, dS^T (scaled for dK) into dpt; rows past the block and
    // masked positions give 0
#pragma unroll
    for (int j = 0; j < QN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + kq + e;
        const bool in = row0 + col < block;
        const float lse = in ? lse_s[col] : 0.f;
        const float delta = in ? dl_s[col] : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int x = 4 * j + 2 * h + e;
          const bool ok = in && tile_ok(qpos0 + col, kpos[h], p.causal,
                                        p.sliding_window);
          const float pr = ok ? expf(st[x] * p.scale - lse) : 0.f;
          st[x] = pr;
          dpt[x] = pr * (dpt[x] - delta) * p.scale;
        }
      }

    // dV += P^T dO and dK += dS^T Q, 16 query rows a round, each operand
    // as three bf16 terms
#pragma unroll
    for (int kk = 0; kk < QN / 16; ++kk) {
      uint32_t pf[3][4], sf[3][4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        sm90::split3(st[8 * kk + 2 * u], st[8 * kk + 2 * u + 1], pf[0][u],
                     pf[1][u], pf[2][u]);
        sm90::split3(dpt[8 * kk + 2 * u], dpt[8 * kk + 2 * u + 1], sf[0][u],
                     sf[1][u], sf[2][u]);
      }
      sm90::wgmma_fence();
      sm90::fence_regs(dv);
      sm90::fence_regs(dk);
#pragma unroll
      for (int part = 0; part < 3; ++part)
        sm90::wgmma_rs<HD>(dv, pf[part],
                           sm90::desc_mn_major<W>(do_addr, QN, kk));
#pragma unroll
      for (int part = 0; part < 3; ++part)
        sm90::wgmma_rs<HD>(dk, sf[part],
                           sm90::desc_mn_major<W>(q_addr, QN, kk));
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_regs(dv);
      sm90::fence_regs(dk);
    }

    // release the stage: the last warp done with it refills it with item
    // i + kStages
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();
      if (atomicAdd(&done[s], 1) == 4 * NWG - 1) {
        done[s] = 0;
        __threadfence_block();
        if (i + kStages < total)
          issue_rows<HD>(ring, rowv, full, &map_q, &map_do, p, tiles, n, nch,
                         per_g, s, i + kStages);
      }
    }
    __syncwarp();

    // this g's partial sums into the running totals (the reference's
    // dk_acc += dk); every element has one owner thread, which alone reads
    // and writes it
    if (i + 1 - g * per_g == per_g) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (key[h] >= block) continue;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          const size_t e = (size_t)key[h] * HD + 8 * j + kq;
          float2 a = make_float2(dk[4 * j + 2 * h], dk[4 * j + 2 * h + 1]);
          float2 b = make_float2(dv[4 * j + 2 * h], dv[4 * j + 2 * h + 1]);
          if (g > 0) {
            const float2 a0 = *reinterpret_cast<const float2*>(dk_out + e);
            const float2 b0 = *reinterpret_cast<const float2*>(dv_out + e);
            a = make_float2(a0.x + a.x, a0.y + a.y);
            b = make_float2(b0.x + b.x, b0.y + b.y);
          }
          *reinterpret_cast<float2*>(dk_out + e) = a;
          *reinterpret_cast<float2*>(dv_out + e) = b;
        }
      }
#pragma unroll
      for (int x = 0; x < HD / 2; ++x) {
        dk[x] = 0.f;
        dv[x] = 0.f;
      }
    }
  }
  if (total == 0) {   // nothing listed: dk and dv of the column are 0
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (key[h] >= block) continue;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const size_t e = (size_t)key[h] * HD + 8 * j + kq;
        *reinterpret_cast<float2*>(dk_out + e) = make_float2(0.f, 0.f);
        *reinterpret_cast<float2*>(dv_out + e) = make_float2(0.f, 0.f);
      }
    }
  }
}

template <int HD, int NWG>
int launch_dkv_sm90_hd(const BwdParams& p, cudaStream_t stream) {
  constexpr int W = sm90_panel_bytes(HD);
  CUtensorMap map_k, map_v, map_q, map_do;
  const uint64_t keys = (uint64_t)p.N * p.Sk;
  const uint64_t rows = (uint64_t)p.N * p.G * p.S;
  int rc = sm90::encode_rows(&map_k, p.k, keys, HD, 64 * NWG, W);
  if (!rc) rc = sm90::encode_rows(&map_v, p.v, keys, HD, 64 * NWG, W);
  if (!rc)
    rc = sm90::encode_rows(&map_q, p.q, rows, HD, dkv_query_rows<HD>(), W);
  if (!rc)
    rc = sm90::encode_rows(&map_do, p.dout, rows, HD, dkv_query_rows<HD>(),
                           W);
  if (rc) return rc;
  const size_t smem = dkv_sm90_smem_bytes<HD, NWG>(p.width);
  auto kernel = block_sparse_dkv_kernel_sm90<HD, NWG>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)p.ncb * p.N, 128 * NWG, smem, stream>>>(
      map_k, map_v, map_q, map_do, p);
  return (int)cudaGetLastError();
}

// One launcher per warpgroup count, each in its own file so that the two
// sets of head dims compile in parallel.
int launch_dkv_sm90_wg1(const BwdParams& p, int hd, cudaStream_t stream);
int launch_dkv_sm90_wg2(const BwdParams& p, int hd, cudaStream_t stream);

// The bf16 entry point's launcher (SPION_DEFINE_BWD_ENTRY): one warpgroup
// of keys for block <= 64, two above.
template <typename T>
int launch_dkv_sm90(const BwdParams& p, int hd, cudaStream_t stream) {
  if (p.block < 16 || p.block > 128 || p.block % 16 != 0 || p.width < 0)
    return (int)cudaErrorInvalidValue;
  if (p.ncb == 0 || p.N == 0) return (int)cudaSuccess;
  (void)cudaGetLastError();  // report only what this launch raises
  return p.block <= 64 ? launch_dkv_sm90_wg1(p, hd, stream)
                       : launch_dkv_sm90_wg2(p, hd, stream);
}

}  // namespace spion

// Dispatch a runtime head dim to launch_dkv_sm90_hd<HD, NWG>.
#define SPION_DKV_SM90_HD_SWITCH(NWG, hd, ...)                                \
  switch (hd) {                                                               \
    case 16: return launch_dkv_sm90_hd<16, NWG>(__VA_ARGS__);                 \
    case 32: return launch_dkv_sm90_hd<32, NWG>(__VA_ARGS__);                 \
    case 48: return launch_dkv_sm90_hd<48, NWG>(__VA_ARGS__);                 \
    case 64: return launch_dkv_sm90_hd<64, NWG>(__VA_ARGS__);                 \
    case 80: return launch_dkv_sm90_hd<80, NWG>(__VA_ARGS__);                 \
    case 96: return launch_dkv_sm90_hd<96, NWG>(__VA_ARGS__);                 \
    case 112: return launch_dkv_sm90_hd<112, NWG>(__VA_ARGS__);               \
    case 128: return launch_dkv_sm90_hd<128, NWG>(__VA_ARGS__);               \
    default: return (int)cudaErrorInvalidValue;                               \
  }
