// Block-sparse flash-attention backward, dQ, for Hopper (sm_90a): the
// scalar kernel of fp32 inputs (a parity path, with TF32 off); bf16 inputs
// run the tensor-core kernel of block_sparse_dq_sm90.cuh.
//
// Replaces the TPU kernel `_dq_kernel` of the JAX package
// (src/repro/kernels/block_sparse_attn.py, host function `_fused_dq`). For
// query rows of row-block r of (kv-head n, query head g) it walks the K/V
// tiles listed in col_idx[r, :nvalid[r]] and accumulates, in fp32,
//   p  = exp(scale * q k^T - lse)      (0 where the tile mask is false)
//   dp = dO v^T,   ds = p * (dp - delta),   dq += scale * ds k,
// with lse the forward's log-sum-exp (Alg. 6 correction included, +inf on
// an empty row, so p = 0 there) and delta = rowsum(dO * O). dq is fp32; the
// caller casts it to q's type.
//
// Layout and budget. One thread block of 256 threads per (n, g, r, half):
// a program owns sub_rows(block) query rows (the whole row block up to 64,
// else half of it) and every key of each listed tile. Shared memory, fp32
// with rows padded by one float (no bank conflicts on the column reads):
// Q and dO rows (qr x (hd + 1) each), one K/V tile (block x (hd + 1): V
// for dp, then K for the scores and for dq), the ds tile (qr x (block + 1))
// and qr lse and delta values. At block 128 / hd 128 that is 165,632 bytes,
// under the 232,448 a block may use after cudaFuncSetAttribute; the
// forward's one-program-per-row-block layout would need 264 KB here.
// Registers: a thread owns rows ty + 16 i (i < 4) and keys tx + 16 j
// (j < 8) of the score tile (s and dp, 2 x 32 floats) and the same rows by
// columns tx + 16 j of dq (32 floats).
//
// Bound on the H100: 6 * block^2 * hd flops per listed tile (three
// products) against one K and one V tile, so at the training shape (block
// 64, hd 16) the bound is the bytes and at the serving shape (128, 128) the
// operations. Scalar fp32 FMAs from shared memory (so the fp32 path keeps
// the reference's tolerance without TF32), far from either bound.
//
// Entries i >= nvalid[r] are never read; column ids outside [0, ncb) are
// skipped, as in the forward. No atomics: each program writes its own rows.
#pragma once

#include "block_sparse_common.cuh"

namespace spion {

inline size_t dq_smem_bytes(int block, int hd) {
  const size_t qr = sub_rows(block);
  return sizeof(float) * (2 * qr * (hd + 1) + (size_t)block * (hd + 1) +
                          qr * (block + 1) + 2 * qr);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    block_sparse_dq_kernel(const BwdParams p) {
  extern __shared__ float smem[];
  constexpr int NC = HD / 16;       // head-dim columns a thread owns
  constexpr int ld = HD + 1;        // padded row stride of the row tiles
  constexpr int kR = 4;             // row slots of a thread: qr <= 64
  constexpr int kK = 8;             // key slots of a thread: block <= 128
  const int block = p.block;
  const int qr = sub_rows(block);
  const int nsub = block / qr;
  const int lds = block + 1;        // padded row stride of the ds tile
  float* q_s = smem;
  float* do_s = q_s + qr * ld;
  float* kv_s = do_s + qr * ld;     // holds V, then K, of the current tile
  float* ds_s = kv_s + block * ld;
  float* lse_s = ds_s + qr * lds;
  float* dl_s = lse_s + qr;

  const int r = blockIdx.x / nsub;
  const int sub = blockIdx.x - r * nsub;
  const int g = blockIdx.y;
  const int n = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int nk = block >> 4;

  // first row of this program in the (N, G, S) row space
  const size_t row_off =
      ((size_t)n * p.G + g) * p.S + (size_t)r * block + (size_t)sub * qr;
  load_rows<T, HD>(q_s, static_cast<const T*>(p.q) + row_off * HD, qr);
  load_rows<T, HD>(do_s, static_cast<const T*>(p.dout) + row_off * HD, qr);
  for (int i = tid; i < qr; i += kThreads) {
    lse_s[i] = p.lse[row_off + i];
    dl_s[i] = p.delta[row_off + i];
  }
  const T* kbase = static_cast<const T*>(p.k) + (size_t)n * p.Sk * HD;
  const T* vbase = static_cast<const T*>(p.v) + (size_t)n * p.Sk * HD;

  float acc[kR][NC];
#pragma unroll
  for (int ii = 0; ii < kR; ++ii)
#pragma unroll
    for (int jj = 0; jj < NC; ++jj) acc[ii][jj] = 0.f;

  const int nv = min(max(p.nidx[r], 0), p.width);
  const int qpos0 = (r + p.row0) * block + sub * qr;
  __syncthreads();

  for (int i = 0; i < nv; ++i) {
    const int c = p.idx[(size_t)r * p.width + i];
    if (c < 0 || c >= p.ncb) continue;  // the same for every thread
    const int kpos0 = (c + p.col0) * block;

    // dp = dO V^T over the rows x keys this thread owns
    load_rows<T, HD>(kv_s, vbase + (size_t)c * block * HD, block);
    __syncthreads();
    float dp[kR][kK];
    float s[kR][kK];
#pragma unroll
    for (int ii = 0; ii < kR; ++ii)
#pragma unroll
      for (int jj = 0; jj < kK; ++jj) {
        dp[ii][jj] = 0.f;
        s[ii][jj] = 0.f;
      }
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float a[kR], b[kK];
#pragma unroll
      for (int ii = 0; ii < kR; ++ii)
        a[ii] = ty + 16 * ii < qr ? do_s[(ty + 16 * ii) * ld + d] : 0.f;
#pragma unroll
      for (int jj = 0; jj < kK; ++jj)
        b[jj] = jj < nk ? kv_s[(tx + 16 * jj) * ld + d] : 0.f;
#pragma unroll
      for (int ii = 0; ii < kR; ++ii)
#pragma unroll
        for (int jj = 0; jj < kK; ++jj) dp[ii][jj] = fmaf(a[ii], b[jj], dp[ii][jj]);
    }
    __syncthreads();  // K replaces V

    load_rows<T, HD>(kv_s, kbase + (size_t)c * block * HD, block);
    __syncthreads();
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float a[kR], b[kK];
#pragma unroll
      for (int ii = 0; ii < kR; ++ii)
        a[ii] = ty + 16 * ii < qr ? q_s[(ty + 16 * ii) * ld + d] : 0.f;
#pragma unroll
      for (int jj = 0; jj < kK; ++jj)
        b[jj] = jj < nk ? kv_s[(tx + 16 * jj) * ld + d] : 0.f;
#pragma unroll
      for (int ii = 0; ii < kR; ++ii)
#pragma unroll
        for (int jj = 0; jj < kK; ++jj) s[ii][jj] = fmaf(a[ii], b[jj], s[ii][jj]);
    }
    // ds, scaled for the dq product, into shared memory
#pragma unroll
    for (int ii = 0; ii < kR; ++ii) {
      const int row = ty + 16 * ii;
      if (row >= qr) break;
      const float lse = lse_s[row];
      const float delta = dl_s[row];
#pragma unroll
      for (int jj = 0; jj < kK; ++jj) {
        if (jj >= nk) break;
        const int key = tx + 16 * jj;
        const bool ok = tile_ok(qpos0 + row, kpos0 + key, p.causal,
                                p.sliding_window);
        const float pr = ok ? expf(s[ii][jj] * p.scale - lse) : 0.f;
        ds_s[row * lds + key] = pr * (dp[ii][jj] - delta) * p.scale;
      }
    }
    __syncthreads();

    // dq += ds K over the rows x head-dim columns this thread owns
#pragma unroll 2
    for (int key = 0; key < block; ++key) {
      float a[kR], b[NC];
#pragma unroll
      for (int ii = 0; ii < kR; ++ii)
        a[ii] = ty + 16 * ii < qr ? ds_s[(ty + 16 * ii) * lds + key] : 0.f;
#pragma unroll
      for (int jj = 0; jj < NC; ++jj) b[jj] = kv_s[key * ld + tx + 16 * jj];
#pragma unroll
      for (int ii = 0; ii < kR; ++ii)
#pragma unroll
        for (int jj = 0; jj < NC; ++jj) acc[ii][jj] = fmaf(a[ii], b[jj], acc[ii][jj]);
    }
    __syncthreads();  // the next tile overwrites kv_s and ds_s
  }

  float* dq = p.out0 + row_off * HD;
#pragma unroll
  for (int ii = 0; ii < kR; ++ii) {
    const int row = ty + 16 * ii;
    if (row >= qr) break;
#pragma unroll
    for (int jj = 0; jj < NC; ++jj)
      dq[(size_t)row * HD + tx + 16 * jj] = acc[ii][jj];
  }
}

template <typename T, int HD>
int launch_dq_hd(const BwdParams& p, cudaStream_t stream) {
  const size_t smem = dq_smem_bytes(p.block, HD);
  auto kernel = block_sparse_dq_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.nrb * (p.block / sub_rows(p.block)), p.G, p.N);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dq(const BwdParams& p, int hd, cudaStream_t stream) {
  if (p.block < 16 || p.block > 128 || p.block % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (p.nrb == 0 || p.G == 0 || p.N == 0) return (int)cudaSuccess;
  (void)cudaGetLastError();  // report only what this launch raises
  SPION_HD_SWITCH(launch_dq_hd, T, hd, p, stream)
}

}  // namespace spion
