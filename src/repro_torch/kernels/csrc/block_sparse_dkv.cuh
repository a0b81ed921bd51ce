// Block-sparse flash-attention backward, dK/dV, for Hopper (sm_90a): the
// scalar kernel of fp32 inputs (a parity path, with TF32 off); bf16 inputs
// run the tensor-core kernel of block_sparse_dkv_sm90.cuh.
//
// Replaces the TPU kernel `_dkv_kernel` of the JAX package
// (src/repro/kernels/block_sparse_attn.py, host function `_fused_dkv`). For
// keys of column-block c of kv-head n it walks the transposed tables
// row_idx[c, :nvalid_t[c]] (the row blocks whose pattern lists c) and, over
// the G query heads that share the kv head, accumulates in fp32
//   p  = exp(scale * q k^T - lse)      (0 where the tile mask is false)
//   ds = p * (dO v^T - delta),   dv += p^T dO,   dk += scale * ds^T q.
// The order is the reference's: for each g in turn, a partial sum over the
// listed row blocks, then added into the running total. The loop over g is
// inside the program and there are no atomics, so the result does not
// depend on scheduling. dk and dv are fp32; the caller casts them.
//
// Layout and budget. One thread block of 256 threads per (n, c, half): a
// program owns kb = sub_rows(block) keys of the column block (the whole
// block up to 64, else half of it) and takes each listed row block in
// chunks of qr = sub_rows(block) query rows. Shared memory, fp32 with rows
// padded by one float: the program's K and V rows (kb x (hd + 1) each), a
// chunk of Q and dO rows (qr x (hd + 1) each), one p / ds tile
// (qr x (kb + 1)) and qr lse and delta values. At block 128 / hd 128 that
// is 149,248 bytes; K, V, Q, dO and a score tile of whole blocks would need
// about 320 KB against the 232,448 a block may use. Registers: a thread
// owns rows ty + 16 i and keys tx + 16 j of the score tile (s and dp,
// 2 x 16 floats) and keys ty + 16 i by columns tx + 16 j of this g's dk and
// dv partial sums (2 x 32 floats). The running totals live in the outputs:
// each thread adds its partial into the elements that only it writes.
//
// Bound on the H100: 8 * block^2 * hd flops per listed (row block, head)
// against one Q and one dO tile, so at the training shape (block 64, hd 16)
// the bound is the bytes and at the serving shape (128, 128) the
// operations. Scalar fp32 FMAs from shared memory, far from either bound.
//
// Entries t >= nvalid_t[c] are never read; row ids outside [0, nrb) are
// skipped.
#pragma once

#include "block_sparse_common.cuh"

namespace spion {

inline size_t dkv_smem_bytes(int block, int hd) {
  const size_t kb = sub_rows(block), qr = sub_rows(block);
  return sizeof(float) * (2 * kb * (hd + 1) + 2 * qr * (hd + 1) +
                          qr * (kb + 1) + 2 * qr);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    block_sparse_dkv_kernel(const BwdParams p) {
  extern __shared__ float smem[];
  constexpr int NC = HD / 16;       // head-dim columns a thread owns
  constexpr int ld = HD + 1;        // padded row stride of the row tiles
  constexpr int kS = 4;             // row and key slots of a thread: <= 64
  const int block = p.block;
  const int kb = sub_rows(block);
  const int qr = kb;
  const int nsub = block / kb;
  const int ldt = kb + 1;           // padded row stride of the p / ds tile
  float* k_s = smem;
  float* v_s = k_s + kb * ld;
  float* q_s = v_s + kb * ld;
  float* do_s = q_s + qr * ld;
  float* t_s = do_s + qr * ld;      // p, then ds
  float* lse_s = t_s + qr * ldt;
  float* dl_s = lse_s + qr;

  const int c = blockIdx.x / nsub;
  const int sub = blockIdx.x - c * nsub;
  const int n = blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  const size_t key_off = (size_t)n * p.Sk + (size_t)c * block +
                         (size_t)sub * kb;   // first key in (N, Sk)
  load_rows<T, HD>(k_s, static_cast<const T*>(p.k) + key_off * HD, kb);
  load_rows<T, HD>(v_s, static_cast<const T*>(p.v) + key_off * HD, kb);
  const int nvt = min(max(p.nidx[c], 0), p.width);
  const int kpos0 = (c + p.col0) * block + sub * kb;
  const int nchunk = block / qr;
  float* dk_out = p.out0 + key_off * HD;
  float* dv_out = p.out1 + key_off * HD;

  for (int g = 0; g < p.G; ++g) {
    float dk[kS][NC], dv[kS][NC];
#pragma unroll
    for (int ii = 0; ii < kS; ++ii)
#pragma unroll
      for (int jj = 0; jj < NC; ++jj) {
        dk[ii][jj] = 0.f;
        dv[ii][jj] = 0.f;
      }
    for (int t = 0; t < nvt; ++t) {
      const int r = p.idx[(size_t)c * p.width + t];
      if (r < 0 || r >= p.nrb) continue;  // the same for every thread
      for (int ch = 0; ch < nchunk; ++ch) {
        const size_t row_off = ((size_t)n * p.G + g) * p.S +
                               (size_t)r * block + (size_t)ch * qr;
        load_rows<T, HD>(q_s, static_cast<const T*>(p.q) + row_off * HD, qr);
        load_rows<T, HD>(do_s, static_cast<const T*>(p.dout) + row_off * HD,
                         qr);
        for (int i = tid; i < qr; i += kThreads) {
          lse_s[i] = p.lse[row_off + i];
          dl_s[i] = p.delta[row_off + i];
        }
        __syncthreads();

        // scores and dp over the rows x keys this thread owns
        float s[kS][kS], dp[kS][kS];
#pragma unroll
        for (int ii = 0; ii < kS; ++ii)
#pragma unroll
          for (int jj = 0; jj < kS; ++jj) {
            s[ii][jj] = 0.f;
            dp[ii][jj] = 0.f;
          }
#pragma unroll 4
        for (int d = 0; d < HD; ++d) {
          float qa[kS], da[kS], kk[kS], vv[kS];
#pragma unroll
          for (int ii = 0; ii < kS; ++ii) {
            const bool in = ty + 16 * ii < qr;
            qa[ii] = in ? q_s[(ty + 16 * ii) * ld + d] : 0.f;
            da[ii] = in ? do_s[(ty + 16 * ii) * ld + d] : 0.f;
          }
#pragma unroll
          for (int jj = 0; jj < kS; ++jj) {
            const bool in = tx + 16 * jj < kb;
            kk[jj] = in ? k_s[(tx + 16 * jj) * ld + d] : 0.f;
            vv[jj] = in ? v_s[(tx + 16 * jj) * ld + d] : 0.f;
          }
#pragma unroll
          for (int ii = 0; ii < kS; ++ii)
#pragma unroll
            for (int jj = 0; jj < kS; ++jj) {
              s[ii][jj] = fmaf(qa[ii], kk[jj], s[ii][jj]);
              dp[ii][jj] = fmaf(da[ii], vv[jj], dp[ii][jj]);
            }
        }
        // p into the tile, ds kept in registers
        const int qpos0 = (r + p.row0) * block + ch * qr;
#pragma unroll
        for (int ii = 0; ii < kS; ++ii) {
          const int row = ty + 16 * ii;
          if (row >= qr) break;
          const float lse = lse_s[row];
          const float delta = dl_s[row];
#pragma unroll
          for (int jj = 0; jj < kS; ++jj) {
            const int key = tx + 16 * jj;
            if (key >= kb) break;
            const bool ok = tile_ok(qpos0 + row, kpos0 + key, p.causal,
                                    p.sliding_window);
            const float pr = ok ? expf(s[ii][jj] * p.scale - lse) : 0.f;
            t_s[row * ldt + key] = pr;
            dp[ii][jj] = pr * (dp[ii][jj] - delta) * p.scale;
          }
        }
        __syncthreads();

        // dv += p^T dO over the keys x head-dim columns this thread owns
        for (int row = 0; row < qr; ++row) {
          float a[kS], b[NC];
#pragma unroll
          for (int ii = 0; ii < kS; ++ii)
            a[ii] = ty + 16 * ii < kb ? t_s[row * ldt + ty + 16 * ii] : 0.f;
#pragma unroll
          for (int jj = 0; jj < NC; ++jj) b[jj] = do_s[row * ld + tx + 16 * jj];
#pragma unroll
          for (int ii = 0; ii < kS; ++ii)
#pragma unroll
            for (int jj = 0; jj < NC; ++jj) dv[ii][jj] = fmaf(a[ii], b[jj], dv[ii][jj]);
        }
        __syncthreads();  // ds replaces p
#pragma unroll
        for (int ii = 0; ii < kS; ++ii) {
          const int row = ty + 16 * ii;
          if (row >= qr) break;
#pragma unroll
          for (int jj = 0; jj < kS; ++jj) {
            const int key = tx + 16 * jj;
            if (key >= kb) break;
            t_s[row * ldt + key] = dp[ii][jj];
          }
        }
        __syncthreads();

        // dk += scale * ds^T Q
        for (int row = 0; row < qr; ++row) {
          float a[kS], b[NC];
#pragma unroll
          for (int ii = 0; ii < kS; ++ii)
            a[ii] = ty + 16 * ii < kb ? t_s[row * ldt + ty + 16 * ii] : 0.f;
#pragma unroll
          for (int jj = 0; jj < NC; ++jj) b[jj] = q_s[row * ld + tx + 16 * jj];
#pragma unroll
          for (int ii = 0; ii < kS; ++ii)
#pragma unroll
            for (int jj = 0; jj < NC; ++jj) dk[ii][jj] = fmaf(a[ii], b[jj], dk[ii][jj]);
        }
        __syncthreads();  // the next chunk overwrites q_s, do_s and t_s
      }
    }
    // this g's partial sums into the running totals (the reference's
    // dk_acc += dk); every element has one owner thread, which alone reads
    // and writes it
#pragma unroll
    for (int ii = 0; ii < kS; ++ii) {
      const int key = ty + 16 * ii;
      if (key >= kb) break;
#pragma unroll
      for (int jj = 0; jj < NC; ++jj) {
        const size_t e = (size_t)key * HD + tx + 16 * jj;
        dk_out[e] = (g == 0 ? 0.f : dk_out[e]) + dk[ii][jj];
        dv_out[e] = (g == 0 ? 0.f : dv_out[e]) + dv[ii][jj];
      }
    }
  }
}

template <typename T, int HD>
int launch_dkv_hd(const BwdParams& p, cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes(p.block, HD);
  auto kernel = block_sparse_dkv_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.ncb * (p.block / sub_rows(p.block)), p.N);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dkv(const BwdParams& p, int hd, cudaStream_t stream) {
  if (p.block < 16 || p.block > 128 || p.block % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (p.ncb == 0 || p.N == 0) return (int)cudaSuccess;
  (void)cudaGetLastError();  // report only what this launch raises
  SPION_HD_SWITCH(launch_dkv_hd, T, hd, p, stream)
}

}  // namespace spion
