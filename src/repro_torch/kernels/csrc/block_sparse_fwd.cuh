// Block-sparse flash-attention forward for Hopper (sm_90a), the fp32 path.
//
// Replaces the TPU kernel `_fwd_kernel` of the JAX package
// (src/repro/kernels/block_sparse_attn.py) for fp32 inputs, which exist for
// parity checks (run with TF32 off); bf16 inputs take the tensor-core kernel
// of block_sparse_fwd_sm90.cuh. For one (kv-head n, query head g,
// row-block r) a thread block streams the K/V tiles listed in
// col_idx[r, :nvalid[r]] through shared memory and keeps the flash carries
// (running max m, sum l, context acc) in fp32. The Alg. 6 zero-correction
// then counts every pruned visible position as exp(0 - m) in the
// denominator: denom = l + max(rt - stored, 0) * exp(-m).
//
// Bound on the H100: at the serving shape (block 128, hd 128) each listed
// tile costs 4 * block^2 * hd flops against 2 * block * hd * 2 bytes of K/V,
// about 128 flops a byte, so a tensor-core kernel would be bound by the
// operations and a scalar one all the more. This version is the
// simple one: every product is a scalar fp32 FMA from shared memory (so the
// fp32 path keeps 3e-5 parity, no TF32), one thread block per (n, g, r),
// tiles staged in fp32 with padded rows so that no shared-memory read has a
// bank conflict, K and V sharing one buffer so that block 128 / hd 128 fits
// in 196 KB.
//
// Semantics kept from the reference:
//   - entries i >= nvalid[r] are skipped (exact no-ops there);
//   - masked scores never enter m, l or acc; m starts at -1e30, so a row
//     with nothing stored ends with denom = +inf, o = 0 and lse = +inf;
//   - rt is row + 1 when causal (capped at the sliding window), else the
//     global seq_len; positions are global through (row0, col0);
//   - o = acc / denom (denom 0 divides by 1), lse = m + log(denom).
// Column ids outside [0, Sk / block) are skipped rather than read out of
// bounds.
#pragma once

#include "block_sparse_common.cuh"

namespace spion {

constexpr int kMaxRows = 8;     // rows (and keys) a thread owns: block / 16

struct FwdParams {
  const void* q;        // (N, G, S, HD)
  const void* k;        // (N, Sk, HD)
  const void* v;        // (N, Sk, HD)
  const int* col_idx;   // (nrb, K)
  const int* nvalid;    // (nrb,)
  void* o;              // (N, G, S, HD), the type of q
  float* lse;           // (N, G, S)
  int N, G, S, Sk, nrb, K, block;
  int causal;
  int sliding_window;   // < 0: none
  int seq_len;          // global row total when not causal
  int row0, col0;       // global block index of local row-block 0 / K block 0
  float scale;
};

inline size_t fwd_smem_bytes(int block, int hd) {
  // Q tile and K/V tile (block x (hd + 1)), score tile (block x (block + 1)),
  // and four per-row vectors (m, l, alpha, stored), all fp32
  return sizeof(float) * ((size_t)2 * block * (hd + 1) +
                          (size_t)block * (block + 1) + 4 * (size_t)block);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    block_sparse_fwd_kernel(const FwdParams p) {
  extern __shared__ float smem[];
  constexpr int NC = HD / 16;       // head-dim columns a thread owns
  constexpr int ld = HD + 1;        // padded row stride of the Q and K/V tiles
  const int block = p.block;
  const int lds = block + 1;        // padded row stride of the score tile
  float* q_s = smem;
  float* kv_s = q_s + block * ld;   // holds K, then V, of the current tile
  float* s_s = kv_s + block * ld;   // scores, then probabilities
  float* m_s = s_s + block * lds;
  float* l_s = m_s + block;
  float* a_s = l_s + block;
  float* c_s = a_s + block;

  const int r = blockIdx.x;
  const int g = blockIdx.y;
  const int n = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nr = block >> 4;

  const size_t q_off = (((size_t)n * p.G + g) * p.S + (size_t)r * block) * HD;
  const T* q = static_cast<const T*>(p.q) + q_off;
  const T* kbase = static_cast<const T*>(p.k) + (size_t)n * p.Sk * HD;
  const T* vbase = static_cast<const T*>(p.v) + (size_t)n * p.Sk * HD;

  for (int idx = tid; idx < block * HD; idx += kThreads) {
    const int row = idx / HD;
    q_s[row * ld + idx - row * HD] = to_float(q[idx]);
  }
  for (int i = tid; i < block; i += kThreads) {
    m_s[i] = kNeg;
    l_s[i] = 0.f;
    c_s[i] = 0.f;
  }

  float acc[kMaxRows][NC];
#pragma unroll
  for (int ii = 0; ii < kMaxRows; ++ii)
#pragma unroll
    for (int jj = 0; jj < NC; ++jj) acc[ii][jj] = 0.f;

  const int nv = min(max(p.nvalid[r], 0), p.K);
  const int ncb = p.Sk / block;
  const int qrow0 = (r + p.row0) * block;
  __syncthreads();

  for (int i = 0; i < nv; ++i) {
    const int c = p.col_idx[(size_t)r * p.K + i];
    if (c < 0 || c >= ncb) continue;  // the same for every thread
    const int kcol0 = (c + p.col0) * block;

    const T* kt = kbase + (size_t)c * block * HD;
    for (int idx = tid; idx < block * HD; idx += kThreads) {
      const int row = idx / HD;
      kv_s[row * ld + idx - row * HD] = to_float(kt[idx]);
    }
    __syncthreads();

    // scores of rows ty + 16 ii against keys tx + 16 jj
    float s[kMaxRows][kMaxRows];
#pragma unroll
    for (int ii = 0; ii < kMaxRows; ++ii)
#pragma unroll
      for (int jj = 0; jj < kMaxRows; ++jj) s[ii][jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[kMaxRows], kv[kMaxRows];
#pragma unroll
      for (int ii = 0; ii < kMaxRows; ++ii) {
        qv[ii] = ii < nr ? q_s[(ty + 16 * ii) * ld + d] : 0.f;
        kv[ii] = ii < nr ? kv_s[(tx + 16 * ii) * ld + d] : 0.f;
      }
#pragma unroll
      for (int ii = 0; ii < kMaxRows; ++ii)
#pragma unroll
        for (int jj = 0; jj < kMaxRows; ++jj)
          s[ii][jj] = fmaf(qv[ii], kv[jj], s[ii][jj]);
    }
#pragma unroll
    for (int ii = 0; ii < kMaxRows; ++ii) {
      if (ii >= nr) break;
      const int row = ty + 16 * ii;
#pragma unroll
      for (int jj = 0; jj < kMaxRows; ++jj) {
        if (jj >= nr) break;
        const int key = tx + 16 * jj;
        const bool ok = tile_ok(qrow0 + row, kcol0 + key, p.causal,
                                p.sliding_window);
        s_s[row * lds + key] = ok ? s[ii][jj] * p.scale : -INFINITY;
      }
    }
    __syncthreads();

    // V replaces K while the warps turn score rows into probabilities
    const T* vt = vbase + (size_t)c * block * HD;
    for (int idx = tid; idx < block * HD; idx += kThreads) {
      const int row = idx / HD;
      kv_s[row * ld + idx - row * HD] = to_float(vt[idx]);
    }
    for (int row = warp; row < block; row += kThreads / 32) {
      float* srow = s_s + row * lds;
      const int qpos = qrow0 + row;
      float mx = -INFINITY;
      for (int key = lane; key < block; key += 32) mx = fmaxf(mx, srow[key]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[row];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      float cnt = 0.f;
      for (int key = lane; key < block; key += 32) {
        const bool ok = tile_ok(qpos, kcol0 + key, p.causal, p.sliding_window);
        const float e = ok ? expf(srow[key] - m_new) : 0.f;
        srow[key] = e;
        sum += e;
        cnt += ok ? 1.f : 0.f;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
        cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
      }
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[row] = alpha;
        m_s[row] = m_new;
        l_s[row] = l_s[row] * alpha + sum;
        c_s[row] += cnt;
      }
    }
    __syncthreads();

#pragma unroll
    for (int ii = 0; ii < kMaxRows; ++ii) {
      const float alpha = ii < nr ? a_s[ty + 16 * ii] : 0.f;
#pragma unroll
      for (int jj = 0; jj < NC; ++jj) acc[ii][jj] *= alpha;
    }
#pragma unroll 2
    for (int key = 0; key < block; ++key) {
      float pv[kMaxRows], vv[NC];
#pragma unroll
      for (int ii = 0; ii < kMaxRows; ++ii)
        pv[ii] = ii < nr ? s_s[(ty + 16 * ii) * lds + key] : 0.f;
#pragma unroll
      for (int jj = 0; jj < NC; ++jj) vv[jj] = kv_s[key * ld + tx + 16 * jj];
#pragma unroll
      for (int ii = 0; ii < kMaxRows; ++ii)
#pragma unroll
        for (int jj = 0; jj < NC; ++jj)
          acc[ii][jj] = fmaf(pv[ii], vv[jj], acc[ii][jj]);
    }
    __syncthreads();  // the next tile overwrites kv_s and s_s
  }

  T* o = static_cast<T*>(p.o) + q_off;
  float* lse = p.lse + ((size_t)n * p.G + g) * p.S + (size_t)r * block;
#pragma unroll
  for (int ii = 0; ii < kMaxRows; ++ii) {
    if (ii >= nr) break;
    const int row = ty + 16 * ii;
    const int qpos = qrow0 + row;
    float rt;
    if (p.causal) {
      rt = (float)(qpos + 1);
      if (p.sliding_window >= 0) rt = fminf(rt, (float)p.sliding_window);
    } else {
      rt = (float)p.seq_len;
    }
    const float m = m_s[row];
    const float denom = l_s[row] + fmaxf(rt - c_s[row], 0.f) * expf(-m);
    const float safe = denom == 0.f ? 1.f : denom;
#pragma unroll
    for (int jj = 0; jj < NC; ++jj)
      o[(size_t)row * HD + tx + 16 * jj] = from_float<T>(acc[ii][jj] / safe);
    if (tx == 0) lse[row] = denom > 0.f ? m + logf(safe) : INFINITY;
  }
}

template <typename T, int HD>
int launch_hd(const FwdParams& p, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes(p.block, HD);
  auto kernel = block_sparse_fwd_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.nrb, p.G, p.N);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fwd(const FwdParams& p, int hd, cudaStream_t stream) {
  if (p.block < 16 || p.block > 16 * kMaxRows || p.block % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (p.nrb == 0 || p.G == 0 || p.N == 0) return (int)cudaSuccess;
  (void)cudaGetLastError();  // report only what this launch raises
  SPION_HD_SWITCH(launch_hd, T, hd, p, stream)
}

}  // namespace spion

// One C entry point per dtype, so each dtype's file builds in its own nvcc.
#define SPION_DEFINE_FWD_ENTRY(NAME, T)                                       \
  extern "C" int NAME(const void* q, const void* k, const void* v,            \
                      const void* col_idx, const void* nvalid, void* o,       \
                      void* lse, int N, int G, int S, int Sk, int hd,         \
                      int nrb, int K, int block, int causal,                  \
                      int sliding_window, int seq_len, int row0, int col0,    \
                      float scale, void* stream) {                            \
    spion::FwdParams p;                                                       \
    p.q = q;                                                                  \
    p.k = k;                                                                  \
    p.v = v;                                                                  \
    p.col_idx = static_cast<const int*>(col_idx);                             \
    p.nvalid = static_cast<const int*>(nvalid);                               \
    p.o = o;                                                                  \
    p.lse = static_cast<float*>(lse);                                         \
    p.N = N;                                                                  \
    p.G = G;                                                                  \
    p.S = S;                                                                  \
    p.Sk = Sk;                                                                \
    p.nrb = nrb;                                                              \
    p.K = K;                                                                  \
    p.block = block;                                                          \
    p.causal = causal;                                                        \
    p.sliding_window = sliding_window;                                        \
    p.seq_len = seq_len;                                                      \
    p.row0 = row0;                                                            \
    p.col0 = col0;                                                            \
    p.scale = scale;                                                          \
    return spion::launch_fwd<T>(p, hd, static_cast<cudaStream_t>(stream));    \
  }
