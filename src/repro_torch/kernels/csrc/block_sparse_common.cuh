// Helpers shared by the block-sparse attention kernels for Hopper (sm_90a):
// the thread count, the reference's NEG, the scalar (fp32) kernels'
// conversions, the causal / sliding-window tile mask in global positions,
// and the parameters and C entry point of the two backward kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace spion {

constexpr int kThreads = 256;   // a 16 x 16 grid of threads over the tile
constexpr float kNeg = -1e30f;  // the reference's NEG

__device__ __forceinline__ float to_float(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }

__device__ __forceinline__ bool tile_ok(int qpos, int kpos, int causal,
                                        int sliding_window) {
  bool ok = true;
  if (causal) ok = qpos >= kpos;
  if (sliding_window >= 0) ok = ok && (qpos - kpos < sliding_window);
  return ok;
}

// Rows of a row block (or keys of a column block) one backward program
// owns: the whole block up to 64, else half of it, so that the tiles of a
// program at block 128 / hd 128 in fp32 fit in shared memory.
__host__ __device__ __forceinline__ int sub_rows(int block) {
  return block <= 64 ? block : block / 2;
}

// Copy `rows` rows of HD values from global memory (type T) into a shared
// fp32 tile with row stride HD + 1 (the padding keeps the 16 rows a warp
// reads at one column in 16 banks).
template <typename T, int HD>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int rows) {
  for (int idx = threadIdx.x; idx < rows * HD; idx += kThreads) {
    const int row = idx / HD;
    dst[row * (HD + 1) + idx - row * HD] = to_float(src[idx]);
  }
}

struct BwdParams {
  const void* q;        // (N, G, S, HD)
  const void* k;        // (N, Sk, HD)
  const void* v;        // (N, Sk, HD)
  const void* dout;     // (N, G, S, HD), the type of q
  const float* lse;     // (N, G, S)
  const float* delta;   // (N, G, S): rowsum(dO * O)
  const int* idx;       // dQ: col_idx (nrb, width); dK/dV: row_idx (ncb, width)
  const int* nidx;      // dQ: nvalid (nrb,); dK/dV: nvalid_t (ncb,)
  float* out0;          // dQ: dq (N, G, S, HD); dK/dV: dk (N, Sk, HD)
  float* out1;          // dK/dV: dv (N, Sk, HD)
  int N, G, S, Sk, nrb, ncb, width, block;
  int causal;
  int sliding_window;   // < 0: none
  int row0, col0;       // global block index of local row-block 0 / K block 0
  int depth;            // bf16 kernels: stages of the ring (1..kMaxDepth)
  int nwg;              // bf16 dQ: warpgroups a program, 0 for the default
  float scale;
};

}  // namespace spion

// One C entry point per kernel and dtype, so each file builds in its own
// nvcc. LAUNCH is spion::launch_dq<T> or spion::launch_dkv<T> (the scalar
// fp32 kernels, which ignore depth and nwg) or the bf16 launchers.
#define SPION_DEFINE_BWD_ENTRY(NAME, T, LAUNCH)                               \
  extern "C" int NAME(const void* q, const void* k, const void* v,            \
                      const void* dout, const void* lse, const void* delta,   \
                      const void* idx, const void* nidx, void* out0,          \
                      void* out1, int N, int G, int S, int Sk, int hd,        \
                      int nrb, int ncb, int width, int block, int causal,     \
                      int sliding_window, int row0, int col0, int depth,      \
                      int nwg, float scale, void* stream) {                   \
    spion::BwdParams p;                                                       \
    p.q = q;                                                                  \
    p.k = k;                                                                  \
    p.v = v;                                                                  \
    p.dout = dout;                                                            \
    p.lse = static_cast<const float*>(lse);                                   \
    p.delta = static_cast<const float*>(delta);                               \
    p.idx = static_cast<const int*>(idx);                                     \
    p.nidx = static_cast<const int*>(nidx);                                   \
    p.out0 = static_cast<float*>(out0);                                       \
    p.out1 = static_cast<float*>(out1);                                       \
    p.N = N;                                                                  \
    p.G = G;                                                                  \
    p.S = S;                                                                  \
    p.Sk = Sk;                                                                \
    p.nrb = nrb;                                                              \
    p.ncb = ncb;                                                              \
    p.width = width;                                                          \
    p.block = block;                                                          \
    p.causal = causal;                                                        \
    p.sliding_window = sliding_window;                                        \
    p.row0 = row0;                                                            \
    p.col0 = col0;                                                            \
    p.depth = depth;                                                          \
    p.nwg = nwg;                                                              \
    p.scale = scale;                                                          \
    return LAUNCH<T>(p, hd, static_cast<cudaStream_t>(stream));               \
  }

// Dispatch a runtime head dim to the template instantiation FN<T, HD>.
#define SPION_HD_SWITCH(FN, T, hd, ...)                                       \
  switch (hd) {                                                               \
    case 16: return FN<T, 16>(__VA_ARGS__);                                   \
    case 32: return FN<T, 32>(__VA_ARGS__);                                   \
    case 48: return FN<T, 48>(__VA_ARGS__);                                   \
    case 64: return FN<T, 64>(__VA_ARGS__);                                   \
    case 80: return FN<T, 80>(__VA_ARGS__);                                   \
    case 96: return FN<T, 96>(__VA_ARGS__);                                   \
    case 112: return FN<T, 112>(__VA_ARGS__);                                 \
    case 128: return FN<T, 128>(__VA_ARGS__);                                 \
    default: return (int)cudaErrorInvalidValue;                               \
  }
