// K4: per-block top-k (a DIRC-RAG core's local comparator) for Hopper (sm_90a).
//
// Replaces the TPU kernel `blockwise_topk` (body `_topk_kernel`) in
// src/repro/kernels/topk_select.py: scores (rows, n) fp32, n = nb * block_n
// -> vals (rows, nb, k) fp32 and block-local idx (rows, nb, k) int32, the
// top k of each block in the order "value descending, lower index first
// among equal values" (`jax.lax.top_k`'s order).
//
// What bounds it on this card: it reads each score once and writes k
// pairs per block, so at the main path's shapes (8 x 8192 scores, 256 KB;
// 32 x 2048 for four macros) its bytes take well under a microsecond. The
// k passes of compare-and-reduce are a few hundred operations per score
// at most. Launch latency dominates.
//
// Design (simple first): one block of threads per (row, score block).
// Pass j picks the best element strictly after pass j-1's winner in that
// order: each thread scans a strided slice of the block, a warp-shuffle
// and then a shared-memory reduction across warps find the winner, and
// thread 0 writes it. The scores are never written, so no mask is kept.
// The TPU body instead overwrites a taken score with -3e38, which ranks
// above -inf: copied as is, it would return a taken index again in any
// block holding fewer than k scores above -inf. Here the order, not a
// sentinel, excludes what was taken, so any block_n and any k <= block_n
// work, -inf included. NaN scores are outside the contract.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kNone = 0x7fffffff;   // "no candidate" index

// (v1, i1) ranks before (v2, i2); an index of kNone is no candidate.
__device__ __forceinline__ bool better(float v1, int i1, float v2, int i2) {
  if (i1 == kNone) return false;
  if (i2 == kNone) return true;
  return v1 > v2 || (v1 == v2 && i1 < i2);
}

__global__ void __launch_bounds__(kThreads)
topk_kernel(const float* __restrict__ scores, float* __restrict__ vals,
            int32_t* __restrict__ idx, int n, int block_n, int nb, int k) {
  __shared__ float warp_v[kWarps];
  __shared__ int warp_i[kWarps];
  __shared__ float win_v;
  __shared__ int win_i;

  const int row = blockIdx.x / nb;
  const int blk = blockIdx.x % nb;
  const float* s = scores + (size_t)row * n + (size_t)blk * block_n;
  const size_t out0 = ((size_t)row * nb + blk) * k;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float prev_v = 0.f;
  int prev_i = -1;                  // -1: no pass yet, every element eligible
  for (int j = 0; j < k; ++j) {
    float bv = 0.f;
    int bi = kNone;
    for (int i = threadIdx.x; i < block_n; i += kThreads) {
      const float v = __ldg(s + i);
      // eligible: strictly after the previous winner in the order
      const bool after = prev_i < 0 || v < prev_v || (v == prev_v && i > prev_i);
      if (after && better(v, i, bv, bi)) {
        bv = v;
        bi = i;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      warp_v[warp] = bv;
      warp_i[warp] = bi;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < kWarps; ++w) {
        if (better(warp_v[w], warp_i[w], bv, bi)) {
          bv = warp_v[w];
          bi = warp_i[w];
        }
      }
      vals[out0 + j] = bv;
      idx[out0 + j] = bi;
      win_v = bv;
      win_i = bi;
    }
    __syncthreads();
    prev_v = win_v;
    prev_i = win_i;
  }
}

}  // namespace

// C entry point. Pointers are device pointers; returns cudaGetLastError()
// (or cudaErrorInvalidValue for shapes the kernel does not take).
extern "C" int topk_select_launch(const void* scores, void* vals, void* idx,
                                  int rows, int n, int block_n, int k,
                                  void* stream) {
  if (rows < 1 || block_n < 1 || n < block_n || n % block_n != 0 || k < 1 ||
      k > block_n) {
    return (int)cudaErrorInvalidValue;
  }
  const int nb = n / block_n;
  if ((long long)rows * nb > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  topk_kernel<<<rows * nb, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scores), static_cast<float*>(vals),
      static_cast<int32_t*>(idx), n, block_n, nb, k);
  return (int)cudaGetLastError();
}
