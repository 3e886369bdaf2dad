// K4: per-block top-k (a DIRC-RAG core's local comparator) and the cores'
// global comparator, for Hopper (sm_90a).
//
// Replaces the TPU kernel `blockwise_topk` (body `_topk_kernel`) in
// src/repro/kernels/topk_select.py: scores (rows, n) fp32, n = nb * block_n
// -> vals (rows, nb, k) fp32 and block-local idx (rows, nb, k) int32, the
// top k of each block in `jax.lax.top_k`'s order: value descending, lower
// index first among equal values. "Equal" is XLA's total order on floats,
// as `lax.top_k` applies it: +0.0 ranks above -0.0, -inf below every
// finite score. The second entry point, `hierarchical_select_launch`,
// adds the global comparator of `core/topk.hierarchical_topk` (paper Fig.
// 3a): each core's local top-k, then the top k of the cores' candidates,
// in one launch.
//
// What bounds it on this card: bytes. It reads each score once and writes
// k pairs per block: 265 KB at the monolithic search (8 x 8192 scores,
// blocks of 512, k 3), 0.079 us at 3.35 TB/s, far under one launch
// (~2-4 us back to back). So the design aims at one launch per search
// (the local and the global comparator together) and a short dependent
// chain per selection round.
//
// Design. One warp per (row, block), the block read once into registers
// (16-byte loads, neighbouring lanes on neighbouring addresses, where the
// block starts 16-byte aligned; scalar loads otherwise): 4 / 8 / 16
// scores a lane for blocks up to 128 / 256 / 512. Larger blocks stream
// from global memory (L1) in every round instead. Each score becomes one
// 64-bit word: above, an unsigned key whose integer order is the total
// order above; below, the complement of its index. A larger word ranks
// first, so round j's winner is the largest word below round j-1's: each
// lane masks its words that do not rank after the last winner and takes
// the max over the rest (a tree, no chain through the slots), then two
// `redux.sync` give the warp's largest key and, among the lanes holding
// it, the largest low word. The key map is a bijection, so lane 0 writes
// the winner's float back from its key, -0.0 included. No shared memory
// and no barrier; a taken score is never written over, so no sentinel
// can come back (the TPU body masks with -3e38, which outranks -inf, and
// repeats an index in a block with fewer than k finite scores). Several
// warps share a CTA, each on its own (row, block).
//
// The fused entry runs one CTA per row: its warps select each core's kk =
// min(k, per) candidates into shared memory (index + core * per, the
// global id, in the word), then after one barrier warp 0 selects the top
// k of the n_cores * kk words: by (key desc, global id asc), from
// registers (two words a lane) up to 64 words, else from shared memory. That is the plain
// path's stable sort over the core-major candidate list, -inf slots
// included. It takes n_cores * kk <= kMaxCandidates (48 KB of shared
// memory; kk <= 384 at 16 cores); the wrapper composes the blockwise
// launch with a merge in PyTorch above that. NaN scores are outside the
// contract.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;              // (row, block) items per CTA, blockwise launch
constexpr int kCoreWarps = 16;         // warps per CTA (one row), fused launch
constexpr int kMaxCandidates = 6144;   // n_cores * kk: 8 bytes each in 48 KB

using u64 = unsigned long long;

// A float's rank in lax.top_k's order as an unsigned key: flip the sign
// bit of a non-negative float and every bit of a negative one. The map
// is a bijection, so the key gives the float back bit for bit.
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key ^ 0x80000000u) : ~key);
}

// An element as one 64-bit word: key above, the complement of its index
// below, so a larger word ranks first (higher value, then lower index).
// 0 is no element (it would be index 0xffffffff).
__device__ __forceinline__ u64 pack(unsigned key, int i) {
  return ((u64)key << 32) | (unsigned)~i;
}

// The word c if it ranks strictly after the previous winner, else 0.
__device__ __forceinline__ u64 eligible(u64 c, u64 prev) { return c < prev ? c : 0; }

__device__ __forceinline__ u64 max64(u64 a, u64 b) { return a > b ? a : b; }

// The warp's winner of a round from each lane's best eligible word: the
// largest key by `redux.sync`, then among the lanes holding it the largest
// low word (the lowest index).
__device__ __forceinline__ u64 warp_max(u64 best) {
  const unsigned hi = __reduce_max_sync(kFull, (unsigned)(best >> 32));
  const unsigned lo = __reduce_max_sync(kFull, (unsigned)(best >> 32) == hi ? (unsigned)best : 0u);
  return ((u64)hi << 32) | lo;
}

// The largest of m[0 .. 2W), as a tree of depth log2(2W); W is a
// template argument so that every index is a constant and m stays in
// registers.
template <int W>
__device__ __forceinline__ u64 tree_max(u64* m) {
#pragma unroll
  for (int r = 0; r < W; ++r) m[r] = max64(m[r], m[r + W]);
  if constexpr (W > 1) {
    return tree_max<W / 2>(m);
  } else {
    return m[0];
  }
}

// One warp: the top k (1 <= k <= len) of the `len` scores at `s`, round
// j's winner handed to emit(j, word) (the same word on every lane).
// R > 0: the block in registers, R scores a lane (32 R >= len, R % 4 ==
// 0); lane l holds elements 128 c + 4 l + e, e < 4, and a round is a
// max tree over them. R == 0: elements l + 32 t streamed from global
// memory in every round.
template <int R, typename Emit>
__device__ __forceinline__ void warp_topk(const float* __restrict__ s, int len, int k,
                                          Emit emit) {
  const int lane = threadIdx.x & 31;
  u64 prev = ~0ull;   // before every element: all are eligible in round 0
  if constexpr (R == 0) {
    for (int j = 0; j < k; ++j) {
      u64 best = 0;
      for (int i = lane; i < len; i += 32) {
        best = max64(best, eligible(pack(order_key(__ldg(s + i)), i), prev));
      }
      prev = warp_max(best);
      emit(j, prev);
    }
  } else {
    u64 c[R];
    const bool vec = (reinterpret_cast<uintptr_t>(s) & 15) == 0 && (len & 3) == 0;
#pragma unroll
    for (int q = 0; q < R / 4; ++q) {
      const int i0 = 128 * q + 4 * lane;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (vec) {
        if (i0 < len) x = __ldg(reinterpret_cast<const float4*>(s + i0));
      } else {
        if (i0 < len) x.x = __ldg(s + i0);
        if (i0 + 1 < len) x.y = __ldg(s + i0 + 1);
        if (i0 + 2 < len) x.z = __ldg(s + i0 + 2);
        if (i0 + 3 < len) x.w = __ldg(s + i0 + 3);
      }
      const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        c[4 * q + e] = i0 + e < len ? pack(order_key(xs[e]), i0 + e) : 0;
      }
    }
    for (int j = 0; j < k; ++j) {
      u64 m[R];
#pragma unroll
      for (int r = 0; r < R; ++r) m[r] = eligible(c[r], prev);
      prev = warp_max(tree_max<R / 2>(m));
      emit(j, prev);
    }
  }
}

template <int R>
__global__ void __launch_bounds__(kWarps * 32)
blockwise_topk_kernel(const float* __restrict__ scores, float* __restrict__ vals,
                      int32_t* __restrict__ idx, int n, int block_n, int nb, int items, int k) {
  const int item = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (item >= items) return;   // whole warps leave; nothing below syncs the CTA
  const int row = item / nb;
  const int blk = item % nb;
  float* ov = vals + (size_t)item * k;
  int32_t* oi = idx + (size_t)item * k;
  const bool writer = (threadIdx.x & 31) == 0;
  warp_topk<R>(scores + (size_t)row * n + (size_t)blk * block_n, block_n, k,
               [&](int j, u64 w) {
                 if (writer) {
                   ov[j] = key_value((unsigned)(w >> 32));
                   oi[j] = ~(int)(unsigned)w;
                 }
               });
}

template <int R>
__global__ void __launch_bounds__(kCoreWarps * 32)
hierarchical_select_kernel(const float* __restrict__ scores, float* __restrict__ vals,
                           int32_t* __restrict__ ids, int n, int n_cores, int kk, int k) {
  extern __shared__ u64 cand[];   // n_cores * kk words, global ids in the low words
  const int per = n / n_cores;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const float* row = scores + (size_t)blockIdx.x * n;
  for (int core = warp; core < n_cores; core += n_warps) {
    u64* out = cand + core * kk;
    const int add = core * per;
    warp_topk<R>(row + (size_t)add, per, kk, [&](int j, u64 w) {
      if (lane == 0) out[j] = pack((unsigned)(w >> 32), ~(int)(unsigned)w + add);
    });
  }
  __syncthreads();
  if (warp != 0) return;
  // the global comparator over the candidates' words: (value, global id);
  // up to 64 words (16 cores at k <= 4) are held in registers, two a lane,
  // more are read from shared memory in every round
  const int m = n_cores * kk;
  const bool in_regs = m <= 64;
  const u64 c0 = in_regs && lane < m ? cand[lane] : 0;
  const u64 c1 = in_regs && lane + 32 < m ? cand[lane + 32] : 0;
  const size_t out0 = (size_t)blockIdx.x * k;
  u64 prev = ~0ull;
  for (int j = 0; j < k; ++j) {
    u64 best = max64(eligible(c0, prev), eligible(c1, prev));
    if (!in_regs) {
      for (int c = lane; c < m; c += 32) best = max64(best, eligible(cand[c], prev));
    }
    prev = warp_max(best);
    if (lane == 0) {
      vals[out0 + j] = key_value((unsigned)(prev >> 32));
      ids[out0 + j] = ~(int)(unsigned)prev;
    }
  }
}

// Scores a lane holds for a block of `len` (0: streamed from global memory).
int regs_for(int len) { return len <= 128 ? 4 : len <= 256 ? 8 : len <= 512 ? 16 : 0; }

template <int R>
void launch_blockwise(const float* s, float* v, int32_t* i, int n, int block_n, int nb,
                      int items, int k, cudaStream_t st) {
  const int grid = (items - 1) / kWarps + 1;   // items + kWarps - 1 may pass INT_MAX
  blockwise_topk_kernel<R><<<grid, kWarps * 32, 0, st>>>(s, v, i, n, block_n, nb, items, k);
}

template <int R>
void launch_hierarchical(const float* s, float* v, int32_t* i, int rows, int n, int n_cores,
                         int kk, int k, cudaStream_t st) {
  const int warps = n_cores < kCoreWarps ? n_cores : kCoreWarps;
  const size_t smem = (size_t)n_cores * kk * sizeof(u64);
  hierarchical_select_kernel<R><<<rows, warps * 32, smem, st>>>(s, v, i, n, n_cores, kk, k);
}

}  // namespace

// C entry points. Pointers are device pointers; each returns
// cudaGetLastError() (or cudaErrorInvalidValue for shapes it does not take).

// Per-block top-k: vals / idx (rows, n / block_n, k).
extern "C" int topk_select_launch(const void* scores, void* vals, void* idx, int rows, int n,
                                  int block_n, int k, void* stream) {
  if (rows < 1 || block_n < 1 || n < block_n || n % block_n != 0 || k < 1 ||
      k > block_n) {
    return (int)cudaErrorInvalidValue;
  }
  const int nb = n / block_n;
  if ((long long)rows * nb > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const auto* s = static_cast<const float*>(scores);
  auto* v = static_cast<float*>(vals);
  auto* i = static_cast<int32_t*>(idx);
  const auto st = static_cast<cudaStream_t>(stream);
  const int items = rows * nb;
  switch (regs_for(block_n)) {
    case 4: launch_blockwise<4>(s, v, i, n, block_n, nb, items, k, st); break;
    case 8: launch_blockwise<8>(s, v, i, n, block_n, nb, items, k, st); break;
    case 16: launch_blockwise<16>(s, v, i, n, block_n, nb, items, k, st); break;
    default: launch_blockwise<0>(s, v, i, n, block_n, nb, items, k, st); break;
  }
  return (int)cudaGetLastError();
}

// Local top-kk of each of n_cores cores (n / n_cores scores each), then
// the global top k of their candidates: vals / ids (rows, k), ids global.
extern "C" int hierarchical_select_launch(const void* scores, void* vals, void* ids, int rows,
                                          int n, int n_cores, int kk, int k, void* stream) {
  if (rows < 1 || n_cores < 1 || n < n_cores || n % n_cores != 0 || kk < 1 ||
      kk > n / n_cores || k < 1 || (long long)n_cores * kk > kMaxCandidates ||
      k > n_cores * kk) {
    return (int)cudaErrorInvalidValue;
  }
  const auto* s = static_cast<const float*>(scores);
  auto* v = static_cast<float*>(vals);
  auto* i = static_cast<int32_t*>(ids);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (regs_for(n / n_cores)) {
    case 4: launch_hierarchical<4>(s, v, i, rows, n, n_cores, kk, k, st); break;
    case 8: launch_hierarchical<8>(s, v, i, rows, n, n_cores, kk, k, st); break;
    case 16: launch_hierarchical<16>(s, v, i, rows, n, n_cores, kk, k, st); break;
    default: launch_hierarchical<0>(s, v, i, rows, n, n_cores, kk, k, st); break;
  }
  return (int)cudaGetLastError();
}
