// K2: exact INT8 score GEMM for Hopper (sm_90a).
//
// Replaces the TPU kernel `score_matmul_int` (body `_score_kernel`) in
// src/repro/kernels/score_matmul.py: q (b, dim) int8 x docs (n, dim) int8
// -> (b, n) int32 = q @ docs^T, exact (int32 accumulation).
//
// What bounds it on this card: at the paper's point (b=16, n=8192,
// dim=512) the docs are 4 MB, ~1.3 us of HBM time, and the 134 M int8
// multiply-adds are far below the dp4a or int8 tensor-core rate. So the
// kernel is memory- and launch-bound at this size; at n = 8192 the grid
// has n/128 = 64 blocks for 132 SMs. mma/wgmma int8 tiles are later work.
//
// Design (simple first): one thread per doc, 128 docs per block. The
// block stages up to QB query rows in shared memory once (as int32 words,
// QB*dim bytes <= 16 KB at dim 1024); grid.y walks chunks of QB queries.
// Each thread reads its doc row as 16-byte vectors and runs __dp4a over
// the four words of each vector against every staged query (the query
// words are warp-wide broadcasts). A ragged n is masked in the kernel.
// The caller guarantees dim % 16 == 0 and 16-byte-aligned rows.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

template <int QB>
__global__ void __launch_bounds__(kThreads)
score_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ docs,
             int32_t* __restrict__ out, int b, int dim, int n) {
  extern __shared__ int qs[];  // [QB][dim / 4] packed int8x4 words
  const int q0 = blockIdx.y * QB;
  const int nq = min(QB, b - q0);
  const int words = dim / 4;
  const int* qw = reinterpret_cast<const int*>(q);
  for (int i = threadIdx.x; i < QB * words; i += blockDim.x) {
    qs[i] = (i / words) < nq ? qw[(size_t)q0 * words + i] : 0;
  }
  __syncthreads();

  const int doc = blockIdx.x * blockDim.x + threadIdx.x;
  if (doc >= n) return;

  int acc[QB];
#pragma unroll
  for (int qi = 0; qi < QB; ++qi) acc[qi] = 0;

  const int4* row = reinterpret_cast<const int4*>(docs + (size_t)doc * dim);
  for (int v = 0; v < dim / 16; ++v) {
    const int4 d = __ldg(row + v);
#pragma unroll
    for (int qi = 0; qi < QB; ++qi) {
      const int* qrow = qs + qi * words + v * 4;
      int a = acc[qi];
      a = __dp4a(d.x, qrow[0], a);
      a = __dp4a(d.y, qrow[1], a);
      a = __dp4a(d.z, qrow[2], a);
      a = __dp4a(d.w, qrow[3], a);
      acc[qi] = a;
    }
  }
#pragma unroll
  for (int qi = 0; qi < QB; ++qi) {
    if (qi < nq) out[(size_t)(q0 + qi) * n + doc] = acc[qi];
  }
}

template <int QB>
void launch(const int8_t* q, const int8_t* d, int32_t* out, int b, int dim, int n,
            cudaStream_t stream) {
  dim3 grid((n + kThreads - 1) / kThreads, (b + QB - 1) / QB);
  size_t smem = (size_t)QB * dim;
  score_kernel<QB><<<grid, kThreads, smem, stream>>>(q, d, out, b, dim, n);
}

}  // namespace

// C entry point. Pointers are device pointers; returns cudaGetLastError()
// (or cudaErrorInvalidValue for shapes the kernel does not take).
extern "C" int score_matmul_launch(const void* q, const void* docs, void* out,
                                   int b, int dim, int n, void* stream) {
  // dim <= 3072 keeps the staged queries within 48 KB of shared memory
  if (b < 1 || n < 1 || dim < 16 || dim % 16 != 0 || dim > 3072) {
    return (int)cudaErrorInvalidValue;
  }
  auto qq = static_cast<const int8_t*>(q);
  auto dd = static_cast<const int8_t*>(docs);
  auto o = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (b <= 1) launch<1>(qq, dd, o, b, dim, n, s);
  else if (b <= 2) launch<2>(qq, dd, o, b, dim, n, s);
  else if (b <= 4) launch<4>(qq, dd, o, b, dim, n, s);
  else if (b <= 8) launch<8>(qq, dd, o, b, dim, n, s);
  else launch<16>(qq, dd, o, b, dim, n, s);
  return (int)cudaGetLastError();
}
