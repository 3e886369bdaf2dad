// K1: DIRC bit-serial bit-plane MAC for Hopper (sm_90a).
//
// Replaces the TPU kernel `dirc_mac_packed` (body `_dirc_mac_kernel`) in
// src/repro/kernels/dirc_mac.py. Same function and layouts:
//   q_planes (b, bits, nw) uint32   query bit-planes (query-stationary)
//   d_planes (bits, nw, n) uint32   doc bit-planes, docs on the fast axis
//   out      (b, n)        int32
//   out[b,n] = sum_bq sum_bd w(bq) w(bd) popcount(Q[b,bq,:] & D[bd,:,n]),
//   w(i) = 2^i, the sign plane (i = bits-1) weighted negative.
//
// What bounds it on this card: the work is b*n*nw*bits*bits AND+POPC
// pairs. At the paper's point (b=16, n=8192, dim=512, bits=8) that is
// ~134 M pairs; 32-bit popcount issues at 16/clk/SM on cc 9.0, so the
// popcount pipe needs ~30 us while the 4 MB of doc planes take ~1.3 us
// of HBM time. The kernel is bound by popcount issue, not by memory —
// once the card is full: at n = 8192 this grid has only n/256 = 32 blocks
// for 132 SMs, so more blocks per query batch is the next step.
//
// Design (simple first): one thread per doc, 256 docs per block, so a
// warp reads 32 neighbouring doc words (coalesced). Each block stages the
// planes of up to QB queries in shared memory once (<= 16*8*32*4 B =
// 16 KB); grid.y walks chunks of QB queries. Loops bd -> w -> bq -> query,
// the query words are warp-wide broadcasts from shared memory, and the
// per-query sums live in registers in int32 (|dot| <= 2^24 at dim 1024).
// A ragged n is masked in the kernel: no padding is needed.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int QB, int BITS>
__global__ void __launch_bounds__(kThreads)
dirc_mac_kernel(const uint32_t* __restrict__ qp, const uint32_t* __restrict__ dp,
                int32_t* __restrict__ out, int b, int nw, int n) {
  extern __shared__ uint32_t qs[];  // [QB][BITS][nw]
  const int q0 = blockIdx.y * QB;
  const int nq = min(QB, b - q0);
  const int per_query = BITS * nw;
  for (int i = threadIdx.x; i < QB * per_query; i += blockDim.x) {
    qs[i] = (i / per_query) < nq ? qp[(size_t)q0 * per_query + i] : 0u;
  }
  __syncthreads();

  const int doc = blockIdx.x * blockDim.x + threadIdx.x;
  if (doc >= n) return;

  int acc[QB];
#pragma unroll
  for (int qi = 0; qi < QB; ++qi) acc[qi] = 0;

#pragma unroll
  for (int bd = 0; bd < BITS; ++bd) {
    const int wd = (bd == BITS - 1) ? -(1 << bd) : (1 << bd);
    int part[QB];
#pragma unroll
    for (int qi = 0; qi < QB; ++qi) part[qi] = 0;
    for (int w = 0; w < nw; ++w) {
      const uint32_t d = __ldg(dp + ((size_t)bd * nw + w) * n + doc);
#pragma unroll
      for (int bq = 0; bq < BITS; ++bq) {
        const int wq = (bq == BITS - 1) ? -(1 << bq) : (1 << bq);
#pragma unroll
        for (int qi = 0; qi < QB; ++qi) {
          part[qi] += wq * __popc(qs[(qi * BITS + bq) * nw + w] & d);
        }
      }
    }
#pragma unroll
    for (int qi = 0; qi < QB; ++qi) acc[qi] += wd * part[qi];
  }
#pragma unroll
  for (int qi = 0; qi < QB; ++qi) {
    if (qi < nq) out[(size_t)(q0 + qi) * n + doc] = acc[qi];
  }
}

template <int QB, int BITS>
void launch(const uint32_t* qp, const uint32_t* dp, int32_t* out, int b, int nw,
            int n, cudaStream_t stream) {
  dim3 grid((n + kThreads - 1) / kThreads, (b + QB - 1) / QB);
  size_t smem = (size_t)QB * BITS * nw * sizeof(uint32_t);
  dirc_mac_kernel<QB, BITS><<<grid, kThreads, smem, stream>>>(qp, dp, out, b, nw, n);
}

template <int BITS>
void dispatch_qb(const uint32_t* qp, const uint32_t* dp, int32_t* out, int b,
                 int nw, int n, cudaStream_t s) {
  if (b <= 1) launch<1, BITS>(qp, dp, out, b, nw, n, s);
  else if (b <= 2) launch<2, BITS>(qp, dp, out, b, nw, n, s);
  else if (b <= 4) launch<4, BITS>(qp, dp, out, b, nw, n, s);
  else if (b <= 8) launch<8, BITS>(qp, dp, out, b, nw, n, s);
  else launch<16, BITS>(qp, dp, out, b, nw, n, s);
}

}  // namespace

// C entry point. Pointers are device pointers; returns cudaGetLastError()
// (or cudaErrorInvalidValue for shapes the kernel does not take).
extern "C" int dirc_mac_launch(const void* q_planes, const void* d_planes,
                               void* out, int b, int bits, int nw, int n,
                               void* stream) {
  // nw <= 96 keeps the staged query planes within 48 KB of shared memory
  if (b < 1 || n < 1 || nw < 1 || nw > 96 || (bits != 4 && bits != 8)) {
    return (int)cudaErrorInvalidValue;
  }
  auto qp = static_cast<const uint32_t*>(q_planes);
  auto dp = static_cast<const uint32_t*>(d_planes);
  auto o = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (bits == 8) dispatch_qb<8>(qp, dp, o, b, nw, n, s);
  else dispatch_qb<4>(qp, dp, o, b, nw, n, s);
  return (int)cudaGetLastError();
}
