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
// What bounds it on this card (NVIDIA H100 80GB HBM3, 700.00 W; data-sheet
// rates). The popcount form does b*n*nw*bits^2 AND+POPC pairs: at b 8, n
// 8192, dim 512, bits 8 that is 67.1 M, and at 16 popcounts / clk / SM (cc
// 9.0) x 132 SMs x ~1.98 GHz its issue bound is ~16 us, twice the 7.5 us
// that one `torch._int_mm` call took for the same scores on that card
// (PERF.md). The bytes are 4.2 MB of doc planes: 1.25 us at 3.35 TB/s. So
// this kernel does not popcount. Every bit pattern of the planes is a valid
// two's-complement code (sensed flips included), and the weighted popcount
// sum is exactly the int32 dot product of the codes the planes encode. So
// the kernel decodes the planes to int8 codes and multiplies them on the
// int8 tensor cores, exact in int32 (|dot| <= 1024 * 128^2 < 2^31 at dim
// 1024; nw is refused above 96).
//
// Design: one block of 256 threads per 32 docs (n 8192 gives 256 blocks
// for 132 SMs) and up to 32 queries (grid.y walks query chunks). Per chunk
// of 16 plane words (512 dims): each thread loads the planes of one doc
// for two words (neighbouring threads read neighbouring docs: coalesced),
// and the query planes of the chunk are decoded while those loads are in
// flight. A word's 8 planes become 32 int8 codes by an 8 x 8 bit-matrix
// transpose of each byte lane: three shift-mask (delta swap) steps over
// the 8 words, 12 swaps in all, no loop per bit; for bits 4 the sign plane
// fills planes 4-7, which sign-extends.
// The transpose leaves the codes of a word in the dim order x, 8+x, 16+x,
// 24+x in its word x; queries and docs take the same permutation and a dot
// product does not depend on the order of its terms, so nothing reorders
// them. Codes go to shared memory in rows padded to an odd number of
// 16-byte units, so ldmatrix reads them without bank conflicts. Each
// 32-dim word is one mma.sync.m16n8k32.s8.s8.s32 k-step with docs as the
// 16-row operand and queries as the 8-column operand. Four warps share the
// products: doc tiles x query-tile groups, and when there are fewer query
// tiles than groups the spare groups take a share of the k-steps and the
// partial sums meet in shared memory at the end; each warp keeps two
// accumulator chains so back-to-back mma do not wait on each other. A
// ragged n is masked in the kernel.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;             // 8 warps: all load and decode, 4 multiply
constexpr int kDocs = 32;                 // docs per block
constexpr int kMTiles = kDocs / 16;       // m16 doc tiles per block
constexpr int kMmaWarps = 4;              // warps that run the products
constexpr int kGroups = kMmaWarps / kMTiles;   // warps per doc tile
constexpr int kWords = 16;                // plane words (32 dims each) per chunk
constexpr int kRow = kWords * 32 + 16;    // staged code row, bytes (33 x 16)
constexpr int kParts = kThreads / kDocs;  // threads per doc
static_assert(kMTiles * kGroups == kMmaWarps && kWords % kParts == 0, "tile shape");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A delta swap between rows a and b of the bit matrix: the bits of a at
// mask << s trade places with the bits of b at mask.
__device__ __forceinline__ void swap_rows(uint32_t& a, uint32_t& b, int s, uint32_t mask) {
  const uint32_t t = ((a >> s) ^ b) & mask;
  b ^= t;
  a ^= t << s;
}

// 8 plane words (bit j of P[b] = bit b of the code of dim j) -> 8 words of
// codes in place: byte y of P[x] becomes the code of dim 8y + x (each byte
// lane is an 8 x 8 bit matrix, rows = planes, transposed in three steps).
__device__ __forceinline__ void decode_word(uint32_t (&P)[8]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) swap_rows(P[r], P[r + 4], 4, 0x0F0F0F0Fu);
  swap_rows(P[0], P[2], 2, 0x33333333u);
  swap_rows(P[1], P[3], 2, 0x33333333u);
  swap_rows(P[4], P[6], 2, 0x33333333u);
  swap_rows(P[5], P[7], 2, 0x33333333u);
#pragma unroll
  for (int r = 0; r < 8; r += 2) swap_rows(P[r], P[r + 1], 1, 0x55555555u);
}

// The planes of one 32-dim word, `stride` words apart, sign-extended to 8.
template <int BITS>
__device__ __forceinline__ void load_planes(uint32_t (&P)[8], const uint32_t* src,
                                            size_t stride, bool ok) {
#pragma unroll
  for (int b = 0; b < BITS; ++b) P[b] = ok ? __ldg(src + b * stride) : 0u;
#pragma unroll
  for (int b = BITS; b < 8; ++b) P[b] = P[BITS - 1];
}

__device__ __forceinline__ void store_codes(uint8_t* dst, const uint32_t (&c)[8]) {
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(c[0], c[1], c[2], c[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(c[4], c[5], c[6], c[7]);
}

// How the kMmaWarps warps share the products for NQ query tiles: NG
// query-tile groups, KS parts of the k-steps, NT query tiles per warp.
template <int NQ>
struct Split {
  static constexpr int KS = NQ >= kGroups ? 1 : kGroups / NQ;
  static constexpr int NG = kGroups / KS;
  static constexpr int NT = (NQ + NG - 1) / NG;
};

// One m16n8k32 k-step (32 dims) of the warp's query tiles into `acc`.
template <int NQ>
__device__ __forceinline__ void mma_step(int (&acc)[Split<NQ>::NT][4], uint32_t a_base,
                                         uint32_t b_base, int ks, int ng) {
  constexpr int NG = Split<NQ>::NG, NT = Split<NQ>::NT;
  uint32_t a[4];
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(a_base + ks * 32));
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const int nt = ng + NG * i;
    if (nt >= NQ) break;
    uint32_t b0, b1;
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
                 : "=r"(b0), "=r"(b1)
                 : "r"(b_base + nt * 8 * kRow + ks * 32));
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(acc[i][0]), "+r"(acc[i][1]), "+r"(acc[i][2]), "+r"(acc[i][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

template <int BITS, int NQ>
__global__ void __launch_bounds__(kThreads)
dirc_mac_kernel(const uint32_t* __restrict__ qp, const uint32_t* __restrict__ dp,
                int32_t* __restrict__ out, int b, int nw, int n) {
  constexpr int QB = 8 * NQ;                 // queries per block
  constexpr int KS = Split<NQ>::KS, NG = Split<NQ>::NG, NT = Split<NQ>::NT;
  static_assert((KS - 1) * kMTiles * NG * NT * 32 * 4 * 4 <= QB * kRow, "reduce space");
  __shared__ __align__(16) uint8_t dcode[kDocs * kRow];
  __shared__ __align__(16) uint8_t qcode[QB * kRow];
  const int n0 = blockIdx.x * kDocs, q0 = blockIdx.y * QB;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool mma_warp = warp < kMmaWarps;
  const int mtile = warp % kMTiles, grp = warp / kMTiles;   // grp < kGroups on mma warps
  const int ng = grp % NG, kp = grp / NG;                   // query-tile group, k part
  const int mi = lane >> 3, rr = lane & 7;
  const uint32_t a_base =
      smem_u32(dcode) + (mtile * 16 + rr + (mi & 1) * 8) * kRow + (mi >> 1) * 16;
  const uint32_t b_base = smem_u32(qcode) + rr * kRow + (mi & 1) * 16;
  int acc[NT][4], acc2[NT][4];   // two chains: alternate k-steps
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = acc2[i][e] = 0;

  const int d = tid % kDocs, part = tid / kDocs;
  const int doc = n0 + d;
  for (int w0 = 0; w0 < nw; w0 += kWords) {
    const int kw = min(kWords, nw - w0);
    // 1. issue the doc tile's plane loads: this thread's doc, words part,
    //    part + kParts, ...; they land while the queries decode
    uint32_t P[kWords / kParts][8];
#pragma unroll
    for (int k = 0; k < kWords / kParts; ++k) {
      const int wi = part + kParts * k;
      load_planes<BITS>(P[k], dp + (size_t)(w0 + wi) * n + doc, (size_t)nw * n,
                        wi < kw && doc < n);
    }
    // 2. the query tile
    for (int idx = tid; idx < QB * kWords; idx += kThreads) {
      const int qi = idx / kWords, wi = idx % kWords;
      uint32_t Q[8];
      load_planes<BITS>(Q, qp + (size_t)(q0 + qi) * BITS * nw + w0 + wi, (size_t)nw,
                        q0 + qi < b && wi < kw);
      decode_word(Q);
      store_codes(qcode + qi * kRow + wi * 32, Q);
    }
    // 3. decode the doc tile
#pragma unroll
    for (int k = 0; k < kWords / kParts; ++k) {
      decode_word(P[k]);
      store_codes(dcode + d * kRow + (part + kParts * k) * 32, P[k]);
    }
    __syncthreads();
    // 4. one m16n8k32 k-step per plane word; k part kp takes k-steps kp,
    //    kp + KS, ...
    if (mma_warp) {
      for (int ks = kp; ks < kw; ks += 2 * KS) {
        mma_step<NQ>(acc, a_base, b_base, ks, ng);
        if (ks + KS < kw) mma_step<NQ>(acc2, a_base, b_base, ks + KS, ng);
      }
    }
    __syncthreads();
  }
  // 5. out: c0, c1 at doc row g, queries 2*tig, 2*tig+1; c2, c3 at doc g + 8
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] += acc2[i][e];
  if (KS > 1) {   // the k parts meet: parts 1.. hand their sums to part 0
    int* red = reinterpret_cast<int*>(qcode);   // [KS-1][kMTiles][NG][NT][32][4]
    auto slot = [&](int part_, int i, int e) {
      return ((((part_ - 1) * kMTiles + mtile) * NG + ng) * NT + i) * 128 + lane * 4 + e;
    };
    if (mma_warp && kp > 0) {
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) red[slot(kp, i, e)] = acc[i][e];
    }
    __syncthreads();
    if (mma_warp && kp == 0) {
      for (int p2 = 1; p2 < KS; ++p2)
#pragma unroll
        for (int i = 0; i < NT; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][e] += red[slot(p2, i, e)];
    }
  }
  if (!mma_warp || kp != 0) return;
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const int nt = ng + NG * i;
    if (nt >= NQ) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int dn = n0 + mtile * 16 + g + 8 * (e >> 1);
      const int qn = q0 + nt * 8 + 2 * tig + (e & 1);
      if (dn < n && qn < b) out[(size_t)qn * n + dn] = acc[i][e];
    }
  }
}

template <int BITS, int NQ>
void launch(const uint32_t* qp, const uint32_t* dp, int32_t* out, int b, int nw, int n,
            cudaStream_t stream) {
  const dim3 grid((n + kDocs - 1) / kDocs, (b + 8 * NQ - 1) / (8 * NQ));
  dirc_mac_kernel<BITS, NQ><<<grid, kThreads, 0, stream>>>(qp, dp, out, b, nw, n);
}

template <int BITS>
void dispatch_nq(const uint32_t* qp, const uint32_t* dp, int32_t* out, int b, int nw, int n,
                 cudaStream_t s) {
  if (b <= 8) launch<BITS, 1>(qp, dp, out, b, nw, n, s);
  else if (b <= 16) launch<BITS, 2>(qp, dp, out, b, nw, n, s);
  else launch<BITS, 4>(qp, dp, out, b, nw, n, s);
}

}  // namespace

// C entry point. Pointers are device pointers; returns cudaGetLastError()
// (or cudaErrorInvalidValue for shapes the kernel does not take).
extern "C" int dirc_mac_launch(const void* q_planes, const void* d_planes,
                               void* out, int b, int bits, int nw, int n,
                               void* stream) {
  // nw <= 96 (dim <= 3072) keeps |dot| <= 3072 * 128^2 far inside int32
  if (b < 1 || n < 1 || nw < 1 || nw > 96 || (bits != 4 && bits != 8) ||
      (b + 31) / 32 > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  auto qp = static_cast<const uint32_t*>(q_planes);
  auto dp = static_cast<const uint32_t*>(d_planes);
  auto o = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (bits == 8) dispatch_nq<8>(qp, dp, o, b, nw, n, s);
  else dispatch_nq<4>(qp, dp, o, b, nw, n, s);
  return (int)cudaGetLastError();
}
