// K2: exact INT8 score GEMM, and K5: the same GEMM with a fused cosine
// epilogue, for Hopper (sm_90a). One kernel body, templated on the
// epilogue; two C entry points; one device kernel per call.
//
// K2 replaces the TPU kernel `score_matmul_int` (body `_score_kernel`) in
// src/repro/kernels/score_matmul.py: q (b, dim) int8 x docs (n, dim) int8
// -> (b, n) int32 = q @ docs^T, exact (int32 accumulation).
// K5 replaces `score_matmul_cosine` (body `_score_cosine_kernel`) in the
// same file: the same product, then out = float(ip) / max(qn[b] * dn[n],
// 1e-12) in fp32 with IEEE division (`__fdiv_rn`; the build passes no
// fast-math flag). The TPU kernel takes the dot in fp32 from int8 values;
// float(ip) equals it while |ip| <= 2^24, which holds for dim <= 1024 (the
// range its docstring states: 1024 * 128 * 128 = 2^24).
//
// What bounds them on this card (NVIDIA H100 80GB HBM3, 700.00 W;
// data-sheet rates), at the main shape b 8, n 8192, dim 512: the bytes.
// The docs are 4.19 MB, 1.33 us at 3.35 TB/s; the 33.5 M multiply-adds
// (67 M int8 operations) take 0.03 us at 1,979 int8 TOPS. Above both sits
// the single-launch floor of CUDA-event timing, ~6-7 us (ROADMAP T17),
// which no kernel design removes: chip_smoke.py also times 50 launches
// back to back. So what counts is how soon every doc byte is in flight,
// and that the product and the stores add little after the last arrives.
//
// Design, against each of those:
// - The whole card: one block of 256 threads (8 warps) per 64 docs, so n
//   8192 gives 128 blocks, one on each of 128 SMs. 32-doc blocks (256, two
//   per SM) measured slower at every shape tried
//   (tools/score_matmul_variants.py; PERF.md §6).
// - The bytes, read once: for b <= 64 every query sits in the block's
//   tile (template instances for b <= 8, <= 16 and <= 64), so grid.y is 1
//   and the corpus is read from device memory once per call. Only above
//   64 queries does grid.y walk chunks of 64 queries; a chunk skips the
//   query tiles that hold no query.
// - The bytes, in flight early and coalesced: the dim axis runs in
//   chunks of 128 through a ring of 5 stages in shared memory, filled by
//   cp.async of 16 bytes a thread; neighbouring threads take neighbouring
//   16-byte pieces of one row, so a warp reads whole 128-byte segments.
//   At dim 512 all 4 chunks are in flight before the first product. Each
//   stage holds the chunk of the 64 doc rows and of the block's query
//   rows, so every query byte is loaded once per block and the ring is
//   52-92 KB at any dim (dynamic shared memory, asked for at launch).
// - The product on the int8 tensor cores: each 32-dim k-step is one
//   mma.sync.m16n8k32.s8.s8.s32 with docs as the 16-row operand and
//   queries as the 8-column operand, fed by ldmatrix from rows padded to
//   an odd number of 16-byte units (144 bytes: no bank conflicts). Two
//   warps share each doc tile (see Tile). A warp reads the operands of all
//   its k-steps in a chunk before the products, so the ldmatrix latencies
//   overlap, and keeps two accumulator chains (as K1 does).
// - The stores: the sums are staged through shared memory, and each
//   query's row of 64 docs leaves as two coalesced 128-byte stores (docs
//   on the fast axis). K5 divides there; it reads its doc norm before the
//   main loop and the query norms beside the staged sums.
// - Edges: rows past n or b and bytes past dim are zero-filled by the
//   copies (cp.async with a source size of 0), so a dim that is not a
//   multiple of 32 runs its last k-step over zeros, and stores are masked.
// The caller guarantees dim % 16 == 0 and 16-byte-aligned q and docs.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 128;               // dims per ring stage
constexpr int kPieces = kChunk / 16;      // 16-byte pieces per staged row
constexpr int kRow = kChunk + 16;         // staged row, bytes (9 x 16: odd)
constexpr int kStages = 5;                // 4 chunks in flight ahead of the first product
constexpr int kMaxNQ = 8;                 // query tiles of 8 per block: b <= 64

// The block's tile for NQ query tiles of 8: QB queries x DOCS docs, two
// warps per m16 doc tile. The two warps of a doc tile share the products:
// NG query-tile groups, KS parts of the k-steps, NT query tiles per warp.
// Splitting the k-steps lets a warp reuse each doc fragment over all its
// query tiles; with 2 query tiles the warps take one each instead.
template <int NQ>
struct Tile {
  static constexpr int QB = 8 * NQ;
  static constexpr int DOCS = 64;
  static constexpr int MT = DOCS / 16;
  static constexpr int WARPS = 2 * MT;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int STAGE = (DOCS + QB) * kRow;   // ring stage, bytes
  static constexpr int SMEM = kStages * STAGE;
  static constexpr int OUT_ROW = DOCS + 4;           // epilogue row, int32 words
  static constexpr int ROWS = THREADS / DOCS;        // epilogue rows per pass
  static constexpr int PASSES = QB / ROWS;           // epilogue passes
  static constexpr int KS = NQ == 2 ? 1 : 2;
  static constexpr int NG = 2 / KS;
  static constexpr int NT = (NQ + NG - 1) / NG;
  static_assert(QB * OUT_ROW * 4 <= SMEM && QB % ROWS == 0, "epilogue tile");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; `bytes` 0 writes 16 zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// The operands of one m16n8k32 k-step (32 dims) for a warp: its doc tile
// (A) and its live query tiles (B), read from the staged rows by ldmatrix.
template <int NQ>
struct Frag {
  uint32_t a[4];
  uint32_t b[Tile<NQ>::NT][2];
};

template <int NQ>
__device__ __forceinline__ void load_frag(Frag<NQ>& f, uint32_t a_base, uint32_t b_base,
                                          int ks, int ng, int live_nt) {
  constexpr int NG = Tile<NQ>::NG, NT = Tile<NQ>::NT;
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(f.a[0]), "=r"(f.a[1]), "=r"(f.a[2]), "=r"(f.a[3])
               : "r"(a_base + ks * 32));
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const int nt = ng + NG * i;
    if (nt >= live_nt) break;
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
                 : "=r"(f.b[i][0]), "=r"(f.b[i][1])
                 : "r"(b_base + nt * 8 * kRow + ks * 32));
  }
}

template <int NQ>
__device__ __forceinline__ void mma_frag(int (&acc)[Tile<NQ>::NT][4], const Frag<NQ>& f,
                                         int ng, int live_nt) {
  constexpr int NG = Tile<NQ>::NG, NT = Tile<NQ>::NT;
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    if (ng + NG * i >= live_nt) break;
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(acc[i][0]), "+r"(acc[i][1]), "+r"(acc[i][2]), "+r"(acc[i][3])
        : "r"(f.a[0]), "r"(f.a[1]), "r"(f.a[2]), "r"(f.a[3]), "r"(f.b[i][0]),
          "r"(f.b[i][1]));
  }
}

// Issue the copies of one dim chunk (from dim c0) into a ring stage: the
// block's DOCS doc rows, then its first `qrows` query rows, kChunk bytes
// each; rows past n or b and bytes past dim are zero-filled.
template <int NQ>
__device__ __forceinline__ void load_chunk(uint8_t* stage, const int8_t* __restrict__ q,
                                           const int8_t* __restrict__ docs, int q0, int n0,
                                           int qrows, int b, int n, int dim, int c0) {
  constexpr int DOCS = Tile<NQ>::DOCS;
  const int kw = min(kChunk, dim - c0);
  for (int i = threadIdx.x; i < (DOCS + qrows) * kPieces; i += Tile<NQ>::THREADS) {
    const int r = i / kPieces, p = i % kPieces;
    const bool is_doc = r < DOCS;
    const int row = is_doc ? n0 + r : q0 + r - DOCS;
    const bool ok = row < (is_doc ? n : b) && p * 16 < kw;
    const int8_t* src = (is_doc ? docs : q) + (ok ? (size_t)row * dim + c0 + p * 16 : 0);
    cp_async16(smem_u32(stage + r * kRow + p * 16), src, ok ? 16 : 0);
  }
}

// COSINE: out is fp32 ip / max(qn * dn, 1e-12) (K5); else int32 ip (K2).
template <int NQ, bool COSINE>
__global__ void __launch_bounds__(Tile<NQ>::THREADS, 2)
score_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ docs,
             void* __restrict__ out, const float* __restrict__ qn,
             const float* __restrict__ dn, int b, int dim, int n) {
  using T = Tile<NQ>;
  constexpr int QB = T::QB, DOCS = T::DOCS, KS = T::KS, NG = T::NG, NT = T::NT;
  constexpr int KPW = kChunk / 32 / KS;             // k-steps per warp per chunk
  extern __shared__ __align__(16) uint8_t ring[];   // [kStages][DOCS + QB][kRow]
  const int n0 = blockIdx.x * DOCS, q0 = blockIdx.y * QB;
  const int live_nt = (min(QB, b - q0) + 7) / 8;    // query tiles holding a query
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mtile = warp % T::MT, grp = warp / T::MT;
  const int ng = grp % NG, kp = grp / NG;           // query-tile group, k part
  const int mi = lane >> 3, rr = lane & 7;
  const uint32_t a_off = (mtile * 16 + rr + (mi & 1) * 8) * kRow + (mi >> 1) * 16;
  const uint32_t b_off = (DOCS + rr) * kRow + (mi & 1) * 16;
  int acc[NT][4], acc2[NT][4];   // two chains: alternate k-steps
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = acc2[i][e] = 0;
  // the epilogue's cells: doc column `col`, query rows r0 + ROWS * j; K5
  // reads its doc norm now, while the copies are in flight
  const int col = threadIdx.x % DOCS, r0 = threadIdx.x / DOCS;
  const int doc = n0 + col;
  const float d_norm = COSINE && doc < n ? __ldg(dn + doc) : 0.0f;

  const int nc = (dim + kChunk - 1) / kChunk;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nc) {
      load_chunk<NQ>(ring + s * T::STAGE, q, docs, q0, n0, 8 * live_nt, b, n, dim,
                     s * kChunk);
    }
    cp_async_commit();
  }
  for (int c = 0; c < nc; ++c) {
    cp_async_wait<kStages - 2>();   // this thread's copies of chunk c have landed
    __syncthreads();                // everyone's; and chunk c-1's stage is free
    const int next = c + kStages - 1;
    if (next < nc) {
      load_chunk<NQ>(ring + (next % kStages) * T::STAGE, q, docs, q0, n0, 8 * live_nt, b,
                     n, dim, next * kChunk);
    }
    cp_async_commit();
    const uint32_t base = smem_u32(ring + (c % kStages) * T::STAGE);
    const int steps = (min(kChunk, dim - c * kChunk) + 31) / 32;
    // k part kp takes k-steps kp, kp + KS, ...: all their operands are
    // read first, so the ldmatrix latencies overlap, then the products
    // alternate between the two chains
    Frag<NQ> f[KPW];
#pragma unroll
    for (int j = 0; j < KPW; ++j) {
      const int ks = kp + KS * j;
      if (ks < steps) load_frag<NQ>(f[j], base + a_off, base + b_off, ks, ng, live_nt);
    }
#pragma unroll
    for (int j = 0; j < KPW; ++j) {
      if (kp + KS * j >= steps) break;
      if (j % 2) mma_frag<NQ>(acc2, f[j], ng, live_nt);
      else mma_frag<NQ>(acc, f[j], ng, live_nt);
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is free: it becomes the output tile

  // the sums into tile[query][doc]: c0, c1 at doc row g, queries 2*tig,
  // 2*tig+1; c2, c3 at doc g + 8. Rows of DOCS + 4 words: no conflicts.
  int* tile = reinterpret_cast<int*>(ring);
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int part = 0; part < KS; ++part) {
    if (kp == part) {
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        const int nt = ng + NG * i;
        if (nt >= live_nt) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          int* cell = tile + (nt * 8 + 2 * tig + (e & 1)) * T::OUT_ROW + mtile * 16 + g +
                      8 * (e >> 1);
          const int v = acc[i][e] + acc2[i][e];
          *cell = part == 0 ? v : *cell + v;
        }
      }
    }
    __syncthreads();
  }
  // stores along each query's row, docs on the fast axis: coalesced; all
  // of a thread's sums are read before the first store
  int v[T::PASSES];
  float q_norm[T::PASSES];
#pragma unroll
  for (int j = 0; j < T::PASSES; ++j) {
    const int qi = q0 + r0 + T::ROWS * j;
    v[j] = tile[(r0 + T::ROWS * j) * T::OUT_ROW + col];
    if constexpr (COSINE) q_norm[j] = qi < b ? __ldg(qn + qi) : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < T::PASSES; ++j) {
    const int qi = q0 + r0 + T::ROWS * j;
    if (qi >= b || doc >= n) break;
    const size_t o = (size_t)qi * n + doc;
    if constexpr (COSINE) {
      const float denom = fmaxf(q_norm[j] * d_norm, 1e-12f);
      static_cast<float*>(out)[o] = __fdiv_rn((float)v[j], denom);
    } else {
      static_cast<int32_t*>(out)[o] = v[j];
    }
  }
}

template <int NQ, bool COSINE>
int launch(const int8_t* q, const int8_t* d, void* out, const float* qn, const float* dn,
           int b, int dim, int n, cudaStream_t stream) {
  using T = Tile<NQ>;
  auto kernel = score_kernel<NQ, COSINE>;
  if (T::SMEM > 48 * 1024) {   // dynamic shared memory above 48 KB must be asked for
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((n + T::DOCS - 1) / T::DOCS, (b + T::QB - 1) / T::QB);
  kernel<<<grid, T::THREADS, T::SMEM, stream>>>(q, d, out, qn, dn, b, dim, n);
  return (int)cudaGetLastError();
}

template <bool COSINE>
int dispatch(const void* q, const void* docs, void* out, const void* qn,
             const void* dn, int b, int dim, int n, void* stream) {
  // the contract: dim % 16 == 0 up to 3072, 16-byte-aligned operands
  if (b < 1 || n < 1 || dim < 16 || dim % 16 != 0 || dim > 3072 ||
      (b + 8 * kMaxNQ - 1) / (8 * kMaxNQ) > 65535 ||
      reinterpret_cast<uintptr_t>(q) % 16 || reinterpret_cast<uintptr_t>(docs) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  auto qq = static_cast<const int8_t*>(q);
  auto dd = static_cast<const int8_t*>(docs);
  auto qf = static_cast<const float*>(qn);
  auto df = static_cast<const float*>(dn);
  auto s = static_cast<cudaStream_t>(stream);
  if (b <= 8) return launch<1, COSINE>(qq, dd, out, qf, df, b, dim, n, s);
  if (b <= 16) return launch<2, COSINE>(qq, dd, out, qf, df, b, dim, n, s);
  return launch<kMaxNQ, COSINE>(qq, dd, out, qf, df, b, dim, n, s);
}

}  // namespace

// C entry points. Pointers are device pointers; each returns
// cudaGetLastError() (or cudaErrorInvalidValue for shapes the kernel does
// not take).
extern "C" int score_matmul_launch(const void* q, const void* docs, void* out,
                                   int b, int dim, int n, void* stream) {
  return dispatch<false>(q, docs, out, nullptr, nullptr, b, dim, n, stream);
}

// q_norms (b,) and doc_norms (n,) fp32; out (b, n) fp32.
extern "C" int score_matmul_cosine_launch(const void* q, const void* docs,
                                          const void* q_norms,
                                          const void* doc_norms, void* out,
                                          int b, int dim, int n, void* stream) {
  return dispatch<true>(q, docs, out, q_norms, doc_norms, b, dim, n, stream);
}
