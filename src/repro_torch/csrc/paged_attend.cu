// K3: fused paged attention for Hopper (sm_90a). Two paths over the same
// function: for decode-shaped calls, the new-token KV scatter and split-KV
// flash-decoding over a block table (one launch), then the combine of the
// per-chunk partials (a second launch); for prefill-shaped bf16 calls, the
// scatter and one online-softmax pass per query tile (one launch, below).
//
// Replaces the TPU kernel `paged_attend_fused` (body `_paged_attend_kernel`)
// in src/repro/kernels/paged_attend.py, and the jnp combine that follows
// its `pallas_call`. Same function and layouts:
//   q      (b, t, h, hd)             post-RoPE queries
//   k_new  (b, t, kh, hd)            new K/V for positions length .. length+t-1
//   v_new  (b, t, kh, hd)
//   pools  (n_blocks, bs, kh, hd)    written in place (the scatter)
//   table  (b, mb) int32             columns >= mb read as NULL block 0
//   length, n_valid (b,) int32
//   acc    (b, nc, t, h, hd) fp32    per-chunk partials; nc = ceil(mb / cb)
//   m, den (b, nc, t, h) fp32
//   out    (b, t, h, hd)             in q's dtype (the combine)
// New token i < n_valid[b] goes to logical position length[b] + i; invalid
// lanes write nothing. Query i < n_valid[b] sees kv position p iff p <=
// length[b] + i; a query row past n_valid sees nothing and comes out 0
// (the caller ignores those rows). Rounding as the TPU kernel: fp32 scores
// and sums, p = exp(s - m_chunk) rounded to the pool dtype before P.V,
// fp32 partials, the output cast to q's dtype.
//
// What bounds it on this card (NVIDIA H100 80GB HBM3, 700.00 W; data-sheet
// rates): decode attention reads every visible K/V byte once and does 4 FLOP
// per (query head, position, dim): at b 8, ~300-token contexts and
// phi4-mini's 8 KV heads of 128 it moves ~9.4 MB per layer against ~0.03
// GFLOP, bytes-bound (2.8 us at 3.35 TB/s). A prefill piece (b 1, t 32 from
// 256) moves ~1.8 MB: 0.55 us. Neither has enough work to fill 132 SMs for
// long, so what the kernel can win is latency: parallel blocks, 16-byte
// asynchronous loads, tensor cores for the two small products, and no blocks
// or host ops that do nothing.
//
// Design:
//   * Grid (kh * row tiles, chunks, rows). A row tile is 16 or 32 of the
//     t * g query rows of one KV head (row r = token r / g, head r % g of
//     the group), so a 96-row prefill piece spreads over 3 blocks per
//     (head, chunk). Several blocks may thus read one chunk, so no block
//     reads a pool cell that this launch writes: staging takes positions
//     length .. length+n_valid-1 from k_new / v_new (the overlay of the
//     TPU body), the pool only below length. Row tile 0 alone scatters the
//     new tokens of its (chunk, head) slice; copy-on-write guarantees that
//     no live row writes a shared block.
//   * A block whose chunk holds no visible position (or whose row tile
//     holds no valid query) writes m = -1e30, den = 0 and returns before
//     staging; the combine skips such partials. The table is read as
//     given (no host-side padding to a chunk multiple).
//   * Staging: the chunk's visible K and V rows of the head (and, for
//     bf16, the tile's q rows) go to shared memory with 16-byte cp.async;
//     rows are padded by 16 bytes (an odd number of 16-byte units) so
//     ldmatrix is free of bank conflicts. Positions past the last valid
//     query's are never read, so a poisoned NULL block cannot leak in.
//   * bf16 body, tensor cores (one instance per head dim that is a
//     multiple of 16, up to 256): 4 warps = (row tile's m16 tiles) x
//     (position slices). Each warp computes S = Q.K^T with
//     mma.sync.m16n8k16 (bf16 -> fp32; fragments by ldmatrix), scales and
//     masks the fp32 scores, and takes row maxima with quad shuffles; the
//     maxima are merged across the slices in shared memory so every p is
//     exp(s - m) of the chunk's own max, as on the TPU. A second pass
//     recomputes S, forms p, sums den, rounds p to bf16 in registers and
//     reuses it as the A fragment of P.V (V through ldmatrix.trans). The
//     slices' den and acc are summed in shared memory.
//   * fp32 body (the tests' and the fp32 engine's pools; TF32 mma would
//     not hold their tolerance): the same grid, staging and early exit,
//     with one query row per warp on the CUDA cores (float4 reads).
//   * The combine: one warp per (b, t, h) row, out = sum_c acc_c a_c /
//     max(sum_c den_c a_c, 1e-30), a_c = exp(m_c - max_c m_c), skipping
//     fully masked chunks (whose acc is never written).
//
// The prefill body (`paged_attend_prefill_bf16_kernel`; the wrapper picks
// it when a bf16 call's full query tiles alone fill the card). A
// 2,048-token piece at phi4-mini's 24/8 heads of 128 from 2,048 cached
// positions needs 7.7e10 FLOP against ~35 MB: FLOP-bound (0.078 ms at
// 989 TFLOP/s), where the split path stages each chunk once per 32-row
// tile, computes the scores twice and round-trips fp32 partials.
//   * Grid: one block per (192-row query tile, KV head, batch row), the
//     tiles with the longest windows launched first. Three warpgroups of
//     64 rows each walk positions 0 .. length + (their last valid query)
//     in tiles of 64: a warpgroup stops at its own causal limit, only the
//     tiles past its first query's position are masked, and nothing past
//     the block's last query's is staged.
//   * Staging: all 384 threads load each K/V tile with 16-byte cp.async
//     into a 128-byte-swizzled layout (double-buffered: the next tile loads
//     while this one computes). Each position's source (its pool row, or
//     its row of k_new / v_new) is read from the table one tile ahead into
//     a ring in shared memory, so no table read delays a tile's loads.
//     Reusing each K/V tile for 192 query rows keeps the loads from L2
//     well under the compute time.
//   * wgmma (sm_90a): S (64 x 64) = Q.K^T with both operands read from
//     shared memory; a running row max and sum in fp32 (the accumulator
//     and the sum rescaled); p = exp(s - m) rounded to bf16 in registers
//     as the A operand of O += P.V, V read from shared memory transposed.
//     The max is running, not per 128-token chunk: the only difference
//     from the split path's rounding. Head dims below 128 (96) run as 128
//     with zero columns.
//   * out (b, t, h, hd) written in bf16 through each warp's own q rows in
//     shared memory (16-byte stores); rows past n_valid come out 0, and a
//     tile whose first row is past them writes its zeros and returns.
//   * The scatter: token i belongs to the tile that holds row i * g, so
//     exactly one block writes it; staging reads positions >= length from
//     k_new / v_new, the pool only below length (the overlay).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1.0e30f;
constexpr int kMaxSmem = 232448;     // 227 KB a block may use on sm_90

struct Args {
  const uint8_t* q;
  const uint8_t* k_new;
  const uint8_t* v_new;
  uint8_t* k_pool;
  uint8_t* v_pool;
  const int32_t* table;
  const int32_t* length;
  const int32_t* n_valid;
  float* acc;
  float* m;
  float* den;
  int t, h, kh, hd, bs, mb, cb, nc;
  int mt;     // m16 row tiles per block (1 or 2)
  int n_rt;   // row tiles per KV head
  float scale;
};

// The block's place in the grid and what it may see.
struct Tile {
  int kk, rt, j, bi, g, R, r0, r1, len, nv, c0, ct, n_vis;
  const int32_t* trow;
};

__device__ __forceinline__ Tile tile_of(const Args& a) {
  Tile T;
  T.kk = blockIdx.x / a.n_rt;
  T.rt = blockIdx.x % a.n_rt;
  T.j = blockIdx.y;
  T.bi = blockIdx.z;
  T.g = a.h / a.kh;
  T.R = a.t * T.g;
  T.r0 = T.rt * a.mt * 16;
  T.r1 = min(T.R, T.r0 + a.mt * 16);
  T.len = max(0, a.length[T.bi]);
  T.nv = min(a.t, max(0, a.n_valid[T.bi]));
  T.ct = a.cb * a.bs;
  T.c0 = T.j * T.ct;
  T.n_vis = max(0, min(T.ct, T.len + T.nv - T.c0));
  T.trow = a.table + (size_t)T.bi * a.mb;
  return T;
}

// Byte offset of the (position p, head kk) row in a pool.
__device__ __forceinline__ size_t pool_row(const Args& a, const Tile& T, int p, int esz) {
  const int lb = p / a.bs;
  const int blk = lb < a.mb ? T.trow[lb] : 0;
  return ((((size_t)blk * a.bs + p % a.bs) * a.kh + T.kk) * a.hd) * esz;
}

// Byte offset of new token i's row (head kk) in k_new / v_new.
__device__ __forceinline__ size_t new_row(const Args& a, const Tile& T, int i, int esz) {
  return ((((size_t)T.bi * a.t + i) * a.kh + T.kk) * a.hd) * esz;
}

// Index of query row r's partial in m / den (times hd: in acc).
__device__ __forceinline__ size_t part_idx(const Args& a, const Tile& T, int r) {
  const int i = r / T.g, hh = T.kk * T.g + r % T.g;
  return (((size_t)T.bi * a.nc + T.j) * a.t + i) * a.h + hh;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_none_pending() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Early exit, scatter and staging shared by both bodies. Returns false when
// the block has nothing to compute (its m / den are then written).
// ks / vs get rows 0 .. n_vis-1 of the chunk, `rs` bytes apart.
__device__ __forceinline__ bool scatter_and_stage(const Args& a, const Tile& T, int esz,
                                                  uint8_t* ks, uint8_t* vs, int rs) {
  if (T.n_vis == 0 || T.r0 >= T.nv * T.g) {
    for (int r = T.r0 + threadIdx.x; r < T.r1; r += kThreads) {
      const size_t pi = part_idx(a, T, r);
      a.m[pi] = kNegInf;
      a.den[pi] = 0.f;
    }
    return false;
  }
  const int U = a.hd * esz / 16;   // 16-byte units per row
  // the scatter of this (chunk, head) slice: row tile 0 only
  if (T.rt == 0) {
    const int p_lo = max(T.len, T.c0), p_hi = min(T.len + T.nv, T.c0 + T.ct);
    for (int idx = threadIdx.x; idx < (p_hi - p_lo) * U; idx += kThreads) {
      const int p = p_lo + idx / U, u = idx % U;
      const size_t dst = pool_row(a, T, p, esz) + 16 * u;
      const size_t src = new_row(a, T, p - T.len, esz) + 16 * u;
      *reinterpret_cast<uint4*>(a.k_pool + dst) = *reinterpret_cast<const uint4*>(a.k_new + src);
      *reinterpret_cast<uint4*>(a.v_pool + dst) = *reinterpret_cast<const uint4*>(a.v_new + src);
    }
  }
  // stage the visible rows; new tokens come from k_new / v_new (overlay)
  for (int idx = threadIdx.x; idx < T.n_vis * U; idx += kThreads) {
    const int s = idx / U, u = idx % U;
    const int p = T.c0 + s;
    const bool fresh = p >= T.len;
    const size_t src = (fresh ? new_row(a, T, p - T.len, esz) : pool_row(a, T, p, esz)) + 16 * u;
    cp_async16(ks + s * rs + 16 * u, (fresh ? a.k_new : a.k_pool) + src);
    cp_async16(vs + s * rs + 16 * u, (fresh ? a.v_new : a.v_pool) + src);
  }
  return true;
}

// ------------------------------------------------------------ bf16 body
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x = lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// S for 16 query rows x positions 16*ks .. 16*ks+31 (n-tiles 0-3; 2-3
// only when `two`): Q rows at qs (16 rows, rs apart), K rows at ks.
template <int HD>
__device__ __forceinline__ void scores(float (&s)[4][4], uint32_t qs, uint32_t ks, int rs,
                                       int ks_step, bool two, int lane) {
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
  const int mi = lane >> 3, rr = lane & 7;
  const uint32_t qa = qs + (rr + (mi & 1) * 8) * rs + (mi >> 1) * 16;
  const uint32_t ka = ks + (16 * ks_step + rr + (mi >> 1) * 8) * rs + (mi & 1) * 16;
#pragma unroll
  for (int kd = 0; kd < HD / 16; ++kd) {
    uint32_t a[4], b[4];
    ldsm_x4(a, qa + kd * 32);
    ldsm_x4(b, ka + kd * 32);
    mma_bf16(s[0], a, b[0], b[1]);
    mma_bf16(s[1], a, b[2], b[3]);
    if (two) {
      ldsm_x4(b, ka + 16 * rs + kd * 32);
      mma_bf16(s[2], a, b[0], b[1]);
      mma_bf16(s[3], a, b[2], b[3]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads) paged_attend_bf16_kernel(const Args a) {
  constexpr int RS = HD * 2 + 16;        // staged row stride, bytes
  constexpr int AS = HD + 8;             // merge row stride, floats
  const Tile T = tile_of(a);
  extern __shared__ __align__(16) uint8_t smem[];
  float* red_m = reinterpret_cast<float*>(smem);          // [kWarps][16]
  float* red_den = red_m + kWarps * 16;                   // [kWarps][16]
  uint8_t* base = smem + 2 * kWarps * 16 * 4;
  uint8_t* qs = base;                                     // [mt*16][RS]
  uint8_t* ks = qs + a.mt * 16 * RS;                      // [ct16][RS]
  const int ct16 = (T.ct + 15) & ~15;
  uint8_t* vs = ks + ct16 * RS;                           // [ct16][RS]
  float* red_acc = reinterpret_cast<float*>(base);        // [kWarps][16][AS], after compute

  if (!scatter_and_stage(a, T, 2, ks, vs, RS)) return;
  constexpr int U = HD * 2 / 16;
  for (int idx = threadIdx.x; idx < a.mt * 16 * U; idx += kThreads) {
    const int lr = idx / U, u = idx % U, r = T.r0 + lr;
    uint8_t* dst = qs + lr * RS + 16 * u;
    if (r < T.R) {
      const int i = r / T.g, hh = T.kk * T.g + r % T.g;
      cp_async16(dst, a.q + (((size_t)T.bi * a.t + i) * a.h + hh) * HD * 2 + 16 * u);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  }
  const int n16 = (T.n_vis + 15) & ~15;   // finite zeros past the last visible row
  for (int idx = threadIdx.x; idx < (n16 - T.n_vis) * U; idx += kThreads) {
    const int s = T.n_vis + idx / U, u = idx % U;
    *reinterpret_cast<uint4*>(ks + s * RS + 16 * u) = make_uint4(0, 0, 0, 0);
    *reinterpret_cast<uint4*>(vs + s * RS + 16 * u) = make_uint4(0, 0, 0, 0);
  }
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int P = kWarps / a.mt;                  // position slices per m-tile
  const int mtile = warp / P, slice = warp % P;
  const int n_ks = n16 >> 4;
  const int per = (n_ks + P - 1) / P;
  const int ks_lo = slice * per, ks_hi = min(n_ks, ks_lo + per);
  const bool active = T.r0 + mtile * 16 < T.R;
  const int gq = lane >> 2, tig = lane & 3;
  // visibility limit of the warp's two rows (gq, gq + 8): p <= lim
  int lim[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int r = T.r0 + mtile * 16 + gq + 8 * h2;
    lim[h2] = (r < T.R && r / T.g < T.nv) ? T.len + r / T.g : -1;
  }
  const uint32_t qa = smem_u32(qs + mtile * 16 * RS), ka = smem_u32(ks);
  // scale and mask S in place; returns nothing, `vis` is recomputed per use
  auto mask = [&](float (&s)[4][4], int ks_step, bool two) {
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int sl = 16 * ks_step + 8 * n + 2 * tig + (e & 1);
        const bool vis = (n < 2 || two) && sl < T.n_vis && T.c0 + sl <= lim[e >> 1];
        s[n][e] = vis ? s[n][e] * a.scale : kNegInf;
      }
  };

  // pass 1: the chunk's row maxima
  float mx[2] = {kNegInf, kNegInf};
  if (active) {
    for (int kstep = ks_lo; kstep < ks_hi; kstep += 2) {
      const bool two = kstep + 1 < ks_hi;
      float s[4][4];
      scores<HD>(s, qa, ka, RS, kstep, two, lane);
      mask(s, kstep, two);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
      }
    }
  }
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    mx[h2] = fmaxf(mx[h2], __shfl_xor_sync(0xffffffffu, mx[h2], 1));
    mx[h2] = fmaxf(mx[h2], __shfl_xor_sync(0xffffffffu, mx[h2], 2));
  }
  if (tig == 0) {
    red_m[warp * 16 + gq] = mx[0];
    red_m[warp * 16 + gq + 8] = mx[1];
  }
  __syncthreads();
  float mrow[2] = {kNegInf, kNegInf};
  for (int sl = 0; sl < P; ++sl) {
    mrow[0] = fmaxf(mrow[0], red_m[(mtile * P + sl) * 16 + gq]);
    mrow[1] = fmaxf(mrow[1], red_m[(mtile * P + sl) * 16 + gq + 8]);
  }

  // pass 2: p, den and P.V
  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float dsum[2] = {0.f, 0.f};
  const int mi = lane >> 3, rr = lane & 7;
  const uint32_t va = smem_u32(vs) + (rr + (mi & 1) * 8) * RS + (mi >> 1) * 16;
  if (active) {
    for (int kstep = ks_lo; kstep < ks_hi; kstep += 2) {
      const bool two = kstep + 1 < ks_hi;
      float s[4][4];
      scores<HD>(s, qa, ka, RS, kstep, two, lane);
      mask(s, kstep, two);
      uint32_t pa[2][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = s[n][e] > 0.5f * kNegInf ? expf(s[n][e] - mrow[e >> 1]) : 0.f;
          dsum[e >> 1] += p;
          s[n][e] = p;
        }
      }
#pragma unroll
      for (int k2 = 0; k2 < 2; ++k2) {
        pa[k2][0] = pack_bf16(s[2 * k2][0], s[2 * k2][1]);
        pa[k2][1] = pack_bf16(s[2 * k2][2], s[2 * k2][3]);
        pa[k2][2] = pack_bf16(s[2 * k2 + 1][0], s[2 * k2 + 1][1]);
        pa[k2][3] = pack_bf16(s[2 * k2 + 1][2], s[2 * k2 + 1][3]);
      }
#pragma unroll
      for (int k2 = 0; k2 < 2; ++k2) {
        if (k2 == 1 && !two) break;
        const uint32_t vrow = va + 16 * (kstep + k2) * RS;
#pragma unroll
        for (int dn = 0; dn < HD / 16; ++dn) {
          uint32_t b[4];
          ldsm_x4_trans(b, vrow + dn * 32);
          mma_bf16(o[2 * dn], pa[k2], b[0], b[1]);
          mma_bf16(o[2 * dn + 1], pa[k2], b[2], b[3]);
        }
      }
    }
  }
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    dsum[h2] += __shfl_xor_sync(0xffffffffu, dsum[h2], 1);
    dsum[h2] += __shfl_xor_sync(0xffffffffu, dsum[h2], 2);
  }
  __syncthreads();   // every warp is done with qs / ks / vs: reuse them
  float* my = red_acc + warp * 16 * AS;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    *reinterpret_cast<float2*>(my + gq * AS + 8 * n + 2 * tig) = make_float2(o[n][0], o[n][1]);
    *reinterpret_cast<float2*>(my + (gq + 8) * AS + 8 * n + 2 * tig) =
        make_float2(o[n][2], o[n][3]);
  }
  if (tig == 0) {
    red_den[warp * 16 + gq] = dsum[0];
    red_den[warp * 16 + gq + 8] = dsum[1];
  }
  __syncthreads();
  // merge the position slices and write the tile's partials
  const int rows = T.r1 - T.r0;
  for (int idx = threadIdx.x; idx < rows * (HD / 4); idx += kThreads) {
    const int lr = idx / (HD / 4), c4 = idx % (HD / 4);
    const int mtl = lr >> 4, row16 = lr & 15;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int sl = 0; sl < P; ++sl) {
      const float4 v =
          *reinterpret_cast<const float4*>(red_acc + ((mtl * P + sl) * 16 + row16) * AS + 4 * c4);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    reinterpret_cast<float4*>(a.acc + part_idx(a, T, T.r0 + lr) * HD)[c4] = sum;
  }
  for (int lr = threadIdx.x; lr < rows; lr += kThreads) {
    const int mtl = lr >> 4, row16 = lr & 15;
    float mm = kNegInf, dd = 0.f;
    for (int sl = 0; sl < P; ++sl) {
      mm = fmaxf(mm, red_m[(mtl * P + sl) * 16 + row16]);
      dd += red_den[(mtl * P + sl) * 16 + row16];
    }
    const size_t pi = part_idx(a, T, T.r0 + lr);
    a.m[pi] = mm;
    a.den[pi] = dd;
  }
}

// ------------------------------------------------------------ fp32 body
__global__ void __launch_bounds__(kThreads) paged_attend_f32_kernel(const Args a) {
  const Tile T = tile_of(a);
  const int RS = a.hd * 4 + 16;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* ks = smem;
  uint8_t* vs = ks + (size_t)T.ct * RS;
  float* qrow = reinterpret_cast<float*>(vs + (size_t)T.ct * RS);   // [kWarps][hd]
  float* prow = qrow + kWarps * a.hd;                               // [kWarps][ct]
  if (!scatter_and_stage(a, T, 4, ks, vs, RS)) return;
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int H4 = a.hd / 4;
  float* qw = qrow + warp * a.hd;
  float* pw = prow + warp * T.ct;
  for (int r = T.r0 + warp; r < T.r1; r += kWarps) {
    const int i = r / T.g, hh = T.kk * T.g + r % T.g;
    const int lim = i < T.nv ? T.len + i : -1;
    const float* qsrc = reinterpret_cast<const float*>(a.q) + (((size_t)T.bi * a.t + i) * a.h + hh) * a.hd;
    for (int d = lane; d < a.hd; d += 32) qw[d] = qsrc[d] * a.scale;
    __syncwarp();
    float mloc = kNegInf;
    for (int s = lane; s < T.n_vis; s += 32) {
      const float4* kr = reinterpret_cast<const float4*>(ks + s * RS);
      float dot = 0.f;
      for (int w = 0; w < H4; ++w) {
        const float4 k4 = kr[w];
        dot = fmaf(qw[4 * w], k4.x, dot);
        dot = fmaf(qw[4 * w + 1], k4.y, dot);
        dot = fmaf(qw[4 * w + 2], k4.z, dot);
        dot = fmaf(qw[4 * w + 3], k4.w, dot);
      }
      const float sc = (T.c0 + s <= lim) ? dot : kNegInf;
      pw[s] = sc;
      mloc = fmaxf(mloc, sc);
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, o));
    float dloc = 0.f;
    for (int s = lane; s < T.n_vis; s += 32) {
      const float p = (T.c0 + s <= lim) ? expf(pw[s] - mloc) : 0.f;
      dloc += p;
      pw[s] = p;
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) dloc += __shfl_xor_sync(0xffffffffu, dloc, o);
    __syncwarp();
    float4 acc4[2] = {make_float4(0.f, 0.f, 0.f, 0.f), make_float4(0.f, 0.f, 0.f, 0.f)};
    for (int s = 0; s < T.n_vis; ++s) {
      const float p = pw[s];
      if (p == 0.f) continue;   // warp-uniform: masked or underflowed
      const float4* vr = reinterpret_cast<const float4*>(vs + s * RS);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int c4 = lane + 32 * k;
        if (c4 < H4) {
          const float4 v = vr[c4];
          acc4[k].x = fmaf(p, v.x, acc4[k].x);
          acc4[k].y = fmaf(p, v.y, acc4[k].y);
          acc4[k].z = fmaf(p, v.z, acc4[k].z);
          acc4[k].w = fmaf(p, v.w, acc4[k].w);
        }
      }
    }
    const size_t pi = part_idx(a, T, r);
    float4* arow = reinterpret_cast<float4*>(a.acc + pi * a.hd);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int c4 = lane + 32 * k;
      if (c4 < H4) arow[c4] = acc4[k];
    }
    if (lane == 0) {
      a.m[pi] = mloc;
      a.den[pi] = dloc;
    }
    __syncwarp();   // the next row reuses qw / pw
  }
}

// ------------------------------------------------------------ combine
template <bool BF16>
__global__ void __launch_bounds__(kThreads)
paged_combine_kernel(const float* __restrict__ acc, const float* __restrict__ m,
               const float* __restrict__ den, void* __restrict__ out, int rows, int nc,
               int th, int hd) {
  const int row = (blockIdx.x * kThreads + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (row >= rows) return;
  const size_t bi = row / th, rem = row % th;
  float big = kNegInf;
  for (int c = 0; c < nc; ++c) big = fmaxf(big, m[(bi * nc + c) * th + rem]);
  const int H4 = hd / 4;
  float4 sum[2] = {make_float4(0.f, 0.f, 0.f, 0.f), make_float4(0.f, 0.f, 0.f, 0.f)};
  float dtot = 0.f;
  for (int c = 0; c < nc; ++c) {
    const size_t pi = (bi * nc + c) * th + rem;
    const float mc = m[pi];
    if (!(mc > 0.5f * kNegInf)) continue;   // fully masked: acc was never written
    const float alpha = expf(mc - big);
    dtot += den[pi] * alpha;
    const float4* arow = reinterpret_cast<const float4*>(acc + pi * hd);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int c4 = lane + 32 * k;
      if (c4 < H4) {
        const float4 v = arow[c4];
        sum[k].x += v.x * alpha;
        sum[k].y += v.y * alpha;
        sum[k].z += v.z * alpha;
        sum[k].w += v.w * alpha;
      }
    }
  }
  const float dv = fmaxf(dtot, 1e-30f);
  const size_t o = (size_t)row * hd;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int c4 = lane + 32 * k;
    if (c4 >= H4) continue;
    const float4 r = make_float4(sum[k].x / dv, sum[k].y / dv, sum[k].z / dv, sum[k].w / dv);
    if constexpr (BF16) {
      uint2 w;
      w.x = pack_bf16(r.x, r.y);
      w.y = pack_bf16(r.z, r.w);
      reinterpret_cast<uint2*>(static_cast<uint8_t*>(out) + o * 2)[c4] = w;
    } else {
      reinterpret_cast<float4*>(static_cast<float*>(out) + o)[c4] = r;
    }
  }
}

// ------------------------------------------------------------ bf16 prefill body
constexpr int kPreWG = 3;                   // warpgroups a block, 64 query rows each
constexpr int kPreRows = 64 * kPreWG;       // packed query rows a block
constexpr int kPreThreads = 128 * kPreWG;
constexpr int kPreCols = 64;                // KV positions a tile
constexpr int kSw = 128;                    // bytes of a swizzled row half (64 bf16)

struct PreArgs {
  const uint8_t* q;
  const uint8_t* k_new;
  const uint8_t* v_new;
  uint8_t* k_pool;
  uint8_t* v_pool;
  const int32_t* table;
  const int32_t* length;
  const int32_t* n_valid;
  uint8_t* out;
  int b, t, h, kh, bs, mb;
  int n_rt;              // query tiles per (row, KV head)
  float scale_log2;      // hd^-0.5 * log2(e): scores in the exp2 domain
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A [rows x 128] bf16 tile in shared memory as wgmma reads it: two halves
// of 64 columns, each rows x 128 bytes with the 128-byte swizzle (16-byte
// unit c of row r at unit c ^ (r % 8)); the halves start 1024-aligned.
// Byte offset of 16-byte unit u (0..15) of row r:
__device__ __forceinline__ uint32_t sw_off(int r, int u, int rows) {
  return (u >> 3) * rows * kSw + r * kSw + (((u & 7) ^ (r & 7)) << 4);
}

// wgmma shared-memory descriptor: 128-byte swizzle, `lbo` / `sbo` in bytes
__device__ __forceinline__ uint64_t sw_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\nwgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

__device__ __forceinline__ void fence_proxy_async() {   // generic-proxy smem writes -> wgmma
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void hold(float (&d)[N]) {   // keep accumulators in place
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// S (64 x 64, fp32) = or += Q (64 x 16, shared) . K^T (16 x 64, shared, K-major)
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// O (64 x 128, fp32) += P (64 x 16, registers) . V (16 x 128, shared, MN-major)
__device__ __forceinline__ void wgmma_pv(float (&d)[64], const uint32_t (&pa)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(pa[0]), "r"(pa[1]), "r"(pa[2]), "r"(pa[3]), "l"(db), "r"(1));
}

// One block: a tile of kPreRows packed query rows (row r = token r / g,
// head r % g of KV head kk) of one batch row; each warpgroup owns 64 of
// them and walks the row's KV positions 0 .. its rows' causal limit in
// tiles of kPreCols with an online softmax. Out in bf16, rows past
// n_valid as 0. HD <= 128: the tiles are 128 columns wide, the columns
// past HD zero.
template <int HD>
__global__ void __launch_bounds__(kPreThreads, 1) paged_attend_prefill_bf16_kernel(const PreArgs a) {
  constexpr int U = HD * 2 / 16;    // 16-byte units a row
  constexpr int QB = 2 * kPreRows * kSw, KB = 2 * kPreCols * kSw;   // bytes of a q / k tile
  // heaviest tiles (the last query rows, the longest windows) first
  const int per_tile = a.kh * a.b;
  const int rt = a.n_rt - 1 - (int)(blockIdx.x / per_tile);
  const int kk = (int)(blockIdx.x % per_tile) % a.kh;
  const int bi = (int)(blockIdx.x % per_tile) / a.kh;
  const int g = a.h / a.kh, R = a.t * g;
  const int r0 = rt * kPreRows, r1 = min(R, r0 + kPreRows);
  const int len = max(0, a.length[bi]);
  const int nv = min(a.t, max(0, a.n_valid[bi]));
  const int rv = nv * g;            // rows r < rv are valid queries
  const int32_t* trow = a.table + (size_t)bi * a.mb;
  auto new_off = [&](int i) -> size_t {    // new token i's row of k_new / v_new
    return (((size_t)bi * a.t + i) * a.kh + kk) * (HD * 2);
  };
  auto out_off = [&](int r) -> size_t {    // query row r of q / out
    return (((size_t)bi * a.t + r / g) * a.h + kk * g + r % g) * (HD * 2);
  };

  if (r0 >= rv) {   // no valid query: zeros out; nothing staged or scattered
    for (int idx = threadIdx.x; idx < (r1 - r0) * U; idx += kPreThreads) {
      *reinterpret_cast<uint4*>(a.out + out_off(r0 + idx / U) + 16 * (idx % U)) =
          make_uint4(0, 0, 0, 0);
    }
    return;
  }
  auto pool_row = [&](int p) -> int {      // position p's row of a pool: block * bs + offset
    const int lb = p / a.bs;
    return (lb < a.mb ? trow[lb] : 0) * a.bs + p % a.bs;
  };
  // Where position p's K/V row comes from, as one int: its pool row below
  // len, else -1 - (its new-token index).
  auto code_of = [&](int p) -> int { return p >= len ? -1 - (p - len) : pool_row(p); };
  // the scatter: this tile owns token i iff row i * g (its head 0) lies in
  // it, so exactly one block writes each new token's K/V of head kk
  {
    const int i_lo = (r0 + g - 1) / g, i_hi = min(nv, (r0 + kPreRows + g - 1) / g);
    for (int idx = threadIdx.x; idx < max(0, i_hi - i_lo) * U; idx += kPreThreads) {
      const int i = i_lo + idx / U, u = idx % U;
      const size_t dst = ((size_t)pool_row(len + i) * a.kh + kk) * (HD * 2) + 16 * u;
      const size_t src = new_off(i) + 16 * u;
      *reinterpret_cast<uint4*>(a.k_pool + dst) = *reinterpret_cast<const uint4*>(a.k_new + src);
      *reinterpret_cast<uint4*>(a.v_pool + dst) = *reinterpret_cast<const uint4*>(a.v_new + src);
    }
  }

  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);   // [QB]
  uint8_t* ks = qs + QB;                                     // [2][KB]
  uint8_t* vs = ks + 2 * KB;                                 // [2][KB]
  int* codes = reinterpret_cast<int*>(vs + 2 * KB);          // [2][kPreCols]
  for (int idx = threadIdx.x; idx < kPreRows * 16; idx += kPreThreads) {
    const int lr = idx / 16, u = idx % 16, r = r0 + lr;
    uint8_t* dst = qs + sw_off(lr, u, kPreRows);
    if (u < U && r < R) {
      cp_async16(dst, a.q + out_off(r) + 16 * u);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  }
  // positions 0 .. kv_end-1 reach the tile's last valid query; new
  // tokens are read from k_new / v_new (the overlay), the pool only below len
  const int kv_end = len + (min(r1, rv) - 1) / g + 1;
  const int n_tiles = (kv_end + kPreCols - 1) / kPreCols;
  // The codes of tile j + 2 are read from the table during tile j and kept
  // in a two-tile ring, so no table read stands between a tile and its loads.
  auto stage_kv = [&](int j) {   // tile j into stage j & 1
    const int c0 = j * kPreCols, n = min(kPreCols, kv_end - c0);
    uint8_t* kd = ks + (j & 1) * KB;
    uint8_t* vd = vs + (j & 1) * KB;
    const int* cj = codes + (j & 1) * kPreCols;
    for (int idx = threadIdx.x; idx < kPreCols * 16; idx += kPreThreads) {
      const int sr = idx / 16, u = idx % 16;
      const uint32_t off = sw_off(sr, u, kPreCols);
      if (u < U && sr < n) {   // finite zeros past the last visible position and HD
        const int code = cj[sr];
        const bool fresh = code < 0;
        const size_t src = (fresh ? new_off(-1 - code)
                                  : ((size_t)code * a.kh + kk) * (HD * 2)) + 16 * u;
        cp_async16(kd + off, (fresh ? a.k_new : a.k_pool) + src);
        cp_async16(vd + off, (fresh ? a.v_new : a.v_pool) + src);
      } else {
        *reinterpret_cast<uint4*>(kd + off) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(vd + off) = make_uint4(0, 0, 0, 0);
      }
    }
  };
  if (threadIdx.x < kPreCols) {
    codes[threadIdx.x] = code_of(threadIdx.x);
    codes[kPreCols + threadIdx.x] = code_of(kPreCols + threadIdx.x);
  }
  __syncthreads();
  stage_kv(0);
  cp_async_commit();

  const int wg = threadIdx.x >> 7, wtid = threadIdx.x & 127;
  const int lane = wtid & 31, gq = lane >> 2, tig = lane & 3;
  const int lr0 = 64 * wg + 16 * (wtid >> 5) + gq;   // the thread's rows: lr0, lr0 + 8
  const int wr0 = r0 + 64 * wg;                      // the warpgroup's first row
  const bool active = wr0 < min(r1, rv);
  // every valid row of the warpgroup sees positions <= len + (its first token)
  const int open_end = len + wr0 / g;                // positions <= this need no mask
  const int wg_end = active ? len + (min(min(r1, rv), wr0 + 64) - 1) / g + 1 : 0;
  int lim[2];                                        // row half h2: p <= lim visible
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int r = r0 + lr0 + 8 * h2;
    lim[h2] = r < rv ? len + r / g : -1;
  }
  float o[64];   // (n8 block n, e): row lr0 + 8 (e >> 1), column 8n + 2 tig + (e & 1)
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  const uint32_t qa = smem_u32(qs) + 64 * wg * kSw;
  const float sl = a.scale_log2;

  // S = Q.K^T, the online softmax and P.V of KV tile j (positions c0 ..)
  auto attend_tile = [&](int j, int c0) {
    const uint32_t kb = smem_u32(ks) + (j & 1) * KB, vb = smem_u32(vs) + (j & 1) * KB;
    float s[32];   // as o, over 8 n8 blocks of positions
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wgmma_fence();
    hold(s);
#pragma unroll
    for (int kd = 0; kd < 8; ++kd) {
      const uint32_t ko = (kd >> 2) * kPreCols * kSw + (kd & 3) * 32;
      wgmma_qk(s, sw_desc(qa + (kd >> 2) * kPreRows * kSw + (kd & 3) * 32, 16, 1024),
               sw_desc(kb + ko, 16, 1024), kd > 0);
    }
    hold(s);
    wgmma_commit_wait();
    hold(s);
    // the row max on unscaled scores (the scale is positive), the scale
    // folded into the exponent: p = 2^(s * scale log2(e) - m * scale log2(e))
    const bool masked = c0 + kPreCols - 1 > open_end;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (masked && c0 + 8 * (i >> 2) + 2 * tig + (i & 1) > lim[(i >> 1) & 1]) s[i] = kNegInf;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    }
    float neg_m[2];   // -m * scale log2(e) of each row half
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      mx[h2] = fmaxf(mx[h2], __shfl_xor_sync(0xffffffffu, mx[h2], 1));
      mx[h2] = fmaxf(mx[h2], __shfl_xor_sync(0xffffffffu, mx[h2], 2));
      const float m_new = fmaxf(m_run[h2], mx[h2]);
      const float alpha = ex2((m_run[h2] - m_new) * sl);
      m_run[h2] = m_new;
      neg_m[h2] = -m_new * sl;
      l_run[h2] *= alpha;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        o[4 * n + 2 * h2] *= alpha;
        o[4 * n + 2 * h2 + 1] *= alpha;
      }
    }
    // a masked score gives 0 once its row has seen a visible position,
    // which every valid row has from its first tile (position 0)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = ex2(fmaf(s[i], sl, neg_m[(i >> 1) & 1]));
      l_run[(i >> 1) & 1] += p;
      s[i] = p;
    }
    // P.V: p rounded to bf16 in registers as the A fragments
    uint32_t pa[4][4];
#pragma unroll
    for (int k2 = 0; k2 < 4; ++k2) {
      pa[k2][0] = pack_bf16(s[8 * k2], s[8 * k2 + 1]);
      pa[k2][1] = pack_bf16(s[8 * k2 + 2], s[8 * k2 + 3]);
      pa[k2][2] = pack_bf16(s[8 * k2 + 4], s[8 * k2 + 5]);
      pa[k2][3] = pack_bf16(s[8 * k2 + 6], s[8 * k2 + 7]);
    }
    wgmma_fence();
    hold(o);
#pragma unroll
    for (int k2 = 0; k2 < 4; ++k2)
      wgmma_pv(o, pa[k2], sw_desc(vb + k2 * 16 * kSw, kPreCols * kSw, 1024));
    hold(o);
    wgmma_commit_wait();
    hold(o);
  };

  for (int j = 0; j < n_tiles; ++j) {
    const bool ahead = threadIdx.x < kPreCols && j + 2 < n_tiles;
    const int next_code = ahead ? code_of((j + 2) * kPreCols + threadIdx.x) : 0;
    cp_async_wait_none_pending();
    fence_proxy_async();
    __syncthreads();   // tile j staged; every warpgroup is done with tile j - 1
    if (j + 1 < n_tiles) stage_kv(j + 1);
    cp_async_commit();
    const int c0 = j * kPreCols;
    if (c0 < wg_end) attend_tile(j, c0);   // not past the warpgroup's last valid query
    if (ahead) codes[(j & 1) * kPreCols + threadIdx.x] = next_code;   // tile j's slot
  }
  // out: each warp writes its 16 rows into its own q rows, then 16-byte stores
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    float l = l_run[h2];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int lr = lr0 + 8 * h2;
    const float inv = r0 + lr < rv ? 1.f / fmaxf(l, 1e-30f) : 0.f;
#pragma unroll
    for (int n = 0; n < 16; ++n)
      *reinterpret_cast<uint32_t*>(qs + sw_off(lr, n, kPreRows) + 4 * tig) =
          pack_bf16(o[4 * n + 2 * h2] * inv, o[4 * n + 2 * h2 + 1] * inv);
  }
  __syncwarp();
  const int wrow = 64 * wg + 16 * (wtid >> 5);
  for (int idx = lane; idx < 16 * U; idx += 32) {
    const int lr = wrow + idx / U, u = idx % U;
    if (r0 + lr < r1) {
      *reinterpret_cast<uint4*>(a.out + out_off(r0 + lr) + 16 * u) =
          *reinterpret_cast<const uint4*>(qs + sw_off(lr, u, kPreRows));
    }
  }
}

// Raise the dynamic shared-memory limit of `fn` once per kernel instance.
template <typename F>
int ensure_smem(F fn, size_t smem, size_t& smem_set) {
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  return 0;
}

template <int HD>
int launch_bf16(const Args& a, dim3 grid, cudaStream_t stream) {
  static size_t smem_set = 48 * 1024;   // the default dynamic limit
  const int ct16 = (a.cb * a.bs + 15) & ~15;
  const size_t rs = HD * 2 + 16;
  const size_t staged = (size_t)(a.mt * 16 + 2 * ct16) * rs;
  const size_t merged = (size_t)kWarps * 16 * (HD + 8) * 4;
  const size_t smem = 2 * kWarps * 16 * 4 + (staged > merged ? staged : merged);
  const int e = ensure_smem(paged_attend_bf16_kernel<HD>, smem, smem_set);
  if (e) return e;
  paged_attend_bf16_kernel<HD><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_prefill(const PreArgs& a, unsigned blocks, cudaStream_t stream) {
  static size_t smem_set = 48 * 1024;
  // q tile, two stages of K and V, the code ring, and room to align to 1024
  constexpr size_t smem = (size_t)2 * kSw * (kPreRows + 4 * kPreCols) + 2 * kPreCols * 4 + 1024;
  const bool first = smem_set < smem;
  const int e = ensure_smem(paged_attend_prefill_bf16_kernel<HD>, smem, smem_set);
  if (e) return e;
  if (first) {   // all of the SM's shared memory, not L1
    const cudaError_t c = cudaFuncSetAttribute(paged_attend_prefill_bf16_kernel<HD>,
                                               cudaFuncAttributePreferredSharedMemoryCarveout,
                                               (int)cudaSharedmemCarveoutMaxShared);
    if (c != cudaSuccess) return (int)c;
  }
  paged_attend_prefill_bf16_kernel<HD><<<blocks, kPreThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

int launch_f32(const Args& a, dim3 grid, cudaStream_t stream) {
  static size_t smem_set = 48 * 1024;
  const size_t ct = (size_t)a.cb * a.bs;
  const size_t smem = 2 * ct * (a.hd * 4 + 16) + (size_t)kWarps * (a.hd + ct) * 4;
  const int e = ensure_smem(paged_attend_f32_kernel, smem, smem_set);
  if (e) return e;
  paged_attend_f32_kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point of the attention launch. Pointers are device pointers;
// returns cudaGetLastError() (or cudaErrorInvalidValue for shapes the
// kernel does not take: bf16 head dims that are multiples of 16 up to 256,
// fp32 head dims that are multiples of 4 up to 256).
extern "C" int paged_attend_launch(const void* q, const void* k_new, const void* v_new,
                                   void* k_pool, void* v_pool, const void* table,
                                   const void* length, const void* n_valid, void* acc,
                                   void* m, void* den, int b, int t, int h, int kh,
                                   int hd, int bs, int mb, int cb, int bf16, float scale,
                                   void* stream) {
  if (b < 1 || b > 65535 || t < 1 || kh < 1 || h < kh || h % kh != 0 || bs < 1 || cb < 1 ||
      mb < 1 || (bf16 && (hd < 16 || hd % 16 != 0 || hd > 256)) ||
      (!bf16 && (hd < 4 || hd % 4 != 0 || hd > 256))) {
    return (int)cudaErrorInvalidValue;
  }
  Args a;
  a.q = static_cast<const uint8_t*>(q);
  a.k_new = static_cast<const uint8_t*>(k_new);
  a.v_new = static_cast<const uint8_t*>(v_new);
  a.k_pool = static_cast<uint8_t*>(k_pool);
  a.v_pool = static_cast<uint8_t*>(v_pool);
  a.table = static_cast<const int32_t*>(table);
  a.length = static_cast<const int32_t*>(length);
  a.n_valid = static_cast<const int32_t*>(n_valid);
  a.acc = static_cast<float*>(acc);
  a.m = static_cast<float*>(m);
  a.den = static_cast<float*>(den);
  a.t = t, a.h = h, a.kh = kh, a.hd = hd, a.bs = bs, a.mb = mb, a.cb = cb;
  a.nc = (mb + cb - 1) / cb;
  const int m_tiles = (t * (h / kh) + 15) / 16;
  a.mt = m_tiles > 1 ? 2 : 1;
  a.n_rt = (m_tiles + a.mt - 1) / a.mt;
  a.scale = scale;
  if (a.nc > 65535 || (long long)kh * a.n_rt > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const dim3 grid(kh * a.n_rt, a.nc, b);
  auto s = static_cast<cudaStream_t>(stream);
  if (!bf16) return launch_f32(a, grid, s);
  switch (hd / 16) {   // one instance per multiple of 16
#define K3_HD(n) case n: return launch_bf16<16 * n>(a, grid, s);
    K3_HD(1) K3_HD(2) K3_HD(3) K3_HD(4) K3_HD(5) K3_HD(6) K3_HD(7) K3_HD(8)
    K3_HD(9) K3_HD(10) K3_HD(11) K3_HD(12) K3_HD(13) K3_HD(14) K3_HD(15)
#undef K3_HD
    default: return launch_bf16<256>(a, grid, s);
  }
}

// C entry point of the combine: out (b, t, h, hd) in bf16 or fp32 from the
// partials acc (b, nc, t, h, hd), m and den (b, nc, t, h).
extern "C" int paged_combine_launch(const void* acc, const void* m, const void* den,
                                    void* out, int b, int nc, int t, int h, int hd, int bf16,
                                    void* stream) {
  if (b < 1 || nc < 1 || t < 1 || h < 1 || hd < 4 || hd % 4 != 0 || hd > 256) {
    return (int)cudaErrorInvalidValue;
  }
  const long long rows = (long long)b * t * h;
  const long long blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto pa = static_cast<const float*>(acc);
  auto pm = static_cast<const float*>(m);
  auto pd = static_cast<const float*>(den);
  if (bf16) {
    paged_combine_kernel<true><<<(unsigned)blocks, kThreads, 0, s>>>(pa, pm, pd, out, (int)rows, nc,
                                                                t * h, hd);
  } else {
    paged_combine_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(pa, pm, pd, out, (int)rows, nc,
                                                                 t * h, hd);
  }
  return (int)cudaGetLastError();
}

// C entry point of the prefill body: the scatter and the attention of every
// query in one launch, out (b, t, h, hd) bf16 written directly. Takes bf16
// head dims 96 and 128; anything else is refused with cudaErrorInvalidValue
// (the wrapper sends other head dims to the split path).
extern "C" int paged_attend_prefill_launch(const void* q, const void* k_new, const void* v_new,
                                           void* k_pool, void* v_pool, const void* table,
                                           const void* length, const void* n_valid, void* out,
                                           int b, int t, int h, int kh, int hd, int bs,
                                           int mb, float scale, void* stream) {
  if (b < 1 || t < 1 || kh < 1 || h < kh || h % kh != 0 || bs < 1 || mb < 1 ||
      (hd != 96 && hd != 128)) {
    return (int)cudaErrorInvalidValue;
  }
  PreArgs a;
  a.q = static_cast<const uint8_t*>(q);
  a.k_new = static_cast<const uint8_t*>(k_new);
  a.v_new = static_cast<const uint8_t*>(v_new);
  a.k_pool = static_cast<uint8_t*>(k_pool);
  a.v_pool = static_cast<uint8_t*>(v_pool);
  a.table = static_cast<const int32_t*>(table);
  a.length = static_cast<const int32_t*>(length);
  a.n_valid = static_cast<const int32_t*>(n_valid);
  a.out = static_cast<uint8_t*>(out);
  a.b = b, a.t = t, a.h = h, a.kh = kh, a.bs = bs, a.mb = mb;
  const long long rows = (long long)t * (h / kh);
  a.n_rt = (int)((rows + kPreRows - 1) / kPreRows);
  a.scale_log2 = scale * 1.4426950408889634f;
  const long long blocks = (long long)a.n_rt * kh * b;
  if (rows > 0x7fffffff || blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  return hd == 96 ? launch_prefill<96>(a, (unsigned)blocks, s)
                  : launch_prefill<128>(a, (unsigned)blocks, s);
}
