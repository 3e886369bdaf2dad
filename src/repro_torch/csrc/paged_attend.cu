// K3: fused paged attention for Hopper (sm_90a) — the new-token KV scatter
// and split-KV flash-decoding over a block table (one launch), then the
// combine of the per-chunk partials (a second launch).
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
