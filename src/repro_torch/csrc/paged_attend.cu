// K3: fused paged attention for Hopper (sm_90a) — the new-token KV scatter
// and split-KV flash-decoding over a block table, in one launch.
//
// Replaces the TPU kernel `paged_attend_fused` (body `_paged_attend_kernel`)
// in src/repro/kernels/paged_attend.py. Same function and layouts:
//   q      (b, t, h, hd)             post-RoPE queries
//   k_new  (b, t, kh, hd)            new K/V for positions length .. length+t-1
//   v_new  (b, t, kh, hd)
//   pools  (n_blocks, bs, kh, hd)    written in place (the scatter)
//   table  (b, mbp) int32            mbp = a multiple of cb, NULL-padded
//   length, n_valid (b,) int32
//   acc    (b, nc, t, h, hd) fp32    per-chunk partials; nc = mbp / cb
//   m, den (b, nc, t, h) fp32
// New token i < n_valid[b] goes to logical position length[b] + i; invalid
// lanes write nothing. Query i sees kv position p iff p <= length[b] + i.
// Rounding as the TPU kernel: q upcast to fp32 then scaled, fp32 scores
// and sums, p cast to the pool dtype before P.V, fp32 partials. The
// combine of the partials is plain PyTorch in the wrapper.
//
// What bounds it on this card: decode attention reads every visible K/V
// byte once and does 4 FLOP per (query head, position, dim): at b 8,
// ~300-token contexts and phi4-mini's 8 KV heads of 128 it moves ~10 MB
// per layer against ~0.06 GFLOP — bytes-bound by a factor of ~20 at the
// 3.35 TB/s / 989 TFLOP/s ridge. Prefill pieces (t = 32) raise the FLOP
// per byte 32-fold, still below the ridge.
//
// Design (simple first): one CUDA block per (KV head, chunk, row): the
// grid is (kh, nc, b), which puts ~300 blocks on 132 SMs at b 8. The block
//   1. scatters the new tokens of its (chunk, head) slice — no other block
//      writes that slice, and copy-on-write guarantees no live row writes
//      a shared block — then __syncthreads() makes them visible to its
//      own reads (plain loads, not the read-only cache);
//   2. stages the chunk's visible K and V rows for its head in dynamic
//      shared memory as 32-bit words, rows padded by one word so the
//      per-token reads of a warp fall in distinct banks; positions past
//      the last query's are never read, so a poisoned NULL block cannot
//      leak in;
//   3. walks its t * g query rows one per warp: the g query heads of the
//      KV head share each staged K/V row. A lane scores positions
//      lane, lane + 32, ... into a per-warp row in shared memory, the warp
//      reduces the max and the sum, and lanes split the head dim for P.V.
// A masked chunk gives m = -1e30, den = 0 and acc = 0, without NaNs.
// Tensor-core tiles (mma / wgmma) and a cp.async pipeline are later work.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxWordsPerLane = 8;  // head rows of <= 256 32-bit words
constexpr float kNegInf = -1.0e30f;
constexpr int kMaxSmem = 232448;     // 227 KB a block may use on sm_90

__device__ __forceinline__ float lo_bf16(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// round-to-nearest-even to bfloat16 and back (finite inputs)
__device__ __forceinline__ float round_bf16(float x) {
  uint32_t u = __float_as_uint(x);
  u += 0x7fffu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xffff0000u);
}

template <bool BF16>
__global__ void __launch_bounds__(kThreads)
paged_attend_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ k_new,
                    const uint32_t* __restrict__ v_new, uint32_t* k_pool,
                    uint32_t* v_pool, const int32_t* __restrict__ table,
                    const int32_t* __restrict__ length,
                    const int32_t* __restrict__ n_valid, float* __restrict__ acc,
                    float* __restrict__ m_out, float* __restrict__ den_out, int t,
                    int h, int kh, int hd, int bs, int mbp, int cb, float scale) {
  constexpr int EPW = BF16 ? 2 : 1;  // elements per 32-bit word
  const int kk = blockIdx.x, j = blockIdx.y, bi = blockIdx.z;
  const int nc = gridDim.y;
  const int g = h / kh;
  const int W = hd / EPW;  // words per head row
  const int WS = W + 1;    // padded shared-memory row stride
  const int ct = cb * bs;
  const int c0 = j * ct;   // first logical position of this chunk
  const int len = length[bi];
  const int nv = n_valid[bi];
  const int32_t* trow = table + (size_t)bi * mbp;

  // 1. scatter the new tokens this (chunk, head) owns
  for (int idx = threadIdx.x; idx < t * W; idx += kThreads) {
    const int i = idx / W, w = idx - (idx / W) * W;
    if (i >= nv) continue;
    const int pos = len + i;
    const int lb = pos / bs;
    if (lb < j * cb || lb >= (j + 1) * cb) continue;
    const size_t dst = (((size_t)trow[lb] * bs + pos % bs) * kh + kk) * W + w;
    const size_t src = (((size_t)bi * t + i) * kh + kk) * W + w;
    k_pool[dst] = k_new[src];
    v_pool[dst] = v_new[src];
  }
  __syncthreads();

  // 2. stage the visible K/V rows of the chunk for this head
  extern __shared__ uint32_t smem[];
  uint32_t* ks = smem;                                        // [ct][WS]
  uint32_t* vs = ks + (size_t)ct * WS;                        // [ct][WS]
  float* qrow = reinterpret_cast<float*>(vs + (size_t)ct * WS);  // [kWarps][hd]
  float* prow = qrow + kWarps * hd;                           // [kWarps][ct]
  const int n_vis = max(0, min(ct, len + t - c0));
  for (int idx = threadIdx.x; idx < n_vis * W; idx += kThreads) {
    const int s = idx / W, w = idx - (idx / W) * W;
    const int pos = c0 + s;
    const size_t src = (((size_t)trow[pos / bs] * bs + pos % bs) * kh + kk) * W + w;
    ks[s * WS + w] = k_pool[src];
    vs[s * WS + w] = v_pool[src];
  }
  __syncthreads();

  // 3. one query row (position i, head kk * g + gi) per warp
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* qw = qrow + warp * hd;
  float* pw = prow + warp * ct;
  for (int r = warp; r < t * g; r += kWarps) {
    const int i = r / g, hh = kk * g + r % g;
    const int qpos = len + i;
    const uint32_t* qsrc = q + (((size_t)bi * t + i) * h + hh) * W;
    for (int w = lane; w < W; w += 32) {
      const uint32_t x = qsrc[w];
      if constexpr (BF16) {
        qw[2 * w] = lo_bf16(x) * scale;
        qw[2 * w + 1] = hi_bf16(x) * scale;
      } else {
        qw[w] = __uint_as_float(x) * scale;
      }
    }
    __syncwarp();

    float mloc = kNegInf;
    for (int s = lane; s < n_vis; s += 32) {
      const uint32_t* kr = ks + s * WS;
      float dot = 0.f;
      for (int w = 0; w < W; ++w) {
        const uint32_t x = kr[w];
        if constexpr (BF16) {
          dot = fmaf(qw[2 * w], lo_bf16(x), dot);
          dot = fmaf(qw[2 * w + 1], hi_bf16(x), dot);
        } else {
          dot = fmaf(qw[w], __uint_as_float(x), dot);
        }
      }
      const float sc = (c0 + s <= qpos) ? dot : kNegInf;
      pw[s] = sc;
      mloc = fmaxf(mloc, sc);
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, o));

    float dloc = 0.f;
    for (int s = lane; s < n_vis; s += 32) {
      const float p = (c0 + s <= qpos) ? expf(pw[s] - mloc) : 0.f;
      dloc += p;
      pw[s] = BF16 ? round_bf16(p) : p;
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) dloc += __shfl_xor_sync(0xffffffffu, dloc, o);
    __syncwarp();

    float a[kMaxWordsPerLane * EPW];
#pragma unroll
    for (int e = 0; e < kMaxWordsPerLane * EPW; ++e) a[e] = 0.f;
    for (int s = 0; s < n_vis; ++s) {
      const float p = pw[s];
      if (p == 0.f) continue;  // warp-uniform: masked or underflowed
      const uint32_t* vr = vs + s * WS;
#pragma unroll
      for (int k = 0; k < kMaxWordsPerLane; ++k) {
        const int w = lane + 32 * k;
        if (w < W) {
          const uint32_t x = vr[w];
          if constexpr (BF16) {
            a[2 * k] = fmaf(p, lo_bf16(x), a[2 * k]);
            a[2 * k + 1] = fmaf(p, hi_bf16(x), a[2 * k + 1]);
          } else {
            a[k] = fmaf(p, __uint_as_float(x), a[k]);
          }
        }
      }
    }
    const size_t ob = (((size_t)bi * nc + j) * t + i) * h + hh;
    float* arow = acc + ob * hd;
#pragma unroll
    for (int k = 0; k < kMaxWordsPerLane; ++k) {
      const int w = lane + 32 * k;
      if (w < W) {
        if constexpr (BF16) {
          arow[2 * w] = a[2 * k];
          arow[2 * w + 1] = a[2 * k + 1];
        } else {
          arow[w] = a[k];
        }
      }
    }
    if (lane == 0) {
      m_out[ob] = mloc;
      den_out[ob] = dloc;
    }
    __syncwarp();  // the next row reuses qw / pw
  }
}

template <bool BF16>
int launch(const void* q, const void* k_new, const void* v_new, void* k_pool,
           void* v_pool, const void* table, const void* length, const void* n_valid,
           void* acc, void* m, void* den, int b, int t, int h, int kh, int hd, int bs,
           int mbp, int cb, float scale, cudaStream_t stream) {
  constexpr int EPW = BF16 ? 2 : 1;
  const int W = hd / EPW;
  const int ct = cb * bs;
  const size_t smem = (size_t)2 * ct * (W + 1) * 4 + (size_t)kWarps * (hd + ct) * 4;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  static size_t smem_set = 48 * 1024;  // the default dynamic limit
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(paged_attend_kernel<BF16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  dim3 grid(kh, mbp / cb, b);
  paged_attend_kernel<BF16><<<grid, kThreads, smem, stream>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(k_new),
      static_cast<const uint32_t*>(v_new), static_cast<uint32_t*>(k_pool),
      static_cast<uint32_t*>(v_pool), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(length), static_cast<const int32_t*>(n_valid),
      static_cast<float*>(acc), static_cast<float*>(m), static_cast<float*>(den), t, h,
      kh, hd, bs, mbp, cb, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point. Pointers are device pointers; returns cudaGetLastError()
// (or cudaErrorInvalidValue for shapes the kernel does not take).
extern "C" int paged_attend_launch(const void* q, const void* k_new, const void* v_new,
                                   void* k_pool, void* v_pool, const void* table,
                                   const void* length, const void* n_valid, void* acc,
                                   void* m, void* den, int b, int t, int h, int kh,
                                   int hd, int bs, int mbp, int cb, int bf16, float scale,
                                   void* stream) {
  const int epw = bf16 ? 2 : 1;
  if (b < 1 || b > 65535 || t < 1 || kh < 1 || h < kh || h % kh != 0 || hd < 1 ||
      hd % epw != 0 || hd / epw > 32 * kMaxWordsPerLane || bs < 1 || cb < 1 ||
      mbp < cb || mbp % cb != 0 || mbp / cb > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch<true>(q, k_new, v_new, k_pool, v_pool, table, length, n_valid, acc, m,
                        den, b, t, h, kh, hd, bs, mbp, cb, scale, s);
  }
  return launch<false>(q, k_new, v_new, k_pool, v_pool, table, length, n_valid, acc, m,
                       den, b, t, h, kh, hd, bs, mbp, cb, scale, s);
}
