"""K3: fused paged attention (KV scatter + split-KV flash-decoding), CUDA
for Hopper.

Port of `repro.kernels.paged_attend.paged_attend_fused` (a Pallas TPU
kernel). Over `t` new positions per row it

  1. scatters new token i < n_valid[b] into the pools IN PLACE at logical
     position length[b] + i through the block table (invalid lanes write
     nothing; the JAX kernel aliases the pools as input/outputs);
  2. attends each row's window causally with the true-length mask
     (kv_pos <= length + i), GQA as h = g * kh without repeating KV;
  3. splits the window into chunks of `cb = CHUNK_TOKENS // block_size`
     blocks; each chunk gives fp32 partials (acc, m, den), and the
     combine merges them with the online-softmax rescale, as the JAX
     package does outside `pl.pallas_call`.

Rounding, as the TPU kernel's: q is upcast to fp32, scores and sums are
fp32, p is cast to the pool dtype before P.V, and the output is cast to
q's dtype.

Layouts: q (b, t, h, hd); k_new, v_new (b, t, kh, hd); pools (n_blocks,
block_size, kh, hd); block_table (b, mb) int32; length, n_valid (b,)
int32. q, k_new, v_new and the pools share one dtype, bfloat16 or
float32. The kernels are in `csrc/paged_attend.cu`: the attention launch
(bf16 on the tensor cores, fp32 on the CUDA cores) and the combine launch.

`paged_attend_fused` launches both kernels for CUDA tensors (two launches
per call, nothing else on the card) and takes the plain version
`paged_attend_fused_ref` (the same split-KV algorithm on the same
layouts, with `combine` as its last step) only for CPU tensors. The
combine kernel has no entry point of its own: `combine` is its plain
version.
"""
from __future__ import annotations

from typing import Optional

import torch

from .counters import LOCK as _COUNT_LOCK

NEG_INF = -1.0e30
CHUNK_TOKENS = 128   # tokens per KV chunk: one CUDA block's tile
MAX_HEAD_DIM = 256

LAUNCHES = 0           # attention calls that launched the kernels (never the plain path)
COMBINE_LAUNCHES = 0   # combine-kernel launches


def pick_chunk_blocks(max_blocks: int, block_size: int,
                      chunk_blocks: Optional[int] = None) -> int:
    """Blocks per KV chunk, as the TPU kernel picks it (`chunk_blocks`
    overrides the CHUNK_TOKENS default, capped at the table width)."""
    return min(max_blocks, chunk_blocks or max(1, CHUNK_TOKENS // block_size))


def padded_table(block_table: torch.Tensor, cb: int) -> torch.Tensor:
    """The table padded with NULL_BLOCK (0) to a multiple of `cb` columns:
    the padded positions lie past every row's capacity, so the mask hides
    them."""
    mb = block_table.shape[1]
    pad = (-mb) % cb
    if pad:
        block_table = torch.nn.functional.pad(block_table, (0, pad))
    return block_table.to(torch.int32).contiguous()


def combine(acc: torch.Tensor, m: torch.Tensor, den: torch.Tensor,
            dtype: torch.dtype) -> torch.Tensor:
    """Merge per-chunk partials acc (b, nc, t, h, hd), m and den (b, nc,
    t, h) into (b, t, h, hd) in `dtype`: with M = max_c m_c and alpha_c =
    exp(m_c - M), out = sum_c acc_c alpha_c / max(sum_c den_c alpha_c,
    1e-30). A fully masked chunk (m_c = NEG_INF, den_c = acc_c = 0) adds
    nothing, and a query with no visible position gives 0."""
    big = m.amax(dim=1)
    alpha = torch.exp(m - big[:, None])
    den_tot = (den * alpha).sum(dim=1)
    out = (acc * alpha[..., None]).sum(dim=1)
    return (out / torch.clamp(den_tot, min=1e-30)[..., None]).to(dtype)


def paged_attend_fused_ref(q, k_new, v_new, k_pool, v_pool, block_table,
                           length, n_valid, chunk_blocks: Optional[int] = None):
    """Plain PyTorch version of the kernel, same layouts and algorithm.
    Writes the pools in place; returns out (b, t, h, hd) in q.dtype."""
    b, t, h, hd = q.shape
    _, bs, kh, _ = k_pool.shape
    g = h // kh
    dev = q.device
    cb = pick_chunk_blocks(block_table.shape[1], bs, chunk_blocks)
    table = padded_table(block_table, cb).long()
    nc = table.shape[1] // cb
    ct = cb * bs
    length, n_valid = length.long(), n_valid.long()
    # 1. scatter the valid new tokens (invalid lanes write nothing)
    ar = torch.arange(t, device=dev)
    pos = length[:, None] + ar[None, :]
    rows, cols = torch.nonzero(ar[None, :] < n_valid[:, None], as_tuple=True)
    p_ = pos[rows, cols]
    phys = table[rows, torch.clamp(p_ // bs, max=table.shape[1] - 1)]
    k_pool[phys, p_ % bs] = k_new[rows, cols].to(k_pool.dtype)
    v_pool[phys, p_ % bs] = v_new[rows, cols].to(v_pool.dtype)
    # 2. per-chunk partials
    kc = k_pool[table].reshape(b, nc, ct, kh, hd).float()
    vc = v_pool[table].reshape(b, nc, ct, kh, hd)
    qf = q.float().reshape(b, t, kh, g, hd) * (hd ** -0.5)
    s = torch.einsum("btkgd,bcskd->bctkgs", qf, kc)
    kv_pos = (torch.arange(nc, device=dev)[:, None] * ct
              + torch.arange(ct, device=dev)[None, :])                # (nc, ct)
    visible = kv_pos[None, :, None, :] <= pos[:, None, :, None]      # (b, nc, t, ct)
    vis = visible[:, :, :, None, None, :]
    s = torch.where(vis, s, NEG_INF)
    m = s.amax(dim=-1)                                                # (b, nc, t, kh, g)
    p = torch.where(vis, torch.exp(s - m[..., None]), 0.0)
    den = p.sum(dim=-1)
    acc = torch.einsum("bctkgs,bcskd->bctkgd", p.to(vc.dtype).float(), vc.float())
    return combine(acc.reshape(b, nc, t, h, hd), m.reshape(b, nc, t, h),
                   den.reshape(b, nc, t, h), q.dtype)


def _check(q, k_new, v_new, k_pool, v_pool, block_table, length, n_valid):
    if q.ndim != 4 or k_new.ndim != 4 or v_new.ndim != 4 or k_pool.ndim != 4:
        raise ValueError("q, k_new, v_new must be (b, t, heads, hd) and the "
                         "pools (n_blocks, block_size, kh, hd)")
    b, t, h, hd = q.shape
    _, bs, kh, phd = k_pool.shape
    if (tuple(k_new.shape) != (b, t, kh, hd) or v_new.shape != k_new.shape
            or v_pool.shape != k_pool.shape or phd != hd or h % kh):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, k_new {tuple(k_new.shape)}, "
            f"v_new {tuple(v_new.shape)}, pools {tuple(k_pool.shape)} / "
            f"{tuple(v_pool.shape)}")
    if block_table.ndim != 2 or block_table.shape[0] != b \
            or tuple(length.shape) != (b,) or tuple(n_valid.shape) != (b,):
        raise ValueError(f"block_table must be (b, mb) and length, n_valid (b,); "
                         f"got {tuple(block_table.shape)}, {tuple(length.shape)}, "
                         f"{tuple(n_valid.shape)}")
    dtypes = {x.dtype for x in (q, k_new, v_new, k_pool, v_pool)}
    if len(dtypes) != 1 or q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError("q, k_new, v_new and the pools must share one dtype, "
                        f"bfloat16 or float32; got {sorted(map(str, dtypes))}")
    for name, x in (("block_table", block_table), ("length", length),
                    ("n_valid", n_valid)):
        if x.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"{name} must be an integer tensor, got {x.dtype}")


def _plain_path(tensors, what: str) -> bool:
    """True when every tensor lies on the CPU (the plain path), False when
    all lie on one CUDA device; raise otherwise."""
    if all(x.device.type == "cpu" for x in tensors):
        return True
    dev = tensors[0].device
    if dev.type != "cuda" or any(x.device != dev for x in tensors):
        raise ValueError(f"{what} must all be on one CUDA device (or all on the CPU)")
    return False


def _launch_combine(lib, acc, m, den, out) -> None:
    """The combine kernel on contiguous fp32 partials acc (b, nc, t, h,
    hd), m and den (b, nc, t, h), into `out` (b, t, h, hd), bfloat16 or
    float32. Chunks with m == NEG_INF are skipped unread."""
    global COMBINE_LAUNCHES
    from . import _build

    b, nc, t, h, hd = acc.shape
    stream = torch.cuda.current_stream().cuda_stream
    status = lib.paged_combine_launch(acc.data_ptr(), m.data_ptr(), den.data_ptr(),
                                      out.data_ptr(), b, nc, t, h, hd,
                                      1 if out.dtype == torch.bfloat16 else 0, stream)
    _build.check(status, "paged_combine_launch")
    with _COUNT_LOCK:
        COMBINE_LAUNCHES += 1


def paged_attend_fused(q, k_new, v_new, k_pool, v_pool, block_table, length,
                       n_valid, chunk_blocks: Optional[int] = None) -> torch.Tensor:
    """Fused scatter + block-table attention; the pools are written in
    place. Returns out (b, t, h, hd) in q.dtype. `chunk_blocks` overrides
    the blocks per KV chunk (default CHUNK_TOKENS // block_size)."""
    global LAUNCHES
    _check(q, k_new, v_new, k_pool, v_pool, block_table, length, n_valid)
    tensors = (q, k_new, v_new, k_pool, v_pool, block_table, length, n_valid)
    if _plain_path(tensors, "q, k_new, v_new, the pools, block_table, length and n_valid"):
        return paged_attend_fused_ref(*tensors, chunk_blocks=chunk_blocks)
    if not all(x.is_contiguous() for x in (q, k_new, v_new, k_pool, v_pool)):
        raise ValueError("q, k_new, v_new and the pools must be contiguous")
    b, t, h, hd = q.shape
    _, bs, kh, _ = k_pool.shape
    bf16 = q.dtype == torch.bfloat16
    if hd % (16 if bf16 else 4) or hd > MAX_HEAD_DIM:
        raise ValueError(f"the CUDA kernel takes a head_dim up to {MAX_HEAD_DIM} that is a "
                         f"multiple of 16 for bfloat16, of 4 for float32; got {hd}")
    if any(x.data_ptr() % 16 for x in (q, k_new, v_new, k_pool, v_pool)):
        raise ValueError("q, k_new, v_new and the pools must start on 16-byte boundaries")
    from . import _build

    lib = _build.load_library()
    mb = block_table.shape[1]
    cb = pick_chunk_blocks(mb, bs, chunk_blocks)
    nc = -(-mb // cb)
    out = torch.empty_like(q)
    if b == 0 or t == 0 or mb == 0:
        return out.zero_()
    table = block_table.to(torch.int32).contiguous()
    length32 = length.to(torch.int32).contiguous()
    nv32 = n_valid.to(torch.int32).contiguous()
    acc = torch.empty((b, nc, t, h, hd), dtype=torch.float32, device=q.device)
    m = torch.empty((b, nc, t, h), dtype=torch.float32, device=q.device)
    den = torch.empty((b, nc, t, h), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.paged_attend_launch(
            q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), table.data_ptr(), length32.data_ptr(),
            nv32.data_ptr(), acc.data_ptr(), m.data_ptr(), den.data_ptr(),
            b, t, h, kh, hd, bs, mb, cb, 1 if bf16 else 0, hd ** -0.5, stream)
        _build.check(status, "paged_attend_launch")
        with _COUNT_LOCK:
            LAUNCHES += 1
        _launch_combine(lib, acc, m, den, out)
    return out
