"""GQA attention: chunked online-softmax prefill, dense KV-cache decode and
block-table (paged) attention.

PyTorch counterpart of `repro.models.attention` (`_project_qkv`,
`_chunked_attention`, `attend_train`, `cross_attention`, `prefill`,
`decode_step`, `PagedKVCache`, `_paged_write`, `paged_attend`), with the
q/k/v biases and the padded query heads (`cfg.effective_n_heads`). Layouts are the JAX package's:
activations (b, s, h, hd), caches (b, S, kh, hd), pools (n_blocks,
block_size, kh, hd). GQA never repeats KV heads: the queries are grouped
as (kv_head, group).

Score and P.V products accumulate in fp32 as `preferred_element_type=f32`
does in JAX (inputs upcast to fp32, which is exact for bf16), and the
probabilities are cast to the query dtype before P.V.

Tensor parallelism over a mesh's `model` dim of m > 1 ranks (the serve
and prefill steps, `launch.steps`; `sharding.shard_model` cuts the
weights). Where the reference's divisibility guard shards the heads
(`sharding._attn_divisibility`), `wq` / `bq` hold this rank's h/m query
heads, `wk` / `wv` / `bk` / `bv` its kh/m KV heads (only when kh divides
too), and `wo` the rows of its query heads: each rank projects its heads,
and the output projection ends in one all-reduce over `model`. Query
heads split over KV heads that are not (MQA, or kh < m) read their own
KV head, each picked out of the whole K/V. Nothing is split where the
heads do not divide: every rank computes the whole attention.

Decode on the sequence-sharded cache (`decode_step` at m > 1; the
reference's "SP / flash-decoding layout", `launch.steps.cache_shardings`
puts the cache's sequence over `model`). Rank r holds positions [r S/m,
(r+1) S/m) of every KV head, so:
  1. every rank needs every head's query and the new token's K/V: the
     split ones go round in one all-gather (b·h·hd elements of q, and
     2·b·kh·hd of K/V where those are split);
  2. the rank that owns position length[b] writes the new K/V there (a
     row at capacity has no owner and writes nothing, as the reference's
     one-hot overwrite);
  3. each rank takes a partial softmax over its slice in fp32: the row
     max m_r, the sum of exponentials l_r and the weighted V o_r, over
     the positions <= length[b] (none: m_r = -1e30, l_r = o_r = 0);
  4. one all-gather of (o_r, l_r, m_r) and every rank combines them in
     rank order with the flash-decoding rescale, o = sum_r e^(m_r - M)
     o_r / sum_r e^(m_r - M) l_r with M = max_r m_r: the same on every
     rank, so the residual stream stays replicated;
  5. a rank whose query heads are split keeps its heads' rows for its
     rows of `wo` and the all-reduce.
The probabilities stay fp32 through P.V here (the mesh-less step casts
them to the query dtype first), so at fp32 the steps agree within
rounding and at bf16 the sharded one rounds less. At m of 1 the
mesh-less code runs, bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import dtype as dt
from . import rope as rope_mod
from . import sharding

NEG_INF = -1.0e30


class KVCache(NamedTuple):
    k: torch.Tensor       # (b, S, kv_heads, hd)
    v: torch.Tensor       # (b, S, kv_heads, hd)
    length: torch.Tensor  # (b,) int32 — valid prefix length


def heads(cfg: ModelConfig) -> tuple[int, int, int]:
    """(query heads, KV heads, head dim): the query heads padded to
    `cfg.effective_n_heads`, whose extra heads are real weights."""
    return cfg.effective_n_heads, cfg.n_kv_heads, cfg.resolved_head_dim


def project_qkv(cfg: ModelConfig, p, x: torch.Tensor, angles: Optional[torch.Tensor],
                h: Optional[int] = None, kh: Optional[int] = None):
    """q (b, s, h, hd), k and v (b, s, kh, hd) in the compute dtype, with
    the biases `p.bq` / `p.bk` / `p.bv` where `cfg.attn_bias` is set and
    q and k rotated by `angles` (None: no positions). `h` / `kh` default
    to the config's heads (an encoder passes its own); the head dim is
    the weights' (`p.wq` is (d, h * hd))."""
    h, kh = _local_heads(p, h or cfg.effective_n_heads, kh or cfg.n_kv_heads)
    hd = p.wq.shape[1] // h
    cdt = dt(cfg.compute_dtype)
    x = x.to(cdt)
    b, s, _ = x.shape
    q, k, v = x @ p.wq.to(cdt), x @ p.wk.to(cdt), x @ p.wv.to(cdt)
    if cfg.attn_bias:
        q, k, v = q + p.bq.to(cdt), k + p.bk.to(cdt), v + p.bv.to(cdt)
    q, k, v = q.reshape(b, s, h, hd), k.reshape(b, s, kh, hd), v.reshape(b, s, kh, hd)
    if angles is not None:
        q = rope_mod.apply_rotary(q, angles)
        k = rope_mod.apply_rotary(k, angles)
    return q, k, v


def _local_heads(p, h: int, kh: int) -> tuple[int, int]:
    """(query heads, KV heads) of the `h` / `kh` that this rank projects:
    1/m of those whose projection is split over `model`."""
    m = sharding.tp_size()
    return (h // m if sharding.split_dim(p.wq) is not None else h,
            kh // m if sharding.split_dim(p.wk) is not None else kh)


def _kv_of_local_q(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, h: int, kh: int):
    """K/V for this rank's query heads: as they are, or, where the query
    heads are split over `model` and the `kh` KV heads are whole, each
    local query head's KV head picked out (a grouping of 1)."""
    hl = q.shape[2]
    if hl == h or k.shape[2] != kh:
        return k, v
    idx = (sharding.tp_rank() * hl + torch.arange(hl, device=q.device)) // (h // kh)
    return k[:, :, idx], v[:, :, idx]


def _out_proj(cfg: ModelConfig, p, out: torch.Tensor) -> torch.Tensor:
    """out (b, s, heads * hd) @ `wo`: a row-parallel `wo` sums over
    `model`."""
    cdt = dt(cfg.compute_dtype)
    y = out.to(cdt) @ p.wo.to(cdt)
    if sharding.split_dim(p.wo) is not None:
        y = sharding.tp_all_reduce(y)
    return y


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      chunk_q: int, chunk_kv: int, causal: bool = True) -> torch.Tensor:
    """(b, sq, h, d) x (b, skv, kh, d) -> (b, sq, h, d), online softmax
    over KV chunks; causal (query i sees keys <= i) unless `causal` is
    False (an encoder, cross attention). Non-divisible lengths are padded
    to chunk multiples and masked; the first KV chunk is always valid, so
    the running max is finite before any padded column is seen."""
    b, sq, h, d = q.shape
    _, skv, kh, _ = k.shape
    g = h // kh
    scale = d**-0.5
    cq = min(chunk_q, sq) if chunk_q else sq
    ckv = min(chunk_kv, skv) if chunk_kv else skv
    pq, pkv = (-sq) % cq, (-skv) % ckv
    if pq:
        q = F.pad(q, (0, 0, 0, 0, 0, pq))
    if pkv:
        k = F.pad(k, (0, 0, 0, 0, 0, pkv))
        v = F.pad(v, (0, 0, 0, 0, 0, pkv))
    sq_p, skv_p = sq + pq, skv + pkv
    dev = q.device
    qs = (q * scale).reshape(b, sq_p, kh, g, d)
    q_pos = torch.arange(sq_p, device=dev)
    k_pos = torch.arange(skv_p, device=dev)
    outs = []
    for q0 in range(0, sq_p, cq):
        qb = qs[:, q0:q0 + cq].float()                      # (b, cq, kh, g, d)
        acc = torch.zeros((b, cq, kh, g, d), dtype=torch.float32, device=dev)
        m = torch.full((b, kh, g, cq), NEG_INF, dtype=torch.float32, device=dev)
        denom = torch.zeros((b, kh, g, cq), dtype=torch.float32, device=dev)
        for k0 in range(0, skv_p, ckv):
            kb = k[:, k0:k0 + ckv]
            vb = v[:, k0:k0 + ckv]
            kp = k_pos[k0:k0 + ckv]
            s = torch.einsum("bqkgd,bskd->bkgqs", qb, kb.float())
            mask = None
            if causal:
                mask = q_pos[q0:q0 + cq][:, None] >= kp[None, :]
            if pkv:
                kv_ok = (kp < skv)[None, :]
                mask = kv_ok if mask is None else mask & kv_ok
            if mask is not None:
                s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            denom = denom * corr + p.sum(dim=-1)
            pv = torch.einsum("bkgqs,bskd->bqkgd", p.to(q.dtype).float(), vb.float())
            acc = acc * corr.permute(0, 3, 1, 2)[..., None] + pv
            m = m_new
        outs.append(acc / denom.permute(0, 3, 1, 2)[..., None])
    out = torch.cat(outs, dim=1).reshape(b, sq_p, h, d)
    return out[:, :sq].to(q.dtype)


def attend_train(cfg: ModelConfig, p, x: torch.Tensor, angles: Optional[torch.Tensor],
                 h: Optional[int] = None, kh: Optional[int] = None,
                 causal: bool = True) -> torch.Tensor:
    """Full-sequence attention x (b, s, d) -> (b, s, d) with no cache (an
    encoder's, or a whole-sequence forward's); `h` / `kh` as in
    `project_qkv`."""
    h, kh = h or cfg.effective_n_heads, kh or cfg.n_kv_heads
    q, k, v = project_qkv(cfg, p, x, angles, h, kh)
    k, v = _kv_of_local_q(q, k, v, h, kh)
    out = chunked_attention(q, k, v, cfg.attn_chunk, cfg.attn_chunk, causal=causal)
    b, s, hl, hd = out.shape
    return _out_proj(cfg, p, out.reshape(b, s, hl * hd))


def cross_attention(cfg: ModelConfig, p, x: torch.Tensor, kv_src: torch.Tensor,
                    h: int, kh: int) -> torch.Tensor:
    """Encoder-decoder cross attention (whisper): queries from x (b, s, d),
    keys and values from `kv_src` (b, F, d); no rotary positions, no mask."""
    hd = p.wq.shape[1] // h
    cdt = dt(cfg.compute_dtype)
    b, s, _ = x.shape
    q = (x.to(cdt) @ p.wq.to(cdt)).reshape(b, s, h, hd)
    k = (kv_src.to(cdt) @ p.wk.to(cdt)).reshape(b, -1, kh, hd)
    v = (kv_src.to(cdt) @ p.wv.to(cdt)).reshape(b, -1, kh, hd)
    out = chunked_attention(q, k, v, cfg.attn_chunk, cfg.attn_chunk, causal=False)
    return out.reshape(b, s, h * hd).to(cdt) @ p.wo.to(cdt)


def prefill(cfg: ModelConfig, p, x: torch.Tensor, angles: Optional[torch.Tensor],
            cache_len: int):
    """Causal attention over the prompt + a KV cache of capacity cache_len."""
    h, kh, hd = heads(cfg)
    q, k, v = project_qkv(cfg, p, x, angles)
    out = chunked_attention(q, k, v, cfg.attn_chunk, cfg.attn_chunk)
    b, s, _, _ = out.shape
    cdt = dt(cfg.compute_dtype)
    y = out.reshape(b, s, h * hd).to(cdt) @ p.wo.to(cdt)
    pad = cache_len - s
    kc = F.pad(k, (0, 0, 0, 0, 0, pad))
    vc = F.pad(v, (0, 0, 0, 0, 0, pad))
    length = torch.full((b,), s, dtype=torch.int32, device=x.device)
    return y, KVCache(k=kc, v=vc, length=length)


def decode_step(cfg: ModelConfig, p, x: torch.Tensor, cache: KVCache,
                angles: Optional[torch.Tensor]):
    """One-token decode: x (b, 1, d) against the cache; returns (y, cache').

    The new K/V overwrite position `cache.length[b]` of each row IN PLACE
    (the JAX package returns a new cache; writing in place saves a full
    cache copy per layer and step). A row whose length is already at the
    cache capacity writes nothing, as the JAX one-hot overwrite does.
    Attention masks positions > length. Under a `model` dim of m > 1 the
    cache holds this rank's 1/m of the positions (the module note)."""
    if sharding.tp_size() > 1:
        return _decode_step_sp(cfg, p, x, cache, angles)
    h, kh, hd = heads(cfg)
    q, k_new, v_new = project_qkv(cfg, p, x, angles)
    b = x.shape[0]
    k, v = cache.k, cache.v
    S = k.shape[1]
    pos = cache.length.long()
    rows = torch.nonzero(pos < S).flatten()
    k[rows, pos[rows]] = k_new[rows, 0].to(k.dtype)
    v[rows, pos[rows]] = v_new[rows, 0].to(v.dtype)
    g = h // kh
    qg = q.reshape(b, 1, kh, g, hd) * hd**-0.5
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float())
    valid = torch.arange(S, device=x.device)[None, :] <= pos[:, None]   # (b, S)
    s = torch.where(valid[:, None, None, None], s, NEG_INF)
    probs = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v).reshape(b, 1, h * hd)
    cdt = dt(cfg.compute_dtype)
    y = out.to(cdt) @ p.wo.to(cdt)
    return y, KVCache(k=k, v=v, length=cache.length + 1)


def _every_head(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, h: int, kh: int):
    """Every head's q, k and v on every rank: those split over `model`
    gathered in one all-gather (head order is rank order)."""
    split = [t.shape[2] < n for t, n in ((q, h), (k, kh), (v, kh))]
    if not any(split):
        return q, k, v
    mine = [t for t, s in zip((q, k, v), split) if s]
    every = sharding.tp_all_gather(torch.cat(mine, dim=2)[None], dim=0)  # (m, b, 1, n, hd)
    parts = iter(every.split([t.shape[2] for t in mine], dim=3))
    out = []
    for t, s in zip((q, k, v), split):
        if s:
            part = next(parts)                                # (m, b, 1, heads, hd)
            t = part.movedim(0, 2).reshape(t.shape[0], t.shape[1], -1, t.shape[3])
        out.append(t)
    return tuple(out)


def _decode_step_sp(cfg: ModelConfig, p, x: torch.Tensor, cache: KVCache,
                    angles: Optional[torch.Tensor]):
    """`decode_step` on this rank's slice of a sequence-sharded cache over
    `model` (the module note's five steps)."""
    h, kh, hd = heads(cfg)
    q, k_new, v_new = project_qkv(cfg, p, x, angles)
    hl = q.shape[2]
    q, k_new, v_new = _every_head(q, k_new, v_new, h, kh)
    b = x.shape[0]
    k, v = cache.k, cache.v
    S = k.shape[1]
    r = sharding.tp_rank()
    off = r * S
    pos = cache.length.long()
    rows = torch.nonzero((pos >= off) & (pos < off + S)).flatten()
    k[rows, pos[rows] - off] = k_new[rows, 0].to(k.dtype)
    v[rows, pos[rows] - off] = v_new[rows, 0].to(v.dtype)
    g = h // kh
    qg = q.reshape(b, 1, kh, g, hd) * hd**-0.5
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float())        # (b, kh, g, 1, S)
    valid = (off + torch.arange(S, device=x.device))[None, :] <= pos[:, None]
    valid = valid[:, None, None, None]
    s = torch.where(valid, s, NEG_INF)
    m_r = s.amax(dim=-1, keepdim=True)
    e = torch.where(valid, torch.exp(s - m_r), 0.0)
    part = torch.cat([torch.einsum("bkgqs,bskd->bkgqd", e, v.float()),
                      e.sum(dim=-1, keepdim=True), m_r], dim=-1)         # (b, kh, g, 1, hd + 2)
    every = sharding.tp_all_gather(part[None], dim=0)
    o_r, l_r, m_r = every[..., :hd], every[..., hd:hd + 1], every[..., hd + 1:]
    w = torch.exp(m_r - m_r.amax(dim=0))
    out = (o_r * w).sum(dim=0) / (l_r * w).sum(dim=0)                   # (b, kh, g, 1, hd)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, 1, h, hd).to(q.dtype)
    if hl < h:
        out = out[:, :, r * hl:(r + 1) * hl]
    y = _out_proj(cfg, p, out.reshape(b, 1, hl * hd))
    return y, KVCache(k=k, v=v, length=cache.length + 1)


class PagedKVCache(NamedTuple):
    """Per-layer view of the block-pooled KV cache (serving memory model).

    The pools are shared by every sequence: row b's logical positions
    live in the physical blocks its `block_table` row names, in order.
    Block `serving.paged_cache.NULL_BLOCK` (physical 0) is scratch —
    inactive lanes point every table entry at it. Allocation is host-side
    (`serving.paged_cache.PagedCacheManager`)."""

    k_pool: torch.Tensor       # (n_blocks, block_size, kh, hd)
    v_pool: torch.Tensor       # (n_blocks, block_size, kh, hd)
    block_table: torch.Tensor  # (b, max_blocks) int32 physical block ids
    length: torch.Tensor       # (b,) int32 — tokens already written


def paged_write(pool: torch.Tensor, new: torch.Tensor, cache: PagedKVCache,
                n_valid: torch.Tensor) -> torch.Tensor:
    """Scatter `new` (b, t, kh, hd) into `pool` IN PLACE at each row's next
    `n_valid[b]` logical positions; invalid lanes land in NULL_BLOCK
    (block 0, offset 0), as the JAX `_paged_write` sends them. Returns
    `pool`."""
    b, t = new.shape[:2]
    block_size = pool.shape[1]
    mb = cache.block_table.shape[1]
    ar = torch.arange(t, device=pool.device)
    pos = cache.length.long()[:, None] + ar[None, :]                  # (b, t)
    valid = ar[None, :] < n_valid.long()[:, None]                     # (b, t)
    blk = torch.gather(cache.block_table.long(), 1,
                       torch.clamp(pos // block_size, 0, mb - 1))
    blk = torch.where(valid, blk, 0)
    off = torch.where(valid, pos % block_size, 0)
    pool[blk, off] = new.to(pool.dtype)
    return pool


def paged_attend(cfg: ModelConfig, p, x: torch.Tensor, cache: PagedKVCache,
                 angles: Optional[torch.Tensor], n_valid: torch.Tensor,
                 paged_kernel: Optional[bool] = None):
    """Block-table attention over `t` new positions per row.

    x (b, t, d) holds each row's next `n_valid[b] <= t` tokens starting
    at logical position `cache.length[b]` (t == 1 is the decode step,
    t == prefill_chunk one chunked-prefill piece). The new K/V are
    scattered into the shared pools IN PLACE at those positions, then
    each row attends its logical window with a causal + true-length mask
    (position j is visible to query i iff j <= length + i). Returns
    (y (b, t, d), k_pool, v_pool); rows past n_valid are garbage the
    caller ignores.

    `paged_kernel` (falling back to `cfg.paged_kernel`) picks the path:
    * gather (default, K3's oracle): `paged_write`, then gather the full
      (b, max_blocks * block_size) window through the table. Rounding
      mirrors the JAX gather path: q is scaled in the compute dtype (the
      scale rounded to that dtype first, as XLA does with a weak-typed
      constant), scores and softmax in fp32, the probabilities cast to
      q's dtype before P.V;
    * fused: `kernels.paged_attend.paged_attend_fused` (K3), the scatter
      and split-KV flash-decoding in one launch on the card.
    """
    h, kh, hd = heads(cfg)
    q, k_new, v_new = project_qkv(cfg, p, x, angles)
    b, t = x.shape[:2]
    cdt = dt(cfg.compute_dtype)
    use_kernel = cfg.paged_kernel if paged_kernel is None else paged_kernel
    if use_kernel:
        from repro_torch.kernels.paged_attend import paged_attend_fused

        pdt = cache.k_pool.dtype
        out = paged_attend_fused(
            q.contiguous(), k_new.to(pdt).contiguous(), v_new.to(pdt).contiguous(),
            cache.k_pool, cache.v_pool, cache.block_table, cache.length, n_valid)
        y = out.reshape(b, t, h * hd).to(cdt) @ p.wo.to(cdt)
        return y, cache.k_pool, cache.v_pool
    k_pool = paged_write(cache.k_pool, k_new, cache, n_valid)
    v_pool = paged_write(cache.v_pool, v_new, cache, n_valid)
    block_size = k_pool.shape[1]
    mb = cache.block_table.shape[1]
    S = mb * block_size
    tbl = cache.block_table.long()
    k = k_pool[tbl].reshape(b, S, kh, hd)
    v = v_pool[tbl].reshape(b, S, kh, hd)
    g = h // kh
    qg = q.reshape(b, t, kh, g, hd) * torch.tensor(hd**-0.5, dtype=q.dtype)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float())
    q_pos = cache.length.long()[:, None] + torch.arange(t, device=x.device)[None, :]
    kv_pos = torch.arange(S, device=x.device)[None, None, :]
    visible = kv_pos <= q_pos[:, :, None]                             # (b, t, S)
    s = torch.where(visible[:, None, None], s, NEG_INF)
    probs = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.to(q.dtype)).reshape(b, t, h * hd)
    y = out.to(cdt) @ p.wo.to(cdt)
    return y, k_pool, v_pool
