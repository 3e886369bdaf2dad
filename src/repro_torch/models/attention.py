"""GQA attention: chunked online-softmax prefill + dense KV-cache decode.

PyTorch counterpart of `repro.models.attention` (`_project_qkv`,
`_chunked_attention`, `prefill`, `decode_step`); the paged path comes
with the paged serving slice. Layouts are the JAX package's: activations
(b, s, h, hd), caches (b, S, kh, hd). GQA never repeats KV heads: the
queries are grouped as (kv_head, group).

Score and P.V products accumulate in fp32 as `preferred_element_type=f32`
does in JAX (inputs upcast to fp32, which is exact for bf16), and the
probabilities are cast to the query dtype before P.V.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import dtype as dt
from . import rope as rope_mod

NEG_INF = -1.0e30


class KVCache(NamedTuple):
    k: torch.Tensor       # (b, S, kv_heads, hd)
    v: torch.Tensor       # (b, S, kv_heads, hd)
    length: torch.Tensor  # (b,) int32 — valid prefix length


def project_qkv(cfg: ModelConfig, p, x: torch.Tensor, h: int, kh: int, hd: int):
    cdt = dt(cfg.compute_dtype)
    x = x.to(cdt)
    b, s, _ = x.shape
    q = (x @ p.wq.to(cdt)).reshape(b, s, h, hd)
    k = (x @ p.wk.to(cdt)).reshape(b, s, kh, hd)
    v = (x @ p.wv.to(cdt)).reshape(b, s, kh, hd)
    return q, k, v


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      chunk_q: int, chunk_kv: int) -> torch.Tensor:
    """(b, sq, h, d) x (b, skv, kh, d) -> (b, sq, h, d), causal, online
    softmax over KV chunks. Non-divisible lengths are padded to chunk multiples and
    masked; the first KV chunk is always valid, so the running max is
    finite before any padded column is seen."""
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
            mask = q_pos[q0:q0 + cq][:, None] >= kp[None, :]
            if pkv:
                mask = mask & (kp < skv)[None, :]
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


def prefill(cfg: ModelConfig, p, x: torch.Tensor, angles: torch.Tensor,
            cache_len: int):
    """Causal attention over the prompt + a KV cache of capacity cache_len."""
    h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q, k, v = project_qkv(cfg, p, x, h, kh, hd)
    q = rope_mod.apply_rotary(q, angles)
    k = rope_mod.apply_rotary(k, angles)
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
                angles: torch.Tensor):
    """One-token decode: x (b, 1, d) against the cache; returns (y, cache').

    The new K/V overwrite position `cache.length[b]` of each row IN PLACE
    (the JAX package returns a new cache; writing in place saves a full
    cache copy per layer and step). A row whose length is already at the
    cache capacity writes nothing, as the JAX one-hot overwrite does.
    Attention masks positions > length."""
    h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q, k_new, v_new = project_qkv(cfg, p, x, h, kh, hd)
    q = rope_mod.apply_rotary(q, angles)
    k_new = rope_mod.apply_rotary(k_new, angles)
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
