"""Hierarchical local/global top-k (paper Fig. 3a).

PyTorch counterpart of `repro.core.topk`. `jax.lax.top_k` breaks ties
toward the LOWER index; `torch.topk` promises no order among ties, so
every selection here is a stable descending sort, which keeps equal
scores in index order.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class TopK(NamedTuple):
    scores: torch.Tensor   # (..., k) fp32, descending
    indices: torch.Tensor  # (..., k) int32, global document ids


def _stable_topk(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    v, i = torch.sort(scores, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def local_topk(scores: torch.Tensor, k: int) -> TopK:
    """Plain top-k over the last axis, lower index first among ties."""
    if k > scores.shape[-1]:
        raise ValueError(f"k={k} exceeds {scores.shape[-1]} candidates")
    v, i = _stable_topk(scores, k)
    return TopK(scores=v, indices=i.int())


def hierarchical_topk(scores: torch.Tensor, k: int, n_cores: int = 16) -> TopK:
    """Split the score vector into `n_cores` shards, local top-k per shard,
    then a global top-k over the n_cores*k candidates. Equals
    `local_topk(scores, k)`, tie-break included.

    scores: (..., n) with n divisible by n_cores.
    """
    *lead, n = scores.shape
    if n % n_cores:
        raise ValueError(f"n={n} not divisible by n_cores={n_cores}")
    per = n // n_cores
    s = scores.reshape(*lead, n_cores, per)
    lv, li = _stable_topk(s, min(k, per))                  # (..., cores, k)
    offset = (torch.arange(n_cores, dtype=torch.int64, device=scores.device)
              * per)[:, None]
    flat_v = lv.reshape(*lead, -1)
    flat_i = (li + offset).reshape(*lead, -1)
    # Candidates are core-major and score-descending within a core, so for
    # equal scores the lower candidate position also has the lower doc id:
    # a stable sort over positions keeps the global lower-index tie-break.
    gv, gpos = _stable_topk(flat_v, k)
    gid = torch.gather(flat_i, -1, gpos)
    return TopK(scores=gv, indices=gid.int())


def merge_candidates(scores: torch.Tensor, indices: torch.Tensor, k: int) -> TopK:
    """Top-k over a (..., m) candidate list by (-score, index), for
    candidates in any order."""
    key = torch.sort(indices, dim=-1, stable=True).indices
    v = torch.gather(scores, -1, key)
    i = torch.gather(indices, -1, key)
    order = torch.sort(-v, dim=-1, stable=True).indices
    v = torch.gather(v, -1, order)[..., :k]
    i = torch.gather(i, -1, order)[..., :k]
    return TopK(scores=v, indices=i)


def precision_at_k(retrieved: torch.Tensor, relevant: torch.Tensor,
                   k: int) -> torch.Tensor:
    """P@k: fraction of the top-k retrieved ids that are relevant.

    retrieved: (q, >=k) int ids; relevant: (q, r) int ids (pad with -1).
    """
    top = retrieved[..., :k]
    hit = (top[..., :, None] == relevant[..., None, :]) & (relevant[..., None, :] >= 0)
    return torch.mean(hit.any(dim=-1).sum(dim=-1) / k)
