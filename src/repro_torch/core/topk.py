"""Hierarchical local/global top-k (paper Fig. 3a).

PyTorch counterpart of `repro.core.topk`. `jax.lax.top_k` breaks ties
toward the LOWER index and compares floats in XLA's total order (+0.0
above -0.0); `torch.topk` promises no order among ties, so every
selection here is a stable descending sort on `topk_select.order_key`.
`hierarchical_topk` (one local comparator per core, then the global
comparator over their candidates) is one launch of
`kernels.topk_select.hierarchical_select` on the card; its plain version
on the CPU is K4's plain version per core and a stable merge.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import topk_select


class TopK(NamedTuple):
    scores: torch.Tensor   # (..., k) fp32, descending
    indices: torch.Tensor  # (..., k) int32, global document ids


def local_topk(scores: torch.Tensor, k: int) -> TopK:
    """Plain top-k over the last axis, lower index first among ties."""
    if k > scores.shape[-1]:
        raise ValueError(f"k={k} exceeds {scores.shape[-1]} candidates")
    i = topk_select.sort_desc(scores)[..., :k]
    return TopK(scores=torch.gather(scores, -1, i), indices=i.int())


def hierarchical_topk(scores: torch.Tensor, k: int, n_cores: int = 16) -> TopK:
    """Split the score vector into `n_cores` shards, local top-k per shard,
    then a global top-k over the n_cores*k candidates. Equals
    `local_topk(scores, k)`, tie-break included.

    scores: (..., n) with n divisible by n_cores.
    """
    *lead, n = scores.shape
    if n % n_cores:
        raise ValueError(f"n={n} not divisible by n_cores={n_cores}")
    v, i = topk_select.hierarchical_select(scores.reshape(-1, n), k, n_cores)
    return TopK(scores=v.reshape(*lead, -1), indices=i.reshape(*lead, -1))


def merge_candidates(scores: torch.Tensor, indices: torch.Tensor, k: int) -> TopK:
    """Top-k over a (..., m) candidate list by (-score, index), for
    candidates in any order. A float sort, as the JAX package's
    `jnp.argsort` is: +0.0 and -0.0 tie (unlike `lax.top_k`'s order) and
    the lower index wins."""
    key = torch.sort(indices, dim=-1, stable=True).indices
    v = torch.gather(scores, -1, key)
    i = torch.gather(indices, -1, key)
    order = torch.sort(-v, dim=-1, stable=True).indices
    v = torch.gather(v, -1, order)[..., :k]
    i = torch.gather(i, -1, order)[..., :k]
    return TopK(scores=v, indices=i)


def merge_topk(a: TopK, b: TopK, k: int) -> TopK:
    """Merge two candidate lists into a single top-k (global comparator)."""
    return merge_candidates(torch.cat([a.scores, b.scores], dim=-1),
                            torch.cat([a.indices, b.indices], dim=-1), k)


def precision_at_k(retrieved: torch.Tensor, relevant: torch.Tensor,
                   k: int) -> torch.Tensor:
    """P@k: fraction of the top-k retrieved ids that are relevant.

    retrieved: (q, >=k) int ids; relevant: (q, r) int ids (pad with -1).
    """
    top = retrieved[..., :k]
    hit = (top[..., :, None] == relevant[..., None, :]) & (relevant[..., None, :] >= 0)
    return torch.mean(hit.any(dim=-1).sum(dim=-1) / k)
