"""Plain PyTorch oracles mirroring `repro.kernels.ref` (the correctness
contract of the ported kernels), in the callers' natural layouts."""
from __future__ import annotations

import torch

from repro_torch.core import bitplane
from .score_matmul import score_matmul_cosine_ref, score_matmul_int_ref
from .topk_select import blockwise_topk_ref


def dirc_mac(q_values: torch.Tensor, d_planes_dense: torch.Tensor,
             bits: int = 8) -> torch.Tensor:
    """Oracle for K1: exact int32 inner products.

    q_values: (b, dim) int8 codes; d_planes_dense: (n, bits, dim) {0,1}.
    """
    return bitplane.bitserial_dot(q_values, d_planes_dense, bits=bits)


def score_matmul_int(q: torch.Tensor, docs: torch.Tensor) -> torch.Tensor:
    """Oracle for K2: (b, n) int32 = q @ docs^T."""
    return score_matmul_int_ref(q, docs)


def score_matmul_cosine(q: torch.Tensor, docs: torch.Tensor, q_norms: torch.Tensor,
                        doc_norms: torch.Tensor) -> torch.Tensor:
    """Oracle for K5: (b, n) fp32 = (q @ docs^T) / max(q_norms * doc_norms, 1e-12)."""
    return score_matmul_cosine_ref(q, docs, q_norms, doc_norms)


def blockwise_topk(scores: torch.Tensor, k: int, block_n: int):
    """Oracle for K4: per-block top-k, lower index first among ties."""
    return blockwise_topk_ref(scores, k, block_n)
