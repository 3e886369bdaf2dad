"""Public wrappers around the ported kernels (counterpart of
`repro.kernels.ops`): query packing, the layout transpose into the
kernels' layouts and the 1-D query squeeze. The score kernels mask a
ragged n themselves, so only the top-k kernel's input is padded to a
block multiple.

Dispatch goes by the tensors' device only: CPU tensors take each
kernel's plain version, CUDA tensors launch the kernel (or raise).
"""
from __future__ import annotations

import torch

from repro_torch.core import bitplane
from repro_torch.core.quantization import int_norm
from . import dirc_mac as _dirc
from . import score_matmul as _score
from . import topk_select as _topk


def dirc_mac(q_values: torch.Tensor, d_planes_packed: torch.Tensor,
             bits: int = 8) -> torch.Tensor:
    """q (b, dim) or (dim,) int8, docs packed (n, bits, nw) -> (b, n) int32.

    Takes the natural (n, bits, nw) layout of
    `bitplane.pack_words(to_bitplanes(...))` and transposes it to the
    kernel's (bits, nw, n) doc-major layout — on every call, as the JAX
    wrapper does, since the sensed planes may differ per query.
    """
    squeeze = q_values.ndim == 1
    if squeeze:
        q_values = q_values[None]
    qp = bitplane.pack_words(bitplane.to_bitplanes(q_values, bits=bits))
    d_t = d_planes_packed.permute(1, 2, 0).contiguous()    # (bits, nw, n)
    out = _dirc.dirc_mac_packed(qp.contiguous(), d_t, bits=bits)
    return out[0] if squeeze else out


def score_matmul(q: torch.Tensor, docs: torch.Tensor) -> torch.Tensor:
    """q (b, dim) or (dim,) int8 x docs (n, dim) int8 -> (b, n) int32."""
    squeeze = q.ndim == 1
    if squeeze:
        q = q[None]
    out = _score.score_matmul_int(q.contiguous(), docs.contiguous())
    return out[0] if squeeze else out


def score_matmul_cosine(q: torch.Tensor, docs: torch.Tensor,
                        doc_norms: torch.Tensor) -> torch.Tensor:
    """Fused cosine scores (b, n) fp32 through K5; q (b, dim) or (dim,)
    int8, docs (n, dim) int8, doc_norms (n,) integer-code norms. The query
    norms are `int_norm` of the codes (the JAX wrapper's fp32 sqrt)."""
    squeeze = q.ndim == 1
    if squeeze:
        q = q[None]
    qn = int_norm(q, keepdim=True)
    out = _score.score_matmul_cosine(q.contiguous(), docs.contiguous(), qn,
                                     doc_norms.float().reshape(1, -1))
    return out[0] if squeeze else out


def local_topk_blocks(scores: torch.Tensor, k: int, block_n: int = _topk.BLOCK_N):
    """scores (b, n) -> global top-k through K4 + a small merge: pad to a
    block multiple with the TPU kernel's -3e38, take each block's top k,
    add the block offsets, then a stable descending sort of the (b, nb*k)
    candidates in `lax.top_k`'s order (`topk_select.sort_desc`).
    Candidates are block-major and, within a block, value descending with
    lower indices first, so the stable merge keeps the global lower-index
    tie-break. Returns (vals (b, k), global idx (b, k))."""
    b, n = scores.shape
    pad = (-n) % block_n
    s = torch.nn.functional.pad(scores, (0, pad), value=_topk.NEG_INF) if pad else scores
    nb = s.shape[1] // block_n
    vals, idx = _topk.blockwise_topk(s.contiguous(), k, block_n=block_n)
    offs = (torch.arange(nb, dtype=torch.int32, device=s.device) * block_n)[None, :, None]
    gidx = (idx + offs).reshape(b, nb * k)
    gvals = vals.reshape(b, nb * k)
    fpos = _topk.sort_desc(gvals)[:, :k]
    return torch.gather(gvals, 1, fpos), torch.gather(gidx, 1, fpos)
