"""Public wrappers around the ported kernels (counterpart of
`repro.kernels.ops`): query packing, the layout transpose into the
kernels' layouts and the 1-D query squeeze. The CUDA kernels mask a
ragged n themselves, so no padding to a block multiple is needed.

Dispatch goes by the tensors' device only: CPU tensors take each
kernel's plain version, CUDA tensors launch the kernel (or raise).
"""
from __future__ import annotations

import torch

from repro_torch.core import bitplane
from . import dirc_mac as _dirc
from . import score_matmul as _score


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
