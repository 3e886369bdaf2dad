"""Symmetric INT8/INT4 quantization for document/query embeddings.

PyTorch counterpart of `repro.core.quantization`; codes and scales are
bit-equal to the JAX package's:

* the scale is `absmax * float32(1/qmax)`, a multiply by the float32
  reciprocal, because that is what XLA makes of `absmax / qmax` (a
  division by a constant). A true division differs in the last bit for a
  few percent of rows;
* the codes are a true division `round(x / scale)` (a tensor divisor is
  not rewritten by XLA), rounded half to even as `jnp.round` does.

Integer products are exact: on the CPU in int64, on the card in float64
(`torch.matmul` has no integer CUDA kernel; every product of INT8 codes
up to dim 1024 is far below 2^53).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

# Integer ranges for the supported precisions. MLC ReRAM stores 2 bits per
# cell; INT8 = 4 cells, INT4 = 2 cells per element.
_QINFO = {
    8: (-128, 127),
    4: (-8, 7),
}

SUPPORTED_BITS = tuple(sorted(_QINFO))


@dataclasses.dataclass(frozen=True)
class QuantizedTensor:
    """values: int8 codes (INT4 codes live in [-8, 7]); scale: fp32,
    per-tensor () or per-row (n, 1); bits: 4 or 8."""

    values: torch.Tensor
    scale: torch.Tensor
    bits: int = 8

    def dequantize(self) -> torch.Tensor:
        return self.values.float() * self.scale


def _check_bits(bits: int) -> None:
    if bits not in _QINFO:
        raise ValueError(f"bits must be one of {SUPPORTED_BITS}, got {bits}")


def quantize(x: torch.Tensor, bits: int = 8, per_row: bool = True) -> QuantizedTensor:
    """Symmetric quantization of `x` (..., dim) to INT<bits> codes."""
    _check_bits(bits)
    qmin, qmax = _QINFO[bits]
    x = x.float()
    if per_row and x.ndim >= 2:
        absmax = x.abs().amax(dim=-1, keepdim=True)
    else:
        absmax = x.abs().amax()
    recip = torch.tensor(np.float32(1) / np.float32(qmax), device=x.device)
    scale = torch.where(absmax > 0, absmax * recip, torch.ones_like(absmax))
    q = torch.clamp(torch.round(x / scale), qmin, qmax).to(torch.int8)
    return QuantizedTensor(values=q, scale=scale, bits=bits)


def dequantize(qt: QuantizedTensor) -> torch.Tensor:
    return qt.dequantize()


def quantize_query(x: torch.Tensor, bits: int = 8) -> QuantizedTensor:
    """Quantize a query embedding (dim,) or batch (b, dim), per-vector scale."""
    return quantize(x, bits=bits, per_row=True)


def int_matmul_nt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer `a @ b.T` for small-integer tensors: (..., k) x (n, k)
    -> (..., n) int64. int64 on the CPU; float64 on the card, exact while
    every partial sum stays below 2^53."""
    if a.device.type == "cpu":
        return a.long() @ b.long().T
    return torch.round(a.double() @ b.double().T).long()


def int_inner_product(q: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Exact integer inner product in int32: (..., dim) x (n, dim) -> (..., n)."""
    return int_matmul_nt(q, d).int()


def int_norm(values: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """||v||_int in float32, bit-equal to the JAX package's.

    The squares of codes sum to integers <= 1024 * 128^2 = 2^24, exact in
    float32 in any order. XLA's float32 sqrt is correctly rounded and
    PyTorch's CPU sqrt is not (it misses by an ulp for ~0.5% of inputs),
    so the root is taken in float64 and rounded once to float32, which is
    correctly rounded (53 >= 2 * 24 + 2 bits)."""
    ss = torch.sum(values.float() ** 2, dim=-1, keepdim=keepdim)
    return torch.sqrt(ss.double()).float()


def doc_int_norms(docs: QuantizedTensor) -> torch.Tensor:
    """||d||_int per document — precomputed offline into the ReRAM buffer."""
    return int_norm(docs.values)


def quantized_scores(query: QuantizedTensor, docs: QuantizedTensor,
                     doc_norms: Optional[torch.Tensor] = None,
                     metric: str = "mips") -> torch.Tensor:
    """Similarity scores between one or a few queries and many docs.

    metric="mips":   scale_q * scale_d * <q, d>_int
    metric="cosine": <q, d>_int / max(|q|_int * |d|_int, 1e-12); the
        integer scales cancel, so the norms are those of the codes.
    doc_norms: optional precomputed ||d||_int (n,) fp32 (the ReRAM buffer).
    """
    ip = int_inner_product(query.values, docs.values).float()
    if metric == "mips":
        d_scale = docs.scale.reshape(-1) if docs.scale.ndim else docs.scale
        return ip * query.scale * d_scale
    if metric == "cosine":
        qn = int_norm(query.values, keepdim=True)
        if doc_norms is None:
            doc_norms = int_norm(docs.values)
        return ip / torch.clamp(qn * doc_norms, min=1e-12)
    raise ValueError(f"unknown metric {metric!r}")
