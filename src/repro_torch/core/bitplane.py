"""Two's-complement bit-plane packing — the ReRAM storage layout.

PyTorch counterpart of `repro.core.bitplane`. Two representations:
  * dense planes: uint8 {0,1} (n_docs, bits, dim), LSB-first;
  * packed words: (..., dim // 32) with bit j of word w = element w*32 + j.

PyTorch has no uint32 shifts on the CPU, so packed words are built in
int64 and stored as int32 tensors holding the uint32 bit pattern (the CUDA
kernel reads them as `uint32_t`). `words.numpy().view(np.uint32)` gives
back the JAX package's uint32 words.

Arithmetic identity (two's complement, b = bits-1 the sign bit):
    value = -2^(b) * bit_b + sum_{i<b} 2^i * bit_i
so  dot(q, d) = sum_{bq} sum_{bd} w(bq) w(bd) * popcount(Q_bq & D_bd).
"""
from __future__ import annotations

import torch

from .quantization import int_matmul_nt


def bit_weight(i: int, bits: int) -> int:
    """Signed two's-complement weight of bit plane `i` (sign bit negative)."""
    return -(1 << i) if i == bits - 1 else (1 << i)


def to_bitplanes(values: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """int8 codes (..., dim) -> uint8 {0,1} planes (..., bits, dim), LSB-first."""
    u = values.int() & ((1 << bits) - 1)
    shifts = torch.arange(bits, dtype=torch.int32, device=values.device)
    planes = (u.unsqueeze(-2) >> shifts[:, None]) & 1
    return planes.to(torch.uint8)


def from_bitplanes(planes: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Inverse of to_bitplanes: (..., bits, dim) {0,1} -> int8 codes (..., dim)."""
    shifts = torch.arange(bits, dtype=torch.int32, device=planes.device)
    u = torch.sum(planes.int() << shifts[:, None], dim=-2, dtype=torch.int32)
    sign = 1 << (bits - 1)
    v = torch.where(u >= sign, u - (1 << bits), u)
    return v.to(torch.int8)


def pack_words(planes: torch.Tensor) -> torch.Tensor:
    """{0,1} planes (..., dim) -> packed words (..., dim // 32), int32 holding
    the uint32 bit pattern."""
    *lead, dim = planes.shape
    if dim % 32:
        raise ValueError(f"dim {dim} not a multiple of 32")
    p = planes.reshape(*lead, dim // 32, 32).long()
    shifts = torch.arange(32, dtype=torch.int64, device=planes.device)
    w = torch.sum(p << shifts, dim=-1)                  # [0, 2^32)
    return torch.where(w >= 2**31, w - 2**32, w).int()


def unpack_words(words: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_words: (..., nw) words -> (..., nw*32) uint8 {0,1}."""
    w = words.long() & 0xFFFFFFFF
    shifts = torch.arange(32, dtype=torch.int64, device=words.device)
    b = (w.unsqueeze(-1) >> shifts) & 1
    *lead, nw, _ = b.shape
    return b.reshape(*lead, nw * 32).to(torch.uint8)


def plane_counts(q_planes: torch.Tensor, d_planes: torch.Tensor) -> torch.Tensor:
    """popcount(Q_bq & D_bd) for {0,1} planes: (..., bq, dim) x (n, bd, dim)
    -> (..., bq, n, bd) int64, exact."""
    n, bd, dim = d_planes.shape
    c = int_matmul_nt(q_planes, d_planes.reshape(n * bd, dim))
    return c.reshape(*c.shape[:-1], n, bd)


def bitserial_dot(q_values: torch.Tensor, d_planes: torch.Tensor,
                  bits: int = 8) -> torch.Tensor:
    """Bit-serial MAC, the functional model of a DIRC column pass.

    q_values: int8 query codes (dim,) or (b, dim); d_planes: uint8 {0,1}
    doc planes (n, bits, dim); returns int32 scores (n,) or (b, n).

    Computed in integers, so it is exact over the whole range. (The JAX
    twin sums through a float32 einsum, exact while |dot| <= 2^24, which
    covers INT8 up to dim 1024; the two agree wherever JAX is exact.)
    """
    q_planes = to_bitplanes(q_values, bits=bits)           # (..., bits, dim)
    inter = plane_counts(q_planes, d_planes)               # (..., bq, n, bd)
    w = torch.tensor([bit_weight(i, bits) for i in range(bits)],
                     dtype=torch.int64, device=q_values.device)
    acc = (inter * w[:, None, None] * w).sum(dim=(-3, -1))
    return acc.int()


def sum_d_lut(planes: torch.Tensor) -> torch.Tensor:
    """Per-(doc, bit-plane) popcount — the D-Sum LUT for error detection:
    (n, bits, dim) -> (n, bits) int32."""
    return torch.sum(planes, dim=-1, dtype=torch.int32)
