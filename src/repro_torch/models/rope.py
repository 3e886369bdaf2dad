"""Rotary position embeddings — counterpart of `repro.models.rope`:
standard split-half RoPE and Qwen2-VL's M-RoPE."""
from __future__ import annotations

from typing import Sequence

import torch


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim/2,) inverse frequencies."""
    half = head_dim // 2
    expo = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=device), expo)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float) -> torch.Tensor:
    """positions (b, s) int -> angles (b, s, head_dim/2) fp32."""
    inv = rope_freqs(head_dim, theta, device=positions.device)
    return positions.float()[..., None] * inv


def mrope_angles(positions: torch.Tensor, head_dim: int, theta: float,
                 sections: Sequence[int]) -> torch.Tensor:
    """positions (3, b, s) -> angles (b, s, head_dim/2): the frequency
    axis is cut into (temporal, height, width) sections, each driven by
    its own position channel; sum(sections) == head_dim/2."""
    inv = rope_freqs(head_dim, theta, device=positions.device)
    if positions.ndim != 3 or positions.shape[0] != len(sections) \
            or sum(sections) != inv.shape[0]:
        raise ValueError(f"M-RoPE wants ({len(sections)}, b, s) positions and sections "
                         f"summing to {inv.shape[0]}; got {tuple(positions.shape)}, "
                         f"{tuple(sections)}")
    parts, start = [], 0
    for c, sec in enumerate(sections):
        parts.append(positions[c].float()[..., None] * inv[start:start + sec])
        start += sec
    return torch.cat(parts, dim=-1)


def apply_rotary(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x (b, s, h, d), angles (b, s, d/2) -> rotated x (split-half); the
    cos/sin tables are cast to x's dtype first, as in the JAX package."""
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    cos = torch.cos(angles)[..., None, :].to(x.dtype)
    sin = torch.sin(angles)[..., None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
