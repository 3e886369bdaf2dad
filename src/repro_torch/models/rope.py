"""Rotary position embeddings (standard, split-half) — counterpart of
`repro.models.rope` without the M-RoPE variant (VLM configs are not
ported yet)."""
from __future__ import annotations

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


def apply_rotary(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x (b, s, h, d), angles (b, s, d/2) -> rotated x (split-half); the
    cos/sin tables are cast to x's dtype first, as in the JAX package."""
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    cos = torch.cos(angles)[..., None, :].to(x.dtype)
    sin = torch.sin(angles)[..., None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
