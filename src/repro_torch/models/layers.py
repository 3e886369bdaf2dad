"""Shared model building blocks: RMSNorm, SwiGLU, embedding, tied-head
logits — the dense-path part of `repro.models.layers`.

Parameters keep the JAX package's (d_in, d_out) layout, so a layer is
`x @ W`. They are stored in `cfg.param_dtype` and cast to
`cfg.compute_dtype` at each use, and every bf16 rounding site of the JAX
model is mirrored (norm in fp32 then cast back, fp32 logits, padded
vocab slots masked to -1e30), so greedy tokens agree.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import dtype as dt


def apply_norm(cfg: ModelConfig, scale: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """RMSNorm in fp32, cast back to x's dtype."""
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + cfg.norm_eps)
    return (y * scale.float()).to(x.dtype)


def apply_mlp(cfg: ModelConfig, w_gate, w_up, w_down, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU in the compute dtype."""
    cdt = dt(cfg.compute_dtype)
    x = x.to(cdt)
    h = F.silu(x @ w_gate.to(cdt)) * (x @ w_up.to(cdt))
    return h @ w_down.to(cdt)


def embed_tokens(cfg: ModelConfig, embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return embed.to(dt(cfg.compute_dtype))[tokens]


def logits_from_hidden(cfg: ModelConfig, embed: torch.Tensor,
                       x: torch.Tensor) -> torch.Tensor:
    """Tied-head fp32 logits over the padded vocab; pad slots -> -1e30."""
    cdt = dt(cfg.compute_dtype)
    logits = (x.to(cdt) @ embed.to(cdt).T).float()
    if cfg.padded_vocab_size != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = -1e30
    return logits
