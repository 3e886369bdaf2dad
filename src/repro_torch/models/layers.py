"""Shared model building blocks: RMSNorm / LayerNorm, Mamba2's gated
RMSNorm, SwiGLU / GELU MLPs, embedding, logits — the serving part of
`repro.models.layers`.

Parameters keep the JAX package's (d_in, d_out) layout, so a layer is
`x @ W`. They are stored in `cfg.param_dtype` and cast to
`cfg.compute_dtype` at each use, and every bf16 rounding site of the JAX
model is mirrored (norm in fp32 then cast back, fp32 logits, padded
vocab slots masked to -1e30), so greedy tokens agree.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import dtype as dt


def apply_norm(cfg: ModelConfig, scale: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """RMSNorm or LayerNorm (`cfg.norm`; scale only, no bias) in fp32,
    cast back to x's dtype. LayerNorm divides by the population variance,
    as `jnp.var` does."""
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, correction=0)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
    else:
        y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + cfg.norm_eps)
    return (y * scale.float()).to(x.dtype)


def gated_rmsnorm(scale: torch.Tensor, x: torch.Tensor, z: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """Mamba2's gated RMSNorm, norm(x * silu(z)), in fp32, cast back to
    x's dtype."""
    g = x.float() * F.silu(z.float())
    y = g * torch.rsqrt((g * g).mean(dim=-1, keepdim=True) + eps) * scale.float()
    return y.to(x.dtype)


def apply_mlp(cfg: ModelConfig, w_gate: Optional[torch.Tensor], w_up: torch.Tensor,
              w_down: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU, or GELU (tanh approximation, `jax.nn.gelu`'s default; no
    gate, `w_gate` is None) when `cfg.mlp == "gelu"`, in the compute
    dtype. The hidden width is the weights' (Arctic's dense residual
    passes its own)."""
    cdt = dt(cfg.compute_dtype)
    x = x.to(cdt)
    if cfg.mlp == "swiglu":
        h = F.silu(x @ w_gate.to(cdt)) * (x @ w_up.to(cdt))
    else:
        h = F.gelu(x @ w_up.to(cdt), approximate="tanh")
    return h @ w_down.to(cdt)


def embed_tokens(cfg: ModelConfig, embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return embed.to(dt(cfg.compute_dtype))[tokens]


def logits_from_hidden(cfg: ModelConfig, embed: torch.Tensor, x: torch.Tensor,
                       lm_head: Optional[torch.Tensor] = None) -> torch.Tensor:
    """fp32 logits over the padded vocab through the tied head (`embed`ᵀ)
    or, with `cfg.tie_embeddings` off, the (d, V) `lm_head`; soft-capped
    as c·tanh(logits / c) when `cfg.logit_softcap` is c > 0; pad slots
    -> -1e30."""
    cdt = dt(cfg.compute_dtype)
    w = embed.to(cdt).T if cfg.tie_embeddings else lm_head.to(cdt)
    logits = (x.to(cdt) @ w).float()
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    if cfg.padded_vocab_size != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = -1e30
    return logits
