"""Zamba2-style hybrid: a Mamba2 backbone and ONE shared attention + MLP
block — counterpart of `repro.models.hybrid` (arXiv:2411.15242).

The shared block (one set of weights, a pre-norm `transformer.Block`)
runs after every `hybrid_attn_every` Mamba2 layers: n_apps = n_layers /
hybrid_attn_every applications. Its decode state is one KV cache per
application, (n_apps, b, S, kh, hd), beside the per-layer Mamba states;
all applications share one `length`.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, dtype as dt
from . import attention, layers, mamba2
from .transformer import Block, TokenLM, init_block, remat


class HybridCaches(NamedTuple):
    mamba: mamba2.MambaState     # leaves stacked (L, b, ...)
    shared_k: torch.Tensor       # (n_apps, b, S, kh, hd)
    shared_v: torch.Tensor
    length: torch.Tensor         # (b,) int32


class HybridLM(TokenLM):
    def __init__(self, cfg: ModelConfig, device: DeviceLike = None):
        if cfg.hybrid_attn_every <= 0 or cfg.ssm is None \
                or cfg.n_layers % cfg.hybrid_attn_every:
            raise ValueError(f"{cfg.name}: HybridLM needs an SSMConfig and n_layers a "
                             f"multiple of hybrid_attn_every > 0")
        super().__init__(cfg, device)
        self.n_apps = cfg.n_layers // cfg.hybrid_attn_every
        self.per_group = cfg.hybrid_attn_every
        self.blocks = nn.ModuleList(mamba2.MambaLayer(cfg, self.device)
                                    for _ in range(cfg.n_layers))
        self.shared = Block(cfg, self.device)

    @torch.no_grad()
    def init(self, generator: Optional[torch.Generator] = None) -> "HybridLM":
        """The JAX initializer's distributions (`MambaBlock.init`,
        `transformer.init_block` for the shared block), drawn from
        `generator` on the model's device."""
        self._init_head(generator)
        for layer in self.blocks:
            layer.init(self.cfg, generator)
        init_block(self.cfg, self.shared, generator)
        return self

    def _shared_fwd(self, x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
        return self.shared.forward_seq(self.cfg, x, angles)[0]

    def hidden_states(self, tokens: Optional[torch.Tensor] = None,
                      embeds: Optional[torch.Tensor] = None,
                      positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens (b, s) or `embeds` -> final-normed hidden (b, s, d); each
        Mamba2 layer and each application of the shared block under
        `cfg.remat`. `positions` (b, s) default to 0 .. s-1."""
        cfg = self.cfg
        x = (layers.embed_tokens(cfg, self.embed, tokens.to(self.device))
             if embeds is None else embeds.to(self.device))
        b, s, _ = x.shape
        if positions is None:
            positions = torch.arange(s, device=self.device)[None].expand(b, s)
        angles = self._rope(positions)
        shared = remat(cfg, self._shared_fwd)
        for i, layer in enumerate(self.blocks):
            x = remat(cfg, functools.partial(layer.forward_seq, cfg))(x)
            if (i + 1) % self.per_group == 0:
                x = shared(x, angles)
        return layers.apply_norm(cfg, self.final_norm, x)

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens (b, s) -> logits (b, s, V); `positions` (b, s) default to
        0 .. s-1."""
        return self.head_logits(self.hidden_states(tokens, positions=positions))

    def loss(self, batch: dict) -> tuple[torch.Tensor, dict]:
        """(cross entropy of the head, metrics) for `tokens` / `labels`,
        with optional `positions`."""
        x = self.hidden_states(batch.get("tokens"), batch.get("embeds"),
                               batch.get("positions"))
        ce = self.head_loss(x, batch["labels"])
        return ce, {"ce": ce}

    def init_caches(self, batch: int, cache_len: int, prefix_len) -> HybridCaches:
        cfg = self.cfg
        shape = (self.n_apps, batch, cache_len, cfg.n_kv_heads, cfg.resolved_head_dim)
        cdt = dt(cfg.compute_dtype)
        return HybridCaches(
            mamba=mamba2.init_layer_states(cfg, batch, self.device),
            shared_k=torch.zeros(shape, dtype=cdt, device=self.device),
            shared_v=torch.zeros(shape, dtype=cdt, device=self.device),
            length=self._lengths(batch, prefix_len))

    @torch.inference_mode()
    def decode_step(self, caches: HybridCaches, token: torch.Tensor,
                    positions: Optional[torch.Tensor] = None):
        """token (b, 1) -> (logits (b, V), caches'). The Mamba states and
        each application's K/V are written in place; the returned length
        is advanced by one. `positions` (b, 1) defaults to the length."""
        cfg = self.cfg
        x = layers.embed_tokens(cfg, self.embed, token.to(self.device))
        angles = self._rope(caches.length.long()[:, None] if positions is None
                              else positions)
        for i, layer in enumerate(self.blocks):
            x = layer.decode(cfg, x, caches.mamba, i)
            if (i + 1) % self.per_group == 0:
                a = i // self.per_group
                cache = attention.KVCache(k=caches.shared_k[a], v=caches.shared_v[a],
                                          length=caches.length)
                h = layers.apply_norm(cfg, self.shared.attn_norm, x)
                y, _ = attention.decode_step(cfg, self.shared, h, cache, angles)
                x = self.shared.join(cfg, x, h, y)[0]
        return self._logits(x[:, -1]), caches._replace(length=caches.length + 1)
