"""`build_model(cfg)` and the pure-SSM LM — counterpart of
`repro.models.model_api` (`MambaCaches`, `MambaLM`, `supports_paged_kv`,
`build_model`) for every family: `dense`, `moe` and `vlm` are served by
`DecoderLM`, `ssm` by `MambaLM`, `hybrid` by `HybridLM`, `audio` by
`EncDecLM`.

Every model has `init(generator)`, `hidden_states`, `loss(batch)` (with
gradients; the training path), `init_caches(batch, cache_len,
prefix_len)` and `decode_step(caches, token)`; `DecoderLM` also has
`prefill` and the paged protocol (`init_paged_caches`, `paged_step`).
SSM and hybrid models do not page: their decode state is O(1) per
sequence, so the paged engine keeps it slot-resident
(`supports_paged_kv` tells the two apart).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike
from . import layers, mamba2
from .encdec import EncDecLM
from .hybrid import HybridLM
from .transformer import FAMILIES, DecoderLM, TokenLM, remat


class MambaCaches(NamedTuple):
    mamba: mamba2.MambaState  # leaves stacked (L, b, ...)
    length: torch.Tensor      # (b,) int32


class MambaLM(TokenLM):
    """Pure SSM LM (mamba2-2.7b): attention-free, `n_layers` pre-norm
    Mamba2 layers between the embedding and the (tied) head."""

    def __init__(self, cfg: ModelConfig, device: DeviceLike = None):
        if cfg.family != "ssm" or cfg.ssm is None:
            raise ValueError(f"{cfg.name}: MambaLM needs family 'ssm' and an SSMConfig")
        super().__init__(cfg, device)
        self.blocks = nn.ModuleList(mamba2.MambaLayer(cfg, self.device)
                                    for _ in range(cfg.n_layers))

    @torch.no_grad()
    def init(self, generator: Optional[torch.Generator] = None) -> "MambaLM":
        """The JAX initializer's distributions (`MambaBlock.init`), drawn
        from `generator` on the model's device."""
        self._init_head(generator)
        for layer in self.blocks:
            layer.init(self.cfg, generator)
        return self

    def hidden_states(self, tokens: Optional[torch.Tensor] = None,
                      embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens (b, s) or `embeds` (b, s, d) -> final-normed hidden (b,
        s, d) through the chunked SSD, each layer under `cfg.remat`."""
        cfg = self.cfg
        x = (layers.embed_tokens(cfg, self.embed, tokens.to(self.device))
             if embeds is None else embeds.to(self.device))
        for layer in self.blocks:
            x = remat(cfg, functools.partial(layer.forward_seq, cfg))(x)
        return layers.apply_norm(cfg, self.final_norm, x)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (b, s) -> logits (b, s, V) through the chunked SSD."""
        return self.head_logits(self.hidden_states(tokens))

    def loss(self, batch: dict) -> tuple[torch.Tensor, dict]:
        """(cross entropy of the head, metrics) for `tokens` / `labels`."""
        x = self.hidden_states(batch.get("tokens"), batch.get("embeds"))
        ce = self.head_loss(x, batch["labels"])
        return ce, {"ce": ce}

    def init_caches(self, batch: int, cache_len: int, prefix_len) -> MambaCaches:
        """Zero states (`cache_len` is unused: the state does not grow)."""
        return MambaCaches(mamba=mamba2.init_layer_states(self.cfg, batch, self.device),
                           length=self._lengths(batch, prefix_len))

    @torch.inference_mode()
    def decode_step(self, caches: MambaCaches, token: torch.Tensor,
                    positions: Optional[torch.Tensor] = None):
        """token (b, 1) -> (logits (b, V), caches'). The states are written
        in place; the returned length is advanced by one. `positions` is
        accepted for the engines' sake and unused (no positions)."""
        x = layers.embed_tokens(self.cfg, self.embed, token.to(self.device))
        for i, layer in enumerate(self.blocks):
            x = layer.decode(self.cfg, x, caches.mamba, i)
        return self._logits(x[:, -1]), MambaCaches(mamba=caches.mamba,
                                                   length=caches.length + 1)


def supports_paged_kv(model) -> bool:
    """True when `model` grows a pageable KV cache (attention families),
    as `repro.models.model_api.supports_paged_kv` decides it."""
    return hasattr(model, "init_paged_caches") and hasattr(model, "paged_step")


def build_model(cfg: ModelConfig, device: DeviceLike = None):
    """The model for `cfg`, with uninitialised weights on `device`
    (`None` is the card); call `.init(generator)` or load converted weights."""
    if cfg.family in FAMILIES:
        return DecoderLM(cfg, device=device)
    if cfg.family == "hybrid":
        return HybridLM(cfg, device=device)
    if cfg.family == "ssm":
        return MambaLM(cfg, device=device)
    if cfg.family == "audio":
        return EncDecLM(cfg, device=device)
    raise ValueError(f"unknown family {cfg.family!r}")
