"""Decoder-only transformer LM, dense family — counterpart of
`repro.models.transformer.DecoderLM` (init, prefill, init_caches,
decode_step).

The JAX package stacks per-layer params on a leading L axis and scans;
here each layer is a `Block` module in an `nn.ModuleList`, run in a
Python loop. Pre-norm blocks: x + attn(norm(x)), then + mlp(norm(x)).
Parameters are created on the model's device (`device=None` is the card)
and filled by `init(generator)` with the JAX initializer's stds, or
loaded from a converted JAX tree (`models.convert.params_from_jax`).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, dtype as dt, resolve_device
from . import attention, layers, rope


class DecodeCaches(NamedTuple):
    k: torch.Tensor        # (L, b, S, kh, hd)
    v: torch.Tensor        # (L, b, S, kh, hd)
    length: torch.Tensor   # (b,) int32, shared across layers


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class Block(nn.Module):
    """One pre-norm block; weights in (d_in, d_out) layout."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        pdt = dt(cfg.param_dtype)
        self.attn_norm = _param((d,), pdt, device)
        self.wq = _param((d, h * hd), pdt, device)
        self.wk = _param((d, kh * hd), pdt, device)
        self.wv = _param((d, kh * hd), pdt, device)
        self.wo = _param((h * hd, d), pdt, device)
        self.mlp_norm = _param((d,), pdt, device)
        self.w_gate = _param((d, f), pdt, device)
        self.w_up = _param((d, f), pdt, device)
        self.w_down = _param((f, d), pdt, device)

    def join(self, cfg: ModelConfig, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Residual join after attention, then the MLP branch."""
        x = x + y
        h2 = layers.apply_norm(cfg, self.mlp_norm, x)
        return x + layers.apply_mlp(cfg, self.w_gate, self.w_up, self.w_down, h2)


class DecoderLM(nn.Module):
    def __init__(self, cfg: ModelConfig, device: DeviceLike = None):
        super().__init__()
        if cfg.family != "dense":
            raise NotImplementedError(
                f"{cfg.name}: only dense decoders are ported "
                "(ROADMAP: other model families)")
        self.cfg = cfg
        dev = resolve_device(device)
        self.embed = _param((cfg.padded_vocab_size, cfg.d_model),
                            dt(cfg.param_dtype), dev)
        self.blocks = nn.ModuleList(Block(cfg, dev) for _ in range(cfg.n_layers))
        self.final_norm = _param((cfg.d_model,), dt(cfg.param_dtype), dev)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ------------------------------------------------------------- params
    @torch.no_grad()
    def init(self, generator: Optional[torch.Generator] = None) -> "DecoderLM":
        """Fill every weight with normals at the JAX initializer's stds
        (embedding 0.02; q/k/v and MLP-in d^-0.5; attention-out
        (h*hd)^-0.5/sqrt(2L); MLP-out f^-0.5/sqrt(2L)); norm scales 1.
        The draws come from `generator`, which must live on the model's
        device; they are not the JAX package's draws."""
        cfg = self.cfg
        d, f, L = cfg.d_model, cfg.d_ff, cfg.n_layers
        hd = cfg.resolved_head_dim
        std_o = (cfg.n_heads * hd) ** -0.5 / math.sqrt(2 * L)
        std_down = f**-0.5 / math.sqrt(2 * L)
        self.embed.normal_(0.0, 0.02, generator=generator)
        self.final_norm.fill_(1.0)
        for blk in self.blocks:
            for w in (blk.wq, blk.wk, blk.wv, blk.w_gate, blk.w_up):
                w.normal_(0.0, d**-0.5, generator=generator)
            blk.wo.normal_(0.0, std_o, generator=generator)
            blk.w_down.normal_(0.0, std_down, generator=generator)
            blk.attn_norm.fill_(1.0)
            blk.mlp_norm.fill_(1.0)
        return self

    # ------------------------------------------------------------- angles
    def _angles(self, positions: torch.Tensor) -> torch.Tensor:
        return rope.rope_angles(positions, self.cfg.resolved_head_dim,
                                self.cfg.rope_theta)

    # ------------------------------------------------------------ serving
    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor, cache_len: Optional[int] = None):
        """tokens (b, s) -> (logits of the last position (b, V), DecodeCaches)."""
        cfg = self.cfg
        tokens = tokens.to(self.device)
        x = layers.embed_tokens(cfg, self.embed, tokens)
        b, s, _ = x.shape
        cache_len = cache_len or s
        pos = torch.arange(s, device=self.device)[None, :].expand(b, s)
        angles = self._angles(pos)
        ks, vs = [], []
        for blk in self.blocks:
            h = layers.apply_norm(cfg, blk.attn_norm, x)
            y, cache = attention.prefill(cfg, blk, h, angles, cache_len)
            x = blk.join(cfg, x, y)
            ks.append(cache.k)
            vs.append(cache.v)
        x = layers.apply_norm(cfg, self.final_norm, x)
        logits = layers.logits_from_hidden(cfg, self.embed, x[:, -1])
        return logits, DecodeCaches(k=torch.stack(ks), v=torch.stack(vs),
                                    length=cache.length)

    def init_caches(self, batch: int, cache_len: int, prefix_len) -> DecodeCaches:
        """Empty caches of logical length `prefix_len` (decode dry-run)."""
        cfg = self.cfg
        shape = (cfg.n_layers, batch, cache_len, cfg.n_kv_heads, cfg.resolved_head_dim)
        cdt = dt(cfg.compute_dtype)
        length = torch.full((batch,), int(prefix_len), dtype=torch.int32,
                            device=self.device)
        return DecodeCaches(k=torch.zeros(shape, dtype=cdt, device=self.device),
                            v=torch.zeros(shape, dtype=cdt, device=self.device),
                            length=length)

    @torch.inference_mode()
    def decode_step(self, caches: DecodeCaches, token: torch.Tensor):
        """token (b, 1) -> (logits (b, V), caches'). The caches' K/V are
        written in place; the returned length is advanced by one."""
        cfg = self.cfg
        token = token.to(self.device)
        x = layers.embed_tokens(cfg, self.embed, token)
        angles = self._angles(caches.length.long()[:, None])
        for i, blk in enumerate(self.blocks):
            h = layers.apply_norm(cfg, blk.attn_norm, x)
            cache = attention.KVCache(k=caches.k[i], v=caches.v[i], length=caches.length)
            y, _ = attention.decode_step(cfg, blk, h, cache, angles)
            x = blk.join(cfg, x, y)
        x = layers.apply_norm(cfg, self.final_norm, x)
        logits = layers.logits_from_hidden(cfg, self.embed, x[:, -1])
        return logits, DecodeCaches(k=caches.k, v=caches.v, length=caches.length + 1)
