"""Whisper-style encoder-decoder backbone (audio family) — counterpart of
`repro.models.encdec`.

The conv/mel frontend is a stub, as in the JAX package: the encoder
takes precomputed frame embeddings (b, n_frames, d_enc). Encoder: a
non-causal transformer (GELU MLPs) with learned positions; decoder:
causal self-attention, cross-attention to the encoder output, MLP. For
decode the self-attention K/V live in a cache and the cross-attention
K/V are computed once per encoder output (`precompute_cross`).

`init_caches` zero-fills the cross K/V, as the JAX package does: a
decode step that was not given `precompute_cross`'s K/V attends to
zeros, and its cross-attention term is exactly 0. The serving engines
(`GenerationEngine`, `ContinuousBatchingEngine`) never call `encode`, so
that is what they serve, in both packages.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, dtype as dt
from . import attention, layers
from .transformer import MLP, Block, TokenLM, _param, init_block, normal_, remat


class EncDecCaches(NamedTuple):
    self_k: torch.Tensor    # (L, b, S, kh, hd)
    self_v: torch.Tensor
    cross_k: torch.Tensor   # (L, b, F, kh, hd), from `precompute_cross`
    cross_v: torch.Tensor
    length: torch.Tensor    # (b,) int32


class Attention(nn.Module):
    """Attention weights `wq` (d, h*hd), `wk` / `wv` (d, kh*hd), `wo`
    (h*hd, d), with `bq` / `bk` / `bv` when `cfg.attn_bias` (the JAX
    init makes them; cross attention does not read them)."""

    def __init__(self, cfg: ModelConfig, d: int, h: int, kh: int, hd: int,
                 device: torch.device):
        super().__init__()
        pdt = dt(cfg.param_dtype)
        self.wq = _param((d, h * hd), pdt, device)
        self.wk = _param((d, kh * hd), pdt, device)
        self.wv = _param((d, kh * hd), pdt, device)
        self.wo = _param((h * hd, d), pdt, device)
        if cfg.attn_bias:
            self.bq = _param((h * hd,), pdt, device)
            self.bk = _param((kh * hd,), pdt, device)
            self.bv = _param((kh * hd,), pdt, device)

    @torch.no_grad()
    def init(self, d: int, n_layers: int, generator: Optional[torch.Generator]) -> None:
        """The JAX `init_attention` stds: q/k/v d^-0.5, out (h*hd)^-0.5 /
        sqrt(2 n_layers); biases 0."""
        for w in (self.wq, self.wk, self.wv):
            normal_(w, d**-0.5, generator)
        normal_(self.wo, self.wo.shape[0] ** -0.5 / (2 * n_layers) ** 0.5, generator)
        for name in ("bq", "bk", "bv"):
            if hasattr(self, name):
                getattr(self, name).zero_()


class EncoderBlock(Attention):
    """An encoder layer: `attn_norm`, the attention weights (on the block,
    as a decoder block holds them), `mlp_norm`, a GELU `mlp` (`w_up`,
    `w_down`), all at the encoder's width."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        e = cfg.encoder
        super().__init__(cfg, e.d_model, e.n_heads, e.n_heads, e.d_model // e.n_heads, device)
        pdt = dt(cfg.param_dtype)
        self.attn_norm = _param((e.d_model,), pdt, device)
        self.mlp_norm = _param((e.d_model,), pdt, device)
        self.mlp = MLP(cfg, e.d_ff, device, d_model=e.d_model, gated=False)


class DecoderBlock(Block):
    """A decoder layer: a pre-norm `Block` (self-attention and MLP) plus
    `cross_norm` and the cross-attention weights `cross`."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__(cfg, device)
        self.cross_norm = _param((cfg.d_model,), dt(cfg.param_dtype), device)
        self.cross = Attention(cfg, cfg.d_model, cfg.effective_n_heads, cfg.n_kv_heads,
                               cfg.resolved_head_dim, device)


class EncDecLM(TokenLM):
    def __init__(self, cfg: ModelConfig, device: DeviceLike = None):
        if cfg.encoder is None:
            raise ValueError(f"{cfg.name}: EncDecLM needs an EncoderConfig")
        super().__init__(cfg, device)
        e, dev, pdt = cfg.encoder, self.device, dt(cfg.param_dtype)
        self.enc_pos_embed = _param((e.n_frames, e.d_model), pdt, dev)
        self.encoder = nn.ModuleList(EncoderBlock(cfg, dev) for _ in range(e.n_layers))
        self.enc_final_norm = _param((e.d_model,), pdt, dev)
        self.decoder = nn.ModuleList(DecoderBlock(cfg, dev) for _ in range(cfg.n_layers))
        # the encoder width may differ from the decoder's: a bridge if so
        self.bridge = (_param((e.d_model, cfg.d_model), pdt, dev)
                       if e.d_model != cfg.d_model else None)

    @torch.no_grad()
    def init(self, generator: Optional[torch.Generator] = None) -> "EncDecLM":
        """The JAX initializer's stds (positions 0.02, encoder attention
        scaled by the encoder's depth, bridge d_enc^-0.5), drawn from
        `generator` on the model's device."""
        cfg, e = self.cfg, self.cfg.encoder
        self._init_head(generator)
        normal_(self.enc_pos_embed, 0.02, generator)
        for blk in self.encoder:
            blk.init(e.d_model, e.n_layers, generator)
            blk.attn_norm.fill_(1.0)
            blk.mlp_norm.fill_(1.0)
            normal_(blk.mlp.w_up, e.d_model**-0.5, generator)
            normal_(blk.mlp.w_down, e.d_ff**-0.5, generator)
        self.enc_final_norm.fill_(1.0)
        for blk in self.decoder:
            init_block(cfg, blk, generator)
            blk.cross_norm.fill_(1.0)
            blk.cross.init(cfg.d_model, cfg.n_layers, generator)
        normal_(self.bridge, e.d_model**-0.5, generator)
        return self

    # ------------------------------------------------------------ encoder
    def _enc_block(self, blk: EncoderBlock, x: torch.Tensor) -> torch.Tensor:
        cfg, e = self.cfg, self.cfg.encoder
        cdt = dt(cfg.compute_dtype)
        h = layers.apply_norm(cfg, blk.attn_norm, x)
        x = x + attention.attend_train(cfg, blk, h, None, h=e.n_heads, kh=e.n_heads,
                                       causal=False)
        h2 = layers.apply_norm(cfg, blk.mlp_norm, x).to(cdt)
        u = F.gelu(h2 @ blk.mlp.w_up.to(cdt), approximate="tanh")
        return x + u @ blk.mlp.w_down.to(cdt)

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """frames (b, F, d_enc) stub embeddings -> encoder output (b, F, d);
        each layer under `cfg.remat`."""
        cfg = self.cfg
        cdt = dt(cfg.compute_dtype)
        x = frames.to(self.device, cdt) + self.enc_pos_embed.to(cdt)[None]
        for blk in self.encoder:
            x = remat(cfg, functools.partial(self._enc_block, blk))(x)
        x = layers.apply_norm(cfg, self.enc_final_norm, x)
        if self.bridge is not None:
            x = x.to(cdt) @ self.bridge.to(cdt)
        return x

    # ------------------------------------------------------------ decoder
    def _dec_block(self, blk: DecoderBlock, x: torch.Tensor, enc_out: torch.Tensor,
                   angles: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = layers.apply_norm(cfg, blk.attn_norm, x)
        x = x + attention.attend_train(cfg, blk, h, angles)
        h2 = layers.apply_norm(cfg, blk.cross_norm, x)
        x = x + attention.cross_attention(cfg, blk.cross, h2, enc_out, cfg.n_heads,
                                          cfg.n_kv_heads)
        return x + blk.ffn(cfg, layers.apply_norm(cfg, blk.mlp_norm, x))[0]

    def hidden_states(self, tokens: torch.Tensor, frames: torch.Tensor,
                      positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Teacher-forced decoder over the encoded frames: tokens (b, s) ->
        final-normed hidden (b, s, d); each layer under `cfg.remat`.
        `positions` (b, s) default to 0 .. s-1."""
        cfg = self.cfg
        enc_out = self.encode(frames)
        x = layers.embed_tokens(cfg, self.embed, tokens.to(self.device))
        b, s, _ = x.shape
        if positions is None:
            positions = torch.arange(s, device=self.device)[None].expand(b, s)
        angles = self._rope(positions)
        for blk in self.decoder:
            x = remat(cfg, functools.partial(self._dec_block, blk))(x, enc_out, angles)
        return layers.apply_norm(cfg, self.final_norm, x)

    def forward(self, tokens: torch.Tensor, frames: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Teacher-forced decode of tokens (b, s) over the encoded frames:
        logits (b, s, V); `positions` (b, s) default to 0 .. s-1."""
        return self.head_logits(self.hidden_states(tokens, frames, positions))

    def loss(self, batch: dict) -> tuple[torch.Tensor, dict]:
        """(cross entropy of the head, metrics) for `tokens`, `frames` and
        `labels` (the positions are 0 .. s-1, as in the JAX package)."""
        x = self.hidden_states(batch["tokens"], batch["frames"])
        ce = self.head_loss(x, batch["labels"])
        return ce, {"ce": ce}

    # ------------------------------------------------------------ serving
    def init_caches(self, batch: int, cache_len: int, prefix_len) -> EncDecCaches:
        """Zero self-attention caches of capacity `cache_len` and zero
        cross K/V over the encoder's `n_frames` (see the module note)."""
        cfg = self.cfg
        kh, hd, L = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_layers
        cdt = dt(cfg.compute_dtype)

        def zeros(s):
            return torch.zeros((L, batch, s, kh, hd), dtype=cdt, device=self.device)
        return EncDecCaches(self_k=zeros(cache_len), self_v=zeros(cache_len),
                            cross_k=zeros(cfg.encoder.n_frames),
                            cross_v=zeros(cfg.encoder.n_frames),
                            length=self._lengths(batch, prefix_len))

    @torch.inference_mode()
    def precompute_cross(self, enc_out: torch.Tensor):
        """Per-layer cross K/V from the encoder output (b, F, d), computed
        once: (k, v), each (L, b, F, kh, hd) in the compute dtype."""
        cfg = self.cfg
        kh, hd = cfg.n_kv_heads, cfg.resolved_head_dim
        cdt = dt(cfg.compute_dtype)
        b, n_frames, _ = enc_out.shape
        x = enc_out.to(self.device, cdt)
        ks = [(x @ blk.cross.wk.to(cdt)).reshape(b, n_frames, kh, hd) for blk in self.decoder]
        vs = [(x @ blk.cross.wv.to(cdt)).reshape(b, n_frames, kh, hd) for blk in self.decoder]
        return torch.stack(ks), torch.stack(vs)

    @torch.inference_mode()
    def decode_step(self, caches: EncDecCaches, token: torch.Tensor,
                    positions: Optional[torch.Tensor] = None):
        """token (b, 1) -> (logits (b, V), caches'). Self-attention K/V are
        written in place; cross attention reads `caches.cross_k` /
        `cross_v` (no mask, no positions); the returned length is advanced
        by one. `positions` (b, 1) defaults to the length."""
        cfg = self.cfg
        cdt = dt(cfg.compute_dtype)
        kh, hd, h_q = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_heads
        x = layers.embed_tokens(cfg, self.embed, token.to(self.device))
        b = x.shape[0]
        angles = self._rope(caches.length.long()[:, None] if positions is None
                              else positions)
        for i, blk in enumerate(self.decoder):
            cache = attention.KVCache(k=caches.self_k[i], v=caches.self_v[i],
                                      length=caches.length)
            h = layers.apply_norm(cfg, blk.attn_norm, x)
            y, _ = attention.decode_step(cfg, blk, h, cache, angles)
            x = x + y
            h2 = layers.apply_norm(cfg, blk.cross_norm, x)
            q = (h2.to(cdt) @ blk.cross.wq.to(cdt)).reshape(b, 1, kh, h_q // kh, hd)
            s = torch.einsum("bqkgd,bskd->bkgqs", (q * hd**-0.5).float(),
                             caches.cross_k[i].float())
            probs = torch.softmax(s, dim=-1).to(cdt)
            o = torch.einsum("bkgqs,bskd->bqkgd", probs, caches.cross_v[i])
            x = x + o.reshape(b, 1, h_q * hd) @ blk.cross.wo.to(cdt)
            x = x + blk.ffn(cfg, layers.apply_norm(cfg, blk.mlp_norm, x))[0]
        return self._logits(x[:, -1]), caches._replace(length=caches.length + 1)
