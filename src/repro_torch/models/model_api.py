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

`input_specs`, `cache_specs` and `param_specs` describe one (arch x
shape) cell: tensors on the `meta` device, which carry the shapes and
dtypes of the reference's `jax.eval_shape` stand-ins and allocate
nothing (`build_model(cfg, device="meta")` builds the model they read).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import DeviceLike, dtype as dt
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


# -------------------------------------------------------------- input specs
def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Meta tensors for the batch of one (arch x shape) cell: train and
    prefill take token ids (train also labels; audio adds the stub
    encoder's `frames`, vlm the M-RoPE `positions` (3, b, s)); decode
    takes the single new token (b, 1), its carried state coming from
    `cache_specs`."""
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind == "train":
        batch = {"tokens": _meta((b, s), i32), "labels": _meta((b, s), i32)}
    elif shape.kind == "prefill":
        batch = {"tokens": _meta((b, s), i32)}
    else:
        batch = {"token": _meta((b, 1), i32)}
    if cfg.family == "audio" and shape.kind != "decode":
        e = cfg.encoder
        batch["frames"] = _meta((b, e.n_frames, e.d_model), dt(cfg.compute_dtype))
    if cfg.family == "vlm" and shape.kind != "decode":
        batch["positions"] = _meta((3, b, s), i32)
    return batch


def cache_specs(cfg: ModelConfig, shape: ShapeConfig):
    """The decode caches of a decode cell on the meta device: capacity
    `shape.seq_len`, logical length `seq_len - 1`."""
    if shape.kind != "decode":
        raise ValueError(f"cache_specs needs a decode shape, not {shape.kind!r}")
    model = build_model(cfg, device="meta")
    return model.init_caches(shape.global_batch, shape.seq_len, shape.seq_len - 1)


def param_specs(cfg: ModelConfig) -> dict:
    """JAX leaf path -> a meta tensor of the leaf's shape and dtype (a
    stacked leaf with its layer dim): the reference's `eval_shape`'d
    param tree, flattened by `convert.jax_leaves`."""
    from .convert import jax_leaves

    model = build_model(cfg, device="meta")
    params = dict(model.named_parameters())
    return {path: _meta(leaf.shape, params[leaf.names[0]].dtype)
            for path, leaf in jax_leaves(cfg).items()}
