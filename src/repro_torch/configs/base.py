"""Model configuration for the PyTorch port.

A trimmed `repro.configs.base.ModelConfig`: the fields the dense decoder
path reads (pre-norm RMSNorm blocks, SwiGLU MLP, GQA attention with
split-half RoPE, tied LM head), with the JAX package's names and
defaults, so a config reads the same in both packages. Families other
than `dense` are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # only "dense" is ported
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    norm_eps: float = 1e-5
    rope_theta: float = 10_000.0
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    attn_chunk: int = 1024           # flash-style KV chunking (0 = dense)
    paged_kernel: bool = False       # paged attention through the fused K3
                                     # kernel instead of the gather path

    @property
    def padded_vocab_size(self) -> int:
        """Vocab rounded up to a multiple of 256; the padded logit slots
        are masked to -1e30 (see `models.layers.logits_from_hidden`)."""
        return (self.vocab_size + 255) // 256 * 256

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0
