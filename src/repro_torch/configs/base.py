"""Model configuration for the PyTorch port.

A trimmed `repro.configs.base.ModelConfig`: the fields every family
reads (`dense`, `moe`, `vlm`: pre-norm or parallel blocks, RMSNorm or
LayerNorm, SwiGLU or GELU MLP, sparse experts, GQA attention with
optional biases and padded query heads, RoPE or M-RoPE, tied or untied
head, logit soft-capping; `ssm` and `hybrid`: the Mamba2 sub-config and
the shared attention block's period; `audio`: the encoder sub-config;
for training, `remat` and `grad_accum_steps`),
with the JAX package's names and defaults, so a config reads the same in
both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int = 2
    capacity_factor: float = 1.25
    # Arctic: dense residual MLP in parallel with the MoE FFN.
    dense_residual_d_ff: int = 0
    router_jitter: float = 0.0       # training only; the port refuses it
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128       # N
    head_dim: int = 64         # P
    expand: int = 2            # d_inner = expand * d_model
    n_groups: int = 1          # B/C groups (GVA-style)
    conv_width: int = 4
    chunk_size: int = 256      # SSD chunk length
    dt_min: float = 1e-3
    dt_max: float = 1e-1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Whisper-style encoder; the conv/mel frontend is a stub — inputs are
    precomputed frame embeddings (n_frames, d_model)."""
    n_layers: int = 12
    n_frames: int = 1500
    d_model: int = 768
    n_heads: int = 12
    d_ff: int = 3072


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    norm_eps: float = 1e-5
    mlp: str = "swiglu"              # swiglu | gelu
    mlp_bias: bool = False           # read by neither package: no MLP has biases
    attn_bias: bool = False
    parallel_block: bool = False     # command-r: attn and mlp in parallel
    rope_style: str = "standard"     # standard | mrope | none
    rope_theta: float = 10_000.0
    mrope_sections: Sequence[int] = (16, 24, 24)  # qwen2-vl (sums to hd/2)
    tie_embeddings: bool = True
    logit_softcap: float = 0.0
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): one SHARED attention block applied after every
    # `hybrid_attn_every` SSM layers (weights shared across applications).
    hybrid_attn_every: int = 0
    encoder: Optional[EncoderConfig] = None
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    attn_chunk: int = 1024           # flash-style KV chunking (0 = dense)
    pad_attn_heads_to: int = 0       # pad the q-head count to this multiple
                                     # (the extra heads are real weights)
    paged_kernel: bool = False       # paged attention through the fused K3
                                     # kernel instead of the gather path
    remat: str = "none"              # none | full | dots (training only)
    grad_accum_steps: int = 1        # microbatches per train step

    @property
    def padded_vocab_size(self) -> int:
        """Vocab rounded up to a multiple of 256; the padded logit slots
        are masked to -1e30 (see `models.layers.logits_from_hidden`)."""
        return (self.vocab_size + 255) // 256 * 256

    @property
    def effective_n_heads(self) -> int:
        """Query heads after padding to a multiple of `pad_attn_heads_to`."""
        if self.pad_attn_heads_to and self.n_heads:
            m = self.pad_attn_heads_to
            return (self.n_heads + m - 1) // m * m
        return self.n_heads

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0
