"""Model configuration for the PyTorch port.

A trimmed `repro.configs.base.ModelConfig`: the fields every family
reads (`dense`, `moe`, `vlm`: pre-norm or parallel blocks, RMSNorm or
LayerNorm, SwiGLU or GELU MLP, sparse experts, GQA attention with
optional biases and padded query heads, RoPE or M-RoPE, tied or untied
head, logit soft-capping; `ssm` and `hybrid`: the Mamba2 sub-config and
the shared attention block's period; `audio`: the encoder sub-config;
for training, `remat` and `grad_accum_steps`),
with the JAX package's names and defaults, so a config reads the same in
both packages. Also the reference's approximate parameter counts
(`param_count`, `active_param_count`) and the dry-run's cell shapes
(`ShapeConfig`, `SHAPES`, `shape_applicable`).
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
    router_jitter: float = 0.0       # unused: no caller of apply_moe jitters
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

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence mixing -> long_500k applies."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # all ten assigned archs are (or contain) decoders

    def param_count(self) -> int:
        """Approximate parameter count (embedding + blocks + head)."""
        d, L = self.d_model, self.n_layers
        hd = self.resolved_head_dim
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        total = emb
        if self.family in ("dense", "moe", "vlm", "audio"):
            attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
            if self.mlp == "swiglu":
                mlp = 3 * d * self.d_ff
            else:
                mlp = 2 * d * self.d_ff
            if self.moe:
                moe_mlp = self.moe.n_experts * mlp + d * self.moe.n_experts
                if self.moe.dense_residual_d_ff:
                    moe_mlp += 3 * d * self.moe.dense_residual_d_ff
                mlp = moe_mlp
            total += L * (attn + mlp + 2 * d)
        if self.ssm is not None:
            s = self.ssm
            di = s.d_inner(d)
            nh = s.n_heads(d)
            in_proj = d * (2 * di + 2 * s.n_groups * s.state_dim + nh)
            ssm_block = in_proj + di * d + 3 * nh + 2 * d
            n_ssm = L if self.family == "ssm" else L
            total += n_ssm * ssm_block
        if self.family == "hybrid" and self.hybrid_attn_every:
            attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
            total += attn + 3 * d * self.d_ff + 2 * d  # ONE shared block
        if self.encoder:
            e = self.encoder
            total += e.n_layers * (4 * e.d_model**2 + 2 * e.d_model * e.d_ff)
            # decoder cross-attention adds one attn block per layer
            total += L * (4 * d * hd * self.n_heads)
        return int(total)

    def active_param_count(self) -> int:
        """MoE: params touched per token (for 6*N_active*D model FLOPs)."""
        if not self.moe:
            return self.param_count()
        d, L = self.d_model, self.n_layers
        hd = self.resolved_head_dim
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        mlp_one = 3 * d * self.d_ff if self.mlp == "swiglu" else 2 * d * self.d_ff
        active_mlp = self.moe.top_k * mlp_one + d * self.moe.n_experts
        if self.moe.dense_residual_d_ff:
            active_mlp += 3 * d * self.moe.dense_residual_d_ff
        return int(emb + L * (attn + active_mlp + 2 * d))


# ----------------------------------------------------------------- shapes
@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")
SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(applies?, reason-if-not) — long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, (
            f"{cfg.name} is full-attention; a 500k dense KV-cache decode is "
            "the quadratic pattern long_500k exists to exclude (DESIGN.md)"
        )
    return True, ""
