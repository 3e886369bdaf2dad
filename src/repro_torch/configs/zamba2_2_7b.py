"""zamba2-2.7b [hybrid] — Mamba2 backbone + SHARED attention block
(arXiv:2411.15242; hf).

54L d_model=2560 32H (GQA kv=32) d_ff=10240 vocab=32000, ssm_state=64.
Shared attention applied every 6 SSM layers (9 applications, one set of
weights). The same FULL and SMOKE shapes as
`repro.configs.zamba2_2_7b`.
"""
from .base import ModelConfig, SSMConfig

FULL = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab_size=32_000, head_dim=80,
    norm="rmsnorm", mlp="swiglu", rope_style="standard",
    tie_embeddings=True, hybrid_attn_every=6,
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, n_groups=1,
                  chunk_size=256),
    param_dtype="bfloat16", remat="full", grad_accum_steps=2,
)

SMOKE = ModelConfig(
    name="zamba2-2.7b-smoke", family="hybrid",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=160, vocab_size=512, head_dim=16,
    norm="rmsnorm", mlp="swiglu", rope_style="standard",
    tie_embeddings=True, hybrid_attn_every=2,
    ssm=SSMConfig(state_dim=16, head_dim=8, expand=2, n_groups=1,
                  chunk_size=16),
    attn_chunk=16,
)
