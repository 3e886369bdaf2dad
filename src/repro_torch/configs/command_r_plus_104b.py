"""command-r-plus-104b [dense] — GQA, no-bias LayerNorm, parallel block
(hf:CohereForAI/c4ai-command-r-v01; unverified).

64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000.
The same FULL and SMOKE as `repro.configs.command_r_plus_104b`.
"""
from .base import ModelConfig

FULL = ModelConfig(
    name="command-r-plus-104b", family="dense",
    n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8,
    d_ff=33792, vocab_size=256_000, head_dim=128,
    norm="layernorm", mlp="swiglu", parallel_block=True,
    rope_style="standard", tie_embeddings=True, param_dtype="bfloat16", remat="full", grad_accum_steps=8,
)

SMOKE = ModelConfig(
    name="command-r-plus-104b-smoke", family="dense",
    n_layers=2, d_model=96, n_heads=6, n_kv_heads=2,
    d_ff=256, vocab_size=512, head_dim=16,
    norm="layernorm", mlp="swiglu", parallel_block=True,
    rope_style="standard", tie_embeddings=True, attn_chunk=16,
)
