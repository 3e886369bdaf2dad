"""phi4-mini-3.8b [dense] — RoPE SwiGLU GQA (arXiv:2412.08905; hf).

32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064. The same FULL
and SMOKE shapes as `repro.configs.phi4_mini_3_8b`, without the
training-only knobs (remat, gradient accumulation) the port has no use for.
"""
from .base import ModelConfig

FULL = ModelConfig(
    name="phi4-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=8192, vocab_size=200_064, head_dim=128,
    param_dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="phi4-mini-3.8b-smoke", family="dense",
    n_layers=2, d_model=96, n_heads=6, n_kv_heads=2,
    d_ff=256, vocab_size=512, head_dim=16,
    attn_chunk=16,
)
