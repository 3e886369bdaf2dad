"""phi3-medium-14b [dense] — RoPE SwiGLU GQA (arXiv:2404.14219; unverified).

40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352.
The same FULL and SMOKE as `repro.configs.phi3_medium_14b`.
"""
from .base import ModelConfig

FULL = ModelConfig(
    name="phi3-medium-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10,
    d_ff=17920, vocab_size=100_352, head_dim=128,
    norm="rmsnorm", mlp="swiglu", rope_style="standard",
    tie_embeddings=True, param_dtype="bfloat16", remat="full", grad_accum_steps=4,
)

SMOKE = ModelConfig(
    name="phi3-medium-14b-smoke", family="dense",
    n_layers=2, d_model=80, n_heads=5, n_kv_heads=5,
    d_ff=224, vocab_size=512, head_dim=16,
    norm="rmsnorm", mlp="swiglu", rope_style="standard",
    tie_embeddings=True, attn_chunk=16,
)
