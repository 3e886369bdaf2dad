"""phi3.5-moe-42b-a6.6b [moe] — 16 experts top-2
(hf:microsoft/Phi-3.5-MoE-instruct; hf).

32L d_model=4096 32H (GQA kv=8) d_ff=6400 (per expert) vocab=32064.
The same FULL and SMOKE as `repro.configs.phi3_5_moe_42b`.
"""
from .base import ModelConfig, MoEConfig

FULL = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=6400, vocab_size=32_064, head_dim=128,
    norm="rmsnorm", mlp="swiglu", rope_style="standard",
    tie_embeddings=True,
    moe=MoEConfig(n_experts=16, top_k=2, capacity_factor=1.25),
    param_dtype="bfloat16", remat="full", grad_accum_steps=4,
)

SMOKE = ModelConfig(
    name="phi3.5-moe-42b-a6.6b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=96, vocab_size=512, head_dim=16,
    norm="rmsnorm", mlp="swiglu", rope_style="standard",
    tie_embeddings=True,
    moe=MoEConfig(n_experts=4, top_k=2, capacity_factor=1.25),
    attn_chunk=16,
)
