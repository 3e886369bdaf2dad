"""arctic-480b [moe] — 128 experts top-2 + dense residual MLP
(hf:Snowflake/snowflake-arctic-base; hf).

35L d_model=7168 56H (GQA kv=8) d_ff=4864 (per expert) vocab=32000.
The same FULL and SMOKE as `repro.configs.arctic_480b`.
"""
from .base import ModelConfig, MoEConfig

FULL = ModelConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=4864, vocab_size=32_000, head_dim=128,
    norm="rmsnorm", mlp="swiglu", rope_style="standard",
    tie_embeddings=True,
    moe=MoEConfig(n_experts=128, top_k=2, capacity_factor=1.25,
                  dense_residual_d_ff=4864),
    param_dtype="bfloat16", remat="full", grad_accum_steps=8,
    # 56 query heads padded to 64 (Megatron-style divisibility padding,
    # +2.2% params) so the heads shard over a 16-way model axis; the
    # padded heads are real weights, so the port keeps them: wq / wo are
    # (7168, 8192) / (8192, 7168) and each KV head serves 8 query heads.
    pad_attn_heads_to=16,
)

SMOKE = ModelConfig(
    name="arctic-480b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=96, vocab_size=512, head_dim=16,
    norm="rmsnorm", mlp="swiglu", rope_style="standard",
    tie_embeddings=True,
    moe=MoEConfig(n_experts=8, top_k=2, capacity_factor=1.25,
                  dense_residual_d_ff=96),
    attn_chunk=16,
)
