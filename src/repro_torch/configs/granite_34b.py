"""granite-34b [dense] — llama-arch code model (arXiv:2405.04324; hf).

88L d_model=6144 48H (GQA kv=1 == MQA) d_ff=24576 vocab=49152.
The same FULL and SMOKE as `repro.configs.granite_34b`.
"""
from .base import ModelConfig

FULL = ModelConfig(
    name="granite-34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab_size=49152, head_dim=128,
    norm="rmsnorm", mlp="swiglu", rope_style="standard",
    tie_embeddings=True, param_dtype="bfloat16", remat="full", grad_accum_steps=8,
)

SMOKE = ModelConfig(
    name="granite-34b-smoke", family="dense",
    n_layers=2, d_model=96, n_heads=6, n_kv_heads=1,
    d_ff=256, vocab_size=512, head_dim=16,
    norm="rmsnorm", mlp="swiglu", rope_style="standard",
    tie_embeddings=True, attn_chunk=16,
)
