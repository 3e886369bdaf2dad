"""mamba2-2.7b [ssm] — SSD / state-space duality (arXiv:2405.21060;
unverified). 64L d_model=2560 attn-free d_ff=0 vocab=50280, ssm_state=128.

The same FULL and SMOKE shapes as `repro.configs.mamba2_2_7b`.
"""
from .base import ModelConfig, SSMConfig

FULL = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=50_280,
    norm="rmsnorm", rope_style="none", tie_embeddings=True,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, n_groups=1,
                  chunk_size=256),
    param_dtype="bfloat16", remat="full", grad_accum_steps=2,
)

SMOKE = ModelConfig(
    name="mamba2-2.7b-smoke", family="ssm",
    n_layers=3, d_model=64, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=512,
    norm="rmsnorm", rope_style="none", tie_embeddings=True,
    ssm=SSMConfig(state_dim=16, head_dim=8, expand=2, n_groups=1,
                  chunk_size=16),
)
