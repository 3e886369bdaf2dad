"""whisper-small [audio] — enc-dec, conv frontend stubbed
(arXiv:2212.04356; unverified).

12L d_model=768 12H (kv=12) d_ff=3072 vocab=51865; encoder 12L over 1500
precomputed frame embeddings. The same FULL and SMOKE shapes as
`repro.configs.whisper_small`.
"""
from .base import EncoderConfig, ModelConfig

FULL = ModelConfig(
    name="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab_size=51_865, head_dim=64,
    norm="layernorm", mlp="gelu", rope_style="standard",
    tie_embeddings=True,
    encoder=EncoderConfig(n_layers=12, n_frames=1500, d_model=768,
                          n_heads=12, d_ff=3072),
    param_dtype="bfloat16", remat="full", grad_accum_steps=2,
)

SMOKE = ModelConfig(
    name="whisper-small-smoke", family="audio",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=512, head_dim=16,
    norm="layernorm", mlp="gelu", rope_style="standard",
    tie_embeddings=True,
    encoder=EncoderConfig(n_layers=2, n_frames=24, d_model=64,
                          n_heads=4, d_ff=128),
    attn_chunk=16,
)
