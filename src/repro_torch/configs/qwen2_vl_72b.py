"""qwen2-vl-72b [vlm] — M-RoPE, dynamic resolution (arXiv:2409.12191; hf).

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064. Backbone only:
the vision frontend is a stub; `positions=` takes (3, b, s) M-RoPE
position ids alongside token ids.
The same FULL and SMOKE as `repro.configs.qwen2_vl_72b`.
"""
from .base import ModelConfig

FULL = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=29568, vocab_size=152_064, head_dim=128,
    norm="rmsnorm", mlp="swiglu", rope_style="mrope",
    mrope_sections=(16, 24, 24),
    tie_embeddings=True, param_dtype="bfloat16", remat="full", grad_accum_steps=8,
)

SMOKE = ModelConfig(
    name="qwen2-vl-72b-smoke", family="vlm",
    n_layers=2, d_model=96, n_heads=6, n_kv_heads=2,
    d_ff=256, vocab_size=512, head_dim=16,
    norm="rmsnorm", mlp="swiglu", rope_style="mrope",
    mrope_sections=(2, 3, 3),
    tie_embeddings=True, attn_chunk=16,
)
