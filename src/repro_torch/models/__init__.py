"""repro_torch.models — every family's LM (`DecoderLM` for dense, MoE and
VLM; `MambaLM`, `HybridLM`, `EncDecLM` for ssm, hybrid and audio), their
layers, the converter from JAX param trees, and the cell specs
(`input_specs`, `cache_specs`, `param_specs`: meta tensors)."""
from .encdec import EncDecCaches, EncDecLM  # noqa: F401
from .hybrid import HybridCaches, HybridLM  # noqa: F401
from .model_api import (  # noqa: F401
    MambaCaches,
    MambaLM,
    build_model,
    cache_specs,
    input_specs,
    param_specs,
    supports_paged_kv,
)
from .transformer import DecodeCaches, DecoderLM, PagedDecodeCaches  # noqa: F401
