"""repro_torch.models — every family's LM (`DecoderLM` for dense, MoE and
VLM; `MambaLM`, `HybridLM`, `EncDecLM` for ssm, hybrid and audio), their
layers, and the converter from JAX param trees."""
from .encdec import EncDecCaches, EncDecLM  # noqa: F401
from .hybrid import HybridCaches, HybridLM  # noqa: F401
from .model_api import MambaCaches, MambaLM, build_model, supports_paged_kv  # noqa: F401
from .transformer import DecodeCaches, DecoderLM, PagedDecodeCaches  # noqa: F401
