"""repro_torch.models — the decoder LM of the dense, MoE and VLM families
(`DecoderLM`), its layers, and the converter from JAX param trees."""
from .model_api import build_model, supports_paged_kv  # noqa: F401
from .transformer import DecodeCaches, DecoderLM, PagedDecodeCaches  # noqa: F401
