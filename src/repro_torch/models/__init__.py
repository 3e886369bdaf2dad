"""repro_torch.models — the dense decoder (`DecoderLM`), its layers, and
the converter from JAX param trees."""
from .model_api import build_model  # noqa: F401
from .transformer import DecodeCaches, DecoderLM  # noqa: F401
