"""repro_torch.configs — model configs (every family) and the
paper's retrieval operating point (`dirc_rag`, imported on demand)."""
from .base import ModelConfig  # noqa: F401
from .registry import ARCHS, all_archs, get_config  # noqa: F401
