"""repro_torch.configs — model configs (phi4-mini only) and the paper's
retrieval operating point (`dirc_rag`, imported on demand)."""
from .base import ModelConfig  # noqa: F401
from .registry import ARCHS, all_archs, get_config  # noqa: F401
