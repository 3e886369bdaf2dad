"""repro_torch.configs — model configs (every family), the dry-run's cell
shapes, and the paper's retrieval operating point (`dirc_rag`, imported
on demand)."""
from .base import (  # noqa: F401
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    SHAPES,
    TRAIN_4K,
    EncoderConfig,
    ModelConfig,
    MoEConfig,
    ShapeConfig,
    SSMConfig,
    shape_applicable,
)
from .registry import ARCHS, all_archs, get_config  # noqa: F401
