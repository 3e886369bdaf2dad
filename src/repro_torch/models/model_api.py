"""`build_model(cfg)` — counterpart of `repro.models.model_api.build_model`
for the families the port has: `dense`, `moe` and `vlm`, all served by
`DecoderLM`. `ssm`, `hybrid` and `audio` raise."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike
from .transformer import FAMILIES, DecoderLM


def build_model(cfg: ModelConfig, device: DeviceLike = None) -> DecoderLM:
    """The model for `cfg`, with uninitialised weights on `device`
    (`None` is the card); call `.init(generator)` or load converted weights."""
    if cfg.family in FAMILIES:
        return DecoderLM(cfg, device=device)
    raise NotImplementedError(
        f"family {cfg.family!r} is not ported yet (ROADMAP: other model families)")


def supports_paged_kv(model) -> bool:
    """True when `model` grows a pageable KV cache (attention families),
    as `repro.models.model_api.supports_paged_kv` decides it."""
    return hasattr(model, "init_paged_caches") and hasattr(model, "paged_step")
