"""`build_model(cfg)` — counterpart of `repro.models.model_api.build_model`
for the families the port has: `dense` only. Other families raise."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike
from .transformer import DecoderLM


def build_model(cfg: ModelConfig, device: DeviceLike = None) -> DecoderLM:
    """The model for `cfg`, with uninitialised weights on `device`
    (`None` is the card); call `.init(generator)` or load converted weights."""
    if cfg.family == "dense":
        return DecoderLM(cfg, device=device)
    raise NotImplementedError(
        f"family {cfg.family!r} is not ported yet (ROADMAP: other model families)")
