"""--arch <id> registry over the architectures the port supports."""
from __future__ import annotations

import importlib

from .base import ModelConfig

ARCHS = {
    "phi4-mini-3.8b": "phi4_mini_3_8b",
}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; choose from {sorted(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
    return mod.SMOKE if smoke else mod.FULL


def all_archs() -> list[str]:
    return list(ARCHS)
