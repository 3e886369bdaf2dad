"""--arch <id> registry over the ten architectures of
`repro.configs.registry`, every family included."""
from __future__ import annotations

import importlib

from .base import ModelConfig

ARCHS = {
    "granite-34b": "granite_34b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "phi3-medium-14b": "phi3_medium_14b",
    "command-r-plus-104b": "command_r_plus_104b",
    "zamba2-2.7b": "zamba2_2_7b",
    "arctic-480b": "arctic_480b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "mamba2-2.7b": "mamba2_2_7b",
    "whisper-small": "whisper_small",
}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; choose from {sorted(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
    return mod.SMOKE if smoke else mod.FULL


def all_archs() -> list[str]:
    return list(ARCHS)
