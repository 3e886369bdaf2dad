"""Device resolution shared by every entry point of the port.

`device=None` means the card. When CUDA is absent the caller must ask
for the CPU explicitly (`device="cpu"`, as the tests do): an entry point
never carries on silently on the host.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the host")
    return dev


def make_generator(device: torch.device, seed: int) -> torch.Generator:
    """A seeded `torch.Generator` living on `device`."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def dtype(name: str) -> torch.dtype:
    """Config dtype string (e.g. "bfloat16") -> torch dtype."""
    out = getattr(torch, name, None)
    if not isinstance(out, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return out
