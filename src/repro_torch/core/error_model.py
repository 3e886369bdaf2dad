"""Spatial ReRAM sensing-error model (paper Fig. 5a).

PyTorch counterpart of `repro.core.error_model`. The error maps and the
bit->cell mapping math are numpy, as in the JAX package. One sensing
event draws its flips from a `torch.Generator` on the planes' device, or
takes an injected flip mask — the hook that lets a test replay the JAX
package's own draws, since the two random streams differ.

MSB cells are 100% reliable; LSB flip probability depends on the cell's
position in the 8x8 subarray (near the VSS rails is best, far from the
readout on the right is worst). Errors are transient per sensing event.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

SUBARRAY_ROWS = 8
SUBARRAY_COLS = 8
CELLS = SUBARRAY_ROWS * SUBARRAY_COLS  # 64 MLC cells -> 64 MSB + 64 LSB bits


@dataclasses.dataclass(frozen=True)
class ErrorModelConfig:
    enabled: bool = False
    p_min: float = 1e-3      # LSB flip prob at the most reliable position
    p_max: float = 5e-2      # ... at the least reliable position
    jitter_sigma: float = 0.0  # log-normal cell-to-cell jitter (0 = systematic only)
    seed: int = 0


def lsb_error_map(cfg: ErrorModelConfig) -> np.ndarray:
    """(8, 8) LSB flip probability per subarray position."""
    r = np.arange(SUBARRAY_ROWS, dtype=np.float64)[:, None]
    c = np.arange(SUBARRAY_COLS, dtype=np.float64)[None, :]
    dist_rail = np.minimum(c, (SUBARRAY_COLS - 1) - c) / ((SUBARRAY_COLS - 1) / 2)
    dist_readout = ((SUBARRAY_COLS - 1) - c) / (SUBARRAY_COLS - 1)
    dist_row = r / (SUBARRAY_ROWS - 1)
    g = 0.55 * dist_rail + 0.35 * dist_readout + 0.10 * np.broadcast_to(
        dist_row, (SUBARRAY_ROWS, SUBARRAY_COLS)
    )
    g = (g - g.min()) / (g.max() - g.min())
    p = cfg.p_min + (cfg.p_max - cfg.p_min) * g
    if cfg.jitter_sigma > 0:
        rng = np.random.default_rng(cfg.seed)
        p = p * rng.lognormal(0.0, cfg.jitter_sigma, size=p.shape)
    return np.clip(p, 0.0, 0.5)


def msb_error_map(cfg: ErrorModelConfig) -> np.ndarray:
    """MSB flip probability — 0 everywhere (paper: '100% reliability')."""
    del cfg
    return np.zeros((SUBARRAY_ROWS, SUBARRAY_COLS), dtype=np.float64)


def flip_probs_for_mapping(mapping: np.ndarray, cfg: ErrorModelConfig) -> np.ndarray:
    """Per-(slot, bit) flip probability given a bit->cell mapping
    (n_slots, bits, 3) of (row, col, level); level 1 = LSB."""
    lsb = lsb_error_map(cfg)
    msb = msb_error_map(cfg)
    rows = mapping[..., 0]
    cols = mapping[..., 1]
    lvl = mapping[..., 2]
    return np.where(lvl == 1, lsb[rows, cols], msb[rows, cols])


def apply_sense_errors(
    planes: torch.Tensor,
    probs: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    flips: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One sensing event: flip each bit of `planes` independently.

    planes: uint8 {0,1} (n_docs, bits, dim); probs: fp32 (n_slots, bits),
    broadcast over docs via slot = doc_index mod n_slots. The flips come
    from `flips` ({0,1} or bool, shape of `planes`) when given, else are
    drawn from `generator`, which must live on the planes' device.
    """
    n, bits, dim = planes.shape
    if flips is None:
        if generator is None:
            raise ValueError("apply_sense_errors needs a generator or flips")
        slot = torch.arange(n, device=planes.device) % probs.shape[0]
        p = probs[slot]                                     # (n, bits)
        u = torch.rand((n, bits, dim), generator=generator, device=planes.device)
        flips = u < p[..., None]
    elif flips.shape != planes.shape:
        raise ValueError(f"flips {tuple(flips.shape)} != planes {tuple(planes.shape)}")
    return torch.where(flips.bool(), 1 - planes, planes).to(torch.uint8)
