"""Sigma-D checksum error detection + re-sense loop (paper Fig. 5b).

PyTorch counterpart of `repro.core.error_detection`. After a bit-plane
is sensed, the adder's all-ones pass yields its popcount; a mismatch
against the offline D-Sum LUT flags the plane, which is RE-SENSED
(transient errors are independent across senses). Compensating flips
(equal numbers of 0->1 and 1->0 in one plane) escape detection.

Randomness: each sensing round draws from `generator`, or takes the next
mask of `flips` — one mask per round, round 0 the first sense and round
i the i-th re-sense — so a test can feed the JAX package's exact draws.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from .error_model import apply_sense_errors


class SenseResult(NamedTuple):
    planes: torch.Tensor          # uint8 (n, bits, dim) — final sensed planes
    detected: torch.Tensor        # int32 () — mismatches detected (all rounds)
    residual_planes: torch.Tensor  # int32 () — planes still mismatched after retries
    rounds: torch.Tensor          # int32 () — sensing rounds executed (1 = no retry)
    detected_map: torch.Tensor    # int32 (n_slots, bits) — FIRST-round mismatches
    #   per physical (slot, bit) position: the unbiased sample of the channel.


def plane_popcount(planes: torch.Tensor) -> torch.Tensor:
    """(n, bits, dim) {0,1} -> (n, bits) int32 popcounts (the adder output)."""
    return torch.sum(planes, dim=-1, dtype=torch.int32)


def sense_with_detection(
    clean_planes: torch.Tensor,
    lut: torch.Tensor,
    probs: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    max_retries: int = 3,
    detect: bool = True,
    flips: Optional[Sequence[torch.Tensor]] = None,
) -> SenseResult:
    """Simulate sensing of all planes with the error channel + detection.

    clean_planes: the true stored bits (n, bits, dim); lut: D-Sum LUT
    (n, bits) int32; probs: (n_slots, bits) per-position flip probability.
    `flips`, when given, holds 1 + max_retries masks (1 when detect is off).
    """
    n_rounds = 1 + (max_retries if detect else 0)
    if flips is not None and len(flips) != n_rounds:
        raise ValueError(f"flips holds {len(flips)} masks, {n_rounds} rounds run")
    dev = clean_planes.device

    def sense(r: int) -> torch.Tensor:
        return apply_sense_errors(clean_planes, probs, generator,
                                  None if flips is None else flips[r])

    n_slots, bits = probs.shape
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    sensed = sense(0)
    if not detect:
        return SenseResult(
            planes=sensed, detected=zero, residual_planes=zero,
            rounds=torch.ones((), dtype=torch.int32, device=dev),
            detected_map=torch.zeros((n_slots, bits), dtype=torch.int32, device=dev),
        )

    slot = torch.arange(clean_planes.shape[0], device=dev) % n_slots
    detected_map = torch.zeros((n_slots, bits), dtype=torch.int32, device=dev)
    detected_map.index_add_(0, slot, (plane_popcount(sensed) != lut).int())

    planes, detected = sensed, zero
    for r in range(1, n_rounds):
        mismatch = plane_popcount(planes) != lut            # (n, bits) bool
        detected = detected + mismatch.sum(dtype=torch.int32)
        planes = torch.where(mismatch[..., None], sense(r), planes)
    residual = (plane_popcount(planes) != lut).sum(dtype=torch.int32)
    return SenseResult(
        planes=planes,
        detected=detected,
        residual_planes=residual,
        rounds=torch.tensor(n_rounds, dtype=torch.int32, device=dev),
        detected_map=detected_map,
    )
