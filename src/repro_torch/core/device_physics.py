"""Per-macro device physics: calibration diversity + temporal drift.

A numpy-only copy of `repro.core.device_physics` (the port keeps its own
so it imports nothing of the JAX package); maps, flip probabilities and
the drift processes are bit-equal to the reference's, seed for seed.

`error_model.py` gives ONE spatial flip-probability map — the systematic
post-layout profile of paper Fig. 5a. Real ReRAM dies are not that tidy:

  * **calibration diversity** — every die shares the layout-driven
    profile (rail distance, readout distance) but carries its own
    process variation on top, so two macros never have exactly the same
    map. Each shard of `ShardedDircIndex` therefore gets an independent
    log-normally jittered calibration, seeded per shard
    (`SeedSequence([cfg.seed, shard])`) so maps are reproducible AND
    uncorrelated across macros.
  * **temporal drift** — temperature and ageing move the map after the
    bit-wise remapping was extracted. We model two components over an
    injectable simulated clock: a smooth random walk (plus a
    deterministic ageing term) on the map's log-amplitude, scaling
    p_min/p_max up over time, and a slow rotation of the spatial
    profile (quarter-turn blending), which re-shapes WHERE the
    unreliable cells sit without changing the total error mass. The
    rotation is the component only recalibration can fix: re-sensing
    repairs detected planes regardless of position, but a stale
    `error_aware` mapping keeps parking the high-weight bits on cells
    that are no longer the reliable ones.

`DevicePhysics` owns the TRUE per-macro maps (the simulation's ground
truth); the index's `mapping`/`flip_probs` are extracted against a
BELIEVED map and go stale as the truth drifts — closing that gap online
is `recalibration.py`'s job.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional, Sequence

import numpy as np

from .error_model import (
    SUBARRAY_COLS,
    SUBARRAY_ROWS,
    ErrorModelConfig,
    lsb_error_map,
)

P_CEIL = 0.5  # a flip probability above 1/2 would be an inverted bit


@dataclasses.dataclass(frozen=True)
class DriftConfig:
    """Temporal drift of a macro's true error map (simulated seconds).

    amp_mu:      deterministic ageing rate on the map's log-amplitude
                 (per second): after T seconds the whole map is scaled
                 by exp(amp_mu * T).
    amp_sigma:   random-walk sigma on the log-amplitude (per sqrt-second),
                 the temperature-like smooth fluctuation.
    rotate_rate: spatial profile rotation in quarter-turns per second;
                 phase w blends rot90(base, floor(w)) -> rot90(base,
                 floor(w)+1), so the error mass migrates continuously
                 across the subarray.
    """

    enabled: bool = False
    amp_mu: float = 0.0
    amp_sigma: float = 0.0
    rotate_rate: float = 0.0
    seed: int = 0


def shard_calibration_map(cfg: ErrorModelConfig, shard: int) -> np.ndarray:
    """This macro's t=0 true LSB map: shared systematic profile, own jitter.

    The systematic part (rail/readout geometry) is identical for every
    die; the log-normal process jitter is drawn from a seed derived as
    (cfg.seed, shard), so each shard's calibration is independent while
    jitter_sigma=0 keeps all shards bit-identical (the monolithic-parity
    regime the sharded tests pin).
    """
    base = lsb_error_map(dataclasses.replace(cfg, jitter_sigma=0.0))
    if cfg.jitter_sigma > 0:
        rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, shard]))
        base = base * rng.lognormal(0.0, cfg.jitter_sigma, size=base.shape)
    return np.clip(base, 0.0, P_CEIL)


def flip_probs_for_map(mapping: np.ndarray, lsb_map: np.ndarray) -> np.ndarray:
    """Per-(slot, bit) flip probability for ONE macro under an arbitrary
    (8, 8) LSB map (MSB positions are error-free, as in the paper).

    mapping: (n_slots, bits, 3) of (row, col, level); returns (n_slots,
    bits) float64. The `error_model.flip_probs_for_mapping` twin derives
    the map from a config; this one takes the map directly, which is what
    the drift/recalibration paths need (believed or drifted maps are
    data, not configs).
    """
    rows, cols, lvl = mapping[..., 0], mapping[..., 1], mapping[..., 2]
    return np.where(lvl == 1, lsb_map[rows, cols], 0.0)


def _rot_blend(base: np.ndarray, phase: float) -> np.ndarray:
    """Continuous quarter-turn rotation of the spatial profile."""
    w = phase % 4.0
    k = int(math.floor(w))
    frac = w - k
    if frac == 0.0:
        return np.rot90(base, k)
    return (1.0 - frac) * np.rot90(base, k) + frac * np.rot90(base, k + 1)


class _MacroDriftState:
    """One macro's drift state: log-amplitude walk + rotation phase."""

    def __init__(self, cfg: DriftConfig, shard: int):
        self.cfg = cfg
        self.rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, shard]))
        self.log_amp = 0.0
        self.phase = 0.0

    def advance(self, dt: float) -> None:
        if dt <= 0.0 or not self.cfg.enabled:
            return
        self.log_amp += self.cfg.amp_mu * dt
        if self.cfg.amp_sigma > 0:
            self.log_amp += (self.cfg.amp_sigma * math.sqrt(dt)
                             * self.rng.standard_normal())
        self.phase += self.cfg.rotate_rate * dt


class DevicePhysics:
    """True per-macro error channels for an `n_shards` macro set.

    Owns the per-shard t=0 calibrations and the drift processes over an
    injectable monotonic clock. `advance()` steps every macro's state to
    `clock()`; `true_maps()` / `flip_probs(mappings)` read the current
    ground truth. The believed state (what remapping was extracted
    against) lives in `ShardedDircIndex` — the divergence between the
    two is exactly what `RecalibrationController` watches for.
    """

    def __init__(
        self,
        error_cfg: ErrorModelConfig,
        n_shards: int,
        drift: Optional[DriftConfig] = None,
        clock: Optional[Callable[[], float]] = None,
    ):
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        self.error_cfg = error_cfg
        self.n_shards = n_shards
        self.drift = drift or DriftConfig()
        self._clock = clock or time.monotonic
        self._t = self._clock()
        self.calibration = np.stack(
            [shard_calibration_map(error_cfg, s) for s in range(n_shards)])
        self._states = [_MacroDriftState(self.drift, s)
                        for s in range(n_shards)]

    # ------------------------------------------------------------ evolution
    def advance(self) -> float:
        """Step every macro's drift state to the current clock reading."""
        now = self._clock()
        dt = now - self._t
        if dt > 0:
            for st in self._states:
                st.advance(dt)
            self._t = now
        return now

    # -------------------------------------------------------------- reads
    def true_map(self, shard: int) -> np.ndarray:
        """(8, 8) current TRUE LSB map of one macro (no clock advance)."""
        st = self._states[shard]
        m = _rot_blend(self.calibration[shard], st.phase)
        return np.clip(m * math.exp(st.log_amp), 0.0, P_CEIL)

    def true_maps(self) -> np.ndarray:
        """(S, 8, 8) current true maps across the macro set."""
        return np.stack([self.true_map(s) for s in range(self.n_shards)])

    def flip_probs(self, mappings: np.ndarray) -> np.ndarray:
        """(S, slots, bits) TRUE per-(slot, bit) probs under per-shard
        mappings (S, slots, bits, 3) — what the sensing channel samples.
        """
        return np.stack([
            flip_probs_for_map(mappings[s], self.true_map(s))
            for s in range(self.n_shards)
        ])

    def drift_amplitude(self) -> np.ndarray:
        """(S,) ground-truth amplitude multiplier exp(log_amp) per macro
        (observability for reports/benches, NOT visible to the
        controller, which must estimate drift from detection counts)."""
        return np.exp([st.log_amp for st in self._states])

    def drift_phase(self) -> np.ndarray:
        """(S,) ground-truth rotation phase in quarter-turns per macro."""
        return np.asarray([st.phase for st in self._states])


# ----------------------------------------------------------- re-extraction
def invert_detection_rate(rate: np.ndarray, dim: int) -> np.ndarray:
    """Per-bit flip prob from a per-plane Sigma-D detection rate.

    A plane of `dim` cells with per-cell flip prob p mismatches its
    popcount LUT with probability ~ 1 - (1-p)^dim (compensating flips
    shave this slightly — we accept the small bias). Inverting gives the
    maximum-likelihood per-cell p from the observed mismatch rate. Rates
    are clamped below 1 so saturated planes invert to a finite ceiling
    instead of p=1.
    """
    r = np.clip(np.asarray(rate, np.float64), 0.0, 0.98)
    return np.clip(1.0 - (1.0 - r) ** (1.0 / max(dim, 1)), 0.0, P_CEIL)


def extract_map_from_counts(
    mapping: np.ndarray,
    det_counts: np.ndarray,
    det_trials: np.ndarray,
    dim: int,
) -> np.ndarray:
    """Reconstruct an (8, 8) believed LSB map from detection statistics.

    det_counts: (n_slots, bits) first-round Sigma-D mismatch counts;
    det_trials: (n_slots,) plane-sense trials per slot (rows x senses).
    Each subarray cell holds exactly one LSB-level (slot, bit) under any
    valid mapping, so the per-bit estimates tile the full 8x8 map — this
    is the online analogue of the paper's offline Monte-Carlo extraction,
    driven purely by the runtime checksum counters.
    """
    trials = np.maximum(np.asarray(det_trials, np.float64)[:, None], 1.0)
    p_hat = invert_detection_rate(det_counts / trials, dim)
    emap = np.zeros((SUBARRAY_ROWS, SUBARRAY_COLS), np.float64)
    lsb = mapping[..., 2] == 1
    emap[mapping[..., 0][lsb], mapping[..., 1][lsb]] = p_hat[lsb]
    return emap


def weighted_exposure(mapping: np.ndarray, lsb_map: np.ndarray) -> float:
    """Expected weighted bit error of a mapping under a map: sum over
    (slot, bit) of 2^bit * p. This is the quantity `error_aware`
    remapping minimizes, and the controller's drift trigger metric — a
    pure amplitude drift raises it, and so does a rotation that slides
    error mass under the high-weight bits, even though rotation leaves
    the TOTAL detection rate unchanged (remapping permutes, it does not
    remove, the per-cell error mass).
    """
    probs = flip_probs_for_map(mapping, lsb_map)
    w = 2.0 ** np.arange(probs.shape[-1])
    return float((probs * w).sum())


def stack_mappings(mapping: np.ndarray, n_shards: int) -> np.ndarray:
    """Tile one (slots, bits, 3) mapping into per-shard (S, slots, bits,
    3) — the degenerate 'every die identical' layout used when the error
    model is disabled."""
    return np.broadcast_to(
        mapping, (n_shards,) + mapping.shape).copy()


__all__: Sequence[str] = [
    "DriftConfig",
    "DevicePhysics",
    "shard_calibration_map",
    "flip_probs_for_map",
    "invert_detection_rate",
    "extract_map_from_counts",
    "weighted_exposure",
    "stack_mappings",
]
