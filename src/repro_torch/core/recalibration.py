"""Online recalibration: detection counters -> re-extraction -> remap.

A numpy-only copy of `repro.core.recalibration`: the controller reads
only the host-side counters of the port's `ShardedDircIndex`, so it is
the reference's line for line.

Closes the loop the paper opens. §III-C extracts the spatial error map
ONCE, offline, and bakes a bit-wise remapping; `device_physics.py` makes
that map drift, so the baked mapping goes stale. This controller watches
the only runtime signal a real macro has — the Sigma-D mismatch counters
from `sense_with_detection` — and, per shard:

  1. accumulates a window of first-round detection counts,
  2. inverts them into a believed per-cell error estimate and summarizes
     it as the WEIGHTED EXPOSURE of the current mapping (sum of
     2^bit * p_hat over slot/bit positions). Exposure is the right
     trigger: the AGGREGATE detection rate is invariant under remapping
     (a permutation moves error mass, it does not remove it), so a pure
     spatial rotation — the drift component recalibration can actually
     fix — is invisible to it, while exposure rises as error mass slides
     under high-weight bits;
  3. establishes the first full window after (re)calibration as the
     shard's baseline, and
  4. when a later window's exposure crosses `trigger_ratio` x baseline
     (with an absolute `min_detected` guard against triggering off
     noise), fires `ShardedDircIndex.recalibrate_shard`: online
     re-extraction of the map from those same counters, a fresh
     error-aware remapping, and an in-place chunked re-encode — the
     index keeps serving throughout.

After a recalibration the shard's window and baseline reset: the next
full window re-baselines against the post-recal channel (the aggregate
rate is unchanged by design, the exposure is what dropped).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .device_physics import invert_detection_rate


@dataclasses.dataclass(frozen=True)
class RecalibrationConfig:
    """enabled: master switch (off = counters only, never recalibrate).
    window: sense events per shard per evaluation window.
    trigger_ratio: exposure multiple over baseline that fires a recal.
    min_detected: minimum raw detections in the window to trust it.
    max_recals: per-shard cap (0 = unlimited) — a runaway guard."""

    enabled: bool = True
    window: int = 16
    trigger_ratio: float = 1.3
    min_detected: int = 32
    max_recals: int = 0


class RecalibrationController:
    """Watches one `ShardedDircIndex`'s detection counters; fires
    per-shard online recalibrations. Drive it by calling `poll()`
    anywhere on the query path (e.g. after each `search_batch`) — it is
    cheap when no window has filled."""

    def __init__(self, index, config: Optional[RecalibrationConfig] = None):
        self.index = index
        self.config = config or RecalibrationConfig()
        s = index.n_shards
        self._mark_senses = np.zeros(s, np.int64)
        self._mark_map = np.zeros_like(index._win_det_map)
        self._baseline = np.full(s, np.nan)
        self._last_metric = np.full(s, np.nan)
        self._triggers = np.zeros(s, np.int64)

    # ----------------------------------------------------------- internals
    def _window_exposure(self, shard: int, d_senses: int,
                         d_map: np.ndarray) -> tuple[float, int]:
        """(exposure, raw detections) of one shard's window delta."""
        trials = self.index._rows_per_slot() * d_senses
        rates = d_map / np.maximum(trials[:, None], 1)
        p_hat = invert_detection_rate(rates, self.index.dim)
        weights = 2.0 ** np.arange(p_hat.shape[-1])
        return float((p_hat * weights).sum()), int(d_map.sum())

    def _reset_shard(self, shard: int) -> None:
        """Post-recal: window counters were cleared by the index; drop
        the baseline so the next full window re-baselines."""
        self._mark_senses[shard] = 0
        self._mark_map[shard] = 0
        self._baseline[shard] = np.nan
        self._last_metric[shard] = np.nan

    # ---------------------------------------------------------------- poll
    def poll(self) -> list[int]:
        """Evaluate any filled windows; returns shards recalibrated now."""
        idx = self.index
        cfg = self.config
        if not (idx.config.error.enabled and idx.config.detect):
            return []
        fired: list[int] = []
        for s in range(idx.n_shards):
            d_senses = int(idx._win_senses[s] - self._mark_senses[s])
            if d_senses < cfg.window:
                continue
            d_map = idx._win_det_map[s] - self._mark_map[s]
            metric, detections = self._window_exposure(s, d_senses, d_map)
            self._last_metric[s] = metric
            self._mark_senses[s] = idx._win_senses[s]
            self._mark_map[s] = idx._win_det_map[s]
            if np.isnan(self._baseline[s]):
                self._baseline[s] = metric
                continue
            capped = cfg.max_recals and self._triggers[s] >= cfg.max_recals
            if (cfg.enabled and not capped
                    and detections >= cfg.min_detected
                    and metric > cfg.trigger_ratio * self._baseline[s]):
                idx.recalibrate_shard(s)
                self._triggers[s] += 1
                self._reset_shard(s)
                fired.append(s)
        return fired

    # --------------------------------------------------------------- stats
    def stats(self) -> dict:
        """Per-shard controller view: baseline/last exposure, the
        drift estimate (their ratio — how far the channel has moved from
        the post-calibration baseline), and trigger counts."""
        shards = []
        for s in range(self.index.n_shards):
            base, last = self._baseline[s], self._last_metric[s]
            drift_est = (float(last / base)
                         if np.isfinite(base) and base > 0
                         and np.isfinite(last) else None)
            shards.append({
                "baseline_exposure": float(base) if np.isfinite(base) else None,
                "last_exposure": float(last) if np.isfinite(last) else None,
                "drift_estimate": drift_est,
                "recal_triggers": int(self._triggers[s]),
            })
        return {
            "enabled": bool(self.config.enabled),
            "window": int(self.config.window),
            "trigger_ratio": float(self.config.trigger_ratio),
            "total_triggers": int(self._triggers.sum()),
            "shards": shards,
        }
