"""Self-tuning SLO control plane: measure per-tenant tails, actuate knobs
— counterpart of `repro.serving.slo_controller` (host-only Python).

`SLOController` measures p95 TTFT / end-to-end latency per tenant against
an SLO target over a sliding window, on the same injectable clock as the
rest of the serving stack (deterministic fake-clock tests, no sleeps),
and actuates three ways:

* **Deadline / lookahead.** When the worst tenant's p95 overshoots its
  target, the scheduler deadline is tightened (`set_max_wait_ms`,
  divided by `wait_step` down to `min_wait_ms`) and the engine's
  admission skip-ahead window widened (`set_admit_lookahead`). When every
  tenant is under `relax_ratio` of its target, both step back toward
  their configured baselines.
* **Tenant weights.** The worst-missing tenant's DRR weight is boosted
  multiplicatively (`weight_step`, capped at `max_weight`) via
  `set_tenant_weight`; on relax, controller-boosted weights decay back to
  their pre-boost values (hand-set weights are the baseline, not 1.0).
* **Priority preemption.** Under pool pressure — a high-priority request
  waits and its reservation cannot be covered — the engine (or every
  router replica) is asked to `preempt_for_waiting`: a strictly
  lower-priority running sequence publishes its resident KV prefix,
  releases its blocks and re-queues.

Measurement rides the engine's completion feed (`pop_completions`: one
`(finish_clock, tenant, priority, ttft_s, e2e_s)` sample per finished
request, router-merged fleet-wide), plus `observe()` for layers without
an engine. All policy lives in the frozen `SLOConfig` (serving/config.py);
`launch/serve.py --slo-*` wires it to the CLI.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Optional

from .config import SLOConfig

# actuator duck-type notes: `engine` may be a ContinuousBatchingEngine
# or an EngineRouter — both expose pop_completions / preempt_for_waiting
# / set_admit_lookahead; the current lookahead value is read off the
# engine (or replica 0, every replica is actuated in lockstep).


def _p95(values: list) -> float:
    """p95 by the nearest-rank method — no numpy, no interpolation, so
    tiny windows behave predictably (n < 20 returns the max)."""
    if not values:
        return 0.0
    ordered = sorted(values)
    rank = max(0, -(-95 * len(ordered) // 100) - 1)
    return ordered[rank]


class SLOController:
    """Sliding-window p95 measurement + knob actuation loop.

    config: the frozen `SLOConfig` — targets and actuation policy.
    engine: a `ContinuousBatchingEngine` or `EngineRouter` (optional) —
        the completion feed and the lookahead/preemption actuators.
    scheduler: an `AsyncBatchScheduler` (optional) — the deadline and
        tenant-weight actuators.
    clock: monotonic-seconds callable; share it with the scheduler and
        engine so window arithmetic and their latency stamps agree.
    start: spawn a background poll thread (real-clock deployments).
        With start=False, call `poll()` yourself — e.g. once per engine
        step.

    `poll()` ingests new completion samples, fires the preemption check
    every call, and at most every `interval_s` computes the worst
    p95/target ratio across tenants and tightens (ratio > 1), relaxes
    (ratio < relax_ratio), or holds. Returns the number of actuation
    actions (knob changes + preemptions) performed by this call.
    """

    def __init__(
        self,
        config: SLOConfig,
        engine=None,
        scheduler=None,
        clock: Callable[[], float] = time.monotonic,
        start: bool = False,
    ):
        if not isinstance(config, SLOConfig):
            raise TypeError(
                f"config must be an SLOConfig, got {type(config).__name__}")
        self.config = config
        self.engine = engine
        self.scheduler = scheduler
        self._clock = clock
        self._lock = threading.Lock()
        # (finish_clock, tenant, priority, ttft_s, e2e_s)
        self._samples: deque = deque()
        self._last_actuation: Optional[float] = None
        # knob baselines: actuation never tightens past config floors and
        # never relaxes past what the operator configured
        self._base_wait_ms = (scheduler.max_wait_ms
                              if scheduler is not None else None)
        self._base_lookahead = self._current_lookahead()
        if config.lookahead_max is not None:
            self._lookahead_max = config.lookahead_max
        elif self._base_lookahead is not None:
            self._lookahead_max = max(4, 4 * self._base_lookahead)
        else:
            self._lookahead_max = None
        self._base_weights: dict[str, float] = {}  # tenant -> pre-boost
        # counters (stats() schema)
        self.n_polls = 0
        self.n_actuations = 0
        self.n_tightens = 0
        self.n_relaxes = 0
        self.n_preemptions = 0
        self.n_weight_updates = 0
        self.worst_ratio = 0.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if start:
            self._thread = threading.Thread(
                target=self._loop, name="SLOController", daemon=True)
            self._thread.start()

    # ----------------------------------------------------------- knob I/O
    def _current_lookahead(self) -> Optional[int]:
        eng = self.engine
        if eng is None:
            return None
        if hasattr(eng, "engines"):  # router: replicas move in lockstep
            eng = eng.engines[0]
        return getattr(eng, "admit_lookahead", None)

    def _set_lookahead(self, n: int) -> None:
        self.engine.set_admit_lookahead(n)

    # -------------------------------------------------------- measurement
    def observe(self, tenant: str, ttft_s: Optional[float], e2e_s: float,
                priority: int = 0, t: Optional[float] = None) -> None:
        """Feed one completed-request sample by hand — for layers with
        no engine completion feed (retrieval-only serving records
        `AsyncTicket.wait_s` as both TTFT and e2e)."""
        now = self._clock() if t is None else t
        with self._lock:
            self._samples.append(
                (now, tenant, priority,
                 e2e_s if ttft_s is None else ttft_s, e2e_s))

    def _ingest_locked(self, now: float) -> None:
        if self.engine is not None:
            self._samples.extend(self.engine.pop_completions())
        horizon = now - self.config.window_s
        while self._samples and self._samples[0][0] < horizon:
            self._samples.popleft()

    def _target(self, per_tenant: Optional[dict], tenant: str,
                global_ms: Optional[float]) -> Optional[float]:
        if per_tenant is not None and tenant in per_tenant:
            return per_tenant[tenant]
        return global_ms

    def _worst_locked(self) -> tuple[float, Optional[str]]:
        """(worst p95/target ratio, worst tenant) over the window."""
        cfg = self.config
        by_tenant: dict[str, tuple[list, list]] = {}
        for _, tenant, _, ttft_s, e2e_s in self._samples:
            ttfts, e2es = by_tenant.setdefault(tenant, ([], []))
            ttfts.append(ttft_s * 1e3)
            e2es.append(e2e_s * 1e3)
        worst, worst_tenant = 0.0, None
        for tenant, (ttfts, e2es) in by_tenant.items():
            for values, per_tenant, global_ms in (
                (ttfts, cfg.tenant_ttft_p95_ms, cfg.ttft_p95_ms),
                (e2es, cfg.tenant_e2e_p95_ms, cfg.e2e_p95_ms),
            ):
                target = self._target(per_tenant, tenant, global_ms)
                if target is None:
                    continue
                ratio = _p95(values) / target
                if ratio > worst:
                    worst, worst_tenant = ratio, tenant
        return worst, worst_tenant

    # ---------------------------------------------------------- actuation
    def _tighten_locked(self, worst_tenant: Optional[str]) -> int:
        cfg = self.config
        acted = 0
        sched = self.scheduler
        if sched is not None and sched.max_wait_ms is not None:
            new = max(cfg.min_wait_ms, sched.max_wait_ms / cfg.wait_step)
            if new != sched.max_wait_ms:
                sched.set_max_wait_ms(new)
                acted += 1
        cur = self._current_lookahead()
        if cur is not None and self._lookahead_max is not None \
                and cur < self._lookahead_max:
            self._set_lookahead(cur + 1)
            acted += 1
        if sched is not None and worst_tenant is not None:
            cur_w = sched.tenant_weight(worst_tenant)
            new_w = min(cfg.max_weight, cur_w * cfg.weight_step)
            if new_w != cur_w:
                self._base_weights.setdefault(worst_tenant, cur_w)
                sched.set_tenant_weight(worst_tenant, new_w)
                self.n_weight_updates += 1
                acted += 1
        if acted:
            self.n_tightens += 1
        return acted

    def _relax_locked(self) -> int:
        cfg = self.config
        acted = 0
        sched = self.scheduler
        if sched is not None and self._base_wait_ms is not None \
                and sched.max_wait_ms is not None \
                and sched.max_wait_ms < self._base_wait_ms:
            sched.set_max_wait_ms(
                min(self._base_wait_ms, sched.max_wait_ms * cfg.wait_step))
            acted += 1
        cur = self._current_lookahead()
        if cur is not None and self._base_lookahead is not None \
                and cur > self._base_lookahead:
            self._set_lookahead(cur - 1)
            acted += 1
        if sched is not None:
            for tenant, base in list(self._base_weights.items()):
                cur_w = sched.tenant_weight(tenant)
                new_w = max(base, cur_w / cfg.weight_step)
                if new_w != cur_w:
                    sched.set_tenant_weight(tenant, new_w)
                    self.n_weight_updates += 1
                    acted += 1
                if new_w <= base:
                    del self._base_weights[tenant]
        if acted:
            self.n_relaxes += 1
        return acted

    def poll(self) -> int:
        """One controller turn; see the class docstring. Thread-safe."""
        cfg = self.config
        now = self._clock()
        acted = 0
        with self._lock:
            self.n_polls += 1
            self._ingest_locked(now)
            due = (self._last_actuation is None
                   or now - self._last_actuation >= cfg.interval_s)
            enough = len(self._samples) >= cfg.min_samples
            if due and enough:
                self._last_actuation = now
                worst, worst_tenant = self._worst_locked()
                self.worst_ratio = worst
                if worst > 1.0:
                    acted += self._tighten_locked(worst_tenant)
                elif worst < cfg.relax_ratio:
                    acted += self._relax_locked()
                if acted:
                    self.n_actuations += 1
        # outside the controller lock: preemption takes engine step locks
        if cfg.preempt and self.engine is not None \
                and cfg.max_preemptions_per_poll > 0:
            n = self.engine.preempt_for_waiting(cfg.max_preemptions_per_poll)
            if n:
                with self._lock:
                    self.n_preemptions += n
                acted += n
        return acted

    # ----------------------------------------------------------- lifecycle
    def _loop(self) -> None:
        # background mode polls on the REAL clock at half the actuation
        # interval (Nyquist-ish: an actuation tick is never missed by
        # more than half an interval)
        while not self._stop.wait(self.config.interval_s / 2):
            try:
                self.poll()
            except Exception:  # noqa: BLE001 - engine may be closing
                pass

    def close(self) -> None:
        """Stop the background poll thread (no-op in manual mode)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def __enter__(self) -> "SLOController":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # --------------------------------------------------------------- stats
    def stats(self) -> dict:
        """Controller counters — the `stats()["slo"]` block the serving
        report embeds. Full schema (all values int/float/None):

        `n_polls`, `n_actuations` (polls that changed at least one
        knob), `n_tightens`, `n_relaxes`, `n_preemptions` (sequences
        preempted via the engine fan-out), `n_weight_updates`,
        `n_samples` (completions currently in the window),
        `worst_ratio` (last computed worst p95/target), `max_wait_ms`
        (scheduler deadline right now; None when no scheduler attached
        or deadline disabled), `admit_lookahead` (engine value right
        now; None when no paged engine attached), `window_s`.
        """
        with self._lock:
            return {
                "n_polls": self.n_polls,
                "n_actuations": self.n_actuations,
                "n_tightens": self.n_tightens,
                "n_relaxes": self.n_relaxes,
                "n_preemptions": self.n_preemptions,
                "n_weight_updates": self.n_weight_updates,
                "n_samples": len(self._samples),
                "worst_ratio": self.worst_ratio,
                "max_wait_ms": (self.scheduler.max_wait_ms
                                if self.scheduler is not None else None),
                "admit_lookahead": self._current_lookahead(),
                "window_s": self.config.window_s,
            }
