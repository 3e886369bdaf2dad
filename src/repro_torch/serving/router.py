"""Engine fleet: a prefix-affinity router over replicated decode engines
— counterpart of `repro.serving.router`.

One `ContinuousBatchingEngine` tops out at `n_slots` sequences. The way
past that is N replicated engines behind one front door. The catch is the
prefix cache: its hit rate comes from locality (identical RAG context
headers landing on the same pool), and round-robin placement destroys it.
`EngineRouter` keeps the locality while adding the lanes:

* **Replication.** N engines built from the SAME `EngineConfig` under one
  `RouterConfig`. The model is shared read-only; every replica owns
  its pools, its locks and (in threaded mode) its decode loop.
* **Prefix-affinity placement.** `submit()` derives the request's prefix
  key with the engine's own `compute_prefix_key` and asks each replica
  `holds_prefix(key)` (published, retained, parked in the host tier,
  mid-publication, or carried by a queued ticket). A holder gets it.
* **Bounded imbalance.** When the holder's load (queued + active)
  exceeds the least-loaded replica's by more than `max_imbalance`, the
  request SPILLS to the least-loaded replica, which re-publishes the
  prefix there, so the affinity map heals around a hot spot.
* **Least-loaded elsewhere.** Keyless requests and affinity misses go to
  the least-loaded replica, with a rotating tie-break.

Placement is stateless: the router probes live membership, so evictions,
host offloads, publications and `clear_prefix_cache()` show at once.
Probes and submits race benignly with the decode loops; the worst case
is a duplicate cold prefill. All of this is host-only Python.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.device import DeviceLike
from .async_scheduler import DEFAULT_TENANT
from .config import EngineConfig, RouterConfig, resolve_config, resolve_router_config
from .continuous_batching import ContinuousBatchingEngine, GenerationTicket


class EngineRouter:
    """Prefix-affinity load balancer over N replicated decode engines.

    model: any family's LM on `device` (None: the card), shared read-only
        by every replica.
    config: the per-replica `EngineConfig` — every replica is built from
        this ONE config (per-knob engine arguments are not accepted here).
    router: a `RouterConfig` holding the fleet knobs. The keywords
        `n_replicas`, `affinity` and `max_imbalance` mirror its fields as
        supported sugar; router= plus any of them is an error.
    n_replicas: engine replicas (>= 1).
    affinity: prefix-affinity placement (default True); False routes
        purely least-loaded.
    max_imbalance: spill threshold in requests; None resolves to the
        replica's `n_slots`.
    eos_id / temperature / clock / start: runtime parameters forwarded to
        every replica. `start=True` spawns N background decode loops,
        `start=False` leaves the fleet in manual mode (`step()` /
        `run_until_drained()`, or a ticket's `result()` driving its
        owning replica).
    """

    def __init__(
        self,
        model,
        config: Optional[EngineConfig] = None,
        router: Optional[RouterConfig] = None,
        *,
        n_replicas: Optional[int] = None,
        affinity: Optional[bool] = None,
        max_imbalance: Optional[int] = None,
        eos_id: Optional[int] = None,
        temperature: float = 0.0,
        clock: Callable[[], float] = time.monotonic,
        start: bool = False,
        device: DeviceLike = None,
    ):
        self.router = resolve_router_config(router, dict(
            n_replicas=n_replicas, affinity=affinity, max_imbalance=max_imbalance))
        config = resolve_config(config, {})
        self.config = config
        self.n_replicas = self.router.n_replicas
        self.affinity = self.router.affinity
        self.max_imbalance = (config.n_slots if self.router.max_imbalance is None
                              else self.router.max_imbalance)
        self.engines: list[ContinuousBatchingEngine] = [
            ContinuousBatchingEngine(
                model, config, replica_id=i, eos_id=eos_id, temperature=temperature,
                clock=clock, start=start, device=device)
            for i in range(self.n_replicas)
        ]
        self._lock = threading.Lock()  # placement counters + tie rotation
        self._rr = 0
        self.n_submitted = 0
        self.n_affinity_hits = 0
        self.n_affinity_misses = 0
        self.n_affinity_spills = 0
        self.per_replica_submits = [0] * self.n_replicas

    # ------------------------------------------------------------ placement
    def _least_loaded(self, loads: list[int]) -> int:
        """Index of a minimum-load replica; ties rotate (under _lock)."""
        m = min(loads)
        ties = [i for i, ld in enumerate(loads) if ld == m]
        pick = ties[self._rr % len(ties)]
        self._rr += 1
        return pick

    def _place(self, key: Optional[str]) -> tuple[int, Optional[str]]:
        """(replica index, placement kind) for a request carrying prefix
        key `key` (None: keyless). Kind is "hit"/"miss"/"spill" for
        keyed traffic, None for keyless. Pure decision — no counters
        move here: `submit()` commits the kind only once the replica has
        ACCEPTED the request, so a rejected submit (never-fits) can
        never leave a placement counted without a placement made
        (`hits + misses + spills == keyed placements`, always).
        """
        loads = [e.load() for e in self.engines]
        holders = ([i for i, e in enumerate(self.engines)
                    if e.holds_prefix(key)]
                   if self.affinity and key is not None else [])
        with self._lock:
            if not (self.affinity and key is not None):
                return self._least_loaded(loads), None
            if not holders:
                return self._least_loaded(loads), "miss"
            holder = min(holders, key=lambda i: loads[i])
            if loads[holder] > min(loads) + self.max_imbalance:
                return self._least_loaded(loads), "spill"
            return holder, "hit"

    def place(self, key: Optional[str]) -> int:
        """Pick the replica for a request carrying prefix key `key`
        (None: keyless), committing the placement counters immediately.
        Prefer `submit()`, which only commits once the replica accepts.
        """
        idx, kind = self._place(key)
        self._commit_placement(kind)
        return idx

    def _commit_placement(self, kind: Optional[str]) -> None:
        if kind is None:
            return
        with self._lock:
            if kind == "hit":
                self.n_affinity_hits += 1
            elif kind == "spill":
                self.n_affinity_spills += 1
            else:
                self.n_affinity_misses += 1

    # --------------------------------------------------------------- submit
    def submit(
        self,
        prompt: Sequence[int],
        max_new_tokens: int = 32,
        tenant: str = DEFAULT_TENANT,
        prefix_len: Optional[int] = None,
        priority: int = 0,
    ) -> GenerationTicket:
        """Route one prompt to a replica; returns that replica's ticket.

        Same contract as `ContinuousBatchingEngine.submit` (including
        SchedulerError on a request no replica could ever serve — every
        replica has identical capacity, so replica 0's check stands for
        the fleet; `priority` forwards to the replica's admission /
        preemption ordering). The ticket's `replica` attribute records
        the placement.

        Placement races benignly with the decode loops: the holder probe
        and the submit are not atomic, so a replica may retire or evict
        the prefix in between — the request then admits as a plain miss
        there and re-publishes (the same publish-heal path a spill
        uses). Placement counters commit only after the replica accepts,
        so `hits + misses + spills == keyed placements` holds even when
        a submit is rejected.
        """
        prompt = np.asarray(list(prompt), np.int32)
        key, _ = self.engines[0].compute_prefix_key(prompt, prefix_len)
        idx, kind = self._place(key)
        ticket = self.engines[idx].submit(
            prompt, max_new_tokens=max_new_tokens, tenant=tenant,
            prefix_len=prefix_len, priority=priority)
        ticket.replica = idx
        self._commit_placement(kind)
        with self._lock:
            self.n_submitted += 1
            self.per_replica_submits[idx] += 1
        return ticket

    @property
    def cache_len(self) -> int:
        """Per-sequence token capacity of every replica (identical by
        construction) — lets router-backed callers reuse engine-shaped
        prompt-budget logic unchanged."""
        return self.engines[0].cache_len

    # ------------------------------------------------------------- lifecycle
    def pending(self) -> int:
        """Requests waiting for a slot, fleet-wide."""
        return sum(e.pending() for e in self.engines)

    def active(self) -> int:
        """Occupied decode slots, fleet-wide."""
        return sum(e.active() for e in self.engines)

    def step(self) -> int:
        """One engine step on every replica (manual mode); total work."""
        return sum(e.step() for e in self.engines)

    def run_until_drained(self, max_steps: Optional[int] = None) -> int:
        """step() every replica until the whole fleet is idle."""
        total = 0
        steps = 0
        while True:
            got = self.step()
            total += got
            steps += 1
            if got == 0 and self.pending() == 0 and self.active() == 0:
                return total
            if max_steps is not None and steps >= max_steps:
                return total

    def clear_prefix_cache(self) -> int:
        """Fan out `clear_prefix_cache()`; total entries dropped."""
        return sum(e.clear_prefix_cache() for e in self.engines)

    # ----------------------------------------------- control-plane fan-out
    def pop_completions(self) -> list[tuple]:
        """Drain every replica's finished-request latency samples,
        merged oldest-first on the shared clock (the SLO controller's
        fleet-wide measurement feed)."""
        out: list[tuple] = []
        for e in self.engines:
            out.extend(e.pop_completions())
        out.sort(key=lambda s: s[0])
        return out

    def set_admit_lookahead(self, n: int) -> None:
        """Fan out `set_admit_lookahead(n)` to every replica."""
        for e in self.engines:
            e.set_admit_lookahead(n)

    def preempt_for_waiting(self, max_preemptions: int = 1) -> int:
        """Fan out `preempt_for_waiting` — each replica preempts only
        for ITS OWN blocked high-priority waiting requests (placement
        already pinned every request to one replica, so pressure is a
        per-replica condition); returns total preemptions performed."""
        return sum(
            e.preempt_for_waiting(max_preemptions) for e in self.engines)

    def close(self, drain: bool = True,
              timeout: Optional[float] = None) -> None:
        """Close every replica; idempotent (same semantics as the
        engine's close, applied fleet-wide)."""
        for e in self.engines:
            e.close(drain=drain, timeout=timeout)

    def __enter__(self) -> "EngineRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.close(drain=exc == (None, None, None))

    # ---------------------------------------------------------------- stats
    def stats(self) -> dict:
        """Fleet counters. Full schema:

        Router scalars (int/float): `n_replicas`, `max_imbalance`,
        `n_submitted`, `n_affinity_hits` (keyed requests placed on a
        replica already holding their prefix), `n_affinity_misses` (no
        replica held it), `n_affinity_spills` (holder over the
        imbalance bound — placed least-loaded instead), and
        `affinity_hit_rate` = hits / (hits + misses + spills), 0.0 with
        no keyed traffic. Router non-scalars: `affinity` (bool),
        `per_replica_submits` (list, placement histogram).

        `fleet` — the all-numeric rollup, every key always present:
        sums `n_tokens`, `n_finished`, `n_failed`, `n_decode_steps`,
        `n_prefills`, `n_backpressure`, `n_preemptions`, `n_resumes`
        over replicas; maxes
        `peak_active`; pools the prefix counters (`n_prefix_hits`,
        `n_prefix_misses`, `n_device_hits`, `n_host_hits`, and the
        derived `prefix_hit_rate` / `device_hit_rate` /
        `host_hit_rate` over the POOLED attempts — not a mean of
        per-replica rates); sums pool headroom (`free_blocks`,
        `n_usable_blocks`). Non-paged fleets report the pool fields
        as 0.

        `replicas` — the per-replica `ContinuousBatchingEngine.stats()`
        dicts, verbatim (index == replica_id); see the engine docstring
        for that schema.
        """
        replicas = [e.stats() for e in self.engines]
        fleet = {
            k: sum(r.get(k, 0) for r in replicas)
            for k in ("n_tokens", "n_finished", "n_failed",
                      "n_decode_steps", "n_prefills", "n_backpressure",
                      "n_preemptions", "n_resumes")
        }
        fleet["peak_active"] = max(r["peak_active"] for r in replicas)
        pools = [r.get("pool") for r in replicas]
        for k in ("n_prefix_hits", "n_prefix_misses", "n_device_hits",
                  "n_host_hits", "free_blocks", "n_usable_blocks"):
            fleet[k] = sum(p[k] for p in pools if p is not None)
        attempts = fleet["n_prefix_hits"] + fleet["n_prefix_misses"]
        fleet["prefix_hit_rate"] = \
            fleet["n_prefix_hits"] / attempts if attempts else 0.0
        fleet["device_hit_rate"] = \
            fleet["n_device_hits"] / attempts if attempts else 0.0
        fleet["host_hit_rate"] = \
            fleet["n_host_hits"] / attempts if attempts else 0.0
        with self._lock:
            keyed = (self.n_affinity_hits + self.n_affinity_misses
                     + self.n_affinity_spills)
            return {
                "n_replicas": self.n_replicas,
                "affinity": self.affinity,
                "max_imbalance": self.max_imbalance,
                "n_submitted": self.n_submitted,
                "n_affinity_hits": self.n_affinity_hits,
                "n_affinity_misses": self.n_affinity_misses,
                "n_affinity_spills": self.n_affinity_spills,
                "affinity_hit_rate":
                    self.n_affinity_hits / keyed if keyed else 0.0,
                "per_replica_submits": list(self.per_replica_submits),
                "fleet": fleet,
                "replicas": replicas,
            }
