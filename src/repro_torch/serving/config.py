"""The serving stack's frozen configs — counterpart of
`repro.serving.config`: `EngineConfig` (every decode-engine knob) and its
`resolve_config` deprecation shim, `RouterConfig` (the engine fleet) and
its `resolve_router_config`, and `SLOConfig` (the SLO control plane).

    from repro_torch.serving import ContinuousBatchingEngine, EngineConfig

    cfg = EngineConfig(paged=True, prefix_sharing=True)
    eng = ContinuousBatchingEngine(model, config=cfg, device="cpu")

Every call site that passes per-knob keywords keeps working through
`resolve_config`, which emits DeprecationWarning and builds the
equivalent `EngineConfig`. Unset knobs are `None`, meaning "let the
consumer pick its default" (`cache_len=None` is 256 in the raw engine
but `max_prompt_len + max_new_tokens` in `RagPipeline.decode_engine`;
`prefix_sharing=None` is off in the raw engine but on for paged KV in
the pipeline). Validation that needs no consumer context runs at
construction.
"""

from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass
from typing import Optional

# knobs that only make sense with the paged memory model; prefix_sharing
# is special-cased (False is allowed without paged, True is not)
_PAGED_ONLY = (
    "block_size",
    "n_blocks",
    "prefill_chunk",
    "admit_lookahead",
    "max_head_skips",
    "paged_kernel",
    "retain_blocks",
    "host_blocks",
)


@dataclass(frozen=True)
class EngineConfig:
    """Shape-and-policy knobs of a `ContinuousBatchingEngine`.

    n_slots: decode batch width (sequences in flight).
    cache_len: per-sequence token capacity; None lets the consumer pick
        (engine: 256; RagPipeline: max_prompt_len + max_new_tokens).
    paged: use the block-pooled KV memory model.
    block_size / n_blocks: paged-pool geometry (None: 16 / fixed-slot
        footprint).
    prefill_chunk: paged-mode admission granularity (None: 32).
    prefix_sharing: CoW prefix sharing over the pool; None lets the
        consumer pick (engine: off; RagPipeline: on when the model
        supports paged KV).
    paged_kernel: route paged attention through the fused K3 kernel
        (`kernels.paged_attend`); None defers to the model config.
    admit_lookahead / max_head_skips: paged admission skip-ahead bound
        and starvation guard (None: 4 / 16).
    retain_blocks: device-tier prefix retention budget in pool blocks
        (None/0: the registry stays non-owning).
    host_blocks: host-RAM tier budget in pool blocks for prefixes
        evicted from the device tier (None/0: off; requires
        retain_blocks).
    """

    n_slots: int = 4
    cache_len: Optional[int] = None
    paged: bool = False
    block_size: Optional[int] = None
    n_blocks: Optional[int] = None
    prefill_chunk: Optional[int] = None
    prefix_sharing: Optional[bool] = None
    paged_kernel: Optional[bool] = None
    admit_lookahead: Optional[int] = None
    max_head_skips: Optional[int] = None
    retain_blocks: Optional[int] = None
    host_blocks: Optional[int] = None

    def __post_init__(self):
        self.validate()

    def validate(self) -> None:
        """Raise ValueError on incoherent knob combinations."""
        if self.n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        if self.cache_len is not None and self.cache_len < 2:
            raise ValueError("cache_len must be >= 2")
        if not self.paged:
            set_knobs = [k for k in _PAGED_ONLY if getattr(self, k) is not None]
            if self.prefix_sharing:
                set_knobs.insert(0, "prefix_sharing")
            if set_knobs:
                raise ValueError(
                    "block/chunk/sharing knobs (block_size, n_blocks, "
                    "prefill_chunk, prefix_sharing, admit_lookahead, "
                    "max_head_skips, paged_kernel, retain_blocks, "
                    "host_blocks) require paged=True; got "
                    + ", ".join(set_knobs))
        if self.block_size is not None and self.block_size < 1:
            raise ValueError("block_size must be >= 1")
        if self.prefill_chunk is not None and self.prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        if self.admit_lookahead is not None and self.admit_lookahead < 0:
            raise ValueError("admit_lookahead must be >= 0")
        if self.max_head_skips is not None and self.max_head_skips < 1:
            raise ValueError("max_head_skips must be >= 1")
        if self.retain_blocks is not None and self.retain_blocks < 0:
            raise ValueError("retain_blocks must be >= 0")
        if self.host_blocks is not None and self.host_blocks < 0:
            raise ValueError("host_blocks must be >= 0")
        if (self.host_blocks or 0) > 0 and not (self.retain_blocks or 0):
            raise ValueError("host_blocks requires retain_blocks > 0")

    def replace(self, **changes) -> "EngineConfig":
        """A copy with `changes` applied (re-validated on construction)."""
        return dataclasses.replace(self, **changes)


@dataclass(frozen=True)
class RouterConfig:
    """Fleet shape-and-policy knobs of an `EngineRouter`.

    One `RouterConfig` describes the layer ABOVE the engines: how many
    replicated `ContinuousBatchingEngine` instances to build (each from
    the same shared `EngineConfig`) and how requests are placed across
    them. It deliberately carries no engine knobs — replica shape lives
    in `EngineConfig`, fleet shape lives here.

    n_replicas: engine replicas in the fleet (>= 1).
    affinity: prefix-affinity placement — route a request whose prefix
        content hash is already held by some replica's prefix cache
        (live pool, retained tier, host tier, or mid-publication) to
        that replica, so the CoW-sharing/retention hit-rate survives
        horizontal scale-out. Off: pure least-loaded placement.
    max_imbalance: bounded imbalance guard for affinity placement — an
        affinity hit is honoured only while the holding replica's load
        (queued + active requests) exceeds the least-loaded replica's by
        at most this many requests; past that the request SPILLS to the
        least-loaded replica (which re-publishes the prefix, updating
        the fleet's affinity map), so one hot prefix can never starve
        the rest of the fleet. None resolves to the engine's `n_slots`
        (one full decode-batch width of headroom); 0 spills on any
        imbalance.
    """

    n_replicas: int = 1
    affinity: bool = True
    max_imbalance: Optional[int] = None

    def __post_init__(self):
        self.validate()

    def validate(self) -> None:
        """Raise ValueError on incoherent knob combinations."""
        if self.n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        if self.max_imbalance is not None and self.max_imbalance < 0:
            raise ValueError("max_imbalance must be >= 0")
        if not self.affinity and self.max_imbalance is not None:
            raise ValueError(
                "max_imbalance is an affinity knob; it requires "
                "affinity=True"
            )

    def replace(self, **changes) -> "RouterConfig":
        """A copy with `changes` applied (re-validated on construction)."""
        return dataclasses.replace(self, **changes)


@dataclass(frozen=True)
class SLOConfig:
    """Targets and actuation policy of an `SLOController`.

    The controller samples per-tenant p95 TTFT / end-to-end latency from
    finished-request completions over a sliding window and nudges the
    serving knobs toward the targets. All times are milliseconds on the
    injected clock.

    ttft_p95_ms / e2e_p95_ms: global p95 targets (None: dimension not
        enforced; at least one of the two must be set).
    tenant_ttft_p95_ms / tenant_e2e_p95_ms: per-tenant overrides, a
        `{tenant: target_ms}` mapping layered over the globals.
    window_s: sliding completion window the percentiles are computed
        over.
    interval_s: minimum controller-clock time between actuations (a
        `poll()` before the interval elapses only ingests samples).
    min_samples: completions required in the window before the
        controller trusts the percentile and actuates.
    relax_ratio: worst observed p95/target ratio below which knobs are
        relaxed back toward their baselines (between that and 1.0 the
        controller holds steady).
    wait_step: multiplicative step applied to the scheduler's
        `max_wait_ms` (divide to tighten, multiply to relax).
    min_wait_ms: floor `max_wait_ms` is never tightened below.
    lookahead_max: ceiling `admit_lookahead` is never raised above
        (None: 4x the engine baseline).
    weight_step: multiplicative boost applied to the worst-missing
        tenant's DRR weight on a tighten.
    max_weight: ceiling any controller-set tenant weight may reach.
    preempt: allow priority preemption as an actuator — under pool
        pressure, a running low-priority sequence is published to the
        retained tier, released, and re-queued behind the high-priority
        admission it unblocks.
    max_preemptions_per_poll: preemption rate limit per actuation.
    """

    ttft_p95_ms: Optional[float] = None
    e2e_p95_ms: Optional[float] = None
    tenant_ttft_p95_ms: Optional[dict] = None
    tenant_e2e_p95_ms: Optional[dict] = None
    window_s: float = 10.0
    interval_s: float = 1.0
    min_samples: int = 8
    relax_ratio: float = 0.7
    wait_step: float = 1.5
    min_wait_ms: float = 0.0
    lookahead_max: Optional[int] = None
    weight_step: float = 1.5
    max_weight: float = 8.0
    preempt: bool = True
    max_preemptions_per_poll: int = 1

    def __post_init__(self):
        self.validate()

    def validate(self) -> None:
        """Raise ValueError on incoherent knob combinations."""
        has_global = self.ttft_p95_ms is not None or self.e2e_p95_ms is not None
        has_tenant = bool(self.tenant_ttft_p95_ms) or bool(self.tenant_e2e_p95_ms)
        if not has_global and not has_tenant:
            raise ValueError(
                "an SLOConfig needs at least one target "
                "(ttft_p95_ms, e2e_p95_ms, or a per-tenant override)"
            )
        for name in ("ttft_p95_ms", "e2e_p95_ms"):
            v = getattr(self, name)
            if v is not None and v <= 0:
                raise ValueError(f"{name} must be > 0")
        for name in ("tenant_ttft_p95_ms", "tenant_e2e_p95_ms"):
            d = getattr(self, name)
            if d is None:
                continue
            if not isinstance(d, dict):
                raise TypeError(f"{name} must be a dict of tenant -> ms")
            if any(v <= 0 for v in d.values()):
                raise ValueError(f"{name} targets must all be > 0")
        if self.window_s <= 0:
            raise ValueError("window_s must be > 0")
        if self.interval_s <= 0:
            raise ValueError("interval_s must be > 0")
        if self.min_samples < 1:
            raise ValueError("min_samples must be >= 1")
        if not 0.0 < self.relax_ratio < 1.0:
            raise ValueError("relax_ratio must be in (0, 1)")
        if self.wait_step <= 1.0:
            raise ValueError("wait_step must be > 1")
        if self.min_wait_ms < 0:
            raise ValueError("min_wait_ms must be >= 0")
        if self.lookahead_max is not None and self.lookahead_max < 0:
            raise ValueError("lookahead_max must be >= 0")
        if self.weight_step <= 1.0:
            raise ValueError("weight_step must be > 1")
        if self.max_weight <= 0:
            raise ValueError("max_weight must be > 0")
        if self.max_preemptions_per_poll < 0:
            raise ValueError("max_preemptions_per_poll must be >= 0")

    def replace(self, **changes) -> "SLOConfig":
        """A copy with `changes` applied (re-validated on construction)."""
        return dataclasses.replace(self, **changes)


def resolve_router_config(
    router, legacy: dict, *, stacklevel: int = 3
) -> RouterConfig:
    """`resolve_config`'s twin for the fleet layer.

    `legacy` maps RouterConfig field name -> value-or-None as received
    by a per-knob caller (`n_replicas=`, `affinity=`, ...). Passing both
    a RouterConfig and any non-None knob is an error; knobs alone build
    the equivalent config (no DeprecationWarning — the per-knob fleet
    spelling is supported sugar, e.g. `decode_engine(n_replicas=4)`);
    neither yields the single-replica default.
    """
    set_knobs = {k: v for k, v in legacy.items() if v is not None}
    if router is not None:
        if set_knobs:
            raise ValueError(
                "pass router=RouterConfig(...) or per-knob fleet "
                "arguments, not both; got router plus "
                + ", ".join(sorted(set_knobs))
            )
        if not isinstance(router, RouterConfig):
            raise TypeError(
                f"router must be a RouterConfig, got {type(router).__name__}"
            )
        return router
    return RouterConfig(**set_knobs)


def resolve_config(config, legacy: dict, *, stacklevel: int = 3) -> EngineConfig:
    """The one shim every deprecated per-knob signature funnels through.

    `legacy` maps knob name -> value-or-None as received by the caller.
    Passing both a config and any non-None knob is an error (ambiguous);
    knobs alone emit DeprecationWarning and build the equivalent
    EngineConfig; neither yields the all-defaults config.
    """
    set_knobs = {k: v for k, v in legacy.items() if v is not None}
    if config is not None:
        if set_knobs:
            raise ValueError(
                "pass config=EngineConfig(...) or per-knob arguments, "
                "not both; got config plus " + ", ".join(sorted(set_knobs)))
        if not isinstance(config, EngineConfig):
            raise TypeError(
                f"config must be an EngineConfig, got {type(config).__name__}")
        return config
    if set_knobs:
        warnings.warn(
            "per-knob engine arguments (" + ", ".join(sorted(set_knobs))
            + ") are deprecated; pass config=EngineConfig(...) instead",
            DeprecationWarning, stacklevel=stacklevel)
    return EngineConfig(**set_knobs)
