"""One frozen `EngineConfig` for every decode-engine knob — counterpart of
`repro.serving.config` (`EngineConfig` and its `resolve_config`
deprecation shim). The fleet and SLO configs (`RouterConfig`,
`SLOConfig`) come with the router and control-plane port (ROADMAP).

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
    retain_blocks: device-tier prefix retention budget in pool blocks.
    host_blocks: host-RAM tier budget in pool blocks (requires
        retain_blocks). The port's engine does not run either tier yet
        and raises for values > 0 (ROADMAP: retention and host tier).
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
