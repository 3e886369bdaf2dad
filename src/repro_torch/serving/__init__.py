"""repro_torch.serving — the serving stack, from front door to device pools:

* `async_scheduler.AsyncBatchScheduler` — the streaming retrieval front
  door (dual-trigger batching, weighted deficit-round-robin tenants,
  futures-style `AsyncTicket`s);
* `continuous_batching.ContinuousBatchingEngine` — iteration-level decode
  batching over fixed slots or the paged pool, chunked prefill, CoW
  prefix sharing, token-streaming `GenerationTicket`s; its shape is one
  `config.EngineConfig`;
* `paged_cache.PagedCacheManager` — the refcounted block allocator under
  the paged pool;
* `router.EngineRouter` — a prefix-affinity router over replicated
  engines (bounded imbalance, fleet `stats()`), its shape one
  `config.RouterConfig`;
* `slo_controller.SLOController` — per-tenant p95 measurement and knob
  actuation (deadline, lookahead, tenant weights, priority preemption),
  its policy one `config.SLOConfig`;
* `engine.GenerationEngine` — batched synchronous generation (and the
  deprecated `BatchScheduler` / `BatchTicket`, a manual-mode
  `AsyncBatchScheduler`);
* `rag_pipeline.RagPipeline` — embed -> DIRC retrieve -> augment ->
  generate, synchronously (`query_many`) or streaming (`query_stream`).
"""
from .async_scheduler import (  # noqa: F401
    DEFAULT_TENANT,
    AsyncBatchScheduler,
    AsyncTicket,
    SchedulerError,
)
from .config import (  # noqa: F401
    EngineConfig,
    RouterConfig,
    SLOConfig,
    resolve_config,
    resolve_router_config,
)
from .continuous_batching import (  # noqa: F401
    ContinuousBatchingEngine,
    GenerationTicket,
)
from .engine import BatchScheduler, BatchTicket, GenerationEngine  # noqa: F401
from .paged_cache import (  # noqa: F401
    NULL_BLOCK,
    OutOfBlocks,
    PagedCacheManager,
    PrefixEntry,
    blocks_for,
    pow2_at_least,
)
from .rag_pipeline import HashEmbedder, RagPipeline, RagResult  # noqa: F401
from .router import EngineRouter  # noqa: F401
from .slo_controller import SLOController  # noqa: F401
