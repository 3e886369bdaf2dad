"""End-to-end edge RAG pipeline (paper Fig. 1) — counterpart of
`repro.serving.rag_pipeline`:

    user query --embed--> query embedding
      --DIRC retrieve--> top-k document ids (quantized CIM search)
      --augment--> [BOS] doc1 SEP doc2 ... SEP query prompt
      --generate--> answer tokens

The embedder is the same numpy stub as the JAX package's (seeded FNV-1a
bucketing of byte 4-grams through a random projection), so both packages
embed every text identically. Retrieval runs on the monolithic
`DircRagIndex` (`n_shards=0`) or on the sharded multi-macro
`ShardedDircIndex` (`n_shards>=1`), which also takes incremental corpus
updates (`add_docs` / `delete_docs`), per-macro device physics (`drift`)
and online recalibration (`recal`, polled after every search batch).

Two front doors:
* synchronous: `query` / `query_many` — one batched search, then
  `GenerationEngine` per query;
* streaming: `query_stream` submits single queries into the async
  dual-trigger scheduler (`scheduler()`) and, with `generate=True`,
  chains each completed retrieval into a `ContinuousBatchingEngine`
  decode slot (`decode_engine()`); under `paged=True` each prompt carries
  its `[BOS] docs SEP` header as a shareable prefix, so queries that
  retrieved the same documents share their context KV blocks
  copy-on-write. `generate_stream` is the retrieval-free variant.

Fleet serving: `decode_engine(n_replicas=N)` (or
`router=RouterConfig(...)`) returns an `EngineRouter` over N replicated
engines; `query_stream` / `generate_stream` take the same knobs, and
prefix-affinity placement keeps the sharing hit rate across the fleet.
SLO control plane: requests carry an optional priority ((tenant, text,
priority) triples) that rides retrieval onto the decode submit, and
`query_stream(generate=True, slo=SLOConfig(...))` attaches an
`SLOController` polled as the stream drains (its final counters land on
`last_slo_stats`).

Retrieval (and the recalibration poll) runs on the scheduler's thread
and decoding on the engine's (one per replica); both write only tensors
they created in the same grad mode.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.device_physics import DriftConfig
from repro_torch.core.recalibration import RecalibrationConfig, RecalibrationController
from repro_torch.core.retrieval import DircRagIndex, RetrievalConfig
from repro_torch.core.sharded_index import ShardedDircIndex
from repro_torch.core.simulator import simulate_query
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model_api import supports_paged_kv
from repro_torch.perf import trace
from .async_scheduler import DEFAULT_TENANT, AsyncBatchScheduler, SchedulerError
from .config import (EngineConfig, RouterConfig, SLOConfig, resolve_config,
                     resolve_router_config)
from .continuous_batching import ContinuousBatchingEngine, GenerationTicket
from .engine import GenerationEngine
from .router import EngineRouter
from .slo_controller import SLOController

_FNV_PRIME = np.uint32(16777619)
_FNV_BASIS = np.uint32(2166136261)


class HashEmbedder:
    """Deterministic byte-4-gram hashing embedder (frontend stub), a numpy
    copy of the JAX package's: seeded FNV-1a buckets, stable across
    processes, projected to `dim` and L2-normalised."""

    def __init__(self, dim: int = 512, seed: int = 0, buckets: int = 8192):
        self.dim = dim
        self.buckets = buckets
        rng = np.random.default_rng(seed)
        self._basis = np.uint32(_FNV_BASIS ^ np.uint32(seed & 0xFFFFFFFF))
        self.proj = rng.normal(size=(buckets, dim)).astype(np.float32)
        self.proj /= np.linalg.norm(self.proj, axis=-1, keepdims=True)

    def _bucket_4grams(self, data: bytes) -> np.ndarray:
        """Bucket ids of every byte 4-gram (short inputs are NUL-padded)."""
        if len(data) < 4:
            data = data.ljust(4, b"\x00")
        arr = np.frombuffer(data, np.uint8)
        grams = np.lib.stride_tricks.sliding_window_view(arr, 4)
        h = np.full((grams.shape[0],), self._basis, np.uint32)
        with np.errstate(over="ignore"):  # uint32 wraparound is the point
            for col in range(4):
                h = (h ^ grams[:, col]) * _FNV_PRIME
        return h % np.uint32(self.buckets)

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), np.float32)
        for i, t in enumerate(texts):
            feats = np.zeros((self.buckets,), np.float32)
            np.add.at(feats, self._bucket_4grams(
                t.encode("utf-8", errors="replace")), 1.0)
            v = feats @ self.proj
            n = np.linalg.norm(v)
            out[i] = v / n if n > 0 else v
        return out


@dataclasses.dataclass
class RagResult:
    doc_ids: np.ndarray
    doc_scores: np.ndarray
    retrieved_texts: list
    answer_text: Optional[str]
    answer_tokens: Optional[np.ndarray]
    sim_latency_us: float
    sim_energy_uj: float


class RagPipeline:
    def __init__(
        self,
        doc_texts: Sequence[str],
        retrieval_config: RetrievalConfig,
        model=None,
        embedder: Optional[HashEmbedder] = None,
        dim: int = 512,
        max_prompt_len: int = 512,
        n_shards: int = 0,
        device: DeviceLike = None,
        clock: Callable[[], float] = time.monotonic,
        drift: Optional[DriftConfig] = None,
        recal=None,
    ):
        """Embed `doc_texts` and build the DIRC index on `device` (`None`
        is the card). `model` is an optional LM of any family on the same
        device; with one, queries also generate answers. `clock` is the
        monotonic-seconds source of every deadline (the engines the
        pipeline builds, the index's drift processes); injectable for
        deterministic tests.

        n_shards=0 builds the monolithic single-macro DircRagIndex;
        n_shards>=1 a ShardedDircIndex, which also unlocks add_docs /
        delete_docs. Device physics (sharded index only): `drift`
        configures each macro's temporal error-map drift over `clock`;
        `recal=True` (or a `RecalibrationConfig`) attaches a
        `RecalibrationController` that `search_batch` polls after every
        batch, so drifted macros are re-extracted and re-encoded online."""
        self.device = resolve_device(device)
        self.tokenizer = ByteTokenizer()
        self.embedder = embedder or HashEmbedder(dim=dim)
        self.doc_texts = list(doc_texts)
        embs = self.embedder.embed(self.doc_texts)
        if n_shards > 0:
            self.index = ShardedDircIndex.build(
                embs, retrieval_config, n_shards=n_shards, drift=drift, clock=clock,
                device=self.device)
        else:
            if drift is not None or recal:
                raise TypeError(
                    "drift/recal require n_shards >= 1 (per-macro device "
                    "physics lives on ShardedDircIndex)")
            self.index = DircRagIndex.build(embs, retrieval_config, device=self.device)
        self.recal_controller = None
        if recal:
            cfg = recal if isinstance(recal, RecalibrationConfig) else None
            self.recal_controller = RecalibrationController(self.index, cfg)
        self.engine = (GenerationEngine(model, device=self.device)
                       if model is not None else None)
        self.max_prompt_len = max_prompt_len
        self._clock = clock
        # final SLOController counters from the last query_stream(slo=...)
        self.last_slo_stats: Optional[dict] = None

    # ------------------------------------------------------------ retrieval
    def search_batch(self, texts: Sequence[str], k: int,
                     generator: Optional[torch.Generator] = None,
                     ) -> tuple[np.ndarray, np.ndarray]:
        """Embed + search a whole batch as one (b, dim) call.

        Returns (ids (b, k) int32, scores (b, k) fp32). `generator` (on the
        pipeline's device) drives the sensing-error channel, if enabled."""
        with trace.span("rag.embed"):
            q = self.embedder.embed(list(texts))
        with trace.span("rag.search"):
            res = self.index.search(q, k=k, generator=generator)
            if self.recal_controller is not None:
                # cheap when no detection window has filled; fires an online
                # re-extraction + re-encode of a macro that has drifted
                self.recal_controller.poll()
            ids, scores = res.indices.cpu().numpy(), res.scores.cpu().numpy()
        return ids, scores

    def retrieval_stats(self) -> dict:
        """Per-shard error/recal counters + the controller's view; {} for
        the monolithic index (device physics lives on the sharded one)."""
        stats: dict = {}
        if isinstance(self.index, ShardedDircIndex):
            stats = self.index.stats()
            if self.recal_controller is not None:
                stats["recalibration"] = self.recal_controller.stats()
        return stats

    def encode_prompt(self, text: str, retrieved_texts: Sequence[str]) -> list:
        """Augmented-prompt token ids, folded into the model vocab."""
        return self.encode_prompt_with_prefix(text, retrieved_texts)[0]

    @trace.spanned("rag.prompt")
    def encode_prompt_with_prefix(
            self, text: str, retrieved_texts: Sequence[str],
    ) -> tuple[list, int]:
        """(augmented-prompt token ids, shareable prefix length): the prefix
        is the `[BOS] doc1 SEP ... SEP` context header before the query;
        0 when `max_prompt_len` truncation left none of it."""
        prompt = self.tokenizer.encode_rag_prompt(
            text, list(retrieved_texts), self.max_prompt_len)
        n_query = len(self.tokenizer.encode(text, bos=False))
        prefix_len = max(len(prompt) - n_query, 0)
        vocab = self.engine.model.cfg.vocab_size
        return [t % vocab for t in prompt], prefix_len

    # --------------------------------------------------------------- query
    def query(self, text: str, k: int = 3, max_new_tokens: int = 32,
              generator: Optional[torch.Generator] = None) -> RagResult:
        return self.query_many([text], k=k, max_new_tokens=max_new_tokens,
                               generator=generator)[0]

    def query_many(self, texts: Sequence[str], k: int = 3,
                   max_new_tokens: int = 32,
                   generator: Optional[torch.Generator] = None) -> list:
        """Serve a batch of queries with ONE embed + ONE batched search;
        generation (if a model is attached) runs per query, since prompt
        lengths differ."""
        ids_b, scores_b = self.search_batch(texts, k, generator=generator)

        # DIRC hardware supports dims 128..1024 (paper Table I); round the
        # simulated dim up to the nearest supported column folding.
        sim_dim = min(max((self.index.dim + 127) // 128 * 128, 128), 1024)
        sim = simulate_query(self.index.n_docs, sim_dim,
                             bits=self.index.config.bits)

        results = []
        for text, ids, scores in zip(texts, ids_b, scores_b):
            texts_k = [self.doc_texts[i] for i in ids if i >= 0]
            answer_text = answer_tokens = None
            if self.engine is not None and max_new_tokens > 0:
                prompt = self.encode_prompt(text, texts_k)
                answer_tokens = self.engine.generate(
                    np.asarray(prompt, np.int64)[None], max_new_tokens=max_new_tokens)
                answer_text = self.tokenizer.decode(answer_tokens[0])
            results.append(RagResult(
                doc_ids=ids,
                doc_scores=scores,
                retrieved_texts=texts_k,
                answer_text=answer_text,
                answer_tokens=answer_tokens,
                sim_latency_us=sim.latency_s * 1e6,
                sim_energy_uj=sim.energy_j * 1e6,
            ))
        return results

    # ------------------------------------------------------------ streaming
    def scheduler(self, max_batch: int = 32,
                  generator: Optional[torch.Generator] = None,
                  max_wait_ms: Optional[float] = None,
                  tenant_quantum: int = 1,
                  tenant_weights: Optional[dict] = None,
                  start: Optional[bool] = None) -> AsyncBatchScheduler:
        """An AsyncBatchScheduler whose flushes run through this pipeline.

        Default (max_wait_ms=None) is pull-based manual mode: batches form
        on flush()/result(). Passing max_wait_ms starts the background
        flush loop: batches form on the dual trigger (max_batch reached OR
        oldest ticket older than max_wait_ms), per-tenant queues drained
        weighted-deficit-round-robin. `generator` (on the pipeline's
        device) drives the sensing-error channel of every batch, in the
        place of the JAX package's `key`."""
        if start is None:
            start = max_wait_ms is not None
        return AsyncBatchScheduler(
            lambda texts, k: self.search_batch(texts, k, generator=generator),
            max_batch=max_batch, max_wait_ms=max_wait_ms, quantum=tenant_quantum,
            tenant_weights=tenant_weights, start=start)

    def decode_engine(self, config: Optional[EngineConfig] = None, *,
                      router: Optional[RouterConfig] = None,
                      n_replicas: Optional[int] = None,
                      affinity: Optional[bool] = None,
                      max_imbalance: Optional[int] = None,
                      n_slots: Optional[int] = None,
                      cache_len: Optional[int] = None,
                      max_new_tokens: int = 32,
                      temperature: float = 0.0,
                      paged: Optional[bool] = None,
                      block_size: Optional[int] = None,
                      n_blocks: Optional[int] = None,
                      prefill_chunk: Optional[int] = None,
                      prefix_sharing: Optional[bool] = None,
                      paged_kernel: Optional[bool] = None,
                      retain_blocks: Optional[int] = None,
                      host_blocks: Optional[int] = None,
                      start: bool = True):
        """A ContinuousBatchingEngine — or an `EngineRouter` fleet — over
        this pipeline's model.

        Pass the engine shape as `config=EngineConfig(...)`; the per-knob
        keywords are the deprecated shim. Two fields resolve here:
        `cache_len=None` becomes `max_prompt_len + max_new_tokens` and
        `prefix_sharing=None` is on exactly when the model's KV is paged.
        `router=RouterConfig(...)` or any fleet knob (`n_replicas`,
        `affinity`, `max_imbalance`; supported sugar, no deprecation)
        returns an `EngineRouter` over that many replicas of the same
        resolved config; its submit / stats / close surface matches the
        engine's."""
        if self.engine is None:
            raise TypeError("decode_engine requires a model (RagPipeline(..., model=))")
        fleet = None
        if (router is not None or n_replicas is not None
                or affinity is not None or max_imbalance is not None):
            fleet = resolve_router_config(router, dict(
                n_replicas=n_replicas, affinity=affinity, max_imbalance=max_imbalance))
        config = resolve_config(config, dict(
            n_slots=n_slots, cache_len=cache_len, paged=paged,
            block_size=block_size, n_blocks=n_blocks,
            prefill_chunk=prefill_chunk, prefix_sharing=prefix_sharing,
            paged_kernel=paged_kernel, retain_blocks=retain_blocks,
            host_blocks=host_blocks))
        resolved = {}
        if config.cache_len is None:
            resolved["cache_len"] = self.max_prompt_len + max_new_tokens
        if config.prefix_sharing is None:
            resolved["prefix_sharing"] = config.paged and supports_paged_kv(
                self.engine.model)
        if resolved:
            config = config.replace(**resolved)
        eos = self.tokenizer.eos_id
        vocab = self.engine.model.cfg.vocab_size
        eos_id = eos if eos < vocab else None
        if fleet is not None:
            return EngineRouter(self.engine.model, config, fleet, eos_id=eos_id,
                                temperature=temperature, clock=self._clock,
                                start=start, device=self.device)
        return ContinuousBatchingEngine(
            self.engine.model, config, eos_id=eos_id, temperature=temperature,
            clock=self._clock, start=start, device=self.device)

    def query_stream(self, requests, k: int = 3, max_batch: int = 32,
                     max_wait_ms: float = 5.0,
                     generator: Optional[torch.Generator] = None,
                     generate: bool = False, max_new_tokens: int = 32,
                     temperature: float = 0.0,
                     config: Optional[EngineConfig] = None,
                     router: Optional[RouterConfig] = None,
                     n_replicas: Optional[int] = None,
                     affinity: Optional[bool] = None,
                     max_imbalance: Optional[int] = None,
                     n_slots: Optional[int] = None,
                     paged: Optional[bool] = None,
                     block_size: Optional[int] = None,
                     n_blocks: Optional[int] = None,
                     prefill_chunk: Optional[int] = None,
                     prefix_sharing: Optional[bool] = None,
                     retain_blocks: Optional[int] = None,
                     host_blocks: Optional[int] = None,
                     slo: Optional[SLOConfig] = None):
        """Stream results as they are served (completion order).

        `requests` is an iterable of query strings, (tenant, text) pairs,
        or (tenant, text, priority) triples. Each is submitted to a live
        AsyncBatchScheduler (background flush loop, dual trigger).

        generate=False yields AsyncTicket objects (`.text`, `.tenant`,
        `.doc_ids`, `.doc_scores`, `.wait_s`, `.batch_size`).

        generate=True (requires a model) submits each completed
        retrieval's augmented prompt straight into a
        ContinuousBatchingEngine decode slot and yields GenerationTicket
        objects as generation completes (`.text`, `.tenant`, `.tokens`,
        `.answer_text`, `.retrieval`, `.first_token_s` TTFT, `.wait_s`
        end to end). If retrieval failed for a request — or its
        generation could not be started, or the engine's loop failed —
        the retrieval AsyncTicket is yielded instead, its `result()`
        re-raising the error. Under `paged=True` each prompt carries its
        retrieved-context header as a shareable prefix. A request's
        priority rides retrieval onto its decode submit: under pool
        pressure higher priorities admit first and may preempt lower ones.
        `router=` / `n_replicas=` / `affinity=` / `max_imbalance=` put an
        `EngineRouter` fleet behind the stream.

        `slo=SLOConfig(...)` (requires generate=True) attaches an
        `SLOController` wired to this stream's scheduler and engine,
        polled as the stream drains; its final counters land on
        `self.last_slo_stats`.
        """
        import queue as _queue

        if generate and self.engine is None:
            raise TypeError("query_stream(generate=True) requires a model")
        if slo is not None and not generate:
            raise TypeError("query_stream(slo=...) requires generate=True")
        config = resolve_config(config, dict(
            n_slots=n_slots, paged=paged, block_size=block_size,
            n_blocks=n_blocks, prefill_chunk=prefill_chunk,
            prefix_sharing=prefix_sharing, retain_blocks=retain_blocks,
            host_blocks=host_blocks))
        done_q: "_queue.Queue" = _queue.Queue()
        sched = engine = controller = None
        try:
            # engine first: if it raises, no thread has started yet; the
            # finally closes whatever did start
            engine = self.decode_engine(
                config, router=router, n_replicas=n_replicas, affinity=affinity,
                max_imbalance=max_imbalance, max_new_tokens=max_new_tokens,
                temperature=temperature, start=True) if generate else None
            sched = self.scheduler(max_batch=max_batch, generator=generator,
                                   max_wait_ms=max_wait_ms, start=True)
            if slo is not None:
                controller = SLOController(slo, engine=engine, scheduler=sched,
                                           clock=self._clock)

            def on_retrieved(ticket):
                """Scheduler-thread callback: chain retrieval into decode."""
                try:
                    texts_k = [self.doc_texts[i] for i in ticket.doc_ids if i >= 0]
                    prompt, prefix_len = self.encode_prompt_with_prefix(
                        ticket.text, texts_k)
                    gen = engine.submit(
                        prompt, max_new_tokens=max_new_tokens,
                        tenant=ticket.tenant, prefix_len=prefix_len,
                        priority=getattr(ticket, "priority", 0))
                    gen.text = ticket.text
                    gen.retrieval = ticket
                    gen.add_done_callback(done_q.put)
                except Exception as e:  # noqa: BLE001 - retrieval/engine failed
                    if ticket._error is None:
                        # retrieval succeeded but the decode submit failed:
                        # graft the error onto the yielded ticket
                        err = SchedulerError(f"generation submit failed: {e}")
                        err.__cause__ = e
                        ticket._error = err
                    done_q.put(ticket)  # surface the failing ticket

            def submit(tenant, text, priority):
                ticket = sched.submit(text, k=k, tenant=tenant)
                ticket.priority = priority   # rides retrieval to the decode submit
                ticket.add_done_callback(on_retrieved if generate else done_q.put)

            yield from self._drain_stream(
                requests, submit, done_q,
                poll=controller.poll if controller is not None else None)
        finally:
            if controller is not None:
                self.last_slo_stats = controller.stats()
                controller.close()
            if sched is not None:
                sched.close(drain=True)
            if engine is not None:
                engine.close(drain=True)

    def _drain_stream(self, requests, submit, done_q, poll=None):
        """Shared submit/drain loop of the streaming generators: submits
        each request via `submit(tenant, text, priority)` (which lands
        exactly one finished ticket per request on `done_q`), yielding
        completions while submitting and the rest afterwards. `poll`,
        when given (the SLO controller's), runs between completions; in
        the final drain the queue wait is chopped so it keeps running
        while no ticket lands."""
        import queue as _queue

        n_submitted = n_yielded = 0
        for req in requests:
            priority = 0
            if isinstance(req, tuple):
                tenant, text = req[0], req[1]
                if len(req) > 2:
                    priority = int(req[2])
            else:
                tenant, text = DEFAULT_TENANT, req
            submit(tenant, text, priority)
            n_submitted += 1
            if poll is not None:
                poll()
            while True:  # opportunistically drain while submitting
                try:
                    yield self._finalize_stream_item(done_q.get_nowait())
                    n_yielded += 1
                except _queue.Empty:
                    break
        while n_yielded < n_submitted:
            if poll is None:
                ticket = done_q.get()
            else:
                poll()
                try:
                    ticket = done_q.get(timeout=0.05)
                except _queue.Empty:
                    continue
            yield self._finalize_stream_item(ticket)
            n_yielded += 1

    def _finalize_stream_item(self, ticket):
        """Attach decoded text to finished generation tickets."""
        if isinstance(ticket, GenerationTicket) and ticket._error is None:
            ticket.answer_text = self.tokenizer.decode(ticket.tokens)
        return ticket

    def generate_stream(self, requests, max_new_tokens: int = 32,
                        temperature: float = 0.0,
                        config: Optional[EngineConfig] = None,
                        router: Optional[RouterConfig] = None,
                        n_replicas: Optional[int] = None,
                        affinity: Optional[bool] = None,
                        max_imbalance: Optional[int] = None,
                        n_slots: Optional[int] = None,
                        cache_len: Optional[int] = None,
                        paged: Optional[bool] = None,
                        block_size: Optional[int] = None,
                        n_blocks: Optional[int] = None,
                        prefill_chunk: Optional[int] = None,
                        prefix_sharing: Optional[bool] = None,
                        retain_blocks: Optional[int] = None,
                        host_blocks: Optional[int] = None):
        """Stream plain (retrieval-free) generations in completion order.

        `requests` is an iterable of prompt strings, (tenant, text) pairs,
        or (tenant, text, priority) triples; each is tokenized (keeping
        the last `cache_len - max_new_tokens` tokens) and submitted into a
        continuous-batching decode slot. Yields GenerationTicket objects
        as sequences retire (`.text`, `.tokens`, `.answer_text`,
        `.first_token_s`, `.wait_s`). `router=` / `n_replicas=` /
        `affinity=` / `max_imbalance=` run the stream over an
        `EngineRouter` fleet."""
        import queue as _queue

        if self.engine is None:
            raise TypeError("generate_stream requires a model")
        config = resolve_config(config, dict(
            n_slots=n_slots, cache_len=cache_len, paged=paged,
            block_size=block_size, n_blocks=n_blocks,
            prefill_chunk=prefill_chunk, prefix_sharing=prefix_sharing,
            retain_blocks=retain_blocks, host_blocks=host_blocks))
        done_q: "_queue.Queue" = _queue.Queue()
        if config.cache_len is not None and config.cache_len <= max_new_tokens:
            raise ValueError(
                f"cache_len ({config.cache_len}) must exceed max_new_tokens "
                f"({max_new_tokens}) to leave room for the prompt")
        engine = self.decode_engine(
            config, router=router, n_replicas=n_replicas, affinity=affinity,
            max_imbalance=max_imbalance, max_new_tokens=max_new_tokens,
            temperature=temperature, start=True)
        vocab = self.engine.model.cfg.vocab_size

        def submit(tenant, text, priority):
            toks = [t % vocab for t in self.tokenizer.encode(text)]
            toks = toks[-(engine.cache_len - max_new_tokens):]
            ticket = engine.submit(toks, max_new_tokens=max_new_tokens,
                                   tenant=tenant, priority=priority)
            ticket.text = text
            ticket.add_done_callback(done_q.put)

        try:
            yield from self._drain_stream(requests, submit, done_q)
        finally:
            engine.close(drain=True)

    async def aquery_stream(self, requests, k: int = 3, max_batch: int = 32,
                            max_wait_ms: float = 5.0,
                            generator: Optional[torch.Generator] = None,
                            close_timeout: float = 30.0):
        """Async-generator twin of `query_stream` (retrieval only) for
        asyncio servers: the blocking waits run on worker threads via
        `asyncio.to_thread`, and closing this generator early closes the
        underlying `query_stream`, which shuts its scheduler thread down.
        `close_timeout` bounds (on the pipeline's clock) how long that
        shutdown retries a still-executing generator before warning."""
        it = self.query_stream(requests, k=k, max_batch=max_batch,
                               max_wait_ms=max_wait_ms, generator=generator)
        sentinel = object()
        try:
            import asyncio

            while True:
                ticket = await asyncio.to_thread(next, it, sentinel)
                if ticket is sentinel:
                    return
                yield ticket
        finally:
            await self._aclose_stream(it, close_timeout)

    async def _aclose_stream(self, it, close_timeout: float) -> None:
        """Close a running `query_stream` generator from async context,
        retrying while a cancelled next() still runs it; a stuck generator
        is warned about rather than silently leaking the scheduler
        thread."""
        import asyncio

        deadline = self._clock() + close_timeout
        while True:
            try:
                await asyncio.to_thread(it.close)
                break
            except ValueError:  # generator already executing
                if self._clock() > deadline:
                    warnings.warn(
                        "aquery_stream could not close its query_stream "
                        f"(still executing after {close_timeout:g}s); the "
                        "background scheduler thread may leak",
                        RuntimeWarning, stacklevel=1)
                    break
                await asyncio.sleep(0.02)

    # ------------------------------------------------------ corpus updates
    def add_docs(self, texts: Sequence[str]) -> np.ndarray:
        """Embed and append new documents (sharded index only); returns
        their stable ids."""
        if not isinstance(self.index, ShardedDircIndex):
            raise TypeError("add_docs requires n_shards >= 1 "
                            "(ShardedDircIndex); the monolithic ReRAM image "
                            "is build-once")
        texts = list(texts)
        if not texts:
            return np.zeros((0,), np.int32)
        # Stable ids are append-ordered, so position in doc_texts == id.
        # Reject BEFORE mutating the index, or the new batch would land in
        # the index with no doc_texts entries.
        if self.index.next_id != len(self.doc_texts):
            raise RuntimeError(
                "doc_texts out of sync with index ids (documents were added "
                "directly on pipe.index, bypassing pipe.add_docs)")
        ids = self.index.add_docs(self.embedder.embed(texts))
        self.doc_texts.extend(texts)
        return ids

    def delete_docs(self, doc_ids: Sequence[int]) -> int:
        """Tombstone documents by id (sharded index only)."""
        if not isinstance(self.index, ShardedDircIndex):
            raise TypeError("delete_docs requires n_shards >= 1")
        return self.index.delete_docs(doc_ids)
