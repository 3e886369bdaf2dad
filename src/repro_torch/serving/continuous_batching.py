"""Continuous-batching decode engine — counterpart of
`repro.serving.continuous_batching` for every model family.

Requests join and leave a decode batch of `n_slots` sequences at TOKEN
boundaries (Orca-style iteration-level scheduling). Between decode steps
the engine admits waiting requests into free slots, decodes one token for
every occupied slot in one batched step, and retires slots whose sequence
emitted `eos_id` or reached its own `max_new_tokens`.

Three cache memory models sit under the slots:

* **Fixed-slot (default, `paged=False`).** Every slot owns a private
  region of the model's batched caches (any tree of tensors:
  `DecodeCaches`, Mamba states, the hybrid's and the encoder-decoder's
  caches); admission prefills the whole prompt at b=1 (`prefill`, or one
  `decode_step` per prompt token for a model without it) and copies that
  cache into the slot, along each leaf's batch axis, found by
  shape-diffing `init_caches` at b 2 and b 1 as the JAX engine does.
* **Slot-resident paged (`paged=True` on a model without pageable KV:
  the ssm, hybrid and audio families).** The state stays in the
  fixed-slot caches; only chunked admission applies: an admitted prompt
  streams `prefill_chunk` tokens per engine step through `decode_step`
  at b=1 into a private cache, written into the slot when the prompt is
  done. Decode always runs the full `n_slots` width. There is no pool:
  prefix sharing, retention and the host tier are off, pool knobs set
  on the config are ignored with a `RuntimeWarning`, and a preempted
  sequence resumes by a full re-prefill of prompt + emitted tokens.
* **Paged KV (`paged=True`).** Attention KV lives in a shared pool of
  `(n_blocks, block_size)` blocks handed out by
  `paged_cache.PagedCacheManager`; `DecoderLM.paged_step` reads each
  row's window through its block table (the gather path, or K3 with
  `paged_kernel=True`). Prompts prefill in `prefill_chunk`-sized pieces,
  one piece per engine step, interleaved with decode. Decode batches are
  compacted to a power-of-two width and each prefill piece's table is
  narrowed to `pow2_at_least(need)` blocks. Admission is FIFO with
  bounded skip-ahead ordered by priority, with a starvation guard.
  With `prefix_sharing=True` the engine is a copy-on-write prefix cache
  over the pool: the first sequence to prefill a prefix publishes its
  blocks, later identical prefixes attach them (refcount++), requests
  whose prefix is mid-publication are deferred, and `prepare_write`
  detaches a shared block before any scatter into it; the block copy is
  an in-place tensor copy across layers (`_copy_block`).
  With `retain_blocks > 0` published prefixes outlive their publisher in
  a device LRU, and with `host_blocks > 0` a prefix evicted from it parks
  its KV in host tensors (`_offload_prefix`) and is written back into
  fresh blocks on a later hit (`_swapin_prefix`).

Priority preemption (paged modes): `preempt()` releases the
lowest-priority running sequence's slot (and blocks) and re-queues it;
with paged KV its resident span is published under its content hash
first, so with retention on the resume is a re-attach plus a one-token
suffix prefill, and otherwise a full re-prefill of prompt + emitted
tokens (`seq_prompt`).
`preempt_for_waiting()` fires only when the best waiting request is
blocked and a strictly lower priority runs — the SLO controller's
actuator, with `set_admit_lookahead()`.

Greedy decoding (`argmax`) is row-independent, so for fixed prompts the
tokens equal per-query `GenerationEngine.generate` and the JAX engine's.
Temperature sampling draws once per step from a `torch.Generator` shared
across rows, as the JAX engine uses one key per step; its tokens are the
JAX package's only in distribution.

The engine drives the model from whichever thread calls `step()` (the
background loop with `start=True`). The model methods run in inference
mode and the pools are created in it, so the in-place writes are legal
from any thread; `_write_slot`, `_copy_block` and the host-tier
callbacks (which `PagedCacheManager` calls under the step lock) run in
inference mode too. Replicas of an `EngineRouter` share one model
read-only; each owns its pools, its locks and its loop thread. The step
lock is handed out first come, first served (`_FifoLock`).
"""

from __future__ import annotations

import hashlib
import itertools
import queue as _queue
import threading
import time
import warnings
from collections import deque
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import DeviceLike, make_generator, resolve_device
from repro_torch.models.model_api import supports_paged_kv
from repro_torch.perf import trace
from .async_scheduler import DEFAULT_TENANT, SchedulerError
from .config import EngineConfig, resolve_config
from .engine import stream_prompt
from .paged_cache import PagedCacheManager, blocks_for, pow2_at_least

_DONE = object()  # token_stream sentinel
_RIDS = itertools.count()  # GenerationTicket.rid, unique in the process


class GenerationTicket:
    """Future-style handle for one generation request.

    Filled in by the engine as decoding progresses: `tokens` grows one id
    per emitted token, `first_token_s` is the submit->first-token latency
    (TTFT) and `wait_s` the submit->finish latency, both on the engine's
    clock, as is `admit_time`, when the request first took a slot. `rid`
    is the ticket's id in the process, which its `engine.piece` spans
    carry. `slot` is the decode slot the request occupied. `priority`
    orders paged admission and shields the request from preemption
    (`n_preempted` counts how often it was preempted; TTFT/e2e stamps
    span the whole request, preemptions included).
    """

    def __init__(self, engine: "ContinuousBatchingEngine", prompt: np.ndarray,
                 max_new_tokens: int, tenant: str, priority: int = 0):
        self._engine = engine
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.tenant = tenant
        self.priority = priority
        self.rid = next(_RIDS)
        self.submit_time = engine._clock()
        self.admit_time: Optional[float] = None
        self.first_token_s: Optional[float] = None
        self.wait_s: Optional[float] = None
        self.slot: Optional[int] = None
        self.prefix_key: Optional[str] = None  # content hash of the
        self.prefix_span: int = 0  # shareable prompt prefix (paged mode)
        self.n_preempted = 0
        # after a preemption: prompt + tokens emitted so far — what a
        # re-admission must make resident before decoding can continue
        self._resume_prompt: Optional[np.ndarray] = None
        self.tokens: list[int] = []
        self._token_q: _queue.SimpleQueue = _queue.SimpleQueue()
        self._event = threading.Event()
        self._error: Optional[BaseException] = None
        self._callbacks: list = []

    @property
    def seq_prompt(self) -> np.ndarray:
        """The token sequence admission must prefill: the original prompt,
        or (after a preemption) prompt + already-emitted tokens."""
        return self.prompt if self._resume_prompt is None else self._resume_prompt

    def done(self) -> bool:
        """True once finished or failed (result() will not block)."""
        return self._event.is_set()

    def add_done_callback(self, fn: Callable[["GenerationTicket"], None]) -> None:
        """Run `fn(ticket)` when done; immediately if already done."""
        run_now = False
        with self._engine._cv:
            if self._event.is_set():
                run_now = True
            else:
                self._callbacks.append(fn)
        if run_now:
            fn(self)

    def token_stream(self, timeout: Optional[float] = None):
        """Yield token ids incrementally as the engine emits them.

        Ends when the sequence retires; re-raises the engine error if the
        request failed. Single consumer. In manual mode each `get` first
        drives `engine.step()` so the stream makes progress.
        """
        while True:
            if not self._engine._has_thread():
                while self._token_q.empty() and not self._event.is_set():
                    if self._engine.step() == 0 and not self._event.is_set():
                        raise SchedulerError(
                            "engine made no progress for this ticket")
            try:
                item = self._token_q.get(timeout=timeout)
            except _queue.Empty:
                raise TimeoutError(
                    f"no token within {timeout}s "
                    f"(tenant={self.tenant!r}, emitted={len(self.tokens)})"
                ) from None
            if item is _DONE:
                if self._error is not None:
                    raise self._error
                return
            yield item

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """All generated token ids as an int32 vector; blocks until done.

        In manual mode an unfinished ticket drives `engine.step()` itself.
        Raises `SchedulerError` if the request failed, `TimeoutError` on
        timeout.
        """
        while not self._event.is_set() and not self._engine._has_thread():
            if self._engine.step() == 0 and not self._event.is_set():
                raise SchedulerError("engine made no progress for this ticket")
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"generation not finished within {timeout}s "
                f"(tenant={self.tenant!r}, emitted={len(self.tokens)})")
        if self._error is not None:
            raise self._error
        return np.asarray(self.tokens, np.int32)

    # -- internal: called by the engine ---------------------------------
    def _emit(self, tok: int) -> None:
        if self.first_token_s is None:
            self.first_token_s = self._engine._clock() - self.submit_time
        self.tokens.append(tok)
        self._token_q.put(tok)

    def _finish(self, error: Optional[BaseException] = None) -> None:
        # set + swap under the engine lock so a concurrent
        # add_done_callback either sees done() and runs immediately or
        # lands in the list we are about to drain — never in between.
        with self._engine._cv:
            self._error = error
            self.wait_s = self._engine._clock() - self.submit_time
            self._event.set()
            callbacks, self._callbacks = self._callbacks, []
            if error is None and self.first_token_s is not None:
                self._engine._completions.append((
                    self._engine._clock(), self.tenant, self.priority,
                    self.first_token_s, self.wait_s))
        self._token_q.put(_DONE)
        for fn in callbacks:
            try:
                fn(self)
            except Exception:  # noqa: BLE001 - callbacks must not kill the loop
                pass


class _FifoLock:
    """A lock handed to its waiters in arrival order.

    The background loop re-takes the step lock a few microseconds after
    each step ends. With a plain `threading.Lock` a thread blocked on it
    (the SLO controller's `preempt_for_waiting`, `clear_prefix_cache`)
    wakes too late and loses the race, for seconds at a time while the
    engine is busy. Here a waiter queued before the loop's next `acquire`
    goes first, so it waits at most one step."""

    def __init__(self):
        self._cv = threading.Condition(threading.Lock())
        self._held = False
        self._queue: deque = deque()

    def acquire(self) -> None:
        me = object()
        with self._cv:
            self._queue.append(me)
            while self._held or self._queue[0] is not me:
                self._cv.wait()
            self._queue.popleft()
            self._held = True

    def release(self) -> None:
        with self._cv:
            self._held = False
            self._cv.notify_all()

    def __enter__(self) -> "_FifoLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


def _leaves(tree) -> list:
    """The tensors of a cache tree (nested tuples), in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for sub in tree for leaf in _leaves(sub)]


class _Prefill:
    """In-flight chunked prefill of one admitted sequence (paged mode)."""

    __slots__ = ("ticket", "pos", "caches1", "publish_key", "publish_span")

    def __init__(self, ticket: GenerationTicket, caches1=None):
        self.ticket = ticket
        self.caches1 = caches1    # b=1 cache tree (slot-resident models only)
        self.pos = 0              # prompt tokens processed so far
        self.publish_key = None   # prefix key to register once pos >= span
        self.publish_span = 0


class ContinuousBatchingEngine:
    """Slot-based continuous-batching decode over any family's LM.

    model: a model whose weights live on `device` (None: the card):
        `decode_step` and `init_caches`, `prefill` optional, the paged
        protocol (`init_paged_caches`, `paged_step`) for paged KV.
    config: an `EngineConfig` holding every shape/policy knob; the
        per-knob keywords are the deprecated shim of `resolve_config`.
        `cache_len` None is 256; `n_blocks` None is the fixed-slot
        footprint plus the null block; `block_size` 16; `prefill_chunk`
        32; `admit_lookahead` 4; `max_head_skips` 16; `paged_kernel` None
        defers to the model config; `retain_blocks` / `host_blocks` turn
        on the tiered prefix cache.
    eos_id: retire a slot when it emits this id (None: length-only).
    temperature: 0 == greedy; > 0 samples with one draw per step from
        `generator` (default: seeded 0 on the engine's device).
    replica_id: this engine's position in an `EngineRouter` fleet; None
        outside a fleet. Identity only: it changes neither behaviour nor
        the stats() schema.
    clock: monotonic-seconds callable, injectable for deterministic tests.
    start: spawn the background decode loop; with False the engine is in
        manual mode (`step()`, or `ticket.result()` / `token_stream()`).
    """

    def __init__(
        self,
        model,
        config: Optional[EngineConfig] = None,
        *,
        n_slots: Optional[int] = None,
        cache_len: Optional[int] = None,
        eos_id: Optional[int] = None,
        temperature: float = 0.0,
        generator: Optional[torch.Generator] = None,
        paged: Optional[bool] = None,
        block_size: Optional[int] = None,
        n_blocks: Optional[int] = None,
        prefill_chunk: Optional[int] = None,
        prefix_sharing: Optional[bool] = None,
        admit_lookahead: Optional[int] = None,
        max_head_skips: Optional[int] = None,
        paged_kernel: Optional[bool] = None,
        retain_blocks: Optional[int] = None,
        host_blocks: Optional[int] = None,
        replica_id: Optional[int] = None,
        clock: Callable[[], float] = time.monotonic,
        start: bool = False,
        device: DeviceLike = None,
    ):
        config = resolve_config(config, dict(
            n_slots=n_slots, cache_len=cache_len, paged=paged,
            block_size=block_size, n_blocks=n_blocks,
            prefill_chunk=prefill_chunk, prefix_sharing=prefix_sharing,
            admit_lookahead=admit_lookahead, max_head_skips=max_head_skips,
            paged_kernel=paged_kernel, retain_blocks=retain_blocks,
            host_blocks=host_blocks))
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"model lives on {model.device}, engine on {self.device}")
        self.config = config
        n_slots = config.n_slots
        cache_len = 256 if config.cache_len is None else config.cache_len
        self.model = model
        self.replica_id = replica_id
        self.n_slots = n_slots
        self.cache_len = cache_len
        self.eos_id = eos_id
        self.temperature = temperature
        self.paged = config.paged
        self.paged_kernel: Optional[bool] = None
        self._generator = (generator if generator is not None
                           else make_generator(self.device, 0))
        self._clock = clock

        # -- cache memory model -----------------------------------------
        self._kv_paged = self.paged and supports_paged_kv(model)
        self._pcm: Optional[PagedCacheManager] = None
        if self.paged:
            if not self._kv_paged and (
                    config.block_size is not None or config.n_blocks is not None
                    or config.paged_kernel is not None or config.prefix_sharing
                    or config.retain_blocks or config.host_blocks):
                # slot-resident state has no pool: the knobs would vanish
                # silently, so say so
                warnings.warn(
                    f"{type(model).__name__} has no pageable KV cache; "
                    "block_size/n_blocks/prefix_sharing/paged_kernel/"
                    "retain_blocks/host_blocks are ignored (state stays "
                    "slot-resident, only chunked admission applies)",
                    RuntimeWarning, stacklevel=2)
            self.block_size = config.block_size or 16
            self.prefill_chunk = config.prefill_chunk or 32
            self.admit_lookahead = (4 if config.admit_lookahead is None
                                    else config.admit_lookahead)
            self.max_head_skips = (16 if config.max_head_skips is None
                                   else config.max_head_skips)
        self.prefix_sharing = bool(config.prefix_sharing) and self._kv_paged
        self.retain_blocks = (config.retain_blocks or 0) if self._kv_paged else 0
        self.host_blocks = (config.host_blocks or 0) if self._kv_paged else 0
        # prefix key -> (k, v) host tensors of the host tier
        self._host_kv: dict = {}
        if self._kv_paged:
            n_blocks = config.n_blocks
            if n_blocks is None:
                n_blocks = blocks_for(n_slots * cache_len, self.block_size) + 1
            host = bool(self.host_blocks)
            self._pcm = PagedCacheManager(
                n_blocks, self.block_size,
                max_blocks_per_seq=blocks_for(cache_len, self.block_size),
                retain_blocks=self.retain_blocks, host_blocks=self.host_blocks,
                on_evict=self._offload_prefix if host else None,
                on_swapin=self._swapin_prefix if host else None,
                on_host_drop=self._drop_host_prefix if host else None)
            self._pools = model.init_paged_caches(n_blocks, self.block_size)
            self.paged_kernel = config.paged_kernel
            self._lengths = np.zeros((n_slots,), np.int64)
            self._caches = None
        else:
            self._batch_axes = self._detect_batch_axes()
            self._caches = model.init_caches(n_slots, cache_len, 0)

        self._pad_id = eos_id if eos_id is not None else 0
        self._cur = np.full((n_slots, 1), self._pad_id, np.int32)
        self._slots: list[Optional[GenerationTicket]] = [None] * n_slots
        self._emitted = np.zeros((n_slots,), np.int64)
        self._prefills: dict[int, _Prefill] = {}  # slot -> chunked prefill
        self._waiting: deque[GenerationTicket] = deque()
        self._cv = threading.Condition()
        # serializes step() bodies: several threads may drive a manual-mode
        # engine via ticket.result()/token_stream() at once; FIFO, so the
        # background loop cannot starve an actuator waiting between steps
        self._step_lock = _FifoLock()
        self._closed = False
        self._drain_on_close = True
        # stats (guarded by _cv for cross-thread reads)
        self.n_decode_steps = 0
        self.n_prefills = 0
        self.n_prefill_chunks = 0
        self.n_tokens = 0
        self.n_finished = 0
        self.n_failed = 0
        self.n_backpressure = 0  # admissions deferred by pool exhaustion
        self.n_skip_ahead = 0  # admissions that jumped a deferred head
        self.n_preemptions = 0  # running sequences released + re-queued
        self.n_resumes = 0  # preempted sequences re-admitted
        self.peak_active = 0
        # finished-request latency samples:
        # (finish clock, tenant, priority, ttft_s, e2e_s)
        self._completions: deque = deque(maxlen=4096)
        # prefix keys being published: key -> owning slot
        self._publishing: dict[str, int] = {}
        self._head_ticket: Optional[GenerationTicket] = None
        self._head_skips = 0
        self._occupancy_counts: dict[int, int] = {}
        self._thread: Optional[threading.Thread] = None
        if start:
            self._thread = threading.Thread(
                target=self._loop, name="ContinuousBatchingEngine", daemon=True)
            self._thread.start()

    # ------------------------------------------------------- cache plumbing
    @torch.inference_mode()
    def _copy_block(self, src: int, dst: int) -> None:
        """Copy physical block `src` onto `dst` in both pools, every layer,
        in place — the device half of a copy-on-write detachment."""
        self._pools.k_pool[:, dst] = self._pools.k_pool[:, src]
        self._pools.v_pool[:, dst] = self._pools.v_pool[:, src]

    def _cow_barrier(self, seq: int, start: int, end: int) -> None:
        """Detach + device-copy every shared block a scatter into
        positions [start, end) of `seq` would touch."""
        for src, dst in self._pcm.prepare_write(seq, start, end):
            self._copy_block(src, dst)

    def _detect_batch_axes(self) -> list:
        """Per-leaf batch axis of the model's cache tree: the one axis on
        which `init_caches` at b 2 and at b 1 differ (raises when a leaf
        has no single such axis)."""
        big = self.model.init_caches(2, self.cache_len, 0)
        one = self.model.init_caches(1, self.cache_len, 0)
        axes = []
        for b_l, s_l in zip(_leaves(big), _leaves(one)):
            diff = [i for i, (a, c) in enumerate(zip(b_l.shape, s_l.shape)) if a != c]
            if len(diff) != 1:
                raise ValueError(f"unsupported cache layout: leaf {tuple(b_l.shape)} vs "
                                 f"{tuple(s_l.shape)} has no unique batch axis")
            axes.append(diff[0])
        return axes

    @torch.inference_mode()
    def _write_slot(self, one, slot: int) -> None:
        """Write a b=1 cache tree into slot `slot` of the batched one, each
        leaf along its batch axis, in place."""
        for full, part, ax in zip(_leaves(self._caches), _leaves(one), self._batch_axes):
            full.select(ax, slot).copy_(part.select(ax, 0))

    @torch.inference_mode()
    def _offload_prefix(self, key, blocks, n_tokens: int) -> int:
        """Host-tier `on_evict` callback: gather the victim prefix's blocks
        out of every layer's K and V pool into host tensors (L, k, bs,
        kh, hd), k = len(blocks); returns the bytes parked. Runs under
        the step lock while the blocks are still resident."""
        idx = torch.as_tensor(list(blocks), dtype=torch.long, device=self.device)
        k = self._pools.k_pool[:, idx].cpu()
        v = self._pools.v_pool[:, idx].cpu()
        self._host_kv[key] = (k, v)
        return k.nbytes + v.nbytes

    @torch.inference_mode()
    def _swapin_prefix(self, key, blocks, n_tokens: int) -> None:
        """Host-tier `on_swapin` callback: write the parked KV back into
        the freshly reserved device blocks, in place."""
        k, v = self._host_kv.pop(key)
        idx = torch.as_tensor(list(blocks), dtype=torch.long, device=self.device)
        self._pools.k_pool[:, idx] = k.to(self.device)
        self._pools.v_pool[:, idx] = v.to(self.device)

    def _drop_host_prefix(self, key) -> None:
        """Host-tier `on_host_drop` callback: discard parked KV."""
        self._host_kv.pop(key, None)

    def clear_prefix_cache(self) -> int:
        """Drop every retained prefix pin and host-tier entry; returns
        entries dropped (test isolation, warm-up)."""
        with self._step_lock:
            if self._pcm is None:
                return 0
            n = self._pcm.clear_retained()
            self._host_kv.clear()
            return n

    def _prefill_one(self, prompt: np.ndarray):
        """Prefill one prompt at b=1; returns (last logits (1, V), caches).
        A model without `prefill` streams the prompt through `decode_step`."""
        toks = torch.as_tensor(prompt, dtype=torch.long, device=self.device)[None]
        if hasattr(self.model, "prefill"):
            return self.model.prefill(toks, cache_len=self.cache_len)
        return stream_prompt(self.model, self.model.init_caches(1, self.cache_len, 0), toks)

    @trace.spanned("engine.sample")
    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        """(b, V) -> (b,) int32 next tokens."""
        if self.temperature <= 0:
            return torch.argmax(logits, dim=-1).cpu().numpy().astype(np.int32)
        probs = torch.softmax(logits.float() / self.temperature, dim=-1)
        out = torch.multinomial(probs, 1, generator=self._generator)[:, 0]
        return out.cpu().numpy().astype(np.int32)

    # --------------------------------------------------------------- submit
    def submit(
        self,
        prompt: Sequence[int],
        max_new_tokens: int = 32,
        tenant: str = DEFAULT_TENANT,
        prefix_len: Optional[int] = None,
        priority: int = 0,
    ) -> GenerationTicket:
        """Enqueue one prompt; returns immediately with a GenerationTicket.

        The request is admitted into a decode slot at the next token
        boundary with a free slot (paged mode: and enough free pool
        blocks for its worst-case budget). Raises SchedulerError if the
        engine is closed or the request could NEVER be served (fixed-slot:
        `len(prompt) + max_new_tokens > cache_len`; paged: the worst case
        exceeds the table width or the whole pool). `prefix_len` bounds
        the shareable prefix under `prefix_sharing=True`; `priority`
        (higher wins) orders paged admission within the skip-ahead window.
        """
        prompt = np.asarray(list(prompt), np.int32)
        if prompt.ndim != 1 or prompt.size == 0:
            raise ValueError("prompt must be a non-empty 1-D token sequence")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        need = int(prompt.size) + max_new_tokens
        if self._kv_paged:
            blocks = self._pcm.blocks_needed(need)
            if blocks > self._pcm.max_blocks_per_seq \
                    or blocks > self._pcm.n_usable_blocks:
                raise SchedulerError(
                    f"request needs {blocks} blocks of {self.block_size} "
                    f"tokens but the pool serves at most "
                    f"{min(self._pcm.max_blocks_per_seq, self._pcm.n_usable_blocks)} "
                    f"per sequence")
        elif need > self.cache_len:
            raise SchedulerError(
                f"request needs {prompt.size} prompt + {max_new_tokens} new "
                f"tokens but cache_len is {self.cache_len}")
        t = GenerationTicket(self, prompt, max_new_tokens, tenant, priority)
        t.prefix_key, t.prefix_span = self.compute_prefix_key(prompt, prefix_len)
        with self._cv:
            if self._closed:
                raise SchedulerError("engine is closed")
            self._waiting.append(t)
            self._cv.notify_all()
        return t

    def compute_prefix_key(
        self, prompt: np.ndarray, prefix_len: Optional[int] = None
    ) -> tuple[Optional[str], int]:
        """(content key, span) a `submit(prompt, prefix_len=...)` would
        carry, or (None, 0) when the span is sub-block or sharing is off:
        the whole prompt minus the final token, clipped to `prefix_len`,
        keyed by the SHA-1 of its int32 token bytes."""
        if not self.prefix_sharing:
            return None, 0
        prompt = np.asarray(prompt, np.int32)
        span = int(prompt.size) - 1
        if prefix_len is not None:
            span = min(int(prefix_len), span)
        if span < self.block_size:
            return None, 0
        return hashlib.sha1(prompt[:span].tobytes()).hexdigest(), span

    def holds_prefix(self, key: str) -> bool:
        """True when this engine holds (or is about to hold) prefix `key`:
        published in the pool registry, pinned in the retained tier, parked
        in the host tier, mid-publication, or carried by a queued/active
        ticket — the placement probe of `EngineRouter`."""
        if not self.prefix_sharing:
            return False
        if self._pcm.has_prefix_any(key) or key in self._publishing:
            return True
        with self._cv:
            return any(t is not None and t.prefix_key == key
                       for t in itertools.chain(self._slots, self._waiting))

    def pending(self) -> int:
        """Requests waiting for a slot (admitted ones count as active)."""
        with self._cv:
            return len(self._waiting)

    def active(self) -> int:
        """Occupied decode slots (decoding or mid-prefill)."""
        with self._cv:
            return sum(t is not None for t in self._slots)

    def load(self) -> int:
        """Queued + active requests, read atomically."""
        with self._cv:
            return len(self._waiting) + sum(t is not None for t in self._slots)

    def stats(self) -> dict:
        """Engine counters, the JAX engine's full schema.

        Always: `n_slots`, `n_decode_steps`, `n_prefills`, `n_tokens`,
        `n_finished`, `n_failed`, `peak_active`, `mean_occupancy`,
        `occupancy_hist` (occupied slots at a decode step -> steps).
        Paged mode: `n_prefill_chunks`, `n_backpressure`, `n_skip_ahead`,
        `prefill_chunk`, `n_preemptions` (running sequences released and
        re-queued), `n_resumes` (preempted sequences re-admitted). Pageable KV:
        `prefix_sharing`, `paged_kernel` (None defers to the model
        config) and `pool`, the `PagedCacheManager.stats()` dict."""
        with self._cv:
            occ = dict(sorted(self._occupancy_counts.items()))
            steps = self.n_decode_steps
            occ_tokens = sum(k * v for k, v in occ.items())
            out = {
                "n_slots": self.n_slots,
                "n_decode_steps": steps,
                "n_prefills": self.n_prefills,
                "n_tokens": self.n_tokens,
                "n_finished": self.n_finished,
                "n_failed": self.n_failed,
                "peak_active": self.peak_active,
                "occupancy_hist": occ,
                "mean_occupancy": occ_tokens / steps if steps else 0.0,
            }
            if self.paged:
                out["n_prefill_chunks"] = self.n_prefill_chunks
                out["n_backpressure"] = self.n_backpressure
                out["n_skip_ahead"] = self.n_skip_ahead
                out["prefill_chunk"] = self.prefill_chunk
                out["n_preemptions"] = self.n_preemptions
                out["n_resumes"] = self.n_resumes
            if self._kv_paged:
                out["prefix_sharing"] = self.prefix_sharing
                out["paged_kernel"] = self.paged_kernel
                out["pool"] = self._pcm.stats()
            return out

    # ------------------------------------------------------- the decode loop
    def _has_thread(self) -> bool:
        return self._thread is not None

    def _free_slots_locked(self) -> list[int]:
        return [i for i, t in enumerate(self._slots) if t is None]

    def _release_slot(self, slot: int) -> None:
        """Drop per-slot serving resources (prefill state, pool blocks);
        called under the step lock."""
        self._prefills.pop(slot, None)
        if self._kv_paged:
            if slot in self._pcm:
                self._pcm.free(slot)
            self._lengths[slot] = 0
            # a failed/retired publisher unblocks deferred same-key
            # requests: the next one to admit becomes the new owner
            for key in [k for k, s in self._publishing.items() if s == slot]:
                del self._publishing[key]

    def _retire_locked(self, slot: int) -> None:
        self._slots[slot] = None
        self._cur[slot, 0] = self._pad_id
        self._emitted[slot] = 0
        self.n_finished += 1
        self._release_slot(slot)

    def _fail_all_locked(self) -> list[GenerationTicket]:
        """Collect every waiting + in-flight ticket and clear the engine
        state (close/abort paths). Caller finishes the tickets."""
        fail = list(self._waiting)
        fail.extend(t for t in self._slots if t is not None)
        self._waiting.clear()
        for slot, t in enumerate(self._slots):
            if t is not None:
                self._release_slot(slot)
        self._slots = [None] * self.n_slots
        self.n_failed += len(fail)
        return fail

    # ------------------------------------------------ fixed-slot admission
    @trace.spanned("engine.admit")
    def _admit(self) -> int:
        """Move waiting requests into free slots; returns tokens emitted.
        Each admission prefills the WHOLE prompt at b=1, copies its cache
        into the slot and emits the first sampled token."""
        emitted = 0
        while True:
            with self._cv:
                free = self._free_slots_locked()
                if not free or not self._waiting:
                    return emitted
                ticket = self._waiting.popleft()
                slot = free[0]
                self._slots[slot] = ticket   # reserve while prefilling
                if ticket.admit_time is None:
                    ticket.admit_time = self._clock()
            try:
                logits, caches1 = self._prefill_one(ticket.prompt)
                self._write_slot(caches1, slot)
                tok = int(self._sample(logits)[0])
            except Exception as e:  # noqa: BLE001 - fail just this ticket
                err = SchedulerError(f"prefill failed: {e}")
                err.__cause__ = e
                with self._cv:
                    self._slots[slot] = None
                    self.n_failed += 1
                ticket._finish(error=err)
                continue
            ticket.slot = slot
            emitted += self._emit_first_token(slot, ticket, tok)

    def _emit_first_token(self, slot: int, ticket: GenerationTicket, tok: int) -> int:
        """Emit the first token and either retire immediately or enter the
        decode rotation."""
        ticket._emit(tok)
        with self._cv:
            self.n_prefills += 1
            self.n_tokens += 1
            # len(tokens), not 1: a resumed sequence re-enters here with its
            # pre-preemption output already emitted
            if (self.eos_id is not None and tok == self.eos_id) \
                    or len(ticket.tokens) >= ticket.max_new_tokens:
                self._retire_locked(slot)
                finish = True
            else:
                self._cur[slot, 0] = tok
                self._emitted[slot] = len(ticket.tokens)
                finish = False
        if finish:
            ticket._finish()
        return 1

    # ----------------------------------------------------- paged admission
    @trace.spanned("engine.admit")
    def _admit_paged(self) -> int:
        """Assign waiting requests to free slots, reserving their
        worst-case pool budget; returns the number admitted. FIFO with
        bounded skip-ahead (highest priority first within the window);
        after `max_head_skips` skips of one head, strict FIFO."""
        admitted = 0
        head_counted = False  # bump n_backpressure once per step
        while True:
            with self._cv:
                free = self._free_slots_locked()
                if not free or not self._waiting:
                    return admitted
                waiting = list(itertools.islice(
                    self._waiting, 1 + self.admit_lookahead))
            head = waiting[0]
            if head is not self._head_ticket:
                self._head_ticket, self._head_skips = head, 0
            lookahead = (self.admit_lookahead
                         if self._head_skips < self.max_head_skips else 0)
            ticket = None
            head_deferred = False
            window = waiting[: 1 + lookahead]
            order = sorted(range(len(window)),
                           key=lambda i: (-window[i].priority, i))
            for i in order:
                cand = window[i]
                if self._kv_paged:
                    if (cand.prefix_key is not None
                            and cand.prefix_key in self._publishing):
                        continue  # prefix mid-publication: attach later
                    need = (int(cand.seq_prompt.size)
                            + cand.max_new_tokens - len(cand.tokens))
                    if not self._pcm.can_reserve(need, prefix_key=cand.prefix_key):
                        if cand is head:
                            head_deferred = True
                        continue
                ticket = cand
                break
            with self._cv:
                if head_deferred and not head_counted:
                    self.n_backpressure += 1
                    head_counted = True
                if ticket is None:
                    return admitted
                if ticket is not head:
                    self._head_skips += 1
                    self.n_skip_ahead += 1
                else:
                    self._head_ticket, self._head_skips = None, 0
                try:
                    self._waiting.remove(ticket)
                except ValueError:  # failed/closed concurrently
                    continue
                slot = free[0]
                self._slots[slot] = ticket
                if ticket.admit_time is None:
                    ticket.admit_time = self._clock()
                if ticket._resume_prompt is not None:
                    self.n_resumes += 1
            if self._kv_paged:
                need = (int(ticket.seq_prompt.size)
                        + ticket.max_new_tokens - len(ticket.tokens))
                self._pcm.reserve(slot, need, prefix_key=ticket.prefix_key)
                shared = self._pcm.shared_tokens(slot)
                self._lengths[slot] = shared
                pre = _Prefill(ticket)
                # prefix hit: the shared KV is already resident — chunked
                # prefill starts at the unique suffix
                pre.pos = shared
                if shared == 0 and ticket.prefix_key is not None:
                    self._publishing[ticket.prefix_key] = slot
                    pre.publish_key = ticket.prefix_key
                    pre.publish_span = ticket.prefix_span
            else:
                # slot-resident state: stream into a private b=1 cache,
                # written into the slot when the prompt is done
                pre = _Prefill(ticket, self.model.init_caches(1, self.cache_len, 0))
            self._prefills[slot] = pre
            ticket.slot = slot
            admitted += 1

    def _advance_prefills(self) -> int:
        """Advance every in-flight prefill by one `prefill_chunk` piece;
        returns pieces processed. Completed prompts emit their first
        token and join the decode rotation at this step's decode."""
        work = 0
        for slot in sorted(self._prefills):
            pre = self._prefills[slot]
            ticket = pre.ticket
            try:
                with trace.span("engine.piece", ticket.rid):
                    done, logits = self._prefill_chunk_once(slot, pre)
                tok = int(self._sample(logits)[0]) if done else None
            except Exception as e:  # noqa: BLE001 - fail just this ticket
                err = SchedulerError(f"chunked prefill failed: {e}")
                err.__cause__ = e
                with self._cv:
                    self._release_slot(slot)
                    self._slots[slot] = None
                    self.n_failed += 1
                ticket._finish(error=err)
                continue
            work += 1
            with self._cv:
                self.n_prefill_chunks += 1
            if pre.publish_key is not None and pre.pos >= pre.publish_span:
                # the prefix KV is fully resident: publish it
                self._pcm.register_prefix(pre.publish_key, slot, pre.publish_span)
                self._publishing.pop(pre.publish_key, None)
                pre.publish_key = None
            if done:
                del self._prefills[slot]
                self._emit_first_token(slot, ticket, tok)
        return work

    def _prefill_chunk_once(self, slot: int, pre: _Prefill):
        """Process the next prompt piece of one admitted sequence; returns
        (done, logits at the prompt's last position when done)."""
        prompt = pre.ticket.seq_prompt
        n = min(self.prefill_chunk, int(prompt.size) - pre.pos)
        if not self._kv_paged:
            toks = torch.as_tensor(prompt[pre.pos: pre.pos + n], dtype=torch.long,
                                   device=self.device)[None]
            logits, pre.caches1 = stream_prompt(self.model, pre.caches1, toks)
            pre.pos += n
            done = pre.pos == int(prompt.size)
            if done:
                self._write_slot(pre.caches1, slot)
            return done, logits
        self._pcm.ensure(slot, pre.pos + n)
        self._cow_barrier(slot, pre.pos, pre.pos + n)
        toks = np.zeros((1, self.prefill_chunk), np.int32)
        toks[0, :n] = prompt[pre.pos: pre.pos + n]
        # narrow the table to the blocks this chunk can see, bucketed to
        # powers of two (the JAX engine's bounded set of compiled shapes;
        # here it bounds the attention window of a short prompt)
        table = self._pcm.tables([slot])
        need = blocks_for(pre.pos + n, self.block_size)
        table = table[:, : min(pow2_at_least(need), table.shape[1])]
        logits, self._pools = self._paged_step(
            table, np.asarray([pre.pos], np.int32), toks, np.asarray([n], np.int32))
        pre.pos += n
        self._lengths[slot] = pre.pos
        return pre.pos == int(prompt.size), logits

    @trace.spanned("engine.forward")
    def _paged_step(self, tables, lengths, toks, n_valid):
        # paged_kernel None: the model config decides
        return self.model.paged_step(self._pools, tables, lengths, toks, n_valid,
                                     paged_kernel=self.paged_kernel)

    # ---------------------------------------------------------- decode step
    def _decode_once(self) -> int:
        """One batched decode step over every occupied, non-prefilling
        slot. Paged lanes are compacted host-side to the active rows,
        padded to a power-of-two width; fixed-slot mode decodes the full
        width."""
        with self._cv:
            active = [(i, t) for i, t in enumerate(self._slots)
                      if t is not None and i not in self._prefills]
            if not active:
                return 0
            cur = self._cur.copy()
        return self._decode_rows(active, cur)

    @trace.spanned("engine.decode")
    def _decode_rows(self, active: list, cur: np.ndarray) -> int:
        """`_decode_once` over its `active` (slot, ticket) rows, `cur`
        their last tokens; returns the tokens emitted."""
        if self._kv_paged:
            idx = [i for i, _ in active]
            for i in idx:
                # lazy append, then detach any block a later prefix hit is
                # still sharing (the mid-decode half of copy-on-write)
                li = int(self._lengths[i])
                self._pcm.ensure(i, li + 1)
                self._cow_barrier(i, li, li + 1)
            width = min(pow2_at_least(len(idx)), self.n_slots)
            tables = self._pcm.tables(idx + [None] * (width - len(idx)))
            lengths = np.zeros((width,), np.int32)
            lengths[: len(idx)] = self._lengths[idx]
            toks = np.full((width, 1), self._pad_id, np.int32)
            toks[: len(idx), 0] = cur[idx, 0]
            n_valid = np.zeros((width,), np.int32)
            n_valid[: len(idx)] = 1
            logits, self._pools = self._paged_step(tables, lengths, toks, n_valid)
        else:
            with trace.span("engine.forward"):
                logits, self._caches = self.model.decode_step(
                    self._caches, torch.as_tensor(cur, dtype=torch.long, device=self.device))
        nxt = self._sample(logits)
        finished: list[GenerationTicket] = []
        emitted = 0
        with self._cv:
            self.n_decode_steps += 1
            n_active = len(active)
            self._occupancy_counts[n_active] = \
                self._occupancy_counts.get(n_active, 0) + 1
            for row, (slot, ticket) in enumerate(active):
                if self._slots[slot] is not ticket:  # failed concurrently
                    continue
                if self._kv_paged:
                    self._lengths[slot] += 1
                tok = int(nxt[row if self._kv_paged else slot])
                ticket._emit(tok)
                emitted += 1
                self.n_tokens += 1
                self._emitted[slot] += 1
                if (self.eos_id is not None and tok == self.eos_id) or \
                        self._emitted[slot] >= ticket.max_new_tokens:
                    self._retire_locked(slot)
                    finished.append(ticket)
                else:
                    self._cur[slot, 0] = tok
        for ticket in finished:
            ticket._finish()
        return emitted

    # ------------------------------------------------- priority preemption
    def _preempt_locked(self, priority_below: Optional[int] = None) -> bool:
        """Preempt one running sequence; the caller holds the step lock.

        Victim: the decode-phase slot (a mid-prefill sequence is never
        preempted) of the LOWEST priority, ties broken by the smallest
        resident length (paged KV; else the lowest slot). With
        `priority_below`, only a strictly lower priority qualifies. With
        paged KV the victim's resident span is published under its
        content hash BEFORE its blocks are freed, so with retention on the
        resume re-attaches it (the span is re-derived from the same tokens
        either way); slot-resident state resumes by a full re-prefill.
        Returns True on a preemption.
        """
        with self._cv:
            cands = [(t.priority, int(self._lengths[s]) if self._kv_paged else 0, s, t)
                     for s, t in enumerate(self._slots)
                     if t is not None and s not in self._prefills]
        if not cands:
            return False
        pri, _, slot, ticket = min(cands, key=lambda c: c[:3])
        if priority_below is not None and pri >= priority_below:
            return False
        full = np.concatenate([ticket.prompt, np.asarray(ticket.tokens, np.int32)])
        key, span = None, 0
        if self._kv_paged:
            # the resident KV covers full[:lengths] (the newest token's KV
            # is written on its next step): exactly the default shareable
            # span of the resume prompt, so the re-admission's key matches
            span = int(self._lengths[slot])
            if span >= self.block_size:
                key = hashlib.sha1(full[:span].tobytes()).hexdigest()
                self._pcm.register_prefix(key, slot, span)
        self._release_slot(slot)
        with self._cv:
            self._slots[slot] = None
            self._cur[slot, 0] = self._pad_id
            self._emitted[slot] = 0
            ticket._resume_prompt = full
            ticket.prefix_key, ticket.prefix_span = key, span
            ticket.slot = None
            ticket.n_preempted += 1
            self.n_preemptions += 1
            self._waiting.append(ticket)
            self._cv.notify_all()
        return True

    def preempt(self, priority_below: Optional[int] = None) -> bool:
        """Release the lowest-priority running sequence's slot and blocks
        and re-queue it to resume later (see `_preempt_locked`). Paged
        engines only: fixed-slot mode returns False. True when a sequence
        was preempted."""
        if not self.paged:
            return False
        with self._step_lock:
            return self._preempt_locked(priority_below)

    def preempt_for_waiting(self, max_preemptions: int = 1) -> int:
        """Preempt lower-priority running sequences so the best waiting
        request can admit; returns preemptions performed (<=
        `max_preemptions`). The highest-priority request of the admission
        window must be blocked (no free slot, or its reservation cannot
        be covered) and a strictly lower priority must be running."""
        if not self.paged:
            return 0
        done = 0
        while done < max_preemptions:
            with self._step_lock:
                with self._cv:
                    window = list(itertools.islice(
                        self._waiting, 1 + self.admit_lookahead))
                    free = self._free_slots_locked()
                if not window:
                    return done
                top = max(window, key=lambda t: t.priority)
                if top.prefix_key is not None and top.prefix_key in self._publishing:
                    return done  # attaches once the publication lands
                blocked = not free
                if not blocked and self._kv_paged:
                    need = (int(top.seq_prompt.size)
                            + top.max_new_tokens - len(top.tokens))
                    blocked = not self._pcm.can_reserve(need, prefix_key=top.prefix_key)
                if not blocked:
                    return done
                if not self._preempt_locked(priority_below=top.priority):
                    return done
            done += 1
        return done

    def set_admit_lookahead(self, n: int) -> None:
        """Retune the paged admission skip-ahead bound live (an SLO
        controller actuator). No-op on non-paged engines."""
        if n < 0:
            raise ValueError("admit_lookahead must be >= 0")
        if not self.paged:
            return
        with self._cv:
            self.admit_lookahead = int(n)

    def pop_completions(self) -> list[tuple]:
        """Drain finished-request latency samples: `(finish_clock, tenant,
        priority, ttft_s, e2e_s)` tuples, oldest first, each once."""
        with self._cv:
            out = list(self._completions)
            self._completions.clear()
        return out

    def step(self) -> int:
        """Admit waiting requests, advance prefills, run one decode step.

        Returns the work done: tokens emitted plus (paged mode) prefill
        pieces processed. 0 means the engine is idle.
        """
        with self._step_lock, trace.span("engine.step"):
            if self.paged:
                self._admit_paged()
                work = self._advance_prefills()
            else:
                work = self._admit()
            with self._cv:
                self.peak_active = max(
                    self.peak_active, sum(t is not None for t in self._slots))
            return work + self._decode_once()

    def run_until_drained(self, max_steps: Optional[int] = None) -> int:
        """step() until no work remains; returns total work units."""
        total = 0
        steps = 0
        while True:
            got = self.step()
            total += got
            steps += 1
            if got == 0:
                with self._cv:
                    if not self._waiting and all(t is None for t in self._slots):
                        return total
            if max_steps is not None and steps >= max_steps:
                return total

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._closed and not self._waiting \
                        and all(t is None for t in self._slots):
                    self._cv.wait()
                if self._closed:
                    idle = not self._waiting and all(t is None for t in self._slots)
                    if idle or not self._drain_on_close:
                        fail = self._fail_all_locked()
                        self._cv.notify_all()
                        closing = True
                    else:
                        closing = False
                else:
                    closing = False
            if closing:
                err = SchedulerError("engine closed without draining")
                for t in fail:
                    t._finish(error=err)
                return
            try:
                self.step()
            except Exception as e:  # noqa: BLE001 - decode died: fail loudly
                # a decode/sample error (a CUDA fault included) must not
                # kill the daemon thread silently: fail every ticket
                err = SchedulerError(f"decode loop failed: {e}")
                err.__cause__ = e
                with self._cv:
                    self._closed = True
                    fail = self._fail_all_locked()
                    self._cv.notify_all()
                for t in fail:
                    t._finish(error=err)
                return

    def close(self, drain: bool = True, timeout: Optional[float] = None) -> None:
        """Stop accepting work and shut down; idempotent. drain=True
        finishes every admitted and waiting request first; drain=False
        fails them with SchedulerError."""
        with self._cv:
            self._closed = True
            self._drain_on_close = drain
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
        elif drain:
            self.run_until_drained()
        else:
            with self._step_lock, self._cv:
                fail = self._fail_all_locked()
            err = SchedulerError("engine closed without draining")
            for t in fail:
                t._finish(error=err)

    def __enter__(self) -> "ContinuousBatchingEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close(drain=exc == (None, None, None))
