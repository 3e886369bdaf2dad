"""Spans and counters at the boundaries of the port's own layers.

Off by default; `enable()` and `disable()` switch it, and `drain()`
hands back what was recorded and clears it. A site is a block

    with trace.span("engine.piece", ticket.rid):
        ...

or a function's whole call, `@trace.spanned("engine.sample")`. Off, a
site checks one module-level boolean (a `span` then returns a shared
no-op): it reads no clock, allocates nothing and calls nothing of
`torch.profiler`. On, each span is kept as its `Span` object: its name,
start and end on `time.monotonic_ns()` (the clock the serving stack
stamps requests with), its thread (native id and Python ident), its
parent (the span open on the same thread when it began) and the request
id it serves, where it serves one. Spans are host records, not
`torch.profiler.record_function` ranges, which cost ~15 us an enter and
exit with no profiler running. A profiler trace taken beside them places
each kernel in the span that launched it: the CUDA runtime call with the
kernel's correlation id carries the host time and the launching thread,
as its native id or as the low 32 bits of its ident (which CUPTI keeps
for a thread the profiler recorded no CPU op of). Spans read no thread
CPU time: where the thread clock advances in 10-ms ticks (gVisor's
does), it under-reads a busy loop by 4-8% and charges a thread that
sleeps nearly all the time a third of its wall, so no span, however
long, and no sum of spans reads time off the CPU from it.

At most `CAP` spans are kept; the rest are counted under
`trace.dropped`. Counters (`count`) share one lock, as the kernels'
launch counters do; `k3.prefill` counts the K3 calls that take the
prefill path (`kernels.paged_attend.paged_attend_fused`, while on).

The sites, by layer:

| span | where | carries |
| --- | --- | --- |
| `sched.flush` | `AsyncBatchScheduler._run_chunk`: search, then the tickets' callbacks | |
| `rag.embed` | `RagPipeline.search_batch`: the embedder | |
| `rag.search` | `RagPipeline.search_batch`: the index, up to the ids on the host | |
| `rag.prompt` | `RagPipeline.encode_prompt_with_prefix` | |
| `engine.step` | `ContinuousBatchingEngine.step` | |
| `engine.admit` | `_admit_paged` / `_admit` | |
| `engine.piece` | each `_prefill_chunk_once` call, the table it builds included | the ticket's `rid` |
| `engine.decode` | `_decode_once` (a step with no row to decode holds no `engine.forward`) | |
| `engine.forward` | the engine's call into the model (`paged_step` / `decode_step`) and whatever wraps it | |
| `engine.sample` | `_sample`, up to the ids on the host | |
| `model.forward` | `DecoderLM.paged_step`, inputs to logits | |
| `model.moe` | `Block.ffn`'s `apply_moe` | |
"""
from __future__ import annotations

import functools
import itertools
import threading
import time
from typing import Optional

CAP = 1 << 20          # spans kept between drains

ON = False
_LOCK = threading.Lock()
_spans: list = []
_counters: dict = {}
_ids = itertools.count(1)


class _Thread(threading.local):
    """Per thread: the ids of its open spans, and its own ids, read once
    (each read is a system call)."""

    def __init__(self):
        self.stack: list = []
        self.tid = threading.get_native_id()
        self.ident = threading.get_ident()


_local = _Thread()


class _Off:
    """What a span site gets while tracing is off."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> None:
        return None


NOOP = _Off()


class Span:
    """One span: `t0` / `t1` in ns on `time.monotonic_ns()`, `tid` /
    `ident` its thread's native id / `threading.get_ident()`, `parent` the
    enclosing span's `sid` (None at the top of its thread), `rid` the
    request it serves (None: no one request)."""

    __slots__ = ("name", "sid", "parent", "tid", "ident", "t0", "t1", "rid")

    def __init__(self, name: str, rid: Optional[int]):
        self.name, self.rid = name, rid
        self.t1 = None

    def __enter__(self) -> "Span":
        th = _local
        stack = th.stack
        self.parent = stack[-1] if stack else None
        self.sid = next(_ids)
        self.tid, self.ident = th.tid, th.ident
        stack.append(self.sid)
        self.t0 = time.monotonic_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = time.monotonic_ns()
        _local.stack.pop()
        with _LOCK:
            kept = len(_spans) < CAP
            if kept:
                _spans.append(self)
        if not kept:
            count("trace.dropped")


def span(name: str, rid: Optional[int] = None):
    """A context manager around one site: a `Span` while tracing is on,
    the shared no-op `NOOP` while it is off. `rid`: the request the span
    serves."""
    if not ON:
        return NOOP
    return Span(name, rid)


def spanned(name: str):
    """Decorator: each call of the function in a span `name` while
    tracing is on; while it is off, one check and the call itself."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not ON:
                return fn(*args, **kwargs)
            with Span(name, None):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add `n` to counter `name`. It checks no switch: a span's close
    past the cap (`trace.dropped`) runs only where a span was opened while
    tracing was on, and every other site checks `ON` itself."""
    with _LOCK:
        _counters[name] = _counters.get(name, 0) + n


def enable() -> None:
    global ON
    ON = True


def disable() -> None:
    """Stop recording; spans open now are still kept when they close."""
    global ON
    ON = False


def drain() -> tuple[list, dict]:
    """(spans in the order they closed, counters), and clear both."""
    global _spans, _counters
    with _LOCK:
        out = _spans, _counters
        _spans, _counters = [], {}
    return out
