"""Async streaming batch scheduler: dual-trigger flush + multi-tenant DRR.

A copy of `repro.serving.async_scheduler` (numpy and threads only, no
torch): the port keeps its own so it imports nothing of the JAX package.
The behaviour is the reference's line for line.

A pull-based scheduler forms a batch only when a caller blocks on
`ticket.result()` or calls `flush()`. Real edge-RAG traffic is an
open-loop stream of single queries from many users, so the
query-stationary macro would mostly see b=1 batches. `AsyncBatchScheduler`
closes that gap:

* **Dual trigger.** A background flush loop forms a batch as soon as
  `max_batch` tickets are pending OR the OLDEST pending ticket has waited
  `max_wait_ms` — bounded latency at low load, full batches at high load.
* **Futures-based tickets.** `submit()` never blocks and returns an
  `AsyncTicket` with `result(timeout=...)`, `done()`, and
  `add_done_callback(fn)`; no caller has to block for a flush to happen.
* **Multi-tenant fairness.** Each tenant gets its own FIFO submission
  queue; batches are formed by WEIGHTED deficit-round-robin (a tenant
  earns `quantum * weight` credit per visit, deficit reset on empty
  queue, rotation persists across flushes), so one chatty tenant cannot
  starve the others, and a paying tenant with `tenant_weights={"pro":
  2.0}` gets ~2x the saturated throughput of a weight-1 tenant.
* **Graceful close.** `close()` drains in-flight work by default (or
  fails pending tickets with `SchedulerError` when `drain=False`).

The clock is injectable (`clock=`) and the background thread optional
(`start=False`), so deadline behaviour is unit-testable with a fake clock
and zero sleeps: manual mode exposes `poll()` (flush exactly the chunks
that are due) and `flush()` (drain everything now).

Error semantics: a `batch_search` that raises fails
every ticket in the chunk with `SchedulerError` (their `result()` re-raises
it); a manual `flush()` additionally raises the `SchedulerError` itself.
`flush()` on an empty or already-drained queue is a no-op returning 0.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.perf import trace


class SchedulerError(RuntimeError):
    """A ticket could not be served: flush failure or scheduler closed."""


class AsyncTicket:
    """Future-style handle for one queued query.

    Filled in by the scheduler on flush; `wait_s` is the submit->serve
    latency on the scheduler's clock and `flush_seq` the index of the
    flush that served it (both None until done).
    """

    def __init__(
        self, scheduler: "AsyncBatchScheduler", text: str, k: int, tenant: str
    ):
        self._scheduler = scheduler
        self.text = text
        self.k = k
        self.tenant = tenant
        self.submit_time = scheduler._clock()
        self.wait_s: Optional[float] = None
        self.flush_seq: Optional[int] = None
        self.batch_size: Optional[int] = None
        self.doc_ids: Optional[np.ndarray] = None
        self.doc_scores: Optional[np.ndarray] = None
        self._event = threading.Event()
        self._error: Optional[BaseException] = None
        self._callbacks: list = []

    def done(self) -> bool:
        """True once served or failed (result() will not block)."""
        return self._event.is_set()

    def add_done_callback(self, fn: Callable[["AsyncTicket"], None]) -> None:
        """Run `fn(ticket)` when done; immediately if already done."""
        run_now = False
        with self._scheduler._cv:
            if self._event.is_set():
                run_now = True
            else:
                self._callbacks.append(fn)
        if run_now:
            fn(self)

    def result(self, timeout: Optional[float] = None) -> tuple:
        """(doc_ids (k,), doc_scores (k,)) — blocks until served.

        In manual mode (no background thread) an un-served ticket first
        triggers a full `flush()`, preserving the pull-based
        behaviour. Raises `SchedulerError` if the flush failed or could
        not serve this ticket, `TimeoutError` on timeout.
        """
        while not self._event.is_set() and not self._scheduler._has_thread():
            # flush() aborts on the first failing chunk, which may not be
            # ours: keep flushing (each attempt consumes >= 1 chunk, so
            # this terminates) until OUR chunk has run and set the
            # event — then the per-ticket error below carries the cause.
            try:
                progressed = self._scheduler.flush() > 0
            except SchedulerError:
                progressed = True
            if not progressed and not self._event.is_set():
                raise SchedulerError("flush did not serve this ticket")
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"ticket not served within {timeout}s "
                f"(tenant={self.tenant!r}, pending={self._scheduler.pending()})"
            )
        if self._error is not None:
            raise self._error
        return self.doc_ids, self.doc_scores

    # -- internal: called by the scheduler, never under its lock ---------
    def _finish(self, error: Optional[BaseException] = None) -> None:
        # set + swap under the scheduler lock so a concurrent
        # add_done_callback either sees done() and runs immediately or
        # lands in the list we are about to drain — never in between.
        with self._scheduler._cv:
            self._error = error
            self._event.set()
            callbacks, self._callbacks = self._callbacks, []
        for fn in callbacks:
            try:
                fn(self)
            except Exception:  # noqa: BLE001 - callbacks must not kill the loop
                pass


# Back-compat alias: the reference exports the ticket class under this name.
BatchTicket = AsyncTicket

DEFAULT_TENANT = "default"


class AsyncBatchScheduler:
    """Queue queries per tenant; serve them in batched search calls.

    batch_search: fn(texts: list[str], k: int) -> (ids (b, >=k) int,
        scores (b, >=k) fp32). Tickets requesting a smaller k get their
        rows truncated, so mixed-k traffic batches together (the search
        runs at the max k in the chunk).

    max_wait_ms: deadline trigger — flush once the oldest pending ticket
        has waited this long. None disables the deadline (batch-size
        trigger and explicit flush/poll only: the pull-based behaviour).
    quantum: DRR quantum, tickets a tenant may take per round-robin
        visit. 1 == strict per-ticket round robin.
    tenant_weights: per-tenant DRR weight (default 1.0 for tenants not
        listed). A tenant earns `quantum * weight` credit per visit, so
        under saturation its share of every batch is proportional to its
        weight. Fractional weights accumulate as deficit across visits.
        `set_tenant_weight` adjusts weights on a live scheduler.
    clock: monotonic-seconds callable, injectable for deterministic
        deadline tests.
    start: spawn the background flush thread. With start=False the
        scheduler is in *manual mode*: call `poll()` (flush due chunks)
        or `flush()` (drain everything) yourself.
    """

    def __init__(
        self,
        batch_search: Callable[[Sequence[str], int], tuple],
        max_batch: int = 32,
        max_wait_ms: Optional[float] = None,
        quantum: int = 1,
        tenant_weights: Optional[dict] = None,
        clock: Callable[[], float] = time.monotonic,
        start: bool = False,
    ):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if max_wait_ms is not None and max_wait_ms < 0:
            raise ValueError("max_wait_ms must be >= 0 (or None to disable)")
        if quantum < 1:
            raise ValueError("quantum must be >= 1")
        self._weights: dict[str, float] = {}
        for name, w in (tenant_weights or {}).items():
            self._check_weight(w)
            self._weights[name] = float(w)
        self._search = batch_search
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self.quantum = quantum
        self._clock = clock
        self._cv = threading.Condition()
        self._tenants: dict[str, deque] = {}
        self._rr: deque = deque()  # tenant visit order, rotates across flushes
        self._credit: dict[str, float] = {}
        self._pending = 0
        self._closed = False
        self._drain_on_close = True
        self.n_flushes = 0
        self.n_served = 0
        self.n_failed = 0
        self._batch_size_counts: dict[int, int] = {}
        self._thread: Optional[threading.Thread] = None
        if start:
            self._thread = threading.Thread(
                target=self._loop, name="AsyncBatchScheduler", daemon=True
            )
            self._thread.start()

    # ------------------------------------------------------------- submit
    def submit(
        self, text: str, k: int = 3, tenant: str = DEFAULT_TENANT
    ) -> AsyncTicket:
        """Enqueue one query; returns immediately with an AsyncTicket."""
        t = AsyncTicket(self, text, k, tenant)
        with self._cv:
            if self._closed:
                raise SchedulerError("scheduler is closed")
            if tenant not in self._tenants:
                self._tenants[tenant] = deque()
                self._rr.append(tenant)
            self._tenants[tenant].append(t)
            self._pending += 1
            self._cv.notify_all()
        return t

    def pending(self) -> int:
        with self._cv:
            return self._pending

    def tenants(self) -> list[str]:
        """Tenant names in current round-robin visit order."""
        with self._cv:
            return list(self._rr)

    @staticmethod
    def _check_weight(weight) -> None:
        # finite too: an inf credit would blow up int(credit) inside the
        # background flush loop and hang every pending ticket
        if not (weight > 0 and math.isfinite(weight)):
            raise ValueError(f"tenant weight must be finite and > 0, got {weight!r}")

    def set_tenant_weight(self, tenant: str, weight: float) -> None:
        """Set `tenant`'s DRR weight (takes effect from its next visit).

        Taken under the queue lock so the background flush thread never
        sees a half-applied update mid-rotation. The tenant's stored
        deficit is reset with the weight: leftover credit was earned at
        the OLD weight, and letting a demoted tenant spend it would let
        it overdraw its new share for a whole extra round (so the
        documented "from its next visit" contract holds under
        demotion).
        """
        self._check_weight(weight)
        with self._cv:
            self._weights[tenant] = float(weight)
            self._credit.pop(tenant, None)

    def set_max_wait_ms(self, max_wait_ms: Optional[float]) -> None:
        """Retune the deadline trigger on a live scheduler (an SLO
        controller actuator). Taken under the queue lock AND notifying
        the flush thread: without the wake-up a thread parked on
        `wait(None)` (deadline previously disabled) would never observe
        the new deadline until an unrelated submit arrived.
        """
        if max_wait_ms is not None and max_wait_ms < 0:
            raise ValueError("max_wait_ms must be >= 0 (or None to disable)")
        with self._cv:
            self.max_wait_ms = max_wait_ms
            self._cv.notify_all()

    def tenant_weight(self, tenant: str) -> float:
        with self._cv:
            return self._weights.get(tenant, 1.0)

    def batch_size_hist(self) -> dict[int, int]:
        """Achieved batch size -> count, over all flushes so far."""
        with self._cv:
            return dict(sorted(self._batch_size_counts.items()))

    def stats(self) -> dict:
        with self._cv:
            n_flushes, n_served = self.n_flushes, self.n_served
        return {
            "n_flushes": n_flushes,
            "n_served": n_served,
            "n_failed": self.n_failed,
            "mean_batch": n_served / n_flushes if n_flushes else 0.0,
            "batch_hist": self.batch_size_hist(),
        }

    # ------------------------------------------------- trigger + batching
    def _has_thread(self) -> bool:
        return self._thread is not None

    def _oldest_locked(self) -> Optional[AsyncTicket]:
        heads = [q[0] for q in self._tenants.values() if q]
        return min(heads, key=lambda t: t.submit_time) if heads else None

    def _due_locked(self, now: float) -> bool:
        if self._pending == 0:
            return False
        if self._closed or self._pending >= self.max_batch:
            return True
        if self.max_wait_ms is None:
            return False
        oldest = self._oldest_locked()
        return now - oldest.submit_time >= self.max_wait_ms / 1e3

    def _wait_s_locked(self, now: float) -> Optional[float]:
        """Seconds the flush loop may sleep; None == until notified."""
        if self._pending == 0 or self.max_wait_ms is None:
            return None
        oldest = self._oldest_locked()
        return max(self.max_wait_ms / 1e3 - (now - oldest.submit_time), 0.0)

    def _next_chunk_locked(self) -> list:
        """Form one batch by weighted deficit round robin over tenant
        queues.

        Each visit grants `quantum * weight` credit; an emptied queue
        forfeits its deficit and its tenant entry is pruned (re-created
        on the next submit), so state stays bounded by the ACTIVE tenant
        count in a long-lived scheduler. `self._rr` rotation persists
        across calls, so tenants beyond `max_batch` positions are not
        starved by a fixed order.
        """
        chunk: list = []
        while len(chunk) < self.max_batch:
            took_any = False
            for _ in range(len(self._rr)):
                if len(chunk) >= self.max_batch:
                    break
                name = self._rr[0]
                q = self._tenants[name]
                weight = self._weights.get(name, 1.0)
                credit = self._credit.get(name, 0.0) + self.quantum * weight
                take = min(int(credit), len(q), self.max_batch - len(chunk))
                for _ in range(take):
                    chunk.append(q.popleft())
                if q:
                    self._credit[name] = credit - take
                    self._rr.rotate(-1)
                else:
                    # popleft advances the visit pointer just like rotate
                    self._rr.popleft()
                    del self._tenants[name]
                    self._credit.pop(name, None)
                took_any = took_any or take > 0
            if not took_any:
                break
        self._pending -= len(chunk)
        return chunk

    @trace.spanned("sched.flush")
    def _run_chunk(self, chunk: list, raise_errors: bool) -> int:
        """Search one formed chunk and finish its tickets (no lock held)."""
        k = max(t.k for t in chunk)
        try:
            ids, scores = self._search([t.text for t in chunk], k)
        except Exception as e:  # noqa: BLE001 - converted to per-ticket errors
            err = SchedulerError(f"batch search failed for {len(chunk)} tickets: {e}")
            err.__cause__ = e
            with self._cv:
                self.n_failed += len(chunk)
            for t in chunk:
                t._finish(error=err)
            if raise_errors:
                raise err
            return 0
        ids = np.asarray(ids)
        scores = np.asarray(scores)
        now = self._clock()
        with self._cv:
            seq = self.n_flushes
            self.n_flushes += 1
            self.n_served += len(chunk)
            n = len(chunk)
            self._batch_size_counts[n] = self._batch_size_counts.get(n, 0) + 1
        for row, t in enumerate(chunk):
            t.doc_ids = ids[row, : t.k]
            t.doc_scores = scores[row, : t.k]
            t.wait_s = now - t.submit_time
            t.flush_seq = seq
            t.batch_size = len(chunk)
            t._finish()
        return len(chunk)

    # ---------------------------------------------------- manual serving
    def poll(self) -> int:
        """Flush exactly the chunks that are due now; returns #served.

        Deterministic-test entry point (manual mode + fake clock): checks
        the dual trigger against `clock()` and serves due chunks without
        any thread or sleep. A no-op (returns 0) when nothing is due.
        """
        served = 0
        while True:
            with self._cv:
                if not self._due_locked(self._clock()):
                    break
                chunk = self._next_chunk_locked()
            if not chunk:
                break
            served += self._run_chunk(chunk, raise_errors=False)
        return served

    def flush(self) -> int:
        """Drain ALL pending tickets now; returns the number served.

        Empty-queue and repeated flushes are no-ops returning 0. A failing
        `batch_search` fails that chunk's tickets with `SchedulerError`
        and re-raises it here (remaining chunks stay queued).
        """
        served = 0
        while True:
            with self._cv:
                chunk = self._next_chunk_locked()
            if not chunk:
                return served
            served += self._run_chunk(chunk, raise_errors=True)

    # ------------------------------------------------------ flush thread
    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._closed and not self._due_locked(self._clock()):
                    self._cv.wait(self._wait_s_locked(self._clock()))
                if self._closed and (self._pending == 0 or not self._drain_on_close):
                    fail = []
                    if self._pending:
                        for q in self._tenants.values():
                            fail.extend(q)
                            q.clear()
                        self._pending = 0
                        self.n_failed += len(fail)
                    self._cv.notify_all()
                    closing = True
                else:
                    chunk = self._next_chunk_locked()
                    closing = False
            if closing:
                err = SchedulerError("scheduler closed without draining")
                for t in fail:
                    t._finish(error=err)
                return
            if chunk:
                self._run_chunk(chunk, raise_errors=False)

    def close(self, drain: bool = True, timeout: Optional[float] = None) -> None:
        """Stop accepting work and shut down; idempotent.

        drain=True serves every pending ticket first; drain=False fails
        them with `SchedulerError`. In manual mode draining is a direct
        `flush()` on the calling thread.
        """
        with self._cv:
            self._closed = True
            self._drain_on_close = drain
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
        else:
            if drain:
                self.flush()
            else:
                with self._cv:
                    fail = []
                    for q in self._tenants.values():
                        fail.extend(q)
                        q.clear()
                    self._pending = 0
                    self.n_failed += len(fail)
                err = SchedulerError("scheduler closed without draining")
                for t in fail:
                    t._finish(error=err)

    def __enter__(self) -> "AsyncBatchScheduler":
        return self

    def __exit__(self, *exc) -> None:
        self.close(drain=exc == (None, None, None))
