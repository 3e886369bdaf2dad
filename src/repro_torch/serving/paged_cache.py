"""Paged KV-cache memory subsystem for the continuous-batching engine.

A copy of `repro.serving.paged_cache` (numpy only, no torch): the port
keeps its own so it imports nothing of the JAX package. The manager is
the reference's line for line, retention and the host tier included,
with one repair: `reserve` re-checks a host-tier hit after the reclaim
that may have dropped it (the reference raises KeyError there). The
port's engine wires the host-tier callbacks to host tensors
(`ContinuousBatchingEngine._offload_prefix` / `_swapin_prefix`).

The fixed-slot decode engine (`continuous_batching.ContinuousBatchingEngine`
in its default mode) gives every slot a `cache_len`-token region of HBM for
the whole lifetime of its sequence, so a 16-token query and a 900-token
retrieval-augmented prompt cost exactly the same cache memory. RAG traffic
is the worst case for that layout: augmented prompts have wildly bimodal
lengths, and the long tail monopolizes admission. This module is the
vLLM-style answer — one shared pool of fixed-size KV *blocks*, handed out
on demand and returned on retirement, so concurrency is bounded by the
number of tokens actually resident instead of `n_slots * cache_len`.

`PagedCacheManager` is the host-side bookkeeping half of the subsystem:

* **Fixed pool.** `n_blocks` blocks of `block_size` token positions each.
  Physical block 0 is reserved as the *null block*: inactive decode rows
  point every block-table entry at it, so their (masked, ignored) writes
  can never corrupt a live sequence. `n_usable_blocks == n_blocks - 1`.
* **Reservation-based admission.** `reserve(seq, max_tokens)` claims the
  worst-case block budget for a sequence up front (prompt + max new
  tokens). It raises `OutOfBlocks` — the backpressure signal — when the
  pool cannot cover it; the engine leaves the request queued and retries
  at the next token boundary. Because the budget is reserved before
  admission, a running sequence can never hit mid-flight exhaustion.
* **Lazy append.** Physical blocks are taken from the explicit free list
  only as the sequence actually grows (`ensure(seq, n_tokens)`, one
  block at a time — the vLLM "append" operation), so a sequence that
  retires early via EOS hands its untouched budget back immediately.
* **Refcounted prefix sharing.** Every live block carries a
  refcount. A sequence that has materialized the KV of a token prefix
  can publish it under a content hash (`register_prefix(key, seq,
  n_tokens)`); a later `reserve(seq, max_tokens, prefix_key=key)` maps
  the identical prefix onto the SAME physical blocks — refcount++
  instead of allocation, and only the unique suffix draws new blocks.
  The registry is non-owning: an entry lives exactly as long as every
  one of its blocks is still referenced by some live sequence, so a
  fully drained pool always returns to pristine state.
* **Copy-on-write.** The engine calls `prepare_write(seq, start, end)`
  before scattering new K/V into token positions `[start, end)`. Any
  touched block with refcount > 1 is detached: a fresh block is taken
  (funded by the CoW credit the attaching reservation posted for the
  shared partial block), the table entry is swapped, and the (old, new)
  pair is returned so the engine can copy the block device-side.
  Divergent continuations therefore never touch shared KV, and the last
  holder of a block writes in place with no copy at all.
* **Tiered prefix retention.** With `retain_blocks > 0`,
  published prefixes become first-class cache citizens instead of dying
  with their publisher: registration pins the entry's blocks (one
  retention reference each, plus a CoW credit on a partial last block so
  the publisher's own continuation can still diverge safely) and enters
  the entry into a bounded LRU. Retained prefixes outlive every holder —
  edge RAG re-serves the same system prompts and hot document headers
  for hours, not milliseconds — and are reclaimed lazily: when a
  reservation cannot be covered, `reserve`/`can_reserve` evict
  least-recently-used retained prefixes (dropping their pins, freeing
  whatever nobody else still references) BEFORE the `OutOfBlocks`
  backpressure signal fires, so retention never delays a live sequence.
* **Host-RAM tier.** With `host_blocks > 0`, a prefix evicted from the
  device LRU is offloaded instead of discarded: the `on_evict` callback
  (the engine) copies the victim's KV blocks into host numpy staging
  buffers while they are still resident, and the entry moves to a
  second, larger LRU keyed by the same content hash. A later
  `reserve(prefix_key=...)` that misses the device tier but hits the
  host tier reserves fresh device blocks, asks `on_swapin` to scatter
  the saved KV back in, re-pins the entry as device-retained, and then
  attaches it exactly like a device hit — the requester still prefills
  only its unique suffix. The swap is a pure device→host→device byte
  round-trip (bit-identical; property-tested at fp32).
* **Block tables.** `table(seq)` / `tables(seqs)` render the per-sequence
  physical-block lists as dense, null-padded int32 rows — the gather
  indices the paged attention read path in `models/attention.py`
  consumes inside the jitted decode step.

The device-side half — the `(L, n_blocks, block_size, kh, hd)` K/V pools
and the gather/scatter read/write path — lives with the models
(`models/transformer.py` `init_paged_caches`/`paged_step`); the engine
(`continuous_batching.py`) glues the two together, adds chunked prefill
so long prompts stream into the pool in `prefill_chunk`-sized pieces
interleaved with decode, and skips prefill entirely for the shared span
of a prefix hit. The attention gather path is unchanged by sharing:
whether a table row points at private or shared blocks is invisible to
`models/attention.paged_attend`.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, NamedTuple, Optional

import numpy as np

NULL_BLOCK = 0  # physical block reserved for masked/inactive writes


class OutOfBlocks(RuntimeError):
    """Pool cannot cover a reservation — the admission backpressure signal."""


class PrefixEntry(NamedTuple):
    """One published prefix: the physical blocks holding its KV and the
    number of token positions they cover (the last block may be partial
    and may also hold the publisher's private suffix tokens — readers
    mask to their own true length, and writers copy-on-write first)."""

    blocks: tuple
    n_tokens: int


def blocks_for(n_tokens: int, block_size: int) -> int:
    """Blocks needed to hold `n_tokens` token positions."""
    return -(-n_tokens // block_size)


def pow2_at_least(n: int) -> int:
    """Smallest power of two >= n (shape-bucketing for compiled steps)."""
    width = 1
    while width < n:
        width *= 2
    return width


class PagedCacheManager:
    """Refcounted free-list allocator + block tables over a fixed KV pool.

    n_blocks: total physical blocks in the pool, INCLUDING the reserved
        null block; `n_usable_blocks == n_blocks - 1` are allocatable.
    block_size: token positions per block.
    max_blocks_per_seq: width of every rendered block table (the static
        gather shape the jitted decode step compiles against). A sequence
        may never grow past `max_blocks_per_seq * block_size` tokens.

    Sequences are keyed by an opaque hashable id (the engine uses slot
    indices). All methods are plain-Python/numpy and O(blocks touched);
    the manager is driven under the engine's step lock and does no
    locking of its own.

    Accounting model: `_reserved[seq]` is the sequence's NEW-block budget
    (its worst case minus any blocks it attached via a prefix hit) and
    `_n_new[seq]` counts the free-list pops `ensure` made for it. A
    prefix hit on a partially filled last block additionally posts one
    *CoW credit* on that block (`_cow_pot`): the block is certain to be
    diverged on by somebody, and whoever writes it first — publisher or
    attacher — consumes the credit, so copy-on-write can never exhaust
    the pool mid-flight. `free_blocks()` nets all three against the
    physical free list.

    Tiered retention: with `retain_blocks > 0`, `register_prefix`
    additionally *pins* the published entry — one retention reference on
    each of its blocks, tracked in the `_retained` LRU, plus one CoW
    credit when the last block is partial (the retained copy must stay
    divergence-safe even after the publisher retires). Pins are dropped
    by `_reclaim` (LRU-first, under reservation pressure, before
    OutOfBlocks is raised) and by `clear_retained()`. With
    `host_blocks > 0` an evicted entry is handed to `on_evict` for a
    device->host KV copy and parked in the `_host_index` LRU; a host hit
    in `reserve` pops it back via fresh blocks + `on_swapin`. The
    manager only does bookkeeping — the engine owns the actual KV bytes
    through the three callbacks:

      on_evict(key, blocks, n_tokens) -> nbytes   save KV, return size
      on_swapin(key, blocks, n_tokens)            restore KV into blocks
      on_host_drop(key)                           discard saved KV

    NOTE: because `can_reserve`/`reserve` may evict retained prefixes to
    make room, retained entries are best-effort cache state, never
    capacity: a workload that fits the pool without retention still fits
    with it enabled.
    """

    def __init__(
        self,
        n_blocks: int,
        block_size: int,
        max_blocks_per_seq: int,
        *,
        retain_blocks: int = 0,
        host_blocks: int = 0,
        on_evict: Optional[Callable] = None,
        on_swapin: Optional[Callable] = None,
        on_host_drop: Optional[Callable] = None,
    ):
        if n_blocks < 2:
            raise ValueError("n_blocks must be >= 2 (block 0 is reserved)")
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        if max_blocks_per_seq < 1:
            raise ValueError("max_blocks_per_seq must be >= 1")
        if retain_blocks < 0 or host_blocks < 0:
            raise ValueError("retain_blocks/host_blocks must be >= 0")
        if host_blocks and not retain_blocks:
            raise ValueError("host_blocks requires retain_blocks > 0")
        if host_blocks and (on_evict is None or on_swapin is None):
            raise ValueError(
                "host_blocks requires on_evict and on_swapin callbacks"
            )
        self.n_blocks = n_blocks
        self.block_size = block_size
        self.max_blocks_per_seq = max_blocks_per_seq
        self.retain_blocks = retain_blocks
        self.host_blocks = host_blocks
        self._on_evict = on_evict
        self._on_swapin = on_swapin
        self._on_host_drop = on_host_drop
        # LIFO free list of physical ids; block 0 (NULL_BLOCK) is never free
        self._free: list[int] = list(range(n_blocks - 1, NULL_BLOCK, -1))
        self._blocks: dict = {}  # seq id -> [physical block ids]
        self._reserved: dict = {}  # seq id -> new-block budget
        self._n_new: dict = {}  # seq id -> free-list pops made so far
        self._ref: dict[int, int] = {}  # physical id -> live refcount
        self._shared: dict = {}  # seq id -> (n shared blocks, shared tokens)
        self._cow_pot: dict[int, int] = {}  # physical id -> CoW credits
        self._funded: dict = {}  # seq id -> [blocks it posted credits on]
        self._prefix_index: dict = {}  # prefix key -> PrefixEntry
        # retention tier: prefix key -> PrefixEntry, LRU order (oldest
        # first); every block of a retained entry holds one extra ref
        self._retained: OrderedDict = OrderedDict()
        self._retained_credit: dict = {}  # prefix key -> credited block
        # host tier: prefix key -> n_tokens, LRU order (oldest first);
        # the KV bytes themselves live with the on_evict caller
        self._host_index: OrderedDict = OrderedDict()
        self.n_oob_events = 0  # reservation attempts refused (stats)
        self.n_cow_copies = 0  # copy-on-write detachments performed
        self.n_prefix_hits = 0  # reserve(prefix_key=) that attached
        self.n_prefix_misses = 0  # reserve(prefix_key=) that did not
        self.n_device_hits = 0  # attaches served by resident blocks
        self.n_host_hits = 0  # attaches served via host swap-in
        self.n_evictions = 0  # retained entries unpinned under pressure
        self.n_registry_invalidations = 0  # entries killed by a block free
        self.host_bytes = 0  # bytes currently parked in the host tier

    # --------------------------------------------------------------- sizing
    @property
    def n_usable_blocks(self) -> int:
        return self.n_blocks - 1

    @property
    def capacity_tokens(self) -> int:
        """Token positions the pool can hold across all sequences."""
        return self.n_usable_blocks * self.block_size

    @property
    def max_seq_tokens(self) -> int:
        """Token positions one sequence may occupy (table width cap)."""
        return min(self.max_blocks_per_seq, self.n_usable_blocks) * self.block_size

    def blocks_needed(self, n_tokens: int) -> int:
        return blocks_for(n_tokens, self.block_size)

    def free_blocks(self) -> int:
        """Blocks neither allocated nor spoken for by a reservation or an
        outstanding copy-on-write credit."""
        outstanding = sum(self._reserved.values()) - sum(self._n_new.values())
        return len(self._free) - outstanding - sum(self._cow_pot.values())

    def retained_blocks(self) -> int:
        """Blocks currently pinned by the device retention tier."""
        return sum(len(e.blocks) for e in self._retained.values())

    def retained_keys(self) -> list:
        """Device-retained prefix keys, LRU-first."""
        return list(self._retained)

    def host_keys(self) -> list:
        """Host-tier prefix keys, LRU-first."""
        return list(self._host_index)

    def seqs(self) -> list:
        """Live sequence ids (reserved and not yet freed)."""
        return list(self._reserved)

    def __contains__(self, seq) -> bool:
        return seq in self._reserved

    # --------------------------------------------------------- prefix index
    def has_prefix(self, key) -> bool:
        return key in self._prefix_index

    def has_prefix_any(self, key) -> bool:
        """True when `key` is resident in ANY tier: the live registry
        (attachable right now), the device-retained LRU (a registry
        subset, checked for symmetry), or the host-RAM tier (swaps back
        in on reservation). Membership only — does not touch LRU order.
        Three plain `in` checks, so fleet placement (`EngineRouter`)
        can call this from another thread without the step lock."""
        return (key in self._prefix_index
                or key in self._retained
                or key in self._host_index)

    def register_prefix(self, key, seq, n_tokens: int) -> bool:
        """Publish the first `n_tokens` positions of `seq` under `key`.

        The caller guarantees the KV for those positions has been written
        (the engine registers once its prefill cursor passes the span).
        Returns False (and changes nothing) when the key is already
        published; first writer wins. Without retention the entry is
        non-owning and dropped automatically as soon as any of its blocks
        is returned to the free list; with `retain_blocks > 0` the entry
        is additionally pinned into the retained LRU (best-effort — when
        the budget or a needed CoW credit cannot be funded even after
        evicting colder entries, the entry stays non-owning).
        """
        if seq not in self._reserved:
            raise KeyError(f"sequence {seq!r} has no reservation")
        if n_tokens < 1:
            raise ValueError("a prefix must cover at least one token")
        n = self.blocks_needed(n_tokens)
        if n > len(self._blocks[seq]):
            raise ValueError(
                f"prefix of {n_tokens} tokens ({n} blocks) is not yet"
                f" materialized for sequence {seq!r}"
            )
        if key in self._prefix_index:
            return False
        entry = PrefixEntry(tuple(self._blocks[seq][:n]), n_tokens)
        self._prefix_index[key] = entry
        if self.retain_blocks:
            self._try_retain(key, entry)
        return True

    # ------------------------------------------------------- retention tier
    def _try_retain(self, key, entry: PrefixEntry) -> bool:
        """Pin `entry` into the retained LRU (one extra ref per block,
        plus one CoW credit when the last block is partial — the retained
        copy must stay divergence-safe for the still-live publisher).
        Evicts colder retained entries for budget/credit room; returns
        False (entry stays non-owning) when room cannot be made."""
        n = len(entry.blocks)
        if n > self.retain_blocks:
            return False
        while self._retained and self.retained_blocks() + n > self.retain_blocks:
            self._evict_retained(next(iter(self._retained)))
        if self.retained_blocks() + n > self.retain_blocks:
            return False
        if entry.n_tokens % self.block_size:
            while self.free_blocks() < 1 and self._retained:
                self._evict_retained(next(iter(self._retained)))
            if self.free_blocks() < 1:
                return False
            last = entry.blocks[-1]
            self._cow_pot[last] = self._cow_pot.get(last, 0) + 1
            self._retained_credit[key] = last
        for b in entry.blocks:
            self._ref[b] += 1
        self._retained[key] = entry
        if key in self._host_index:
            # the device tier holds the truth again; drop the stale copy
            self._host_drop(key)
        return True

    def _evict_retained(self, key, to_host: bool = True) -> None:
        """Unpin retained entry `key`: offload it to the host tier first
        (when enabled and `to_host`), return its retention CoW credit,
        drop its per-block pins, and free whatever nobody else holds."""
        entry = self._retained.pop(key)
        if to_host:
            self.n_evictions += 1
            if self.host_blocks:
                self._host_insert(key, entry)
        credited = self._retained_credit.pop(key, None)
        if credited is not None:
            self._return_credit(credited)
        freed = []
        for b in reversed(entry.blocks):
            self._ref[b] -= 1
            if self._ref[b] == 0:
                del self._ref[b]
                self._cow_pot.pop(b, None)
                self._free.append(b)
                freed.append(b)
        if freed:
            self._invalidate(freed)

    def _reclaim(self, need: int, keep=None) -> None:
        """Evict retained entries, LRU-first, until `need` blocks are
        free (or nothing evictable remains). `keep` shields the entry a
        reservation is about to attach. Called by both `can_reserve` and
        `reserve` so the two stay exactly consistent — which makes
        `can_reserve` a (documented) mutator under pool pressure:
        retained entries are reclaimable cache, never capacity."""
        while self.free_blocks() < need:
            key = next((k for k in self._retained if k != keep), None)
            if key is None:
                return
            self._evict_retained(key)

    def clear_retained(self) -> int:
        """Drop every retained pin and host-tier entry; returns the
        number of entries dropped across both tiers. Restores the
        non-owning registry semantics exactly (bench warm-up / test isolation)."""
        n = len(self._retained) + len(self._host_index)
        while self._retained:
            self._evict_retained(next(iter(self._retained)), to_host=False)
        while self._host_index:
            self._host_drop(next(iter(self._host_index)))
        return n

    # ------------------------------------------------------------ host tier
    def _host_insert(self, key, entry: PrefixEntry) -> None:
        """Offload `entry` (still device-resident) into the host tier via
        `on_evict`, evicting LRU host entries for budget room."""
        n = len(entry.blocks)
        if n > self.host_blocks:
            return
        while self._host_index and self._host_blocks() + n > self.host_blocks:
            self._host_drop(next(iter(self._host_index)))
        nbytes = int(self._on_evict(key, entry.blocks, entry.n_tokens))
        self._host_index[key] = (entry.n_tokens, n, nbytes)
        self.host_bytes += nbytes

    def _host_drop(self, key) -> None:
        _, _, nbytes = self._host_index.pop(key)
        self.host_bytes -= nbytes
        if self._on_host_drop is not None:
            self._on_host_drop(key)

    def _host_blocks(self) -> int:
        return sum(n for _, n, _ in self._host_index.values())

    def _try_swapin(self, key) -> bool:
        """Bring host-tier prefix `key` back on-device: reserve fresh
        blocks, re-pin them as retained, and ask `on_swapin` to restore
        the saved KV. The host entry is consumed WITHOUT `on_host_drop`
        (the swap-in callback pops its own saved bytes). The caller has
        already verified enough free blocks exist for the swap PLUS the
        attach that motivated it."""
        n_tokens, pb, nbytes = self._host_index[key]
        if pb > self.retain_blocks:
            return False
        # consume the index entry up front so budget evictions below
        # cannot push it out of the host LRU from under us
        del self._host_index[key]
        self.host_bytes -= nbytes
        while self._retained and self.retained_blocks() + pb > self.retain_blocks:
            self._evict_retained(next(iter(self._retained)))
        if self.retained_blocks() + pb > self.retain_blocks or (
            self.free_blocks() < pb
        ):
            self._host_index[key] = (n_tokens, pb, nbytes)
            self.host_bytes += nbytes
            return False
        blocks = []
        for _ in range(pb):
            b = self._free.pop()
            self._ref[b] = 1
            blocks.append(b)
        entry = PrefixEntry(tuple(blocks), n_tokens)
        self._on_swapin(key, entry.blocks, n_tokens)
        self._prefix_index[key] = entry
        self._retained[key] = entry
        return True

    def shared_tokens(self, seq) -> int:
        """Token positions `seq` attached from a published prefix (0 when
        it reserved without a hit)."""
        return self._shared.get(seq, (0, 0))[1]

    def _attachable(self, n_tokens: int, prefix_key) -> Optional[PrefixEntry]:
        """The entry a reservation of `n_tokens` can attach, if any. The
        request must extend past the prefix (the engine always recomputes
        at least the final prompt token to obtain logits)."""
        if prefix_key is None:
            return None
        entry = self._prefix_index.get(prefix_key)
        if entry is not None and n_tokens > entry.n_tokens:
            return entry
        return None

    # ---------------------------------------------------- reserve / release
    def can_reserve(self, n_tokens: int, prefix_key=None) -> bool:
        """Whether `reserve(seq, n_tokens, prefix_key)` would succeed.

        Under pool pressure this MAY evict retained prefixes (LRU-first)
        to make the answer true — retained entries are reclaimable cache,
        and live-sequence admission always outranks them. The eviction
        logic is shared with `reserve`, so a True here is a guarantee. A
        host-tier hit is deliberately priced as a plain miss: `reserve`
        only swaps in when extra headroom exists and otherwise falls back
        to recompute, so `n` fresh blocks is the true bound either way.
        """
        n = self.blocks_needed(n_tokens)
        if n > self.max_blocks_per_seq:
            return False
        entry = self._attachable(n_tokens, prefix_key)
        if entry is None:
            need = n
            self._reclaim(need)
        else:
            credit = 1 if entry.n_tokens % self.block_size else 0
            need = n - len(entry.blocks) + credit
            self._reclaim(need, keep=prefix_key)
        return need <= self.free_blocks()

    def reserve(self, seq, n_tokens: int, prefix_key=None) -> int:
        """Claim a `n_tokens` worst-case budget for `seq`; returns the
        number of NEW blocks budgeted.

        With `prefix_key` published, the identical token prefix is mapped
        onto the same physical blocks (refcount++, no allocation) and
        only the unique suffix is budgeted — plus one copy-on-write
        credit when the last shared block is partially filled, since a
        divergent continuation is certain to detach it. A key that misses
        the device tier but hits the host tier is swapped back in first
        (fresh blocks + `on_swapin`) when enough headroom exists for the
        swap AND the attach; otherwise it degrades to a plain miss.
        Retained prefixes are evicted, LRU-first, before OutOfBlocks is
        raised — retention never delays a live sequence. Raises
        OutOfBlocks when the pool cannot cover the budget right now (the
        caller should queue and retry) and ValueError when the request
        exceeds the per-sequence table width — i.e. could NEVER be
        admitted regardless of load.
        """
        if seq in self._reserved:
            raise ValueError(f"sequence {seq!r} already has a reservation")
        n = self.blocks_needed(n_tokens)
        if n > self.max_blocks_per_seq:
            msg = (
                f"{n_tokens} tokens need {n} blocks but block tables are"
                f" {self.max_blocks_per_seq} wide"
                f" (max_seq_tokens={self.max_seq_tokens})"
            )
            raise ValueError(msg)
        entry = self._attachable(n_tokens, prefix_key)
        from_host = False
        if entry is None and prefix_key is not None:
            hinfo = self._host_index.get(prefix_key)
            if hinfo is not None and n_tokens > hinfo[0]:
                # swap-in is worthwhile only with headroom for the swap
                # (pb blocks) plus the attach (n - pb + credit): n + credit
                hcredit = 1 if hinfo[0] % self.block_size else 0
                self._reclaim(n + hcredit, keep=prefix_key)
                # the reclaim may offload retained prefixes into the host
                # tier, whose LRU can drop this very key to make room: it
                # is then a plain miss (the JAX package raises KeyError)
                if (prefix_key in self._host_index
                        and self.free_blocks() >= n + hcredit
                        and self._try_swapin(prefix_key)):
                    entry = self._prefix_index[prefix_key]
                    from_host = True
        credit = 0
        if entry is None:
            need = n
            self._reclaim(need)
        else:
            credit = 1 if entry.n_tokens % self.block_size else 0
            need = n - len(entry.blocks) + credit
            self._reclaim(need, keep=prefix_key)
        if need > self.free_blocks():
            self.n_oob_events += 1
            if prefix_key is not None:
                self.n_prefix_misses += 1
            msg = (
                f"{n_tokens} tokens need {need} blocks;"
                f" {self.free_blocks()} of {self.n_usable_blocks} free"
            )
            raise OutOfBlocks(msg)
        if entry is None:
            if prefix_key is not None:
                self.n_prefix_misses += 1
            self._reserved[seq] = n
            self._blocks[seq] = []
        else:
            self.n_prefix_hits += 1
            if from_host:
                self.n_host_hits += 1
            else:
                self.n_device_hits += 1
            if prefix_key in self._retained:
                self._retained.move_to_end(prefix_key)  # LRU touch
            self._reserved[seq] = n - len(entry.blocks)
            self._blocks[seq] = list(entry.blocks)
            for b in entry.blocks:
                self._ref[b] += 1
            self._shared[seq] = (len(entry.blocks), entry.n_tokens)
            if credit:
                last = entry.blocks[-1]
                self._cow_pot[last] = self._cow_pot.get(last, 0) + 1
                self._funded.setdefault(seq, []).append(last)
        self._n_new[seq] = 0
        return self._reserved[seq]

    def _return_credit(self, block: int) -> None:
        """Give one CoW credit on `block` back to the pool (clamped: the
        credit may already have been consumed by another holder's copy)."""
        left = self._cow_pot.get(block, 0)
        if left > 1:
            self._cow_pot[block] = left - 1
        elif left:
            del self._cow_pot[block]

    def free(self, seq) -> int:
        """Drop `seq`'s references; returns blocks actually freed.

        A block goes back to the free list only when its last reference
        drops; prefix-registry entries touching a freed block are evicted
        so a fully drained pool is pristine. Unconsumed CoW credits the
        sequence posted are returned.
        """
        if seq not in self._reserved:
            raise KeyError(f"sequence {seq!r} has no reservation")
        blocks = self._blocks.pop(seq)
        freed = []
        for b in reversed(blocks):  # LIFO: reuse hot blocks first
            self._ref[b] -= 1
            if self._ref[b] == 0:
                del self._ref[b]
                self._cow_pot.pop(b, None)
                self._free.append(b)
                freed.append(b)
        del self._reserved[seq]
        del self._n_new[seq]
        self._shared.pop(seq, None)
        for b in self._funded.pop(seq, []):
            self._return_credit(b)
        if freed:
            self._invalidate(freed)
        return len(freed)

    def _invalidate(self, freed) -> None:
        """Sweep prefix-registry entries touching any freed block (their
        KV is gone or about to be overwritten). Retained entries are
        never swept — their pins keep every block referenced. Each kill
        bumps `n_registry_invalidations` so retention-vs-invalidation
        behaviour is observable instead of silent."""
        dead = set(freed)
        stale = [k for k, e in self._prefix_index.items() if dead & set(e.blocks)]
        for k in stale:
            del self._prefix_index[k]
            self.n_registry_invalidations += 1

    # ------------------------------------------------------- allocate/append
    def ensure(self, seq, n_tokens: int) -> list[int]:
        """Grow `seq`'s physical blocks to cover `n_tokens` positions.

        Appends whole blocks from the free list (lazily — only what the
        sequence has actually grown into) and returns the ids appended.
        Guaranteed to succeed within the sequence's reservation; growing
        past it raises ValueError (an engine accounting bug, not load).
        """
        if seq not in self._reserved:
            raise KeyError(f"sequence {seq!r} has no reservation")
        need = self.blocks_needed(n_tokens)
        shared_blocks = self._shared.get(seq, (0, 0))[0]
        if need > shared_blocks + self._reserved[seq]:
            msg = (
                f"sequence {seq!r} grew to {n_tokens} tokens ({need} blocks)"
                f" past its {shared_blocks + self._reserved[seq]}-block"
                f" reservation"
            )
            raise ValueError(msg)
        added = []
        blocks = self._blocks[seq]
        while len(blocks) < need:
            b = self._free.pop()
            self._ref[b] = 1
            self._n_new[seq] += 1
            blocks.append(b)
            added.append(b)
        return added

    def prepare_write(self, seq, start: int, end: int) -> list[tuple[int, int]]:
        """Copy-on-write barrier for a scatter into positions [start, end).

        Every touched block still shared with another sequence (refcount
        > 1) is detached: a fresh block is taken from the free list
        (consuming the block's CoW credit when one is posted), the table
        entry is swapped, and the (old, new) physical pair is appended to
        the returned list — the caller MUST copy old -> new in the device
        pools before scattering. Blocks this sequence holds exclusively
        are written in place (empty return). Call `ensure` first; the
        span must already be covered by the sequence's block list.
        """
        if seq not in self._reserved:
            raise KeyError(f"sequence {seq!r} has no reservation")
        if end <= start:
            return []
        blocks = self._blocks[seq]
        last_bi = (end - 1) // self.block_size
        if last_bi >= len(blocks):
            raise ValueError(
                f"write span [{start}, {end}) of sequence {seq!r} is not"
                f" covered by its {len(blocks)} blocks — call ensure() first"
            )
        pairs = []
        for bi in range(start // self.block_size, last_bi + 1):
            b = blocks[bi]
            if self._ref[b] <= 1:
                continue
            if not self._free:
                raise OutOfBlocks(
                    f"copy-on-write of block {b} for sequence {seq!r} found"
                    " an empty free list (CoW accounting bug)"
                )
            nb = self._free.pop()
            if self._cow_pot.get(b, 0):
                # consume the credit posted for this block's divergence;
                # treat it as this sequence's own even if another holder
                # funded it — credits are fungible per block
                self._return_credit(b)
                funded = self._funded.get(seq)
                if funded and b in funded:
                    funded.remove(b)
            self._ref[nb] = 1
            self._ref[b] -= 1
            blocks[bi] = nb
            self.n_cow_copies += 1
            pairs.append((b, nb))
        return pairs

    def allocated(self, seq) -> list[int]:
        return list(self._blocks[seq])

    # ----------------------------------------------------------- block tables
    def table(self, seq: Optional[object] = None) -> np.ndarray:
        """(max_blocks_per_seq,) int32 row: physical ids, null-padded.

        `seq=None` (or an unknown id) renders the all-null row used for
        free/inactive decode lanes: every entry points at NULL_BLOCK so
        the lane's masked write lands in the scratch block.
        """
        row = np.full((self.max_blocks_per_seq,), NULL_BLOCK, np.int32)
        blocks = self._blocks.get(seq)
        if blocks:
            row[: len(blocks)] = blocks
        return row

    def tables(self, seqs) -> np.ndarray:
        """(len(seqs), max_blocks_per_seq) int32 — one row per entry of
        `seqs`; None/unknown entries render the null row."""
        return np.stack([self.table(s) for s in seqs])

    # ----------------------------------------------------------------- stats
    def stats(self) -> dict:
        """Pool counters. Full schema (all values int/float):

        Geometry / occupancy: `n_usable_blocks`, `block_size`, `n_seqs`,
        `allocated_blocks` (distinct referenced blocks),
        `reserved_blocks` (sum of live worst-case budgets, attached
        prefix blocks included), `free_blocks` (nets reservations and
        CoW credits).

        Admission / sharing: `n_oob_events` (reservations refused),
        `n_shared_blocks` (refcount >= 2 right now), `n_cow_copies`,
        `n_prefix_entries`, `n_prefix_hits` (device + host),
        `n_prefix_misses`, `prefix_hit_rate`, `n_device_hits`,
        `device_hit_rate`, `n_registry_invalidations` (entries killed by
        a block free).

        Retention / host tier: `n_retained`, `n_retained_blocks`,
        `n_evictions` (pressure unpins, `clear_retained()` excluded),
        `n_host_entries`, `n_host_blocks`, `host_bytes`, `n_host_hits`,
        `host_hit_rate`.

        Hit-rate denominators are all `n_prefix_hits + n_prefix_misses`,
        so `prefix_hit_rate == device_hit_rate + host_hit_rate`.
        """
        hits, misses = self.n_prefix_hits, self.n_prefix_misses
        attempts = hits + misses
        return {
            "n_usable_blocks": self.n_usable_blocks,
            "block_size": self.block_size,
            "n_seqs": len(self._reserved),
            "allocated_blocks": len(self._ref),
            "reserved_blocks": sum(self._reserved.values())
            + sum(n for n, _ in self._shared.values()),
            "free_blocks": self.free_blocks(),
            "n_oob_events": self.n_oob_events,
            "n_shared_blocks": sum(1 for r in self._ref.values() if r >= 2),
            "n_cow_copies": self.n_cow_copies,
            "n_prefix_entries": len(self._prefix_index),
            "n_prefix_hits": hits,
            "n_prefix_misses": misses,
            "prefix_hit_rate": hits / attempts if attempts else 0.0,
            "n_device_hits": self.n_device_hits,
            "device_hit_rate": self.n_device_hits / attempts if attempts else 0.0,
            "n_registry_invalidations": self.n_registry_invalidations,
            "n_retained": len(self._retained),
            "n_retained_blocks": self.retained_blocks(),
            "n_evictions": self.n_evictions,
            "n_host_entries": len(self._host_index),
            "n_host_blocks": self._host_blocks(),
            "host_bytes": self.host_bytes,
            "n_host_hits": self.n_host_hits,
            "host_hit_rate": self.n_host_hits / attempts if attempts else 0.0,
        }
