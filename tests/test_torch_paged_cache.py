"""Port vs JAX package: `PagedCacheManager` (the port keeps its own copy of
the numpy-only allocator). Both managers are driven through the same
random operation sequence — reserve (with and without prefix keys),
ensure + prepare_write (the copy-on-write barrier), register_prefix,
free, and the retention / host tiers with their callbacks, plus
clear_retained — and must agree after every operation: return values,
raised exception types, every live block table, the callback log and
`stats()`. The op sequence is the JAX allocator fuzz driver's
(`tests/test_paged_cache.py::_fuzz_round`), so a seed reaches the same
states in both files.

One point differs on purpose: the reference's `reserve` raises KeyError
when the reclaim before a host-tier swap-in drops the very key being
swapped in; the port re-checks and treats it as a miss. There the two
allocators part: the round checks that the port did not raise and that
its block accounting holds, and compares no further."""
import random

import pytest
from _hypothesis_compat import given, settings, st

from repro.serving import paged_cache as J
from repro_torch.serving import paged_cache as T


def _make(mod, log, n_blocks, block_size, width, retain, host):
    tag = mod.__name__.split(".")[0]

    def on_evict(key, blocks, n_tokens):
        log.append((tag, "evict", key, tuple(blocks), n_tokens))
        return 4 * n_tokens

    def on_swapin(key, blocks, n_tokens):
        log.append((tag, "swapin", key, tuple(blocks), n_tokens))

    def on_host_drop(key):
        log.append((tag, "drop", key))

    return mod.PagedCacheManager(
        n_blocks, block_size, width, retain_blocks=retain, host_blocks=host,
        on_evict=on_evict if host else None, on_swapin=on_swapin if host else None,
        on_host_drop=on_host_drop if host else None)


def _call(pcm, name, *args, **kw):
    try:
        return ("ok", getattr(pcm, name)(*args, **kw))
    except (ValueError, KeyError, J.OutOfBlocks, T.OutOfBlocks) as e:
        return ("raise", type(e).__name__)


def _agree(jp, tp, jlog, tlog, seqs):
    assert tp.stats() == jp.stats()
    assert tp.free_blocks() == jp.free_blocks()
    assert [e[1:] for e in tlog] == [e[1:] for e in jlog]
    for sid in seqs:
        assert (tp.table(sid) == jp.table(sid)).all()
        assert tp.shared_tokens(sid) == jp.shared_tokens(sid)
    assert tp.retained_keys() == jp.retained_keys()
    assert tp.host_keys() == jp.host_keys()


def _port_accounting_holds(tp, seqs) -> None:
    """The port's own books balance: every usable block is free or
    referenced, each live table is its allocator view, and draining every
    sequence and both tiers returns the whole pool."""
    assert tp.stats()["free_blocks"] == tp.free_blocks() >= 0
    assert len(set(tp._free)) == len(tp._free)
    assert set(tp._free).isdisjoint(tp._ref)
    assert len(tp._free) + len(tp._ref) == tp.n_usable_blocks
    for sid in seqs:
        row, blocks = tp.table(sid), tp._blocks[sid]
        assert list(row[: len(blocks)]) == blocks
    for sid in sorted(seqs):
        tp.free(sid)
    tp.clear_retained()
    assert tp.free_blocks() == tp.n_usable_blocks


def _round(seed: int, n_ops: int) -> bool:
    """Drive both allocators through one op sequence; False when the
    reference hit its swap-in KeyError and the round stopped there."""
    rng = random.Random(seed)
    block_size = rng.choice([1, 2, 4])
    width = rng.randint(2, 6)
    n_blocks = rng.randint(4, 24)
    retain = rng.choice([0, rng.randint(1, max(1, n_blocks // 2))])
    host = rng.choice([0, rng.randint(1, n_blocks)]) if retain else 0
    jlog, tlog = [], []
    jp = _make(J, jlog, n_blocks, block_size, width, retain, host)
    tp = _make(T, tlog, n_blocks, block_size, width, retain, host)
    keys = [f"k{i}" for i in range(3)]
    seqs: dict = {}   # sid -> {n, cur, key}
    next_sid = 0
    for _ in range(n_ops):
        op = rng.random()
        if op < 0.05 and retain:
            assert tp.clear_retained() == jp.clear_retained()
        elif op < 0.35:
            sid, next_sid = next_sid, next_sid + 1
            n_tok = rng.randint(1, jp.max_seq_tokens + block_size)
            key = rng.choice(keys + [None, None])
            assert tp.can_reserve(n_tok, prefix_key=key) == \
                jp.can_reserve(n_tok, prefix_key=key)
            got = _call(tp, "reserve", sid, n_tok, prefix_key=key)
            want = _call(jp, "reserve", sid, n_tok, prefix_key=key)
            if want == ("raise", "KeyError"):   # the reference's fault
                assert got[0] == "ok" or got == ("raise", "OutOfBlocks"), got
                if got[0] == "ok":
                    seqs[sid] = {}
                _port_accounting_holds(tp, seqs)
                return False
            assert got == want
            if got[0] == "ok":
                shared = jp.shared_tokens(sid)
                seqs[sid] = {"n": n_tok, "cur": shared,
                             "key": key if shared == 0 else None,
                             "published": False}
        elif op < 0.65 and seqs:
            sid = rng.choice(sorted(seqs))
            s = seqs[sid]
            if s["cur"] < s["n"]:
                new_cur = rng.randint(s["cur"] + 1, s["n"])
                assert tp.ensure(sid, new_cur) == jp.ensure(sid, new_cur)
                assert tp.prepare_write(sid, s["cur"], new_cur) == \
                    jp.prepare_write(sid, s["cur"], new_cur)
                s["cur"] = new_cur
        elif op < 0.8 and seqs:
            cands = [i for i, s in sorted(seqs.items())
                     if s["key"] is not None and not s["published"]
                     and s["cur"] >= 1]
            if cands:
                sid = rng.choice(cands)
                n = rng.randint(1, seqs[sid]["cur"])
                got = _call(tp, "register_prefix", seqs[sid]["key"], sid, n)
                assert got == _call(jp, "register_prefix", seqs[sid]["key"], sid, n)
                seqs[sid]["published"] = got == ("ok", True)
        elif seqs:
            sid = rng.choice(sorted(seqs))
            assert tp.free(sid) == jp.free(sid)
            del seqs[sid]
        for key in keys:
            assert tp.has_prefix(key) == jp.has_prefix(key)
            assert tp.has_prefix_any(key) == jp.has_prefix_any(key)
        _agree(jp, tp, jlog, tlog, seqs)
    for sid in sorted(seqs):
        assert tp.free(sid) == jp.free(sid)
    assert tp.clear_retained() == jp.clear_retained()
    _agree(jp, tp, jlog, tlog, {})
    assert tp.stats()["free_blocks"] == tp.n_usable_blocks
    return True


@pytest.mark.parametrize("chunk", range(4))
def test_allocator_differential_seeded(chunk):
    """240 seeded op sequences, split in four cases."""
    for seed in range(chunk * 60, (chunk + 1) * 60):
        _round(seed, 40)


def test_allocator_differential_swapin_keyerror():
    """Seed 25 at 85 ops reaches the reference's swap-in KeyError (the
    JAX fuzz driver fails there); the port serves the reserve and keeps
    its books."""
    assert _round(25, 85) is False


@settings(max_examples=60, deadline=None)
@given(st.integers(min_value=0, max_value=2**32 - 1), st.integers(40, 120))
def test_allocator_differential_hypothesis(seed, n_ops):
    _round(seed, n_ops)


def test_helpers_and_refusals():
    for n, bs in ((1, 4), (4, 4), (5, 4), (16, 4), (0, 3)):
        assert T.blocks_for(n, bs) == J.blocks_for(n, bs)
    for n in (0, 1, 3, 4, 5, 33):
        assert T.pow2_at_least(n) == J.pow2_at_least(n)
    assert T.NULL_BLOCK == J.NULL_BLOCK == 0
    for args, kw in (((1, 4, 2), {}), ((4, 0, 2), {}), ((4, 4, 0), {}),
                     ((4, 4, 2), dict(host_blocks=2)),
                     ((4, 4, 2), dict(retain_blocks=2, host_blocks=2))):
        with pytest.raises(ValueError) as je:
            J.PagedCacheManager(*args, **kw)
        with pytest.raises(ValueError) as te:
            T.PagedCacheManager(*args, **kw)
        assert str(te.value) == str(je.value)
