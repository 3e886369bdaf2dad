"""Port vs JAX: the tiered prefix cache of `ContinuousBatchingEngine`
(`retain_blocks`, `host_blocks`) on the fp32 phi4-mini SMOKE model with
the same (converted) weights, in manual mode.

One scripted sequence of requests, each run to completion before the
next, walks every tier transition: a retained prefix serves a hit after
its publisher retired, an attach touches the device LRU, budget eviction
takes the least recently used entry to the host tier, the host budget
drops its own LRU entry, a host hit swaps the parked KV back in, and a
dropped prefix is a plain miss. After every request the tokens, the
engine's `stats()` (pool and tier counters included) and the tier key
orders equal the JAX engine's. The swapped-in blocks hold the bits they
held before they left, and the pools agree with JAX's outside block 0
(allclose: the port's fp32 projections round apart from XLA's).

The JAX engine runs its gather path (its Pallas kernel raises on this JAX
version). Where the JAX allocator raises its swap-in KeyError (a host hit
whose reclaim drops that very key), the JAX run is held up to that
request and expected to raise there; the port serves on."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from _torch_parity import converted_models, to_numpy  # noqa: E402

from repro.serving import ContinuousBatchingEngine as JaxEngine  # noqa: E402
from repro.serving import EngineConfig as JaxEngineConfig  # noqa: E402
from repro_torch.serving import ContinuousBatchingEngine, EngineConfig  # noqa: E402

TOL = dict(rtol=2e-5, atol=1e-5)
# one request at a time; 20-token headers are 3-block entries (the last
# one partial), so the device tier holds two and the host tier one
TIERED = dict(n_slots=1, cache_len=32, paged=True, block_size=8, n_blocks=16,
              prefill_chunk=8, prefix_sharing=True, retain_blocks=6, host_blocks=3)
# (header, query): publish h0, hit it, publish h1, touch h0, publish h2
# (h1 -> host), publish h3 (h0 -> host, the host budget drops h1), hit h0
# from the host (a swap-in; h2 -> host), then h1 again: dropped, a miss
SCRIPT = [(0, 0), (0, 1), (1, 0), (0, 2), (2, 0), (3, 0), (0, 3), (1, 1)]


@pytest.fixture(scope="module")
def models():
    return converted_models(seed=0)


def _prompts(vocab, seed=7):
    rng = np.random.default_rng(seed)
    hdr = [rng.integers(0, vocab, size=20) for _ in range(4)]
    qs = [rng.integers(0, vocab, size=4) for _ in range(4)]
    return hdr, [(np.concatenate([hdr[h], qs[q]]), 20) for h, q in SCRIPT]


def _names(eng, keys, hdr):
    """Tier keys -> header indices (the key is a hash of the header)."""
    by_key = {eng.compute_prefix_key(np.concatenate([h, [0]]), 20)[0]: i
              for i, h in enumerate(hdr)}
    return [by_key[k] for k in keys]


def _walk(eng, reqs, hdr, stop=None):
    """Serve `reqs` one at a time; after each, (tokens, stats, retained
    header order, host header order). Also the KV of h0's blocks just
    before it left for the host tier and just after it came back."""
    trace, kv = [], {}
    key0 = eng.compute_prefix_key(reqs[0][0], 20)[0]
    for i, (p, pl) in enumerate(reqs[:stop]):
        t = eng.submit(p, max_new_tokens=3, prefix_len=pl)
        eng.run_until_drained()
        pcm = eng._pcm
        if key0 in pcm.retained_keys() and i == 4:   # h0's last moment on the device
            kv["before"] = [np.array(to_numpy(x)[:, list(pcm._prefix_index[key0].blocks)])
                            for x in eng._pools]
        if i == 6:                                    # h0 swapped back in
            kv["after"] = [np.array(to_numpy(x)[:, list(pcm._prefix_index[key0].blocks)])
                           for x in eng._pools]
        trace.append((t.result().tolist(), eng.stats(), _names(eng, pcm.retained_keys(), hdr),
                      _names(eng, pcm.host_keys(), hdr)))
    return trace, kv


_JAX: dict = {}


def _jax_walk(models, hdr, reqs):
    if "walk" not in _JAX:
        jmodel, params, _ = models
        eng = JaxEngine(jmodel, params, JaxEngineConfig(**TIERED, paged_kernel=False))
        _JAX["walk"] = _walk(eng, reqs, hdr) + ([np.asarray(x) for x in eng._pools],)
    return _JAX["walk"]


@pytest.mark.parametrize("paged_kernel", [False, True])
def test_tier_walk_matches_jax(models, paged_kernel):
    hdr, reqs = _prompts(models[2].cfg.vocab_size)
    want, want_kv, want_pools = _jax_walk(models, hdr, reqs)
    eng = ContinuousBatchingEngine(models[2], EngineConfig(**TIERED, paged_kernel=paged_kernel),
                                   device="cpu")
    got, kv = _walk(eng, reqs, hdr)
    for step, ((gt, gs, gr, gh), (wt, ws, wr, wh)) in enumerate(zip(got, want)):
        ws = dict(ws)
        assert gs.pop("paged_kernel") is paged_kernel
        ws.pop("paged_kernel")
        assert (gt, gs, gr, gh) == (wt, ws, wr, wh), f"request {step}"
    pools = [st["pool"] for _, st, _, _ in got]
    assert [p["n_device_hits"] for p in pools] == [0, 1, 1, 2, 2, 2, 2, 2]
    assert [p["n_host_hits"] for p in pools] == [0, 0, 0, 0, 0, 0, 1, 1]
    assert [p["n_evictions"] for p in pools][-1] >= 4
    assert [(r, h) for _, _, r, h in got] == [
        ([0], []), ([0], []), ([0, 1], []), ([1, 0], []), ([0, 2], [1]), ([2, 3], [0]),
        ([3, 0], [2]), ([0, 1], [3])]
    # the swap-in restored the bits that left, on both sides
    for a, b in zip(kv["before"], kv["after"]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(want_kv["before"], want_kv["after"]):
        np.testing.assert_array_equal(a, b)
    for t, w in zip(eng._pools, want_pools):
        np.testing.assert_allclose(to_numpy(t)[:, 1:], w[:, 1:], **TOL)
    assert eng.clear_prefix_cache() == 3          # two retained entries, one parked
    pool = eng.stats()["pool"]
    assert pool["free_blocks"] == pool["n_usable_blocks"] and not eng._host_kv
    assert pool["n_host_entries"] == 0 and pool["host_bytes"] == 0


def test_host_tier_callbacks_park_host_tensors(models):
    """`_offload_prefix` parks (L, k, bs, kh, hd) host tensors and returns
    their bytes, which the pool accounts as `host_bytes`; `holds_prefix`
    sees the retained and host tiers; `_drop_host_prefix` forgets."""
    hdr, reqs = _prompts(models[2].cfg.vocab_size)
    eng = ContinuousBatchingEngine(models[2], EngineConfig(**TIERED), device="cpu")
    for p, pl in reqs[:5]:
        eng.submit(p, max_new_tokens=3, prefix_len=pl)
        eng.run_until_drained()
    (key,) = eng._pcm.host_keys()
    k, v = eng._host_kv[key]
    cfg = models[2].cfg
    assert k.device.type == "cpu" and v.shape == k.shape
    assert tuple(k.shape) == (cfg.n_layers, 3, 8, cfg.n_kv_heads, cfg.resolved_head_dim)
    assert eng._pcm.stats()["host_bytes"] == k.nbytes + v.nbytes
    assert eng.holds_prefix(key)                       # the host tier counts
    retained = eng._pcm.retained_keys()
    assert all(eng.holds_prefix(r) for r in retained)  # so does the device tier
    eng._drop_host_prefix(key)
    assert key not in eng._host_kv
    eng._drop_host_prefix(key)                         # idempotent


def test_reference_swapin_keyerror_then_port_serves_on(models):
    """A host hit whose reclaim pushes that very key out of a one-entry
    host tier: the JAX allocator raises KeyError (the reference's fault),
    the port's `reserve` re-checks and serves it as a plain miss. Up to
    that request the two engines agree; past it the port's tokens equal
    an engine without tiers."""
    jmodel, params, tmodel = models
    hdr, _ = _prompts(tmodel.cfg.vocab_size)
    rng = np.random.default_rng(3)
    reqs = [(np.concatenate([hdr[h], rng.integers(0, tmodel.cfg.vocab_size, size=4)]), 20)
            for h in (0, 1, 0)]
    # 8 usable blocks: with one entry pinned (3 blocks and a CoW credit)
    # exactly the 4 a request needs stay free, so admission's check evicts
    # nothing and the swap-in's reclaim (4 + a credit) parks h1, whose
    # host insert drops h0 from the one-entry host tier
    tight = dict(TIERED, n_blocks=9, retain_blocks=3, host_blocks=3)
    jeng = JaxEngine(jmodel, params, JaxEngineConfig(**tight, paged_kernel=False))
    teng = ContinuousBatchingEngine(tmodel, EngineConfig(**tight), device="cpu")
    want, _ = _walk(jeng, reqs, hdr, stop=2)
    got, _ = _walk(teng, reqs, hdr, stop=2)
    for (gt, gs, gr, gh), (wt, ws, wr, wh) in zip(got, want):
        ws, gs = dict(ws), dict(gs)
        ws.pop("paged_kernel"), gs.pop("paged_kernel")
        assert (gt, gs, gr, gh) == (wt, ws, wr, wh)
    assert got[-1][2:] == ([1], [0])                   # h0 parked, h1 retained
    jeng.submit(*reqs[2][:1], max_new_tokens=3, prefix_len=20)
    with pytest.raises(KeyError):
        jeng.run_until_drained()
    t = teng.submit(reqs[2][0], max_new_tokens=3, prefix_len=20)
    teng.run_until_drained()
    pool = teng.stats()["pool"]
    assert pool["n_host_hits"] == 0 and pool["n_prefix_misses"] == 3
    plain = ContinuousBatchingEngine(tmodel, EngineConfig(n_slots=1, cache_len=32, paged=True,
                                                          block_size=8, prefill_chunk=8),
                                     device="cpu")
    assert t.result().tolist() == plain.submit(reqs[2][0], max_new_tokens=3).result().tolist()
