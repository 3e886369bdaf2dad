"""Port vs JAX: `EngineRouter` (prefix-affinity placement over replicated
engines) on the fp32 phi4-mini SMOKE model with the same (converted)
weights, in manual mode. One scripted submit sequence — two retrieved
contexts, a hot one that overruns the imbalance bound, a second wave
after the fleet drained (retention keeps the holders) and keyless
requests — goes into the JAX router and the port's: the same placements,
the same placement counters (per-replica submits, affinity hits / misses
/ spills), the same tokens and the same `stats()` at every level. Routed
greedy tokens equal one engine's; `resolve_router_config` answers the
same matrix as JAX's; `clear_prefix_cache` fans out to every replica."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from _torch_parity import converted_models  # noqa: E402

from repro.serving import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serving import EngineRouter as JaxRouter  # noqa: E402
from repro.serving import RouterConfig as JaxRouterConfig  # noqa: E402
from repro.serving.config import resolve_router_config as jax_resolve  # noqa: E402
from repro_torch.serving import (ContinuousBatchingEngine, EngineConfig,  # noqa: E402
                                 EngineRouter, RouterConfig, SchedulerError,
                                 resolve_router_config)

CFG = dict(n_slots=2, cache_len=40, paged=True, block_size=8, prefill_chunk=8,
           prefix_sharing=True, retain_blocks=8)
FLEET = dict(n_replicas=2, max_imbalance=1)
# header index per request (None: a short keyless prompt); wave 2 after a drain
WAVE1 = [0, 1, 0, 1, 0, 0, 0]
WAVE2 = [1, 0, None, None]


@pytest.fixture(scope="module")
def models():
    return converted_models(seed=0)


def _requests(vocab, seed=5):
    rng = np.random.default_rng(seed)
    hdr = [rng.integers(0, vocab, size=16) for _ in range(2)]

    def req(h):
        if h is None:
            return rng.integers(0, vocab, size=5), None
        return np.concatenate([hdr[h], rng.integers(0, vocab, size=4)]), 16

    return [req(h) for h in WAVE1], [req(h) for h in WAVE2]


def _drive(router, waves):
    """Both waves, draining in between; (tokens, replicas, stats)."""
    tickets = []
    for wave in waves:
        tickets += [router.submit(p, max_new_tokens=3, prefix_len=pl, tenant="t")
                    for p, pl in wave]
        router.run_until_drained()
    return ([t.result().tolist() for t in tickets], [t.replica for t in tickets],
            router.stats())


_JAX: dict = {}


def _jax_run(models, waves):
    if "run" not in _JAX:
        jmodel, params, _ = models
        router = JaxRouter(jmodel, params, JaxEngineConfig(**CFG, paged_kernel=False),
                           **FLEET)
        _JAX["run"] = _drive(router, waves)
        _JAX["router"] = router
    return _JAX["run"]


def _strip(st):
    st = dict(st, replicas=[dict(r) for r in st["replicas"]])
    for r in st["replicas"]:
        r.pop("paged_kernel")
    return st


@pytest.mark.parametrize("paged_kernel", [False, True])
def test_placement_tokens_and_stats_match_jax(models, paged_kernel):
    waves = _requests(models[2].cfg.vocab_size)
    want = _jax_run(models, waves)
    router = EngineRouter(models[2], EngineConfig(**CFG, paged_kernel=paged_kernel),
                          **FLEET, device="cpu")
    got = _drive(router, waves)
    assert got[0] == want[0]
    assert got[1] == want[1] == [0, 1, 0, 1, 0, 0, 1, 1, 0, 1, 0]
    st = got[2]
    assert _strip(st) == _strip(want[2])
    assert (st["n_affinity_hits"], st["n_affinity_misses"], st["n_affinity_spills"]) \
        == (6, 2, 1)
    assert st["per_replica_submits"] == [6, 5] and st["n_submitted"] == 11
    assert st["fleet"]["n_device_hits"] >= 2       # wave 2 hits the retained tier
    assert all(r["paged_kernel"] is paged_kernel for r in st["replicas"])


def test_stats_keys_match_jax_at_every_level(models):
    waves = _requests(models[2].cfg.vocab_size)
    want = _jax_run(models, waves)[2]
    router = EngineRouter(models[2], EngineConfig(**CFG), n_replicas=2, device="cpu")
    router.submit(*waves[0][0][:1], prefix_len=16, max_new_tokens=2)
    router.run_until_drained()
    st = router.stats()
    assert set(st) == set(want) and set(st["fleet"]) == set(want["fleet"])
    for r, w in zip(st["replicas"], want["replicas"]):
        assert set(r) == set(w) and set(r["pool"]) == set(w["pool"])
    assert [e.replica_id for e in router.engines] == [0, 1]
    assert router.cache_len == router.engines[0].cache_len == 40
    for v in st["fleet"].values():
        assert isinstance(v, (int, float)) and not isinstance(v, bool)


def test_routed_tokens_equal_one_engine(models):
    waves = _requests(models[2].cfg.vocab_size)
    reqs = waves[0] + waves[1]
    single = ContinuousBatchingEngine(models[2], EngineConfig(**CFG), device="cpu")
    want = [single.submit(p, max_new_tokens=3, prefix_len=pl) for p, pl in reqs]
    single.run_until_drained()
    want = [t.result().tolist() for t in want]
    for fleet in (dict(n_replicas=3), dict(n_replicas=2, affinity=False)):
        router = EngineRouter(models[2], EngineConfig(**CFG, paged_kernel=True), **fleet,
                              device="cpu")
        ts = [router.submit(p, max_new_tokens=3, prefix_len=pl) for p, pl in reqs]
        router.run_until_drained()
        assert [t.result().tolist() for t in ts] == want, fleet
        if not fleet.get("affinity", True):
            st = router.stats()
            assert st["n_affinity_hits"] == st["n_affinity_misses"] == 0
            assert [t.replica for t in ts] == [i % 2 for i in range(len(ts))]


def test_rejected_submit_counts_nothing_and_threaded_fleet_closes(models):
    router = EngineRouter(models[2], EngineConfig(**CFG), n_replicas=2, device="cpu")
    too_big = np.arange(1, 40, dtype=np.int32)
    with pytest.raises(SchedulerError, match="blocks"):
        router.submit(too_big, max_new_tokens=8, prefix_len=30)
    st = router.stats()
    assert st["n_submitted"] == 0 and st["per_replica_submits"] == [0, 0]
    assert st["n_affinity_hits"] + st["n_affinity_misses"] + st["n_affinity_spills"] == 0
    waves = _requests(models[2].cfg.vocab_size)
    with EngineRouter(models[2], EngineConfig(**CFG), n_replicas=2, start=True,
                      device="cpu") as threaded:
        ts = [threaded.submit(p, max_new_tokens=2, prefix_len=pl, priority=i % 2)
              for i, (p, pl) in enumerate(waves[0][:4])]
        outs = [t.result(timeout=60.0) for t in ts]
    assert all(len(o) == 2 for o in outs) and [t.priority for t in ts] == [0, 1, 0, 1]
    threaded.close()   # idempotent


def test_clear_prefix_cache_fans_out(models):
    waves = _requests(models[2].cfg.vocab_size)
    router = EngineRouter(models[2], EngineConfig(**CFG), n_replicas=2, affinity=False,
                          device="cpu")
    for p, pl in waves[0][:2]:
        router.submit(p, max_new_tokens=2, prefix_len=pl)
    router.run_until_drained()
    keys = [router.engines[0].compute_prefix_key(p, pl)[0] for p, pl in waves[0][:2]]
    held = [[e.holds_prefix(k) for e in router.engines] for k in keys]
    assert held == [[True, False], [False, True]]  # one context per replica
    assert router.clear_prefix_cache() == 2
    assert not any(e.holds_prefix(k) for e in router.engines for k in keys)
    for r in router.stats()["replicas"]:
        assert r["pool"]["free_blocks"] == r["pool"]["n_usable_blocks"]
    router.set_admit_lookahead(7)
    assert [e.admit_lookahead for e in router.engines] == [7, 7]
    assert router.preempt_for_waiting() == 0 and router.pop_completions() != []


def _outcome(fn, *args):
    try:
        rc = fn(*args)
    except (TypeError, ValueError) as e:
        return type(e).__name__, str(e)
    return rc.n_replicas, rc.affinity, rc.max_imbalance


@pytest.mark.parametrize("case", [
    (None, {}), (None, dict(n_replicas=None, affinity=None)),
    (None, dict(n_replicas=3, affinity=False, max_imbalance=None)),
    (None, dict(n_replicas=2, max_imbalance=0)), ("given", dict(n_replicas=None)),
    ("given", dict(n_replicas=2)), ("dict", {}), (None, dict(n_replicas=0)),
    (None, dict(max_imbalance=-1)), (None, dict(affinity=False, max_imbalance=2)),
])
def test_resolve_router_config_matrix_matches_jax(case):
    kind, legacy = case
    given = {None: (None, None), "given": (JaxRouterConfig(n_replicas=2),
                                           RouterConfig(n_replicas=2)),
             "dict": ({"n_replicas": 2}, {"n_replicas": 2})}[kind]
    want = _outcome(jax_resolve, given[0], dict(legacy))
    got = _outcome(resolve_router_config, given[1], dict(legacy))
    assert got == want
    if kind == "given" and not any(v is not None for v in legacy.values()):
        assert resolve_router_config(given[1], dict(legacy)) is given[1]
