"""Port vs JAX: `ContinuousBatchingEngine` in manual mode on the fp32
phi4-mini SMOKE model with the same (converted) weights. One scripted
workload — staggered admission, mixed prompt lengths and
`max_new_tokens`, a pool small enough for backpressure and skip-ahead,
and repeated retrieved-context prefixes for CoW sharing — runs through
the JAX engine and the port's engine under each memory model: fixed-slot,
paged gather, and paged fused (K3's plain version on the CPU; the JAX
side runs its gather path, its Pallas kernel raises on this JAX version).
Tokens must be identical and `stats()` equal except `paged_kernel`."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import warnings  # noqa: E402

import numpy as np  # noqa: E402
from _torch_parity import converted_models  # noqa: E402

from repro.serving import ContinuousBatchingEngine as JaxEngine  # noqa: E402
from repro.serving import EngineConfig as JaxEngineConfig  # noqa: E402
from repro_torch.serving import ContinuousBatchingEngine, EngineConfig  # noqa: E402
from repro_torch.serving import SchedulerError  # noqa: E402

PAGED = dict(n_slots=3, cache_len=64, paged=True, block_size=8, n_blocks=14,
             prefill_chunk=8, prefix_sharing=True, admit_lookahead=2,
             max_head_skips=2)


@pytest.fixture(scope="module")
def models():
    return converted_models(seed=0)


def _workload(vocab, seed=3):
    """(prompt, max_new_tokens, prefix_len) requests: two retrieved-context
    headers shared by several queries, one long prompt that the small pool
    defers (backpressure, skip-ahead), and short plain prompts."""
    rng = np.random.default_rng(seed)
    hdr = [rng.integers(0, vocab, size=n) for n in (20, 17)]
    def q(n):
        return rng.integers(0, vocab, size=n)
    # three prompt lengths only (25, 22, 44): the JAX fixed-slot engine
    # compiles one prefill per length
    return [
        (np.concatenate([hdr[0], q(5)]), 4, 20),
        (np.concatenate([hdr[0], q(5)]), 3, 20),
        (q(22), 5, None),
        (q(44), 6, None),                      # 50 tokens: 7 of 13 blocks
        (np.concatenate([hdr[1], q(5)]), 6, 17),
        (np.concatenate([hdr[0], q(5)]), 2, 20),
        (q(25), 1, None),
        (np.concatenate([hdr[1], q(5)]), 5, 17),
    ]


def _drive(eng, reqs):
    tickets = [eng.submit(p, max_new_tokens=m, prefix_len=pl,
                          tenant=f"t{i % 2}") for i, (p, m, pl) in enumerate(reqs[:4])]
    eng.step()                                  # staggered admission
    eng.step()
    tickets += [eng.submit(p, max_new_tokens=m, prefix_len=pl,
                           tenant=f"t{i % 2}") for i, (p, m, pl) in enumerate(reqs[4:])]
    eng.run_until_drained()
    return [t.result().tolist() for t in tickets], eng.stats()


_JAX_RUNS: dict = {}


def _jax_run(models, knobs, reqs):
    """The JAX engine's (tokens, stats) on the workload, once per knobs."""
    key = tuple(sorted(knobs.items()))
    if key not in _JAX_RUNS:
        jmodel, params, _ = models
        _JAX_RUNS[key] = _drive(JaxEngine(jmodel, params, JaxEngineConfig(**knobs)), reqs)
    toks, stats = _JAX_RUNS[key]
    return toks, dict(stats)


@pytest.mark.parametrize("mode", ["fixed_slot", "paged_gather", "paged_fused_plain"])
def test_engine_matches_jax(models, mode):
    knobs = dict(n_slots=3, cache_len=64) if mode == "fixed_slot" else dict(PAGED)
    reqs = _workload(models[2].cfg.vocab_size)
    want_toks, want_stats = _jax_run(models, knobs, reqs)
    tknobs = dict(knobs)
    if knobs.get("paged"):
        tknobs["paged_kernel"] = mode == "paged_fused_plain"
    teng = ContinuousBatchingEngine(models[2], EngineConfig(**tknobs), device="cpu")
    got_toks, got_stats = _drive(teng, reqs)
    assert got_toks == want_toks
    assert [len(t) for t in got_toks] == [m for _, m, _ in reqs]
    want_stats.pop("paged_kernel", None)
    kernel = got_stats.pop("paged_kernel", None)
    assert got_stats == want_stats
    if mode != "fixed_slot":
        assert kernel is (mode == "paged_fused_plain")
        pool = got_stats["pool"]
        assert pool["n_prefix_hits"] > 0 and pool["n_cow_copies"] > 0
        assert got_stats["n_backpressure"] > 0 and got_stats["n_skip_ahead"] > 0
        assert pool["free_blocks"] == pool["n_usable_blocks"]


def test_knob_shim_and_config_validation(models):
    tmodel = models[2]
    with pytest.warns(DeprecationWarning, match="per-knob"):
        eng = ContinuousBatchingEngine(tmodel, n_slots=2, cache_len=32, device="cpu")
    assert eng.config == EngineConfig(n_slots=2, cache_len=32)
    with pytest.raises(ValueError, match="not both"):
        ContinuousBatchingEngine(tmodel, EngineConfig(), n_slots=2, device="cpu")
    with pytest.raises(ValueError, match="host_blocks requires"):
        EngineConfig(paged=True, host_blocks=4)
    assert dataclasses.replace(EngineConfig(), n_slots=3) == EngineConfig().replace(n_slots=3)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ContinuousBatchingEngine(tmodel, EngineConfig(paged=True), device="cpu")


def test_submit_refusals_and_close(models):
    tmodel = models[2]
    fixed = ContinuousBatchingEngine(tmodel, EngineConfig(n_slots=1, cache_len=8),
                                     device="cpu")
    with pytest.raises(SchedulerError, match="cache_len"):
        fixed.submit(list(range(6)), max_new_tokens=4)
    paged = ContinuousBatchingEngine(
        tmodel, EngineConfig(n_slots=1, cache_len=16, paged=True, block_size=4,
                             n_blocks=3), device="cpu")
    with pytest.raises(SchedulerError, match="blocks"):
        paged.submit(list(range(8)), max_new_tokens=4)
    t = paged.submit([1, 2, 3], max_new_tokens=2)
    paged.close(drain=False)
    with pytest.raises(SchedulerError, match="without draining"):
        t.result()
    with pytest.raises(SchedulerError, match="closed"):
        paged.submit([1], max_new_tokens=1)


def test_engine_without_device_needs_cuda(models, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ContinuousBatchingEngine(models[2], EngineConfig(paged=True))
