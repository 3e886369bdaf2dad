"""Port vs JAX: `GenerationEngine` streaming the prompt through
`decode_step` on the ssm / hybrid / audio families, the port's mirrors
of tests/test_paged_cache.py's slot-resident greedy parity and
tests/test_continuous_batching.py's exact-fit boundary on a Mamba state
tree, and the `RuntimeWarning` on pool knobs that a model without
pageable KV ignores (fp32, smoke size, `_torch_ssm`)."""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import to_torch
from _torch_ssm import ARCHS, drive, models, prompts, workload
from repro.serving import GenerationEngine as JaxGenerationEngine
from repro_torch.serving import (ContinuousBatchingEngine, EngineConfig, GenerationEngine,
                                 SchedulerError)


@pytest.mark.parametrize("arch", ARCHS)
def test_generation_engine_streams_the_prompt(arch):
    jmodel, params, _, tmodel = models(arch)
    toks = prompts(2, 6, tmodel.cfg.vocab_size, seed=11)
    want = JaxGenerationEngine(jmodel, params).generate(jnp.asarray(toks), max_new_tokens=5)
    got = GenerationEngine(tmodel, device="cpu").generate(to_torch(toks), max_new_tokens=5)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_greedy_parity_paged_engine_mamba_slot_resident():
    """Mirror of tests/test_paged_cache.py's test of the same name: under
    paged=True the Mamba state stays slot-resident with chunked admission;
    the tokens equal per-query `generate` (port and JAX)."""
    jmodel, params, _, tmodel = models("mamba2-2.7b")
    rng = np.random.default_rng(5)
    lens, max_news = [4, 13, 2], [4, 3, 5]
    reqs = [rng.integers(0, tmodel.cfg.vocab_size, size=n) for n in lens]
    base = GenerationEngine(tmodel, device="cpu")
    jbase = JaxGenerationEngine(jmodel, params)
    refs = []
    for p, m in zip(reqs, max_news):
        refs.append(base.generate(p[None], max_new_tokens=m, cache_len=24)[0])
        want = jbase.generate(jnp.asarray(p, jnp.int32)[None], max_new_tokens=m, cache_len=24)
        np.testing.assert_array_equal(refs[-1], np.asarray(want)[0])
    eng = ContinuousBatchingEngine(tmodel, EngineConfig(n_slots=2, cache_len=24, paged=True,
                                                        prefill_chunk=4), device="cpu")
    tickets = [eng.submit(p, max_new_tokens=m) for p, m in zip(reqs, max_news)]
    eng.run_until_drained()
    for ref, t in zip(refs, tickets):
        np.testing.assert_array_equal(ref, t.result())
    stats = eng.stats()
    assert "pool" not in stats
    assert stats["n_prefill_chunks"] >= sum(-(-n // 4) for n in lens)


def test_boundary_exact_fit_admits_and_completes_mamba():
    """Mirror of tests/test_continuous_batching.py's test of the same
    name: prompt + max_new == cache_len admits and completes on a Mamba
    state tree; one past it is refused."""
    tmodel = models("mamba2-2.7b")[3]
    cache_len, prompt_len, max_new = 12, 7, 5
    prompt = np.random.default_rng(1).integers(0, tmodel.cfg.vocab_size, size=prompt_len)
    ref = GenerationEngine(tmodel, device="cpu").generate(
        prompt[None], max_new_tokens=max_new, cache_len=cache_len)[0]
    engine = ContinuousBatchingEngine(tmodel, EngineConfig(n_slots=1, cache_len=cache_len),
                                      device="cpu")
    out = engine.submit(prompt, max_new_tokens=max_new).result()
    assert len(out) == max_new
    np.testing.assert_array_equal(out, ref)
    with pytest.raises(SchedulerError, match="cache_len"):
        engine.submit(prompt, max_new_tokens=max_new + 1)


def test_pool_knobs_warn_and_are_ignored():
    """Pool geometry, sharing, retention or the kernel on a model without
    pageable KV: a RuntimeWarning, then the slot-resident engine (no pool,
    no prefix keys); plain chunked admission warns about nothing."""
    tmodel = models("whisper-small")[3]
    for knobs in (dict(block_size=8), dict(n_blocks=9), dict(paged_kernel=True),
                  dict(prefix_sharing=True), dict(retain_blocks=4, host_blocks=8)):
        with pytest.warns(RuntimeWarning, match="no pageable KV cache"):
            eng = ContinuousBatchingEngine(tmodel, EngineConfig(paged=True, **knobs),
                                           device="cpu")
        assert eng._pcm is None and eng.prefix_sharing is False
        assert eng.compute_prefix_key(np.arange(40)) == (None, 0)
        assert not eng.holds_prefix("k")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        eng = ContinuousBatchingEngine(tmodel, EngineConfig(paged=True, prefill_chunk=4),
                                       device="cpu")
    toks, stats = drive(eng, workload(tmodel.cfg.vocab_size)[:3])
    assert [len(t) for t in toks] == [4, 3, 5] and "pool" not in stats
    assert eng.preempt_for_waiting() == 0      # nothing waits
