"""Port vs JAX: the continuous-batching engine over the ssm / hybrid /
audio families, whose decode state is slot-resident — the fixed-slot
`ContinuousBatchingEngine` (the cache tree written into a slot along
each leaf's shape-diffed batch axis) and the slot-resident paged mode
(`paged=True` on a model without pageable KV: chunked admission into a
private b=1 cache, full-width decode, no pool), each against the JAX
engine of the same mode on one scripted workload: tokens and `stats()`
identical, fp32, smoke size (`_torch_ssm`); and preempt / resume
token-identical to the uninterrupted run and to JAX's.
tests/test_torch_slot_resident_generate.py holds the rest of the slice's
serving checks."""
import pytest

from _torch_ssm import ARCHS, FIXED, SLOT_RESIDENT, check_engine, jax_run, models, workload


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", ["fixed_slot", "slot_resident"])
def test_engine_matches_jax(arch, mode):
    toks, stats = check_engine(arch, FIXED if mode == "fixed_slot" else SLOT_RESIDENT)
    assert "pool" not in stats and "prefix_sharing" not in stats
    if mode == "slot_resident":
        # every prompt streams in 4-token pieces, one piece per engine step
        assert stats["n_prefill_chunks"] == sum(-(-len(p) // 4) for p, _ in
                                                workload(models(arch)[3].cfg.vocab_size))


def test_preempt_resume_token_identical():
    """A slot-resident sequence preempted mid-decode re-prefills prompt +
    emitted tokens at b 1 where the uninterrupted run decoded at b 3: the
    same tokens at fp32 (and JAX's preempted run's tokens and stats)."""
    arch = "zamba2-2.7b"
    toks, stats = check_engine(arch, SLOT_RESIDENT, preempt_at=3)
    assert stats["n_preemptions"] == stats["n_resumes"] == 1
    assert toks == jax_run(arch, SLOT_RESIDENT)[0]
