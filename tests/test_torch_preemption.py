"""Port vs JAX: priority preemption in `ContinuousBatchingEngine` on the
fp32 phi4-mini SMOKE model with the same (converted) weights, in manual
mode. A request preempted mid-decode resumes by re-attaching its
published span (retention on) or by a full re-prefill of prompt + emitted
tokens (retention off): in both the tokens and the `n_preemptions` /
`n_resumes` counters equal the JAX engine's, and the tokens equal an
uninterrupted run. `preempt_for_waiting` fires only for a blocked,
strictly higher priority; admission orders by priority within the
skip-ahead window, whose width `set_admit_lookahead` retunes live. The
JAX engine runs its gather path; the port runs its gather path and K3's
plain version."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from _torch_parity import converted_models  # noqa: E402

from repro.serving import ContinuousBatchingEngine as JaxEngine  # noqa: E402
from repro.serving import EngineConfig as JaxEngineConfig  # noqa: E402
from repro_torch.serving import ContinuousBatchingEngine, EngineConfig  # noqa: E402

CFG = dict(n_slots=2, cache_len=40, paged=True, block_size=8, prefill_chunk=8,
           prefix_sharing=True)


@pytest.fixture(scope="module")
def models():
    return converted_models(seed=0)


def _prompts(vocab, seed=11):
    """Four 20-token prompts: a 16-token header (two full blocks, the
    shareable span) + a 4-token query, no two alike."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=20) for _ in range(4)]


def _port(models, paged_kernel=False, **kw):
    return ContinuousBatchingEngine(models[2], EngineConfig(**{**CFG, **kw},
                                                            paged_kernel=paged_kernel),
                                    device="cpu")


def _jax(models, **kw):
    jmodel, params, _ = models
    return JaxEngine(jmodel, params, JaxEngineConfig(**{**CFG, **kw}, paged_kernel=False))


def _preempt_resume(eng, prompt):
    t = eng.submit(prompt, max_new_tokens=12, prefix_len=16)
    for _ in range(6):
        eng.step()             # 3 prefill chunks, then decode
    assert len(t.tokens) >= 3
    assert eng.preempt() is True
    assert t.slot is None and eng.pending() == 1
    eng.run_until_drained()
    st = eng.stats()
    return t.result().tolist(), t.n_preempted, st


def _strip(st):
    st = dict(st)
    st.pop("paged_kernel", None)
    return st


@pytest.mark.parametrize("retain", [8, 0])
def test_preempt_resume_matches_jax(models, retain):
    p = _prompts(models[2].cfg.vocab_size)[0]
    want = _preempt_resume(_jax(models, retain_blocks=retain), p)
    plain = _port(models).submit(p, max_new_tokens=12, prefix_len=16).result().tolist()
    for pk in (False, True):
        got = _preempt_resume(_port(models, pk, retain_blocks=retain), p)
        assert got[0] == want[0] == plain          # as if never interrupted
        assert got[1] == want[1] == 1
        assert _strip(got[2]) == _strip(want[2])
        st = got[2]
        assert st["n_preemptions"] == st["n_resumes"] == 1
        # with retention the resume re-attaches the published span (a
        # device hit), without it the span died with the free: a miss
        assert st["pool"]["n_device_hits"] == (1 if retain else 0)


def test_preempt_noop_cases(models):
    eng = _port(models, retain_blocks=8)
    assert eng.preempt() is False                  # nothing running
    t = eng.submit(_prompts(models[2].cfg.vocab_size)[1], max_new_tokens=4)
    eng.step()                                     # still prefilling
    assert eng.preempt() is False
    eng.run_until_drained()
    assert eng.preempt() is False                  # retired
    assert t.n_preempted == 0 and eng.stats()["n_preemptions"] == 0
    fixed = ContinuousBatchingEngine(models[2], EngineConfig(n_slots=2, cache_len=32),
                                     device="cpu")
    assert fixed.preempt() is False and fixed.preempt_for_waiting() == 0
    fixed.set_admit_lookahead(3)                   # a no-op without the pool
    assert "n_preemptions" not in fixed.stats()


def test_priority_below_shields_equal_priority(models):
    p = _prompts(models[2].cfg.vocab_size)[2]
    eng = _port(models)
    t = eng.submit(p, max_new_tokens=8, priority=2)
    for _ in range(5):
        eng.step()
    assert eng.preempt(priority_below=2) is False  # equal is shielded
    assert eng.preempt(priority_below=3) is True   # strictly lower only
    eng.run_until_drained()
    assert t.result().tolist() == _port(models).submit(p, max_new_tokens=8).result().tolist()


def _pressure(eng, prompts):
    """A priority-0 hog fills the pool; an equal priority waits without
    effect, then a priority-5 arrival preempts the hog."""
    hog = eng.submit(prompts[0], max_new_tokens=16, priority=0)
    for _ in range(4):
        eng.step()
    assert eng.preempt_for_waiting() == 0          # nobody waiting
    same = eng.submit(prompts[1], max_new_tokens=4, priority=0)
    eng.step()
    assert eng.pending() == 1
    fired = [eng.preempt_for_waiting()]            # equal priority: never
    hi = eng.submit(prompts[2], max_new_tokens=4, priority=5)
    eng.step()
    fired.append(eng.preempt_for_waiting())
    assert hog.slot is None and hog.n_preempted == 1
    eng.run_until_drained()
    return fired, [t.result().tolist() for t in (hog, same, hi)], eng.stats()


def test_preempt_for_waiting_under_pressure_matches_jax(models):
    prompts = _prompts(models[2].cfg.vocab_size)
    tight = dict(n_blocks=7, retain_blocks=4)      # 6 usable: one 36-token hog fills 5
    wf, wt, ws = _pressure(_jax(models, **tight), prompts)
    gf, gt, gs = _pressure(_port(models, True, **tight), prompts)
    assert gf == wf == [0, 1]
    assert gt == wt
    assert _strip(gs) == _strip(ws)
    assert gs["n_preemptions"] == gs["n_resumes"] == 1
    plain = _port(models)
    assert gt[0] == plain.submit(prompts[0], max_new_tokens=16).result().tolist()


def test_preempt_for_waiting_without_pressure(models):
    """A free slot and room in the pool: a waiting higher priority admits
    on its own, nothing is preempted."""
    prompts = _prompts(models[2].cfg.vocab_size)
    eng = _port(models, n_slots=3)
    a = eng.submit(prompts[0], max_new_tokens=4)
    eng.step()
    eng.submit(prompts[1], max_new_tokens=4, priority=3)
    assert eng.preempt_for_waiting(max_preemptions=4) == 0
    eng.run_until_drained()
    assert a.n_preempted == 0 and eng.stats()["n_preemptions"] == 0


def _admission_order(eng, prompts):
    eng.submit(prompts[0], max_new_tokens=2).result()   # warm, then back up the queue
    lo = eng.submit(prompts[1], max_new_tokens=2, priority=0)
    hi = eng.submit(prompts[2], max_new_tokens=2, priority=1)
    eng.step()
    first = "hi" if hi.slot is not None else "lo"
    eng.run_until_drained()
    return first, lo.result().tolist(), hi.result().tolist()


def test_priority_admission_and_lookahead_match_jax(models):
    prompts = _prompts(models[2].cfg.vocab_size)
    one = dict(n_slots=1)
    jeng, teng = _jax(models, **one), _port(models, **one)
    want = _admission_order(jeng, prompts)
    got = _admission_order(teng, prompts)
    assert got == want and got[0] == "hi"          # the window [lo, hi]: hi first
    # a window of one: strict FIFO, the head goes first whatever its priority
    for eng in (jeng, teng):
        eng.set_admit_lookahead(0)
        assert eng.admit_lookahead == 0
    assert _admission_order(teng, prompts)[0] == _admission_order(jeng, prompts)[0] == "lo"
    assert _strip(teng.stats()) == _strip(jeng.stats())
    with pytest.raises(ValueError, match="admit_lookahead"):
        teng.set_admit_lookahead(-1)


def test_step_lock_lets_a_waiter_in_between_steps():
    """A thread that re-takes the step lock right after releasing it (the
    engine's background loop) against one waiting for it (the SLO
    controller's actuator): the waiter gets in after at most one hold,
    about once per 5 ms hold. (A plain `threading.Lock` lets the loop win
    the race most of the time: 0-7 acquisitions in the same 0.5 s.)"""
    import threading
    import time

    from repro_torch.serving.continuous_batching import _FifoLock

    lock, stop, entered = _FifoLock(), threading.Event(), threading.Event()

    def loop():
        while not stop.is_set():
            with lock:
                entered.set()
                time.sleep(0.005)

    th = threading.Thread(target=loop)
    th.start()
    try:
        assert entered.wait(5.0)
        got, t0 = 0, time.monotonic()
        while time.monotonic() - t0 < 0.5:
            with lock:
                got += 1
    finally:
        stop.set()
        th.join(5.0)
    assert not th.is_alive() and got >= 10
