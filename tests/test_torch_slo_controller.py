"""Port vs JAX: the SLO control plane (`SLOController`, `SLOConfig`).

The same completion feed and the same polls on a fake clock drive the JAX
controller (over the JAX `AsyncBatchScheduler`) and the port's (over the
port's scheduler), each with a scripted engine stand-in: every actuator
call (deadline, lookahead, tenant weight, preemption) and every `stats()`
after each poll are equal. The `SLOConfig` validation matrix answers as
JAX's. Wired to real engines on the fp32 phi4-mini SMOKE model, the
controller's preemption frees the pool for a priority-5 request in both
packages, with the same tokens. No sleeps: everything runs on the
injected clock."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from _torch_parity import converted_models  # noqa: E402

from repro.serving import AsyncBatchScheduler as JaxScheduler  # noqa: E402
from repro.serving import ContinuousBatchingEngine as JaxEngine  # noqa: E402
from repro.serving import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serving import SLOConfig as JaxSLOConfig  # noqa: E402
from repro.serving import SLOController as JaxController  # noqa: E402
from repro_torch.serving import (AsyncBatchScheduler, ContinuousBatchingEngine,  # noqa: E402
                                 EngineConfig, EngineRouter, SLOConfig, SLOController)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class ScriptedEngine:
    """Engine stand-in: hands out scripted completion samples and
    preemption results, and logs every actuator call."""

    def __init__(self, feed, preempts, log):
        self.feed, self.preempts, self.log = list(feed), list(preempts), log
        self.admit_lookahead = 4

    def pop_completions(self):
        return self.feed.pop(0) if self.feed else []

    def set_admit_lookahead(self, n):
        self.log.append(("lookahead", n))
        self.admit_lookahead = n

    def preempt_for_waiting(self, n):
        got = self.preempts.pop(0) if self.preempts else 0
        self.log.append(("preempt", n, got))
        return got


def _search(texts, k):
    return np.zeros((len(texts), k), np.int32), np.zeros((len(texts), k), np.float32)


# per poll: (clock advance s, engine samples (finish, tenant, priority, ttft, e2e),
# observe() samples (tenant, ttft, e2e), preemptions the engine reports)
SCRIPT = [
    (0.0, [], [("pro", 0.4, 0.4)], 0),                                     # below min_samples
    (0.1, [(0.1, "pro", 1, 0.3, 0.5), (0.1, "batch", 0, 0.02, 0.04)], [], 1),   # tighten
    (0.2, [(0.3, "pro", 1, 0.3, 0.6)], [], 0),                             # interval holds
    (1.0, [(1.3, "batch", 0, 0.4, 0.9)], [("batch", None, 0.7)], 2),       # tighten again
    (30.0, [(31.3, "pro", 1, 0.001, 0.002)] * 4, [], 0),                   # window aged: relax
    (2.0, [], [("pro", 0.001, 0.001)] * 4, 0),                             # relax
    (2.0, [], [("batch", 0.001, 0.001)] * 4, 1),                           # relax to baselines
    (2.0, [], [], 0),
]


def _drive(Controller, Config, Scheduler):
    clock, log = FakeClock(), []
    sched = Scheduler(_search, max_batch=4, max_wait_ms=40.0, clock=clock)
    sched.set_tenant_weight("batch", 2.0)          # a hand-set weight is a baseline
    eng = ScriptedEngine([s for _, s, _, _ in SCRIPT], [p for *_, p in SCRIPT], log)
    ctrl = Controller(Config(ttft_p95_ms=100.0, e2e_p95_ms=200.0,
                             tenant_e2e_p95_ms={"batch": 400.0}, window_s=20.0,
                             interval_s=1.0, min_samples=2, max_preemptions_per_poll=2),
                      engine=eng, scheduler=sched, clock=clock)
    trace = []
    for dt, _, obs, _ in SCRIPT:
        clock.t += dt
        for tenant, ttft, e2e in obs:
            ctrl.observe(tenant, ttft, e2e)
        acted = ctrl.poll()
        trace.append((acted, ctrl.stats(), sched.max_wait_ms, sched.tenant_weight("pro"),
                      sched.tenant_weight("batch"), list(log)))
    ctrl.close()
    sched.close()
    return trace


def test_controller_matches_jax_on_a_fake_clock():
    want = _drive(JaxController, JaxSLOConfig, JaxScheduler)
    got = _drive(SLOController, SLOConfig, AsyncBatchScheduler)
    assert got == want
    st = got[-1][1]
    assert st["n_tightens"] >= 2 and st["n_relaxes"] >= 1
    assert st["n_preemptions"] == 4 and st["n_weight_updates"] >= 2
    assert got[-1][2] == 40.0 and got[-1][4] == 2.0   # back to the baselines
    assert set(st) == {"n_polls", "n_actuations", "n_tightens", "n_relaxes",
                       "n_preemptions", "n_weight_updates", "n_samples", "worst_ratio",
                       "max_wait_ms", "admit_lookahead", "window_s"}


def _slo_outcome(Config, kw):
    try:
        cfg = Config(**kw)
    except (TypeError, ValueError) as e:
        return type(e).__name__, str(e)
    return sorted((k, v) for k, v in vars(cfg).items() if not isinstance(v, dict))


@pytest.mark.parametrize("kw", [
    {}, dict(ttft_p95_ms=-1.0), dict(e2e_p95_ms=0.0), dict(e2e_p95_ms=10.0),
    dict(tenant_ttft_p95_ms={"a": 5.0}), dict(tenant_e2e_p95_ms={"a": -5.0}),
    dict(tenant_e2e_p95_ms=[("a", 5.0)]), dict(e2e_p95_ms=10.0, relax_ratio=1.5),
    dict(e2e_p95_ms=10.0, wait_step=1.0), dict(e2e_p95_ms=10.0, weight_step=0.5),
    dict(e2e_p95_ms=10.0, window_s=0.0), dict(e2e_p95_ms=10.0, interval_s=-1.0),
    dict(e2e_p95_ms=10.0, min_samples=0), dict(e2e_p95_ms=10.0, min_wait_ms=-1.0),
    dict(e2e_p95_ms=10.0, lookahead_max=-1), dict(e2e_p95_ms=10.0, max_weight=0.0),
    dict(e2e_p95_ms=10.0, max_preemptions_per_poll=-1),
    dict(ttft_p95_ms=5.0, preempt=False, lookahead_max=9),
])
def test_slo_config_matrix_matches_jax(kw):
    assert _slo_outcome(SLOConfig, kw) == _slo_outcome(JaxSLOConfig, kw)


def test_config_replace_and_controller_type_check():
    cfg = SLOConfig(e2e_p95_ms=10.0)
    assert cfg.replace(ttft_p95_ms=5.0).ttft_p95_ms == 5.0 and cfg.ttft_p95_ms is None
    with pytest.raises(TypeError, match="SLOConfig"):
        SLOController(config={"e2e_p95_ms": 10.0})


CFG = dict(n_slots=2, cache_len=40, paged=True, block_size=8, n_blocks=7,
           prefill_chunk=8, prefix_sharing=True, retain_blocks=4)


def _preempt_through_controller(eng, ctrl, prompts):
    big = eng.submit(prompts[0], max_new_tokens=16, priority=0)
    for _ in range(4):
        eng.step()
    hi = eng.submit(prompts[1], max_new_tokens=4, priority=5)
    eng.step()                                     # the pool cannot cover hi
    acted = ctrl.poll()
    n = ctrl.stats()["n_preemptions"]
    eng.run_until_drained()
    return acted, n, big.n_preempted, big.result().tolist(), hi.result().tolist()


def test_controller_preempts_through_the_engine_like_jax():
    jmodel, params, tmodel = converted_models(seed=0)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, tmodel.cfg.vocab_size, size=20) for _ in range(2)]
    jclock, tclock = FakeClock(), FakeClock()
    jeng = JaxEngine(jmodel, params, JaxEngineConfig(**CFG, paged_kernel=False),
                     clock=jclock)
    want = _preempt_through_controller(
        jeng, JaxController(JaxSLOConfig(e2e_p95_ms=10.0), engine=jeng, clock=jclock),
        prompts)
    teng = ContinuousBatchingEngine(tmodel, EngineConfig(**CFG, paged_kernel=True),
                                    clock=tclock, device="cpu")
    got = _preempt_through_controller(
        teng, SLOController(SLOConfig(e2e_p95_ms=10.0), engine=teng, clock=tclock), prompts)
    assert got == want and got[:3] == (1, 1, 1)
    plain = ContinuousBatchingEngine(tmodel, EngineConfig(**CFG), device="cpu")
    assert got[3] == plain.submit(prompts[0], max_new_tokens=16).result().tolist()
    # preempt=False: the controller never touches the engine
    eng = ContinuousBatchingEngine(tmodel, EngineConfig(**CFG), clock=tclock, device="cpu")
    off = SLOController(SLOConfig(e2e_p95_ms=10.0, preempt=False), engine=eng, clock=tclock)
    assert _preempt_through_controller(eng, off, prompts)[:3] == (0, 0, 0)


def test_controller_over_a_fleet_ingests_and_actuates():
    """Over an `EngineRouter`: the merged completion feed is ingested
    (oldest first, each sample once), lookahead is read off replica 0 and
    set on every replica."""
    _, _, tmodel = converted_models(seed=0)
    clock = FakeClock()
    router = EngineRouter(tmodel, EngineConfig(**dict(CFG, n_blocks=None)), n_replicas=2,
                          clock=clock, device="cpu")
    ctrl = SLOController(SLOConfig(e2e_p95_ms=1e-6, min_samples=1, interval_s=1.0),
                         engine=router, clock=clock)
    rng = np.random.default_rng(4)
    for i in range(3):
        router.submit(rng.integers(0, tmodel.cfg.vocab_size, size=10), max_new_tokens=2,
                      tenant=f"t{i}")
    while router.pending() or router.active():
        router.step()
        clock.t += 0.01
    assert ctrl.poll() >= 1                        # far over target: tighten
    st = ctrl.stats()
    assert st["n_samples"] == 3 and st["n_tightens"] == 1
    assert [e.admit_lookahead for e in router.engines] == [5, 5] == [st["admit_lookahead"]] * 2
    assert router.pop_completions() == []
