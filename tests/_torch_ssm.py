"""Shared pieces of the port's ssm / hybrid / audio parity tests
(tests/test_torch_model_families_{ssm,audio}.py,
test_torch_slot_resident*.py, test_torch_serve_families.py).

Each smoke model is the JAX init from `jax.random.key(0)` in fp32 with
its norm scales, biases and Mamba2 `D` moved off 1 / 0 (so a misplaced
leaf shows), converted across; the JAX side runs jitted, built once per
model and cached here at module scope, as `_torch_families` does.
Logits agree within 1e-4 (the packages sum in different orders)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_parity import smoke_configs, to_numpy, to_torch
from repro.launch import serve as jserve
from repro.models import build_model as jax_build_model
from repro.serving import ContinuousBatchingEngine as JaxEngine
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import GenerationEngine as JaxGenerationEngine
from repro_torch.device import make_generator
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import ContinuousBatchingEngine, EngineConfig, GenerationEngine

TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ("mamba2-2.7b", "zamba2-2.7b", "whisper-small")
_RANDOMISED = ("scale", "bq", "bk", "bv", "D", "conv_x_b", "conv_B_b", "conv_C_b")

_MODELS: dict = {}
_JAX_RUNS: dict = {}


def _randomise(params: dict, seed: int) -> dict:
    rng = np.random.default_rng(seed)

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in _RANDOMISED:
                base = 1.0 if k in ("scale", "D") else 0.0
                out[k] = jnp.asarray(base + 0.3 * rng.normal(size=v.shape), v.dtype)
            else:
                out[k] = v
        return out

    return walk(params)


def models(arch: str):
    """(JAX model, params, jitted decode_step, port model on the CPU)."""
    if arch not in _MODELS:
        jcfg, tcfg = smoke_configs(arch)
        jmodel = jax_build_model(jcfg)
        params = _randomise(jax.jit(jmodel.init)(jax.random.key(0)), seed=1)
        tmodel = build_model(tcfg, device="cpu")
        tmodel.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), tcfg))
        _MODELS[arch] = (jmodel, params, jax.jit(jmodel.decode_step), tmodel)
    return _MODELS[arch]


def prompts(b, s, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, s)).astype(np.int32)


def check_decode(arch, steps: int = 8, cache_len: int = 16):
    """`init_caches` shapes and dtypes, then `steps` decode steps (the
    first fed from a prompt column, then greedy) from zero caches: logits
    each step and every cache leaf at the end."""
    jmodel, params, jdec, tmodel = models(arch)
    jc = jmodel.init_caches(2, cache_len, 0)
    tc = tmodel.init_caches(2, cache_len, 0)
    jl, tl = jax.tree.leaves(jc), _leaves(tc)
    assert [tuple(t.shape) for t in tl] == [j.shape for j in jl]
    assert [str(t.dtype).removeprefix("torch.") for t in tl] == [str(j.dtype) for j in jl]
    nxt = prompts(2, 1, tmodel.cfg.vocab_size, seed=2)
    for _ in range(steps):
        jlog, jc = jdec(params, jc, jnp.asarray(nxt))
        tlog, tc = tmodel.decode_step(tc, to_torch(nxt).long())
        np.testing.assert_allclose(to_numpy(tlog), np.asarray(jlog), **TOL)
        nxt = np.asarray(jnp.argmax(jlog, -1))[:, None].astype(np.int32)
    for t, j in zip(_leaves(tc), jax.tree.leaves(jc)):
        np.testing.assert_allclose(to_numpy(t), np.asarray(j), **TOL)


def _leaves(tree) -> list:
    if hasattr(tree, "shape"):
        return [tree]
    return [leaf for sub in tree for leaf in _leaves(sub)]


# ------------------------------------------------------------ engines
# prompts of several lengths (streamed token by token, so no shape is
# compiled per length), staggered admission, more requests than slots
WORKLOAD = [(9, 4), (14, 3), (5, 5), (19, 6), (11, 2)]
FIXED = dict(n_slots=3, cache_len=32)
SLOT_RESIDENT = dict(n_slots=3, cache_len=32, paged=True, prefill_chunk=4)


def workload(vocab: int, seed: int = 3):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, size=n), m) for n, m in WORKLOAD]


def drive(eng, reqs, preempt_at=None):
    """Submit 3 requests, step once, submit the rest, drain; with
    `preempt_at` = k, `preempt()` once after k more steps. Returns the
    tokens and `stats()`."""
    tickets = [eng.submit(p, max_new_tokens=m) for p, m in reqs[:3]]
    eng.step()
    tickets += [eng.submit(p, max_new_tokens=m) for p, m in reqs[3:]]
    if preempt_at is not None:
        for _ in range(preempt_at):
            eng.step()
        assert eng.preempt()
    eng.run_until_drained()
    return [t.result().tolist() for t in tickets], eng.stats()


def jax_run(arch, knobs: dict, preempt_at=None):
    key = (arch, tuple(sorted(knobs.items())), preempt_at)
    if key not in _JAX_RUNS:
        jmodel, params, _, tmodel = models(arch)
        _JAX_RUNS[key] = drive(JaxEngine(jmodel, params, JaxEngineConfig(**knobs)),
                               workload(tmodel.cfg.vocab_size), preempt_at)
    toks, stats = _JAX_RUNS[key]
    return toks, dict(stats)


def check_engine(arch, knobs: dict, preempt_at=None):
    """The port's engine against the JAX engine of the same memory model:
    tokens and `stats()` identical."""
    tmodel = models(arch)[3]
    want_toks, want_stats = jax_run(arch, knobs, preempt_at)
    got_toks, got_stats = drive(
        ContinuousBatchingEngine(tmodel, EngineConfig(**knobs), device="cpu"),
        workload(tmodel.cfg.vocab_size), preempt_at)
    assert got_toks == want_toks
    assert [len(t) for t in got_toks] == [m for _, m in WORKLOAD]
    assert got_stats == want_stats
    return got_toks, got_stats


# ------------------------------------------------------------ drivers
def check_serve(arch, monkeypatch, batch=2, prompt_len=6, new_tokens=4, seed=0):
    """`launch.serve.serve(arch)` over the converted smoke model against the
    JAX `GenerationEngine` with the same weights on the same prompts (the
    driver's seeded `torch.randint` prompts): tokens equal."""
    jmodel, params, _, tmodel = models(arch)
    with monkeypatch.context() as m:
        m.setattr(tserve, "_seeded_model", lambda *a: tmodel)
        out = tserve.serve(arch, batch=batch, prompt_len=prompt_len,
                           new_tokens=new_tokens, seed=seed, device="cpu")
    cpu = torch.device("cpu")
    toks = torch.randint(0, tmodel.cfg.vocab_size, (batch, prompt_len),
                         generator=make_generator(cpu, seed + 1), device=cpu)
    want = JaxGenerationEngine(jmodel, params).generate(
        jnp.asarray(toks.numpy().astype(np.int32)), max_new_tokens=new_tokens,
        cache_len=prompt_len + new_tokens)
    np.testing.assert_array_equal(out["tokens"], np.asarray(want))
    assert out["tokens"].shape == (batch, new_tokens)


def converted_pipelines(arch, **size):
    """(JAX pipeline, port pipeline) of `launch.serve.build_rag_pipeline`
    over the same corpus, each with `arch`'s converted smoke model (the
    port's built with `arch=`, its seeded model then swapped for it)."""
    jmodel, params, _, tmodel = models(arch)
    tpipe = tserve.build_rag_pipeline(**size, arch=arch, device="cpu")
    assert type(tpipe.engine.model) is type(tmodel)
    assert tpipe.engine.model.cfg.name == f"{arch}-smoke"
    tpipe.engine = GenerationEngine(tmodel, device="cpu")
    jpipe = jserve.build_rag_pipeline(**size)
    jpipe.engine = JaxGenerationEngine(jmodel, params)
    return jpipe, tpipe
