"""Shared checks of the port's `DecoderLM` families against the JAX
package at smoke size in fp32 (tests/test_torch_model_families*.py).

Each model is the JAX init from `jax.random.key(0)` with its norm scales
and biases moved off 1 / 0 (so a misplaced leaf shows), converted across;
the JAX side runs jitted, once per model and shape. Logits agree within
1e-4 (the packages sum in different orders), pools within 1e-5 outside
the NULL block 0. The engine checks hold the port's
`ContinuousBatchingEngine` against the JAX engine of the same memory
model on one scripted workload."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import converted_models, smoke_configs, to_numpy, to_torch
from repro.models import build_model as jax_build_model
from repro.serving import ContinuousBatchingEngine as JaxEngine
from repro.serving import EngineConfig as JaxEngineConfig
from repro_torch.models import build_model
from repro_torch.serving import ContinuousBatchingEngine, EngineConfig
from repro_torch.models.convert import params_from_jax

TOL = dict(atol=1e-4, rtol=1e-4)
POOL_TOL = dict(atol=1e-5, rtol=1e-5)

# features no smoke config has, each on a smoke base (name -> (arch, overrides))
VARIANTS = {
    # LayerNorm, GELU, q/k/v biases, untied head, soft-capped logits, 6 query
    # heads padded to 8 over 2 KV heads, no rotary positions
    "gelu-layernorm-bias-untied-softcap-padded": (
        "phi4-mini-3.8b", dict(norm="layernorm", mlp="gelu", attn_bias=True,
                               tie_embeddings=False, logit_softcap=3.0,
                               pad_attn_heads_to=4, rope_style="none")),
    # a parallel block whose ffn is Arctic's experts + dense residual
    "arctic-parallel": ("arctic-480b", dict(parallel_block=True)),
}

_MODELS: dict = {}


def _randomise(params: dict, seed: int) -> dict:
    """Norm scales and biases away from their 1 / 0 init."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in ("scale", "bq", "bk", "bv"):
                base = 1.0 if k == "scale" else 0.0
                out[k] = jnp.asarray(base + 0.3 * rng.normal(size=v.shape), v.dtype)
            else:
                out[k] = v
        return out

    return walk(params)


def models(name: str):
    """(JAX model, params, jitted prefill / decode / paged step, port model)
    of a smoke arch or a `VARIANTS` entry."""
    if name not in _MODELS:
        arch, over = VARIANTS.get(name, (name, {}))
        jcfg, tcfg = smoke_configs(arch, **over)
        jmodel = jax_build_model(jcfg)
        params = _randomise(jax.jit(jmodel.init)(jax.random.key(0)), seed=1)
        tmodel = build_model(tcfg, device="cpu")
        tmodel.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), tcfg))
        _MODELS[name] = (
            jmodel, params,
            jax.jit(jmodel.prefill, static_argnames=("cache_len",)),
            jax.jit(jmodel.decode_step),
            jax.jit(jmodel.paged_step, static_argnames=("paged_kernel",)),
            tmodel)
    return _MODELS[name]


def prompts(b, s, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, s)).astype(np.int32)


def check_convert(name):
    """Every JAX leaf lands in the port's state dict, bit for bit; an extra
    leaf or an empty place raises."""
    _, params, *_, tmodel = models(name)
    tree = jax.tree.map(np.asarray, params)
    state = params_from_jax(tree, tmodel.cfg)
    assert set(state) == set(tmodel.state_dict())
    for k, v in tmodel.state_dict().items():
        assert torch.equal(state[k], v), k
    bad = dict(tree, extra={"w": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="no place"):
        params_from_jax(bad, tmodel.cfg)
    blocks = dict(tree["blocks"])
    blocks.pop("attn_norm")
    with pytest.raises(ValueError, match="leaves empty"):
        params_from_jax(dict(tree, blocks=blocks), tmodel.cfg)


def check_prefill_decode(name):
    """`prefill` at s = 19 (not a multiple of the smoke attn_chunk 16),
    then 3 `decode_step`s: logits and caches."""
    _, params, jpre, jdec, _, tmodel = models(name)
    vocab = tmodel.cfg.vocab_size
    toks = prompts(2, 19, vocab, seed=2)
    jlog, jc = jpre(params, tokens=jnp.asarray(toks), cache_len=23)
    tlog, tc = tmodel.prefill(to_torch(toks).long(), cache_len=23)
    np.testing.assert_allclose(to_numpy(tlog), np.asarray(jlog), **TOL)
    np.testing.assert_allclose(to_numpy(tc.k), np.asarray(jc.k), **TOL)
    nxt = np.array([[3], [vocab - 1]], np.int32)
    for _ in range(3):
        jlog, jc = jdec(params, jc, jnp.asarray(nxt))
        tlog, tc = tmodel.decode_step(tc, to_torch(nxt).long())
        np.testing.assert_allclose(to_numpy(tlog), np.asarray(jlog), **TOL)
        nxt = np.asarray(jnp.argmax(jlog, -1))[:, None].astype(np.int32)
    np.testing.assert_allclose(to_numpy(tc.v), np.asarray(jc.v), **TOL)
    np.testing.assert_array_equal(to_numpy(tc.length), np.asarray(jc.length))


# a prefill piece (b 2, t 8: 8 and 5 valid), then a decode step at width 4
# with two inactive lanes (all-NULL tables, length 0, n_valid 0)
TABLES = [np.array([[1, 2, 3, 4], [5, 6, 7, 0]], np.int32),
          np.array([[1, 2, 3, 4], [5, 6, 7, 0], [0] * 4, [0] * 4], np.int32)]
STEPS = [(np.array([0, 0], np.int32), np.array([8, 5], np.int32), 8),
         (np.array([8, 5, 0, 0], np.int32), np.array([1, 1, 0, 0], np.int32), 1)]


def paged_run(name, paged_kernel, positions=None):
    """Logits of the valid rows of both steps, port and JAX gather path,
    and the final (port, JAX) pools; `positions(lengths, t)` gives each
    step's position ids (None: the default)."""
    jmodel, params, _, _, jstep, tmodel = models(name)
    rng = np.random.default_rng(5)
    jpools = jmodel.init_paged_caches(9, 4)
    tpools = tmodel.init_paged_caches(9, 4)
    out = []
    for (lengths, nv, t), tables in zip(STEPS, TABLES):
        toks = rng.integers(0, tmodel.cfg.vocab_size, size=(len(nv), t)).astype(np.int32)
        pos = None if positions is None else positions(lengths, t)
        jlog, jpools = jstep(params, jpools, jnp.asarray(tables), jnp.asarray(lengths),
                             jnp.asarray(toks), jnp.asarray(nv),
                             positions=None if pos is None else jnp.asarray(pos),
                             paged_kernel=False)
        tlog, back = tmodel.paged_step(tpools, tables, lengths, toks, nv,
                                       positions=None if pos is None else to_torch(pos),
                                       paged_kernel=paged_kernel)
        assert back.k_pool is tpools.k_pool      # written in place
        rows = nv > 0
        out.append((to_numpy(tlog)[rows], np.asarray(jlog)[rows]))
    return out, (tpools, jpools)


def check_paged(name, paged_kernel):
    """`paged_step` through the gather path or K3's plain version against
    the JAX gather path: logits, and the pools outside block 0."""
    logits, (tp, jp) = paged_run(name, paged_kernel)
    for got, want in logits:
        np.testing.assert_allclose(got, want, **TOL)
    for a, b in ((tp.k_pool, jp.k_pool), (tp.v_pool, jp.v_pool)):
        np.testing.assert_allclose(to_numpy(a)[:, 1:], np.asarray(b)[:, 1:], **POOL_TOL)


# ------------------------------------------------------------ engines
PAGED = dict(n_slots=3, cache_len=48, paged=True, block_size=8, n_blocks=16,
             prefill_chunk=8, prefix_sharing=True)
FIXED = dict(n_slots=3, cache_len=48)

_ENGINE_MODELS: dict = {}
_JAX_RUNS: dict = {}


def _engine_models(arch):
    """`converted_models` of the plain smoke arch (default norm scales)."""
    if arch not in _ENGINE_MODELS:
        _ENGINE_MODELS[arch] = converted_models(seed=0, arch=arch)
    return _ENGINE_MODELS[arch]


def _workload(vocab, seed=3):
    """(prompt, max_new_tokens, prefix_len): a retrieved-context header
    shared by three queries, and plain prompts; two prompt lengths only
    (the JAX fixed-slot engine compiles one prefill per length)."""
    rng = np.random.default_rng(seed)
    hdr = rng.integers(0, vocab, size=14)

    def q(n):
        return rng.integers(0, vocab, size=n)
    return [
        (np.concatenate([hdr, q(5)]), 4, 14),
        (np.concatenate([hdr, q(5)]), 3, 14),
        (q(19), 5, None),
        (q(19), 6, None),
        (np.concatenate([hdr, q(5)]), 2, 14),
    ]


def _drive(eng, reqs):
    tickets = [eng.submit(p, max_new_tokens=m, prefix_len=pl)
               for p, m, pl in reqs[:3]]
    eng.step()                                  # staggered admission
    tickets += [eng.submit(p, max_new_tokens=m, prefix_len=pl) for p, m, pl in reqs[3:]]
    eng.run_until_drained()
    return [t.result().tolist() for t in tickets], eng.stats()


def _jax_run(arch, knobs, reqs):
    key = (arch, tuple(sorted(knobs.items())))
    if key not in _JAX_RUNS:
        jmodel, params, _ = _engine_models(arch)
        _JAX_RUNS[key] = _drive(JaxEngine(jmodel, params, JaxEngineConfig(**knobs)), reqs)
    toks, stats = _JAX_RUNS[key]
    return toks, dict(stats)


def check_engine(arch, mode):
    """The port's engine in `mode` against the JAX engine of the same
    memory model on `_workload`: tokens and `stats()` identical."""
    knobs = dict(FIXED) if mode == "fixed_slot" else dict(PAGED)
    tmodel = _engine_models(arch)[2]
    reqs = _workload(tmodel.cfg.vocab_size)
    want_toks, want_stats = _jax_run(arch, knobs, reqs)
    if knobs.get("paged"):
        knobs["paged_kernel"] = mode == "paged_fused_plain"
    got_toks, got_stats = _drive(
        ContinuousBatchingEngine(tmodel, EngineConfig(**knobs), device="cpu"), reqs)
    assert got_toks == want_toks
    assert [len(t) for t in got_toks] == [m for _, m, _ in reqs]
    want_stats.pop("paged_kernel", None)
    got_stats.pop("paged_kernel", None)
    assert got_stats == want_stats
    if mode != "fixed_slot":
        pool = got_stats["pool"]
        assert pool["n_prefix_hits"] > 0
        assert pool["free_blocks"] == pool["n_usable_blocks"]

