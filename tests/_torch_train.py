"""Helpers shared by the training-path parity tests (tests/test_torch_loss*.py,
tests/test_torch_train*.py, tests/test_torch_optim.py).

Each family's smoke model in fp32, with the JAX init converted across
(`_torch_parity.converted_models`); batches made with numpy from a seed
(labels < 0 included, M-RoPE positions for the VLM, stub frames for the
audio family); the JAX `value_and_grad` and train step jitted once per
arch and cached at module scope.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU, smoke_configs
from repro.models import build_model as jax_build_model
from repro.launch.mesh import make_local_mesh
from repro.launch.steps import build_train_step as jax_build_train_step
from repro.models import sharding as jax_sharding
from repro.optim import adamw as jax_adamw
from repro_torch.launch.steps import build_train_step, loss_and_grads
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import adamw

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while a module runs (restored after): the
    smoke-size ops are tiny, and with several test workers on the host
    torch's thread pools oversubscribe it (a file took 25x its time alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# one config per family (and the untied head)
FAMILY_ARCHS = {"dense": "phi4-mini-3.8b", "moe": "phi3.5-moe-42b-a6.6b",
                "vlm": "qwen2-vl-72b", "ssm": "mamba2-2.7b", "hybrid": "zamba2-2.7b",
                "audio": "whisper-small", "untied": "command-r-plus-104b"}

# the optimizer of the step tests: warm-up inside the 3 steps
JAX_OCFG = jax_adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
OCFG = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)


def batch_np(cfg, b: int = 2, s: int = 32, seed: int = 0) -> dict:
    """A numpy batch for `cfg`'s family; the first 3 labels of row 0 are -1."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)}
    out["labels"][0, :3] = -1
    if cfg.family == "vlm":
        out["positions"] = rng.integers(0, s, size=(3, b, s)).astype(np.int32)
    if cfg.family == "audio":
        e = cfg.encoder
        out["frames"] = rng.normal(size=(b, e.n_frames, e.d_model)).astype(np.float32)
    return out


def to_jax(b: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in b.items()}


def to_port(b: dict) -> dict:
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
            for k, v in b.items()}


@functools.lru_cache(maxsize=None)
def jax_model(arch: str):
    """(JAX model, its params from key 0, the port config, the converted
    state dict), fp32 compute, cached."""
    jcfg, tcfg = smoke_configs(arch)
    jm = jax_build_model(jcfg)
    params = jax.jit(jm.init)(jax.random.key(0))
    return jm, params, tcfg, params_from_jax(jax.tree.map(np.asarray, params), tcfg)


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(arch: str):
    jm = jax_model(arch)[0]
    return jax.jit(jax.value_and_grad(jm.loss, has_aux=True))


def fresh_port_model(arch: str):
    """The arch's fp32 smoke model on the CPU with the converted JAX init."""
    _, _, tcfg, state = jax_model(arch)
    m = build_model(tcfg, device=CPU)
    m.load_state_dict(state)
    return m


def grads_pair(arch: str, b: dict):
    """(JAX loss, JAX grads as port tensors by name, port loss, port grads)
    on the same converted weights and batch."""
    params = jax_model(arch)[1]
    (jl, _), jg = _jax_value_and_grad(arch)(params, to_jax(b))
    tm = fresh_port_model(arch)
    tm.requires_grad_(True)
    tl, tg = loss_and_grads(tm, to_port(b), dict(tm.named_parameters()))
    return float(jl), params_from_jax(jax.tree.map(np.asarray, jg), tm.cfg), float(tl), tg


def assert_grads_close(jg: dict, tg: dict, rel: float) -> None:
    """Every gradient within `rel` of its JAX twin's largest magnitude."""
    assert set(jg) == set(tg)
    for k, g in tg.items():
        scale = float(jg[k].abs().max())
        err = float((g.float() - jg[k].float()).abs().max())
        assert err <= rel * max(scale, 1e-30), (k, err, scale)


def run_steps(arch: str, accum: int, n: int = 3):
    """`n` train steps of the JAX step and the port's from the same
    converted weights over the same batches (b 4 x s 32): (per-step JAX
    metrics, per-step port metrics, JAX params as port tensors, port
    model)."""
    jm, params = jax_model(arch)[:2]
    tm = fresh_port_model(arch)
    mesh = make_local_mesh()
    fn = jax.jit(jax_build_train_step(jm.cfg, mesh, JAX_OCFG, grad_accum=accum).fn)
    jopt = jax_adamw.init(params)
    step = build_train_step(tm.cfg, OCFG, grad_accum=accum)
    topt = adamw.init(dict(tm.named_parameters()))
    jms, tms = [], []
    for i in range(n):
        b = batch_np(tm.cfg, b=4, s=32, seed=100 + i)
        with mesh, jax_sharding.sharding_ctx(mesh):
            params, jopt, jmet = fn(params, jopt, to_jax(b))
        topt, tmet = step(tm, topt, to_port(b))
        jms.append({k: float(v) for k, v in jmet.items()})
        tms.append({k: float(v) for k, v in tmet.items()})
    return jms, tms, params_from_jax(jax.tree.map(np.asarray, params), tm.cfg), tm
