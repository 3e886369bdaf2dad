"""Helpers shared by the PyTorch port's parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; data
crosses between JAX and PyTorch as numpy arrays. JAX stays on the CPU and
its Pallas kernels run in interpret mode, as the JAX tests run them.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.core import error_model as jax_error_model
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_config as torch_get_config
from repro_torch.models import build_model as torch_build_model
from repro_torch.models.convert import params_from_jax

CPU = "cpu"


def to_torch(x, dtype=None) -> torch.Tensor:
    """numpy / JAX array -> CPU tensor (a copy)."""
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def int_codes(rng: np.random.Generator, shape, bits: int = 8) -> np.ndarray:
    """Uniform INT<bits> codes as int8."""
    lo = -(1 << (bits - 1))
    return rng.integers(lo, -lo, size=shape).astype(np.int8)


def unit_rows(rng: np.random.Generator, n: int, dim: int) -> np.ndarray:
    x = rng.normal(size=(n, dim)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def jax_flip_masks(key, probs, shape, max_retries: int, detect: bool) -> list:
    """The JAX sense channel's own flips, one mask per sensing round.

    Replays `error_detection.sense_with_detection`'s key schedule: `k0,
    kloop = split(key)` for the first sense, then one `split` per re-sense
    round; each mask is `apply_sense_errors` on all-zero planes."""
    zeros = jnp.zeros(shape, jnp.uint8)
    probs = jnp.asarray(probs, jnp.float32)
    k0, k = jax.random.split(key)
    masks = [jax_error_model.apply_sense_errors(zeros, probs, k0)]
    for _ in range(max_retries if detect else 0):
        k, sub = jax.random.split(k)
        masks.append(jax_error_model.apply_sense_errors(zeros, probs, sub))
    return [to_torch(m) for m in masks]


def smoke_configs(**overrides):
    """(JAX config, port config) of the phi4-mini smoke model in fp32."""
    kw = dict(compute_dtype="float32", **overrides)
    return (dataclasses.replace(jax_get_config("phi4-mini-3.8b", smoke=True), **kw),
            dataclasses.replace(torch_get_config("phi4-mini-3.8b", smoke=True), **kw))


def converted_models(seed: int = 0, **overrides):
    """(JAX model, JAX params, port model on the CPU) with the same weights:
    the JAX init from `jax.random.key(seed)`, converted across."""
    jcfg, tcfg = smoke_configs(**overrides)
    jmodel = jax_build_model(jcfg)
    params = jmodel.init(jax.random.key(seed))
    tmodel = torch_build_model(tcfg, device=CPU)
    tmodel.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), tcfg))
    return jmodel, params, tmodel


def make_corpus(n: int, seed: int = 0) -> list:
    """The synthetic corpus template of the JAX serving CLI."""
    rng = np.random.default_rng(seed)
    return [f"document {i}: " + " ".join(
        f"w{rng.integers(0, 997)}" for _ in range(12)) for i in range(n)]
