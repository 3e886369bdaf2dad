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
from repro.core import retrieval as jax_retrieval
from repro.core import sharded_index as jax_sharded
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_config as torch_get_config
from repro_torch.core import error_model as torch_error_model
from repro_torch.core import retrieval as torch_retrieval
from repro_torch.core import sharded_index as torch_sharded
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


def smoke_configs(arch: str = "phi4-mini-3.8b", **overrides):
    """(JAX config, port config) of `arch`'s smoke model in fp32."""
    kw = {"compute_dtype": "float32", **overrides}
    return (dataclasses.replace(jax_get_config(arch, smoke=True), **kw),
            dataclasses.replace(torch_get_config(arch, smoke=True), **kw))


def converted_models(seed: int = 0, arch: str = "phi4-mini-3.8b", **overrides):
    """(JAX model, JAX params, port model on the CPU) with the same weights:
    the JAX init from `jax.random.key(seed)`, converted across."""
    jcfg, tcfg = smoke_configs(arch, **overrides)
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


def retrieval_configs(**kw):
    """(JAX, port) `RetrievalConfig`s from the same fields; `error=` is a
    dict of `ErrorModelConfig` fields."""
    err = kw.pop("error", None) or {}
    return (jax_retrieval.RetrievalConfig(
                error=jax_error_model.ErrorModelConfig(**err), **kw),
            torch_retrieval.RetrievalConfig(
                error=torch_error_model.ErrorModelConfig(**err), **kw))


def sharded_pair(emb, n_shards, drift=None, clock=None, **kw):
    """(JAX, port on the CPU) `ShardedDircIndex` over the same embeddings;
    `drift` is a dict of `DriftConfig` fields, `clock` the shared clock."""
    jcfg, tcfg = retrieval_configs(**kw)
    jd = td = None
    if drift is not None:
        jd = jax_sharded.DriftConfig(**drift)
        td = torch_sharded.DriftConfig(**drift)
    return (jax_sharded.ShardedDircIndex.build(jnp.asarray(emb), jcfg, n_shards=n_shards,
                                               drift=jd, clock=clock),
            torch_sharded.ShardedDircIndex.build(emb, tcfg, n_shards=n_shards, drift=td,
                                                 clock=clock, device="cpu"))


def same_sharded_image(j, t):
    """Assert two sharded indexes hold the same image, bit for bit."""
    assert (t.n_shards, t.capacity, t.dim, t.next_id) == \
        (j.n_shards, j.capacity, j.dim, j.next_id)
    for name in ("values", "scales", "planes", "lut", "norms", "ids", "alive",
                 "flip_probs"):
        np.testing.assert_array_equal(to_numpy(getattr(t, name)),
                                      np.asarray(getattr(j, name)), err_msg=name)
    np.testing.assert_array_equal(t.mapping, j.mapping)
    assert t.n_docs == j.n_docs
    assert t.storage_bytes() == j.storage_bytes()


def same_sharded_search(j, t, queries, k=5, exact=True, key=None, flips=None):
    """Assert a JAX and a port sharded search agree (ids equal; scores
    bit-equal, or allclose where `exact` is False); returns the port's."""
    jres = j.search(jnp.asarray(queries), k=k, key=key)
    tres = t.search(queries, k, flips=flips)
    np.testing.assert_array_equal(to_numpy(tres.indices), np.asarray(jres.indices))
    assert tres.indices.dtype == torch.int32
    if exact:
        np.testing.assert_array_equal(to_numpy(tres.scores), np.asarray(jres.scores))
    else:   # fp32 matmuls summed in another order than XLA's
        np.testing.assert_allclose(to_numpy(tres.scores), np.asarray(jres.scores),
                                   rtol=1e-5, atol=1e-6)
    return tres
