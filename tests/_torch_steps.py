"""Shared pieces of the port's inference-step tests
(tests/test_torch_steps*.py): the cells at smoke size, seeded weights
and inputs, and the reference's own steps (`repro.launch.steps.
lower_cell`) on a mesh of Auto axes.

The reference's `make_local_mesh` builds Explicit axes, on which its
serve and prefill steps raise `ShardingTypeError` at the embedding
gather under JAX 0.9.0 (ROADMAP §3), so the tests build the mesh with
`jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) *
2)`. Each model is the JAX init from `jax.random.key(0)` with its norm
scales, biases and Mamba2 `D` moved off 1 / 0, converted across."""
from __future__ import annotations

import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import AxisType

from repro.configs import ShapeConfig as JaxShape
from repro.configs import get_config as jax_get_config
from repro.launch import steps as jax_steps
from repro.models import build_model as jax_build_model
from repro.models import cache_specs as jax_cache_specs
from repro.models import sharding as jax_sh
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.models.convert import params_from_jax

TOL = dict(atol=1e-4, rtol=1e-4)       # logits, as test_torch_model_families*.py
CACHE_TOL = dict(atol=1e-5, rtol=1e-5)  # caches, as those files' pools
BF16 = dict(atol=2e-2, rtol=2e-2)       # bf16, as test_torch_moe.py
_RANDOMISED = ("scale", "bq", "bk", "bv", "D", "conv_x_b", "conv_B_b", "conv_C_b")

SEQ, DECODE_B, PREFILL_B = 16, 4, 2
NAMES = {"decode": "decode_32k", "prefill": "prefill_32k", "train": "train_4k"}


def cell(kind: str, seq: int = SEQ, batch=None) -> ShapeConfig:
    """A cell of `kind` at smoke size, under the name of its full cell."""
    b = batch or {"decode": DECODE_B}.get(kind, PREFILL_B)
    return ShapeConfig(NAMES[kind], seq, b, kind)


def configs(arch: str, dtype: str = "float32"):
    """(JAX config, port config) of `arch`'s smoke model in `dtype`."""
    kw = {"compute_dtype": dtype}
    return (dataclasses.replace(jax_get_config(arch, smoke=True), **kw),
            dataclasses.replace(get_config(arch, smoke=True), **kw))


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


@functools.lru_cache(maxsize=None)
def weights(arch: str):
    """(JAX params, port state dict as numpy) of the same weights. The
    smoke configs keep fp32 params whatever their compute dtype, so the
    bf16 checks load these too."""
    jcfg, tcfg = configs(arch)
    params = _randomise(jax.jit(jax_build_model(jcfg).init)(jax.random.key(0)), seed=1)
    state = params_from_jax(jax.tree.map(np.asarray, params), tcfg)
    return params, {k: v.numpy() for k, v in state.items()}


def flat(tree) -> dict:
    """A JAX pytree's leaves by path string (`sharding._path_str`)."""
    return {jax_sh._path_str(p): v for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def decode_inputs(jcfg, shape: ShapeConfig, lengths, seed: int = 0):
    """(cache leaves by path as numpy, token (b, 1)): seeded normal K/V and
    states in the cache dtypes, `lengths` as the rows' lengths."""
    rng = np.random.default_rng(seed)
    spec = flat(jax_cache_specs(jcfg, JaxShape(shape.name, shape.seq_len,
                                               shape.global_batch, "decode")))
    leaves = {}
    for path, s in spec.items():
        if path == "length":
            leaves[path] = np.asarray(lengths, np.int32)
        else:
            leaves[path] = np.asarray(jnp.asarray(rng.normal(size=s.shape), s.dtype))
    return leaves, rng.integers(0, jcfg.vocab_size, (shape.global_batch, 1)).astype(np.int32)


def prefill_inputs(jcfg, shape: ShapeConfig, seed: int = 0) -> dict:
    """A seeded prefill batch: tokens, and `frames` (audio) or M-RoPE
    `positions` (vlm)."""
    rng = np.random.default_rng(seed)
    b, s = shape.global_batch, shape.seq_len
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (b, s)).astype(np.int32)}
    if jcfg.family == "audio":
        e = jcfg.encoder
        batch["frames"] = np.asarray(jnp.asarray(rng.normal(size=(b, e.n_frames, e.d_model)),
                                                 jcfg.compute_dtype))
    if jcfg.family == "vlm":
        batch["positions"] = rng.integers(0, s, (3, b, s)).astype(np.int32)
    return batch


def auto_mesh(shape=(1, 1)):
    return jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * len(shape))


def jax_cell(jcfg, params, shape: ShapeConfig, inputs, mesh=None):
    """The reference's `lower_cell` program on `mesh` (default (1, 1)),
    compiled and run: decode -> (tokens, caches by path), prefill ->
    tokens; numpy out."""
    mesh = mesh or auto_mesh()
    jshape = JaxShape(shape.name, shape.seq_len, shape.global_batch, shape.kind)
    compiled = jax_steps.lower_cell(jcfg, mesh, jshape).compile()
    if shape.kind == "decode":
        leaves, token = inputs
        tree = jax_cache_specs(jcfg, jshape)
        caches = jax.tree_util.tree_map_with_path(
            lambda p, s: jnp.asarray(leaves[jax_sh._path_str(p)]), tree)
        tok, new = compiled(params, caches, {"token": jnp.asarray(token)})
        return np.asarray(tok), {k: np.asarray(v) for k, v in flat(new).items()}
    return np.asarray(compiled(params, {k: jnp.asarray(v) for k, v in inputs.items()}))


# ----------------------------------------------------------- the port
def port_cell(tcfg, state: dict, shape: ShapeConfig, inputs, mesh, logits: bool = False):
    """`launch.steps.build_cell` over the one-rank CPU `mesh` from whole
    weights and inputs: decode -> (tokens, caches by path), prefill ->
    tokens; with `logits`, also the fp32 logits its model gives (decode:
    `decode_step`'s; prefill: the head at the last position)."""
    import torch

    from repro_torch.launch import steps
    from repro_torch.models.convert import _tensor

    art = steps.build_cell(tcfg, mesh, shape, device="cpu")
    art.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    if shape.kind == "decode":
        leaves, token = inputs

        def whole():
            c = art.model.init_caches(shape.global_batch, shape.seq_len, 0)
            return steps.map_caches(c, lambda p, t: _tensor(leaves[p]))
        tok, new = art.fn(art.local_caches(whole()), {"token": torch.from_numpy(token)})
        out = (tok.numpy(), {p: t.float().numpy() for p, t in steps.cache_leaves(new).items()})
        if logits:
            with art.context():
                lg = art.model.decode_step(art.local_caches(whole()), torch.from_numpy(token))[0]
            out += (lg.float().numpy(),)
        return out
    batch = {k: _tensor(v) for k, v in inputs.items()}
    tok = art.fn(batch).numpy()
    if not logits:
        return tok
    with art.context(), torch.inference_mode():
        return tok, steps.last_logits(art.model, batch).numpy()


# ------------------------------------------ against the reference, (1, 1)
@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    """A one-rank gloo group for the module and its (1, 1) mesh, with one
    torch intra-op thread meanwhile (ROADMAP T44: the smoke-size ops are
    tiny, and several test workers share the host)."""
    import torch

    from repro_torch.launch import mesh as mesh_mod

    store = tmp_path_factory.mktemp("group") / "store"
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with mesh_mod.distributed(0, 1, store_path=str(store), device="cpu"):
            yield mesh_mod.make_local_mesh(1, device="cpu")
    finally:
        torch.set_num_threads(n)


def _lengths(b: int, seq: int) -> list:
    return [[5, seq - 1, seq, 0][i % 4] for i in range(b)]   # one row at capacity


def check_serve_fp32(mesh, arch):
    """fp32: the serve step's tokens == the reference's, caches within
    1e-5."""
    jcfg, tcfg = configs(arch)
    params, state = weights(arch)
    shape = cell("decode")
    inputs = decode_inputs(jcfg, shape, _lengths(shape.global_batch, shape.seq_len))
    want_tok, want_caches = jax_cell(jcfg, params, shape, inputs)
    tok, caches = port_cell(tcfg, state, shape, inputs, mesh)
    np.testing.assert_array_equal(tok, want_tok)
    assert tok.dtype == np.int32
    assert set(caches) == set(want_caches)
    for path, want in want_caches.items():
        np.testing.assert_allclose(caches[path], np.asarray(want, np.float32), **CACHE_TOL,
                                   err_msg=path)


def check_prefill_fp32(mesh, arch):
    """fp32: the prefill step's tokens == the reference's."""
    jcfg, tcfg = configs(arch)
    params, state = weights(arch)
    shape = cell("prefill")
    batch = prefill_inputs(jcfg, shape)
    np.testing.assert_array_equal(port_cell(tcfg, state, shape, batch, mesh),
                                  jax_cell(jcfg, params, shape, batch))


def check_bf16(mesh, arch):
    """bf16: well-formed tokens; decode and last-position logits within
    `BF16` of the reference's `decode_step` / `forward`."""
    jcfg, tcfg = configs(arch, "bfloat16")
    params, state = weights(arch)
    jmodel = jax_build_model(jcfg)
    shape = cell("decode")
    leaves, token = decode_inputs(jcfg, shape, _lengths(shape.global_batch, shape.seq_len))
    tok, _, logits = port_cell(tcfg, state, shape, (leaves, token), mesh, logits=True)
    tree = jax.eval_shape(lambda: jmodel.init_caches(shape.global_batch, shape.seq_len, 0))
    caches = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(tree), [jnp.asarray(leaves[p]) for p in flat(tree)])
    want = np.asarray(jax.jit(jmodel.decode_step)(params, caches, jnp.asarray(token))[0],
                      np.float32)
    np.testing.assert_allclose(logits, want, **BF16)
    assert tok.dtype == np.int32 and ((tok >= 0) & (tok < jcfg.vocab_size)).all()

    shape = cell("prefill")
    batch = prefill_inputs(jcfg, shape)
    tok, logits = port_cell(tcfg, state, shape, batch, mesh, logits=True)
    kw = {k: jnp.asarray(v) for k, v in batch.items() if k != "tokens"}
    if jcfg.family == "audio":
        out = jax.jit(jmodel.forward)(params, jnp.asarray(batch["tokens"]), kw["frames"])
    else:
        out = jax.jit(lambda p, t, **k: jmodel.forward(p, tokens=t, **k))(
            params, jnp.asarray(batch["tokens"]), **kw)
    np.testing.assert_allclose(logits, np.asarray(out[0][:, -1], np.float32), **BF16)
    assert tok.dtype == np.int32 and ((tok >= 0) & (tok < jcfg.vocab_size)).all()


# ----------------------------------- against the reference, 4 host devices
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH_LENGTHS = [6, 15, 16, 1]   # 6 ends in a middle rank's slice at (1, 4); 16 is at capacity

_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, %(src)r)
sys.path.insert(0, %(tests)r)
import jax, numpy as np
from _torch_steps import auto_mesh, cell, configs, jax_cell
from repro.models import build_model
assert jax.device_count() == 4
data = np.load(%(npz)r)
out = {}
for i, (arch, mesh_shape) in enumerate(%(cases)r):
    jcfg, _ = configs(arch)
    tree = jax.eval_shape(build_model(jcfg).init, jax.random.key(0))
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    from repro.models import sharding as sh
    params = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(tree),
        [data[f"{i}/p/{sh._path_str(p)}"] for p, _ in leaves])
    mesh = auto_mesh(tuple(mesh_shape))
    caches = {k[len(f"{i}/c/"):]: data[k] for k in data.files if k.startswith(f"{i}/c/")}
    tok, _ = jax_cell(jcfg, params, cell("decode"), (caches, data[f"{i}/token"]), mesh)
    out[f"{i}/decode"] = tok
    batch = {k[len(f"{i}/b/"):]: data[k] for k in data.files if k.startswith(f"{i}/b/")}
    out[f"{i}/prefill"] = jax_cell(jcfg, params, cell("prefill", batch=4), batch, mesh)
np.savez(%(out)r, **out)
print("ok")
"""



def reference_and_ranks(tmp, cases: list):
    """For `cases` [(arch, (data, model)), ...] at fp32: the reference's
    `lower_cell` tokens on an Auto mesh of that shape over 4 host devices
    (a subprocess with `--xla_force_host_platform_device_count=4`, so this
    process keeps its one device), and the port's steps on 4 spawned gloo
    ranks over `make_local_mesh(model)`, from the same weights and inputs,
    both at once: ({"<case>/decode" | "<case>/prefill": tokens}, each
    rank's `_torch_dist.jobs` results)."""
    from _torch_dist import Ranks, inference_steps, jobs

    arrays, port_jobs = {}, []
    for i, (arch, (data, model)) in enumerate(cases):
        jcfg, tcfg = configs(arch)
        params, state = weights(arch)
        leaves, token = decode_inputs(jcfg, cell("decode"), MESH_LENGTHS, seed=i)
        batch = prefill_inputs(jcfg, cell("prefill", batch=4), seed=i)
        arrays.update({f"{i}/p/{p}": np.asarray(v) for p, v in flat(params).items()})
        arrays.update({f"{i}/c/{p}": v for p, v in leaves.items()})
        arrays.update({f"{i}/b/{k}": v for k, v in batch.items()})
        arrays[f"{i}/token"] = token
        port_jobs.append((inference_steps, (model, tcfg, state, [(leaves, token)], [batch],
                                            cell("decode").seq_len)))
    np.savez(tmp / "in.npz", **arrays)
    script = _SCRIPT % dict(src=os.path.join(ROOT, "src"), tests=os.path.join(ROOT, "tests"),
                            npz=str(tmp / "in.npz"), out=str(tmp / "out.npz"),
                            cases=[(a, list(m)) for a, m in cases])
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, "-c", script], env=env, cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    ranks = Ranks(jobs, 4, str(tmp / "store"), port_jobs)
    try:
        port = ranks.results()
    finally:
        _, stderr = proc.communicate(timeout=300)
    assert proc.returncode == 0, stderr[-3000:]
    return dict(np.load(tmp / "out.npz")), port


def check_reference_4_devices(runs, case: int) -> None:
    """Every row's tokens (from the ranks at model coordinate 0, in data
    order) equal the reference's, decode and prefill; every rank along
    `model` holds the same tokens."""
    ref, port = runs
    for kind in ("decode", "prefill"):
        parts = sorted((r[case]["coord"][0], r[case][kind][0]["token"])
                       for r in port if r[case]["coord"][1] == 0)
        np.testing.assert_array_equal(np.concatenate([t for _, t in parts]),
                                      ref[f"{case}/{kind}"], err_msg=kind)
        for r in port:
            for q in port:
                if q[case]["coord"][0] == r[case]["coord"][0]:
                    np.testing.assert_array_equal(q[case][kind][0]["token"],
                                                  r[case][kind][0]["token"])
