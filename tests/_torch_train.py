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
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist import Ranks, jobs, tp_train
from _torch_parity import CPU, smoke_configs
from _torch_steps import ROOT, flat
from _torch_tp import OCFG as TP_OCFG
from repro.models import build_model as jax_build_model
from repro.launch.mesh import make_local_mesh
from repro.launch.steps import build_train_step as jax_build_train_step
from repro.models import sharding as jax_sharding
from repro.optim import adamw as jax_adamw
from repro_torch.launch.steps import build_train_step, loss_and_grads
from repro_torch.models import build_model
from repro_torch.models.convert import jax_leaves, params_from_jax
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


# ------------------------------------ the TP step against the reference's
_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, %(src)r)
sys.path.insert(0, %(tests)r)
import jax, jax.numpy as jnp, numpy as np
from _torch_steps import auto_mesh
from _torch_train import JAX_OCFG, smoke_configs
from repro.launch.steps import build_train_step
from repro.models import build_model, sharding as sh
from repro.optim import adamw
assert jax.device_count() == 4
data = np.load(%(npz)r)
jcfg, _ = smoke_configs(%(arch)r)
tree = jax.eval_shape(build_model(jcfg).init, jax.random.key(0))
leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
params = jax.tree_util.tree_unflatten(
    jax.tree_util.tree_structure(tree),
    [jnp.asarray(data["p/" + sh._path_str(p)]) for p, _ in leaves])
batch = {k[2:]: jnp.asarray(data[k]) for k in data.files if k.startswith("b/")}
out = {}
for shape in %(shapes)r:
    mesh = auto_mesh(tuple(shape))
    fn = jax.jit(build_train_step(jcfg, mesh, JAX_OCFG, grad_accum=1).fn)
    with mesh, sh.sharding_ctx(mesh):
        new, _, met = fn(params, adamw.init(params), batch)
    key = f"{shape[0]}{shape[1]}"
    out[key] = np.asarray([met["loss"], met["grad_norm"]], np.float64)
    placed = jax.device_put(new, sh.param_shardings(mesh, tree, cfg=jcfg))
    first = mesh.devices.flat[0]
    for (p, v), (_, w) in zip(jax.tree_util.tree_flatten_with_path(new)[0],
                              jax.tree_util.tree_flatten_with_path(placed)[0]):
        out[f"{key}/" + sh._path_str(p)] = np.asarray(v)
        mine = [s for s in w.addressable_shards if s.device == first]
        out[f"{key}@0/" + sh._path_str(p)] = np.asarray(mine[0].data)
np.savez(%(out)r, **out)
print("ok")
"""


def start_reference_step0(tmp, arch: str, shapes: list):
    """Start the reference's own sharded train step (`repro.launch.steps.
    build_train_step(cfg, mesh)`, jitted on an Auto mesh of each (data,
    model) shape over 4 host devices, in a subprocess with
    `--xla_force_host_platform_device_count=4`) from the converted JAX
    init and a global batch: (the subprocess, {shape: the port's rank job
    on the same weights and batch, `_torch_dist.tp_train`})."""
    _, params, tcfg, state = jax_model(arch)
    batch = batch_np(tcfg, b=4, s=32, seed=100)
    arrays = {f"p/{p}": np.asarray(v) for p, v in flat(params).items()}
    arrays.update({f"b/{k}": v for k, v in batch.items()})
    np.savez(tmp / "in.npz", **arrays)
    script = _SCRIPT % dict(src=os.path.join(ROOT, "src"), tests=os.path.join(ROOT, "tests"),
                            npz=str(tmp / "in.npz"), out=str(tmp / "out.npz"), arch=arch,
                            shapes=[list(s) for s in shapes])
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, "-c", script], env=env, cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    case = [(arch, tcfg, {k: v.numpy() for k, v in state.items()}, [batch])]
    return proc, {tuple(s): (tp_train, (s[1], case, TP_OCFG)) for s in shapes}


def reference_result(tmp, proc) -> dict:
    """{"<data><model>": [loss, grad norm], "<data><model>/<path>": each
    parameter after the update} of the reference's step 0."""
    _, stderr = proc.communicate(timeout=300)
    assert proc.returncode == 0, stderr[-3000:]
    return dict(np.load(tmp / "out.npz"))


def reference_tp_step0(tmp, arch: str, shapes: list):
    """The reference's step 0 (`start_reference_step0`) and the port's on 4
    spawned gloo ranks at each shape, both at once: (`reference_result`,
    {shape: each rank's `tp_train` results})."""
    proc, port_jobs = start_reference_step0(tmp, arch, shapes)
    ranks = Ranks(jobs, 4, str(tmp / "store"), list(port_jobs.values()))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        port = ranks.results(timeout=200)
    finally:
        torch.set_num_threads(n)
        ref = reference_result(tmp, proc)
    return ref, {s: [r[i] for r in port] for i, s in enumerate(port_jobs)}


def check_step0(ref: dict, port: list, arch: str, shape: tuple) -> None:
    """Step 0 of the port's TP step at `shape` (`port`: each rank's
    `tp_train` results there), on every rank, against the reference's
    (`reference_result`): loss within 1e-5, grad norm within 2e-5
    (relative), the parameters after the update within 2e-3 (ROADMAP
    T42: Adam's first step moves a weight by about ±lr / 2, so a gradient
    with the wrong sign, a partial sum, shows); the port's step ran
    tensor-parallel where `model` > 1."""
    d, m = shape
    key = f"{d}{m}"
    want_loss, want_norm = ref[key]
    for r in port:                       # every rank reports the same metrics
        got = r[arch]["metrics"][0]
        assert abs(got["loss"] - want_loss) <= 1e-5 * abs(want_loss), (got, want_loss)
        assert abs(got["grad_norm"] - want_norm) <= 2e-5 * want_norm, (got, want_norm)
    assert bool(port[0][arch]["split"]) == (m > 1)
    _, tree, tcfg, _ = jax_model(arch)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(tree)
    new = jax.tree_util.tree_unflatten(
        treedef, [ref[f"{key}/" + jax_sharding._path_str(p)] for p, _ in leaves])
    got = port[0][arch]["params"]
    for k, want in params_from_jax(new, tcfg).items():
        np.testing.assert_allclose(got[k], want, rtol=0, atol=2e-3, err_msg=k)
    # rank 0's resident shards against the reference's shard on device 0
    # of its placement (`param_shardings`): the same shape, the same values
    local = port[0][arch]["local"]
    for path, leaf in jax_leaves(tcfg).items():
        want = ref[f"{key}@0/{path}"]
        mine = (np.stack([local[n] for n in leaf.names]) if leaf.stacked
                else local[leaf.names[0]])
        assert mine.shape == want.shape, (path, mine.shape, want.shape)
        np.testing.assert_allclose(mine, want, rtol=0, atol=2e-3, err_msg=path)
