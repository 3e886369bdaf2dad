"""Shared pieces of the FSDP placement tests
(tests/test_torch_fsdp_specs*.py): the meshes, the reference's local
shard of each leaf on a `jax.sharding.AbstractMesh`, the port's resident
shards on the meta device, and the check that holds them equal (see
test_torch_fsdp_specs.py)."""
import functools
import math

import jax
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P

from repro.configs import get_config as jax_get_config
from repro.launch import steps as jax_steps
from repro.models import build_model as jax_build_model
from repro.models import sharding as jax_sh
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import steps
from repro_torch.models import build_model, sharding
from repro_torch.models.convert import jax_leaves

MESHES = [{"data": 2, "model": 2}, {"data": 4, "model": 1}, {"data": 1, "model": 4},
          {"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16}]
MESH_IDS = ["2x2", "4x1", "1x4", "16x16", "2x16x16"]
SIZES = ["smoke", "published"]


@functools.lru_cache(maxsize=None)
def _jax_tree(arch: str, smoke: bool):
    return jax.eval_shape(jax_build_model(jax_get_config(arch, smoke=smoke)).init,
                          jax.random.key(0))


def _flat(tree) -> dict:
    return {jax_sh._path_str(p): s for p, s in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, (P, NamedSharding)))[0]}


def _reference(arch: str, smoke: bool, shape: dict, kind: str) -> dict:
    """JAX leaf path -> (the reference's spec, its local shard's shape)."""
    jcfg = jax_get_config(arch, smoke=smoke)
    am = AbstractMesh(tuple(shape.values()), tuple(shape))
    tree = _jax_tree(arch, smoke)
    sh = (jax_sh.param_shardings(am, tree, cfg=jcfg) if kind == "train"
          else jax_steps.inference_param_shardings(jcfg, am, tree))
    leaves = {jax_sh._path_str(p): leaf for p, leaf in
              jax.tree_util.tree_flatten_with_path(tree)[0]}
    return {path: (tuple(s.spec) + (None,) * (len(leaves[path].shape) - len(s.spec)),
                   tuple(s.shard_shape(leaves[path].shape)))
            for path, s in _flat(sh).items()}


def _port_model(cfg, shape: dict, kind: str):
    if kind == "train":
        specs = sharding.port_specs(jax_leaves(cfg), sharding.param_shardings(
            shape, jax_leaves(cfg), cfg))
        return sharding.shard_model(build_model(cfg, device="meta"), specs, shape, "meta",
                                    trainable=True)
    return steps.build_prefill_step(cfg, shape, ShapeConfig("prefill_32k", 32, 4, "prefill"),
                                    device="meta").model


def _axes_of(entry) -> tuple:
    return () if entry is None else (entry if isinstance(entry, tuple) else (entry,))


def check(arch: str, size: str, shape: dict, kind: str) -> int:
    """Every port weight of `arch` (`size` "smoke" or "published") under the
    `kind` ("train" or "serve") placement over the bare mesh `shape`: its
    resident shape is the reference's local shard (a stacked leaf's layer
    dim kept whole), and its `model` / data marks are the reference's
    spec's. Returns how many weights are cut over the data axes."""
    smoke = size == "smoke"
    cfg = get_config(arch, smoke=smoke)
    ref = _reference(arch, smoke, shape, kind)
    params = dict(_port_model(cfg, shape, kind).named_parameters())
    n_fsdp = 0
    for path, leaf in jax_leaves(cfg).items():
        spec, want = ref[path]
        if leaf.stacked:
            # every rank holds every layer: the reference's layer-dim cut is dropped
            assert want[0] == leaf.shape[0] // math.prod(
                shape[a] for a in _axes_of(spec[0])), (path, want, spec)
            want, spec = want[1:], spec[1:]
        for name in leaf.names:
            p = params[name]
            assert tuple(p.shape) == want, (name, tuple(p.shape), want, spec)
            tp = [d for d, e in enumerate(spec) if _axes_of(e) == ("model",)]
            data = [d for d, e in enumerate(spec) if _axes_of(e) and "model" not in _axes_of(e)]
            assert sharding.split_dim(p) == (tp[0] if tp else None), name
            assert sharding.fsdp_dim(p) == (data[0] if data else None), name
            assert sharding.fsdp_axes(p) == (_axes_of(spec[data[0]]) if data else ()), name
            n_fsdp += bool(data)
    return n_fsdp
