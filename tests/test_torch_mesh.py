"""The scale-out tables as data, port against the JAX package, and the
mesh helpers in a one-rank process group:

  * `configs`: `SHAPES`, `shape_applicable`, `param_count` and
    `active_param_count` for all ten architectures;
  * `models.sharding`: `default_rules`, and `param_pspecs` /
    `param_shardings` leaf by leaf over every config's JAX leaves at the
    (16, 16), (2, 16, 16) and (2, 4) meshes as bare shapes; on the JAX
    side the same meshes as `AbstractMesh`es under `sharding_ctx`, over
    `jax.eval_shape(model.init)` (which also holds the leaves' paths and
    shapes equal);
  * `optim.adamw.zero1_spec` at `test_optim.py`'s cases, and
    `state_shardings` for every leaf of every config at those meshes
    against the JAX `zero1_spec` of the same leaf;
  * `launch.steps.batch_shardings` against the JAX one;
  * `launch.mesh` and `spmd`: the meshes, their refusals, `flat_index`,
    the collectives over one rank, and `constrain` / `tp_size`."""
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec as P

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import all_archs
from repro.configs import get_config as jax_get_config
from repro.configs import shape_applicable as jax_shape_applicable
from repro.launch import steps as jax_steps
from repro.models import build_model as jax_build_model
from repro.models import sharding as jax_sh
from repro.optim import adamw as jax_adamw
from repro_torch import configs
from repro_torch import spmd
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.models import sharding as tsh
from repro_torch.models.convert import jax_leaves
from repro_torch.optim import adamw

MESHES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
          {"data": 2, "model": 4}]
MESH_IDS = ["16x16", "2x16x16", "2x4"]


def _abstract(shape: dict) -> AbstractMesh:
    return AbstractMesh(tuple(shape.values()), tuple(shape))


@functools.lru_cache(maxsize=None)
def _jax_tree(arch: str):
    """The eval_shape'd param tree of the full config's init."""
    return jax.eval_shape(jax_build_model(jax_get_config(arch)).init, jax.random.key(0))


@functools.lru_cache(maxsize=None)
def _port_leaves(arch: str) -> dict:
    return jax_leaves(configs.get_config(arch))


def _flat_specs(tree) -> dict:
    return {jax_sh._path_str(p): tuple(s) for p, s in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))[0]}


def test_shapes_and_applicability():
    assert list(configs.SHAPES) == list(JAX_SHAPES)
    for name, s in configs.SHAPES.items():
        j = JAX_SHAPES[name]
        assert (s.name, s.seq_len, s.global_batch, s.kind) == \
            (j.name, j.seq_len, j.global_batch, j.kind)
    for arch in all_archs():
        cfg, jcfg = configs.get_config(arch), jax_get_config(arch)
        assert (cfg.is_attention_free, cfg.supports_long_context, cfg.has_decoder) == \
            (jcfg.is_attention_free, jcfg.supports_long_context, jcfg.has_decoder)
        for name in configs.SHAPES:
            assert configs.shape_applicable(cfg, configs.SHAPES[name]) == \
                jax_shape_applicable(jcfg, JAX_SHAPES[name])
    from repro_torch.configs import EncoderConfig, MoEConfig, SSMConfig  # noqa: F401


@pytest.mark.parametrize("arch", all_archs())
def test_param_counts(arch):
    for smoke in (False, True):
        cfg, jcfg = configs.get_config(arch, smoke=smoke), jax_get_config(arch, smoke=smoke)
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.active_param_count() == jcfg.active_param_count()


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", all_archs())
def test_param_and_state_specs_match_jax(arch, shape):
    tree, leaves = _jax_tree(arch), _port_leaves(arch)
    assert {jax_sh._path_str(p): tuple(v.shape) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]} == \
        {p: leaf.shape for p, leaf in leaves.items()}
    cfg, jcfg = configs.get_config(arch), jax_get_config(arch)
    am = _abstract(shape)
    with jax_sh.sharding_ctx(am):
        want = _flat_specs(jax_sh.param_pspecs(tree, cfg=jcfg, mesh=am))
    got = tsh.param_shardings(shape, leaves, cfg)
    assert got == want
    with tsh.sharding_ctx(shape):
        assert tsh.param_pspecs(leaves, cfg) == want
    # ZeRO-1: the JAX zero1_spec of each leaf with the reference's data axes
    data = tuple(a for a in ("pod", "data") if a in shape)
    state = adamw.state_shardings(shape, got, {p: leaf.shape for p, leaf in leaves.items()})
    assert state.step == () and state.master == state.mu == state.nu
    for path, spec in state.master.items():
        assert spec == tuple(jax_adamw.zero1_spec(P(*want[path]), leaves[path].shape,
                                                  data, shape)), path


def test_spec_rules_and_defaults():
    """The reference's `test_spec_rules` cases, and `default_rules`."""
    for path, shape, kw in [("blocks/mlp/w_gate", (8, 16, 32), {}),
                            ("blocks/attn/wq", (8, 16, 32), dict(attn_q_tp=True)),
                            ("blocks/attn/wq", (8, 16, 32), dict(attn_q_tp=False)),
                            ("blocks/moe/w_gate", (8, 4, 16, 32), {}),
                            ("embedding/embed", (100, 64), {}),
                            ("final_norm/scale", (64,), {}),
                            ("blocks/mamba/A_log", (8, 80), {})]:
        assert tsh.spec_for_path(path, shape, **kw) == jax_sh.spec_for_path(path, shape, **kw)
    for shape in MESHES:
        assert tsh.default_rules(shape) == jax_sh.default_rules(_abstract(shape))
    with tsh.sharding_ctx({"data": 1}):
        assert tsh._physical(("batch", None, "tp"), (8, 4, 30)) == (None, None, None)


def test_zero1_spec_reference_cases():
    """`test_optim.py`'s cases, then every leaf of arctic's state at (2, 4)
    as the reference picks it."""
    assert adamw.zero1_spec((None, "model"), (64, 32), ("data",),
                            {"data": 16, "model": 16}) == ("data", "model")
    assert adamw.zero1_spec(("data", "model"), (64, 32), ("data",),
                            {"data": 16, "model": 16}) == ("data", "model")
    assert adamw.zero1_spec((None, None), (7, 5), ("data",), {"data": 16}) == (None, None)
    assert adamw.zero1_spec((), (8, 3), ("pod", "data"), {"pod": 2, "data": 2}) == \
        (("pod", "data"), None)
    # a norm scale is replicated by the param rules: ZeRO-1 shards its layers
    leaves = _port_leaves("phi4-mini-3.8b")
    shape = {"data": 2, "model": 4}
    specs = tsh.param_shardings(shape, leaves, configs.get_config("phi4-mini-3.8b"))
    state = adamw.state_shardings(shape, specs, {p: v.shape for p, v in leaves.items()})
    assert specs["blocks/attn_norm/scale"] == (None, None)
    assert state.master["blocks/attn_norm/scale"] == ("data", None)


def test_batch_shardings_match_jax():
    b = {"tokens": (64, 8), "labels": (64, 8), "positions": (3, 64, 8),
         "frames": (64, 30, 16), "odd": (3, 8)}
    for shape in MESHES:
        want = jax_steps.batch_shardings(
            _abstract(shape), {k: jax.ShapeDtypeStruct(v, np.int32) for k, v in b.items()})
        got = tsteps.batch_shardings(shape, b)
        assert got == {k: tuple(v.spec) for k, v in want.items()}


def test_mesh_helpers(tmp_path):
    assert tmesh.production_mesh_shape() == {"data": 16, "model": 16}
    assert tmesh.batch_axes(tmesh.production_mesh_shape(True)) == ("pod", "data")
    assert tmesh.mesh_chips(tmesh.production_mesh_shape(True)) == 512
    with pytest.raises(RuntimeError, match="init_distributed"):
        tmesh.make_local_mesh(device="cpu")
    assert tsh.tp_size() == 1
    x = torch.arange(6.0)
    assert tsh.constrain(x, ("batch",)) is x
    with tmesh.distributed(0, 1, store_path=str(tmp_path / "store"), device="cpu"):
        with pytest.raises(RuntimeError, match="already"):
            tmesh.init_distributed(0, 1, store_path=str(tmp_path / "other"), device="cpu")
        mesh = tmesh.make_local_mesh(1, device="cpu")
        assert spmd.mesh_shape(mesh) == {"data": 1, "model": 1}
        assert tmesh.batch_axes(mesh) == ("data",) and tmesh.mesh_chips(mesh) == 1
        assert spmd.mesh_chips(mesh, ("model",)) == 1
        assert spmd.flat_index(mesh, ("data", "model")) == 0
        with pytest.raises(ValueError, match="in its order"):
            spmd.flat_index(mesh, ("model", "data"))
        assert torch.equal(spmd.all_gather_axes(x[None], mesh, ("data", "model")), x[None])
        assert torch.equal(spmd.all_reduce_axes(x.clone(), mesh, ("data",)), x)
        assert spmd.mesh_shape(tmesh.make_macro_mesh(device="cpu")) == {"macro": 1}
        with pytest.raises(ValueError, match="world size 2"):
            tmesh.make_macro_mesh(2, device="cpu")
        with pytest.raises(ValueError, match="does not divide"):
            tmesh.make_local_mesh(2, device="cpu")
        with pytest.raises(ValueError, match="needs world size 256"):
            tmesh.make_production_mesh(device="cpu")
        with tsh.sharding_ctx(mesh):
            assert tsh.tp_size() == 1
    with pytest.raises(ValueError, match="outside world size 1"):
        tmesh.init_distributed(1, 1, store_path=str(tmp_path / "third"), device="cpu")
