"""Logical-axis sharding: activation constraints and parameter spec
tables — counterpart of `repro.models.sharding`.

A spec is what the reference's `PartitionSpec` holds, as a plain tuple:
one entry a dim, each None (replicated), a mesh axis name, or a tuple of
axis names (the dim split over their product, the first outermost).
`spmd.placements(spec, mesh)` turns it into DTensor placements
(`Shard(d)` on each mesh dim that entry d names, `Replicate()`
elsewhere).

Models annotate activations with LOGICAL axes ("batch", "tp",
"cache_seq", ...); a context (`sharding_ctx`) installs the mesh and the
logical -> physical translation. Outside any context `constrain` is a
no-op, as in the reference; inside one it redistributes a DTensor to the
spec's placements and returns a plain tensor (a full replica on every
rank) as it is. The mesh may be a `DeviceMesh` or a bare shape ({"data":
16, "model": 16}, see `spmd`): the tables are data and need no
process group.

Parameter specs come from leaf PATHS (a MaxText-style rules table) of
the JAX package's parameter tree, `models.convert.jax_leaves`: a stacked
leaf's spec has its leading layer dim (always replicated here; ZeRO-1
state may shard it, `optim.adamw.state_shardings`). The tables are
copied from the reference and held equal to it leaf by leaf.

Divisibility guard: an axis is only sharded if its size divides the
mesh-axis product, otherwise the dim is replicated (e.g. 24 query heads
on a 16-way `model` axis).

Tensor-parallel compute (the serve and prefill steps, `launch.steps`):
`inference_rules` picks the inference placement as the reference's
`inference_param_shardings` does, and `shard_model` gives a model the
local shards of its tensor-parallel weights. A rank's compute shards a
weight only along `model` (`compute_spec`): the entries over data axes
(FSDP) and a stacked leaf's layer dim are kept whole on every rank, as
the sharded train step gathers them (ROADMAP item 8's per-layer gather
is to come). Each cut weight is marked with the dim it is cut along
(`split_dim`), and the layers read the mark: a column-parallel matmul
runs on the local columns, a row-parallel one ends in `tp_all_reduce`
over `model`, a vocabulary-split embedding masks the tokens outside its
rows. With no mesh installed, or `model` of 1, nothing is cut and no
collective runs: the mesh-less program.
"""
from __future__ import annotations

import contextlib
import math
import re
import threading
from typing import Optional, Sequence

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import dtype as dt
from repro_torch.spmd import (all_gather_axes, all_reduce_axes, argmax_axes, local_shard,
                              mesh_shape, placements)

_state = threading.local()


def _rules() -> Optional[dict]:
    return getattr(_state, "rules", None)


def _mesh():
    return getattr(_state, "mesh", None)


def default_rules(mesh) -> dict:
    """batch -> all data-like axes; tp -> the model axis."""
    names = tuple(mesh_shape(mesh))
    batch = tuple(n for n in names if n in ("pod", "data", "replica", "fsdp"))
    model = ("model",) if "model" in names else ()
    return {
        "batch": batch,
        "tp": model,
        "seq": model,          # sequence parallel
        "heads": model,
        "expert": model,
        "fsdp": ("data",) if "data" in names else (),
        "cache_seq": model,
    }


@contextlib.contextmanager
def sharding_ctx(mesh, rules: Optional[dict] = None):
    """Install `mesh` (a `DeviceMesh` or a bare shape) and its logical
    rules for this thread."""
    prev = (_mesh(), _rules())
    _state.mesh = mesh
    _state.rules = rules or default_rules(mesh)
    try:
        yield
    finally:
        _state.mesh, _state.rules = prev


def _physical(logical: Sequence[Optional[str]], shape) -> Optional[tuple]:
    mesh, rules = _mesh(), _rules()
    if mesh is None:
        return None
    sizes = mesh_shape(mesh)
    out = []
    for dim, name in zip(shape, logical):
        if name is None:
            out.append(None)
            continue
        axes = rules.get(name, ())
        size = 1
        for a in axes:
            size *= sizes[a]
        if axes and size > 1 and dim % size == 0:
            out.append(axes if len(axes) > 1 else axes[0])
        else:
            out.append(None)
    return tuple(out)


def tp_size() -> int:
    """Size of the tensor-parallel axis in the ambient mesh (1 if none)."""
    mesh = _mesh()
    if mesh is None:
        return 1
    return mesh_shape(mesh).get("model", 1)


def tp_rank() -> int:
    """This rank's coordinate on the ambient mesh's `model` dim (0 without
    a `DeviceMesh` or without that dim)."""
    from torch.distributed.device_mesh import DeviceMesh

    mesh = _mesh()
    if not isinstance(mesh, DeviceMesh) or "model" not in mesh.mesh_dim_names:
        return 0
    return mesh.get_local_rank("model")


def tp_all_reduce(x: torch.Tensor) -> torch.Tensor:
    """Sum `x` over the ambient mesh's `model` dim (in place) and return it."""
    return all_reduce_axes(x, _mesh(), ("model",))


def tp_all_gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Every `model` rank's `x`, concatenated along `dim` in rank order."""
    return all_gather_axes(x, _mesh(), ("model",), dim=dim)


def tp_argmax(x: torch.Tensor, offset: int) -> torch.Tensor:
    """The global argmax over the last dim of a tensor split along it over
    `model` (`spmd.argmax_axes`; this rank's columns start at `offset`)."""
    return argmax_axes(x, offset, _mesh(), ("model",))


def split_dim(w: torch.Tensor) -> Optional[int]:
    """The dim along which `shard_model` cut this weight over `model`, or
    None for a weight every rank holds whole."""
    return getattr(w, "_tp_dim", None)


def constrain(x: torch.Tensor, logical: Sequence[Optional[str]]) -> torch.Tensor:
    """Place a DTensor by logical axes; any tensor as it is without a mesh."""
    from torch.distributed.tensor import DTensor

    mesh = _mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    spec = _physical(logical, x.shape)
    return x.redistribute(x.device_mesh, placements(spec, x.device_mesh))


# ------------------------------------------------------------ param specs
# Path-suffix regex -> logical spec for the LAST len(spec) dims; leading
# dims (layer stacking, expert axis handled explicitly) are replicated.
# Dense 2-D weights are FSDP x TP sharded ("2D sharding"): the non-TP dim
# shards over `data`, so weights / grads / optimizer state all scale with
# the full chip count.
_PARAM_RULES: list[tuple[str, tuple]] = [
    (r"embed$", ("tp", "fsdp")),          # (V, d) vocab x fsdp
    (r"lm_head$", ("fsdp", "tp")),
    (r"(wq|wk|wv)$", ("fsdp", "tp")),
    (r"wo$", ("tp", "fsdp")),
    (r"(w_gate|w_up)$", ("fsdp", "tp")),  # overridden for MoE by expert rule
    (r"w_down$", ("tp", "fsdp")),
    (r"(in_z|in_x)$", ("fsdp", "tp")),
    (r"(in_B|in_C|in_dt)$", ("fsdp", None)),
    (r"conv_x_w$", (None, "tp")),
    (r"conv_x_b$", ("tp",)),
    (r"(conv_B_w|conv_C_w|conv_B_b|conv_C_b)$", None),  # replicate (small)
    (r"out_proj$", ("tp", "fsdp")),
    (r"(A_log|dt_bias|D)$", ("tp",)),
    (r"router$", ("fsdp", None)),
    (r"(bq)$", ("tp",)),
    (r"(bk|bv)$", ("tp",)),
    (r"scale$", None),
    (r"pos_embed$", None),
]
# Experts shard over the SAME physical axis as tp ("model"), so expert
# tensors shard on E only (a spec may not repeat a mesh axis), and d over
# `data` (FSDP).
_MOE_RULES: list[tuple[str, tuple]] = [
    (r"(w_gate|w_up)$", ("expert", "fsdp", None)),
    (r"w_down$", ("expert", None, "fsdp")),
]


def spec_for_path(path_str: str, shape, attn_q_tp: bool = True,
                  attn_kv_tp: bool = False) -> tuple:
    """Logical spec tuple (len == ndim) for a parameter leaf path.

    attn_q_tp / attn_kv_tp: whether this arch's (kv-)head count divides the
    tp degree; uneven heads replicate the attention projections.
    """
    ndim = len(shape)
    # MoE expert tensors (E, d, f) live under a "moe" subtree; the expert
    # rule takes priority over the dense-MLP name rules there.
    if "moe" in path_str.split("/"):
        for pat, spec in _MOE_RULES:
            if re.search(pat, path_str) and ndim >= len(spec):
                pad = ndim - len(spec)
                return (None,) * pad + tuple(spec)
    # attention projections: head-divisibility aware
    leaf = path_str.split("/")[-1]
    if leaf in ("wq",):
        spec = ("fsdp", "tp") if attn_q_tp else ("fsdp", None)
        return (None,) * (ndim - 2) + spec
    if leaf in ("wk", "wv"):
        spec = ("fsdp", "tp") if attn_kv_tp else ("fsdp", None)
        return (None,) * (ndim - 2) + spec
    if leaf == "wo":
        spec = ("tp", "fsdp") if attn_q_tp else (None, "fsdp")
        return (None,) * (ndim - 2) + spec
    if leaf == "bq":
        return (None,) * (ndim - 1) + (("tp",) if attn_q_tp else (None,))
    if leaf in ("bk", "bv"):
        return (None,) * (ndim - 1) + (("tp",) if attn_kv_tp else (None,))
    for pat, spec in _PARAM_RULES:
        if re.search(pat, path_str):
            if spec is None:
                return (None,) * ndim
            pad = ndim - len(spec)
            if pad < 0:  # spec longer than the leaf's rank: replicate
                return (None,) * ndim
            return (None,) * pad + tuple(spec)
    return (None,) * ndim


def _attn_divisibility(cfg: Optional[ModelConfig], mesh) -> tuple:
    tp = mesh_shape(mesh).get("model", 1) if mesh is not None else 1
    if cfg is None or tp <= 1:
        return True, True
    heads = getattr(cfg, "effective_n_heads", cfg.n_heads)
    q_ok = heads > 0 and heads % tp == 0
    kv_ok = cfg.n_kv_heads > 0 and cfg.n_kv_heads % tp == 0
    return q_ok, kv_ok


def param_pspecs(leaves: dict, cfg: Optional[ModelConfig] = None, mesh=None) -> dict:
    """JAX leaf path -> physical spec for `leaves` (path -> a
    `convert.JaxLeaf` or a shape: `convert.jax_leaves(cfg)`, the
    reference's eval_shape'd tree), under the ambient `sharding_ctx`
    (`()` for every leaf outside one); `mesh` (default: the ambient one)
    decides the attention heads' divisibility."""
    q_ok, kv_ok = _attn_divisibility(cfg, mesh if mesh is not None else _mesh())

    def one(path, leaf):
        shape = tuple(getattr(leaf, "shape", leaf))
        logical = spec_for_path(path, shape, attn_q_tp=q_ok, attn_kv_tp=kv_ok)
        spec = _physical(logical, shape)
        return spec if spec is not None else ()
    return {path: one(path, leaf) for path, leaf in leaves.items()}


def param_shardings(mesh, leaves: dict, cfg: Optional[ModelConfig] = None,
                    rules: Optional[dict] = None) -> dict:
    """JAX leaf path -> spec over `mesh` (`param_pspecs` under
    `sharding_ctx(mesh, rules)`); `spmd.placements(spec, mesh)`
    places it."""
    with sharding_ctx(mesh, rules):
        return param_pspecs(leaves, cfg=cfg, mesh=mesh)


# ------------------------------------------------- inference placement
def inference_rules(mesh, cfg: ModelConfig, leaves: dict) -> dict:
    """The logical rules of the serve and prefill steps' weights, as the
    reference's `inference_param_shardings` decides them: tensor-parallel
    only (no FSDP, so replicated over the data axes) when the model is
    neither MoE nor hybrid and holds at most 8 GiB a device after the
    `model` split; otherwise the default rules, FSDP included. `leaves` is
    `convert.jax_leaves(cfg)` (or path -> shape)."""
    nbytes = sum(math.prod(getattr(leaf, "shape", leaf)) for leaf in leaves.values())
    per_dev = nbytes * dt(cfg.param_dtype).itemsize / max(mesh_shape(mesh).get("model", 1), 1)
    rules = default_rules(mesh)
    if cfg.moe is None and cfg.family != "hybrid" and per_dev <= 8 * 2**30:
        rules["fsdp"] = ()
    return rules


def compute_spec(spec: tuple, stacked: bool) -> tuple:
    """The spec a rank's compute holds a port tensor in: the JAX leaf's
    spec on the port tensor's dims (a stacked leaf's layer dim dropped),
    with every entry but `model` replicated."""
    spec = tuple(spec)[1:] if stacked else tuple(spec)
    return tuple("model" if e == "model" else None for e in spec)


def port_specs(leaves: dict, specs: dict) -> dict:
    """Port parameter name -> `compute_spec` of its JAX leaf's spec
    (`leaves` = `convert.jax_leaves(cfg)`, `specs` = leaf path -> spec)."""
    out = {}
    for path, leaf in leaves.items():
        spec = specs[path] or (None,) * len(leaf.shape)
        for name in leaf.names:
            out[name] = compute_spec(spec, leaf.stacked)
    return out


def local_shape(shape, spec: tuple, mesh) -> tuple:
    """The shape of one rank's shard of a tensor of `shape` under `spec`."""
    sizes = mesh_shape(mesh)
    out = []
    for d, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        n = math.prod(sizes[a] for a in ((entry,) if isinstance(entry, str) else entry or ()))
        if d % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not divide over {entry} ({n})")
        out.append(d // n)
    return tuple(out)


def cut(full: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's shard (a view) of a tensor every rank holds whole,
    under `spec` over the `DeviceMesh` `mesh`. No collective."""
    local_shape(full.shape, spec, mesh)          # refuses an uneven split
    return local_shard(full, mesh, placements(spec, mesh))


def shard_model(model: torch.nn.Module, specs: dict, mesh, device) -> torch.nn.Module:
    """Materialise a model built on the meta device on `device`, each
    parameter in its local shape under `specs` (port name -> compute
    spec, `port_specs`) and marked with the dim it is cut along. The
    values are uninitialised: load them with `load_whole`."""
    cut_dims = {}
    for name, p in list(model.named_parameters()):
        spec = specs[name]
        dims = [d for d, e in enumerate(spec) if e is not None]
        if not dims:
            continue
        mod_name, _, attr = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        shape = local_shape(p.shape, spec, mesh)
        mod.register_parameter(attr, torch.nn.Parameter(
            torch.empty(shape, dtype=p.dtype, device="meta"), requires_grad=False))
        cut_dims[name] = dims[0]
    model.to_empty(device=device)
    params = dict(model.named_parameters())
    for name, d in cut_dims.items():
        params[name]._tp_dim = d
    return model


@torch.no_grad()
def load_whole(model: torch.nn.Module, state: dict, specs: dict, mesh) -> None:
    """Copy a whole state dict (every tensor whole, the same on every
    rank) into a `shard_model` model: each tensor cut to its shard."""
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(state))
    if missing:
        raise ValueError(f"state lacks {missing[:4]}")
    for name, p in params.items():
        src = state[name]
        if split_dim(p) is not None:
            src = cut(src, specs[name], mesh)
        if tuple(src.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shard {tuple(src.shape)}, parameter {tuple(p.shape)}")
        p.copy_(src)
