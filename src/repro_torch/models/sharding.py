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

Tensor-parallel compute and FSDP (the serve, prefill and train steps,
`launch.steps`): `inference_rules` picks the inference placement as the
reference's `inference_param_shardings` does; the train step takes the
default rules' table (`param_shardings`, FSDP included). A rank HOLDS
each weight in its `resident_spec`: the reference's spec on the port
tensor's dims (a stacked leaf's layer dim dropped), so its shard of a
weight the rules cut over `data` (FSDP) is that data rank's slice, as
the reference's device holds it. A rank COMPUTES in the `compute_spec`,
the `model` entries only: a layer gathers its FSDP-cut weights over the
data axes just before it runs (`gathered`, `full`: `spmd.fsdp_gather`,
whose backward reduce-scatters the gradient back to the shard) and drops
them after, as GSPMD's per-layer FSDP all-gather does. `shard_model`
materialises the resident shards and marks each weight with the dim it
is cut along over `model` (`split_dim`) and, apart, the dim and axes it
is cut along over the data axes (`fsdp_dim`, `fsdp_axes`), and each
module on the way to an FSDP-cut weight (`_holds_fsdp`); a gathered
weight keeps the `model` mark, and the layers decide by it, never by
the mesh alone: a column-parallel matmul takes its input through
`tp_copy` and runs on the local columns, a row-parallel one ends in
`tp_all_reduce` over `model`, a vocabulary-split embedding masks the
tokens outside its rows, a Mamba2 block runs the SSD on its heads
(`models.mamba2`). With gradients on, `tp_copy` / `tp_all_reduce` /
`tp_all_gather` are the autograd collectives of `spmd` (the backward
all-reduces where the forward copied, and passes through where it
reduced); without them, the in-place forms. With no mesh installed, or
`model` and `data` of 1, nothing is cut and no collective runs: the
mesh-less program.

Row axes (`sharding_ctx(row_axes=)`, read by `row_axes()`): the mesh
axes over which the rows of the current call's batch are split, as the
step that installs them cut the batch (the train step's data shard, the
serve and prefill steps' batch spec), never inferred from the mesh: a
batch that does not divide over the data axes is whole on every rank.
A layer whose result depends on every row of the call (MoE routing:
capacity, ranks, aux means) reads them: `row_size` / `row_index` place
this rank's rows in the global batch (contiguous, rank-major, in
`flat_index` order), `row_all_gather` gathers a statistic of every
rank's rows in that order, and `row_sum` sums one over the row axes as a
statistic every rank's loss reads whole,
`copy_to_axes(reduce_from_axes(x))`, so that its backward sums the
ranks' (loss-weighted) gradients too. With no row axes, or a product of
1, nothing is gathered.
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
from repro_torch.spmd import (all_gather_axes, all_reduce_axes, argmax_axes, copy_to_axes,
                              flat_index, fsdp_gather, gather_from_axes, local_shard, mesh_shape,
                              placements, reduce_from_axes, spec_axes)

_state = threading.local()


def _rules() -> Optional[dict]:
    return getattr(_state, "rules", None)


def _mesh():
    return getattr(_state, "mesh", None)


def row_axes() -> tuple:
    """The mesh axes the current call's batch rows are split over (() when
    every rank holds the whole batch, or outside any `sharding_ctx`)."""
    return getattr(_state, "row_axes", ())


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
def sharding_ctx(mesh, rules: Optional[dict] = None, row_axes: Sequence[str] = ()):
    """Install `mesh` (a `DeviceMesh` or a bare shape), its logical rules
    and the axes the call's batch rows are split over (see the module
    note) for this thread."""
    prev = (_mesh(), _rules(), getattr(_state, "row_axes", ()))
    _state.mesh = mesh
    _state.rules = rules or default_rules(mesh)
    _state.row_axes = tuple(row_axes)
    try:
        yield
    finally:
        _state.mesh, _state.rules, _state.row_axes = prev


def carry_ctx(fn):
    """`fn`, run under the mesh, rules and row axes installed on this
    thread now, whichever thread later calls it (a checkpointed layer's
    recompute runs on autograd's device thread on the card); `fn` itself
    outside any `sharding_ctx`."""
    mesh, rules, rows = _mesh(), _rules(), row_axes()
    if mesh is None:
        return fn

    def run(*args, **kwargs):
        with sharding_ctx(mesh, rules, rows):
            return fn(*args, **kwargs)
    return run


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


def ambient_mesh():
    """The mesh `sharding_ctx` installed on this thread (None outside one)."""
    return _mesh()


def ambient_rules() -> Optional[dict]:
    """The logical rules installed with it (None outside one)."""
    return _rules()


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
    """Sum `x` over the ambient mesh's `model` dim: in place without
    gradients, else out of place with the gradient passed back as it is
    (`spmd.reduce_from_axes`)."""
    return reduce_from_axes(x, _mesh(), ("model",))


def tp_all_gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Every `model` rank's `x`, concatenated along `dim` in rank order
    (with gradients, the backward keeps this rank's slice)."""
    return gather_from_axes(x, _mesh(), ("model",), dim=dim)


def tp_copy(x: torch.Tensor) -> torch.Tensor:
    """`x` replicated along `model` entering rank-local compute: the
    identity, whose backward sums the gradient over `model`
    (`spmd.copy_to_axes`; `x` itself without gradients)."""
    return copy_to_axes(x, _mesh(), ("model",))


def tp_argmax(x: torch.Tensor, offset: int) -> torch.Tensor:
    """The global argmax over the last dim of a tensor split along it over
    `model` (`spmd.argmax_axes`; this rank's columns start at `offset`)."""
    return argmax_axes(x, offset, _mesh(), ("model",))


def row_size() -> int:
    """The number of ranks the call's batch rows are split over (1 with no
    row axes)."""
    rows = row_axes()
    return math.prod(mesh_shape(_mesh())[a] for a in rows) if rows else 1


def row_index() -> int:
    """This rank's place among them (`spmd.flat_index` over the row axes):
    its rows are that block of the global batch."""
    return flat_index(_mesh(), row_axes()) if row_size() > 1 else 0


def row_all_gather(x: torch.Tensor) -> torch.Tensor:
    """Every row rank's `x` concatenated along dim 0 in `row_index` order
    (no gradient)."""
    return all_gather_axes(x, _mesh(), row_axes())


def row_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over the row axes, read whole by every rank: forward
    an all-reduce, backward an all-reduce of the gradients (each rank's
    loss weights its own), so that the statistic's gradient reaches every
    rank's addend once (`copy_to_axes(reduce_from_axes(x))`, T62's form
    over the row axes)."""
    mesh, rows = _mesh(), row_axes()
    return copy_to_axes(reduce_from_axes(x, mesh, rows), mesh, rows)


def split_dim(w: torch.Tensor) -> Optional[int]:
    """The dim along which `shard_model` cut this weight over `model`, or
    None for a weight every rank holds whole."""
    return getattr(w, "_tp_dim", None)


def fsdp_dim(w: torch.Tensor) -> Optional[int]:
    """The dim along which `shard_model` cut this weight over the data
    axes (FSDP), or None for a weight every data rank holds whole (a
    gathered one among them)."""
    return getattr(w, "_fsdp_dim", None)


def fsdp_axes(w: torch.Tensor) -> tuple:
    """The mesh axes that dim is cut over (() where it is not cut)."""
    return getattr(w, "_fsdp_axes", ())


def full(w: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """An FSDP-cut weight gathered whole over its data axes, under the
    ambient mesh (`spmd.fsdp_gather`: the backward reduce-scatters its
    gradient back to the shard), keeping its `model` mark; any other
    weight (None included) as it is."""
    d = fsdp_dim(w) if w is not None else None
    if d is None:
        return w
    mesh = _mesh()
    if mesh is None:
        raise RuntimeError("an FSDP-cut weight is gathered under its mesh: install it with "
                           "sharding_ctx")
    out = fsdp_gather(w, mesh, fsdp_axes(w), d)
    if split_dim(w) is not None:
        out._tp_dim = split_dim(w)
    return out


def gathered(module):
    """`module` with every FSDP-cut weight of it and of its submodules
    gathered (`full`): a shallow copy that shares everything else, built
    per call and dropped after it, so the gathered weights live as long
    as the layer's call (and what autograd saves of them). `module`
    itself where `shard_model` cut nothing in it (`_holds_fsdp`, one
    attribute read on the mesh-less model's hot path), and anything but
    a module as it is."""
    if not getattr(module, "_holds_fsdp", False):
        return module
    params = {n: full(p) for n, p in module._parameters.items()
              if p is not None and fsdp_dim(p) is not None}
    subs = {n: gathered(m) for n, m in module._modules.items()
            if getattr(m, "_holds_fsdp", False)}
    view = object.__new__(type(module))
    view.__dict__.update(module.__dict__)
    view.__dict__["_parameters"] = {**module._parameters, **params}
    view.__dict__["_modules"] = {**module._modules, **subs}
    view.__dict__["_holds_fsdp"] = False
    return view


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


def resident_spec(spec: tuple, stacked: bool) -> tuple:
    """The spec a rank holds a port tensor in: the JAX leaf's spec on the
    port tensor's dims (a stacked leaf's layer dim dropped, so every rank
    holds every layer), its `model` and data entries both kept."""
    return tuple(spec)[1:] if stacked else tuple(spec)


def compute_spec(spec: tuple, stacked: bool) -> tuple:
    """The spec a rank's compute holds a port tensor in once its layer
    has gathered it (`gathered`): `resident_spec` with every entry but
    `model` replicated."""
    return tuple("model" if e == "model" else None for e in resident_spec(spec, stacked))


def port_specs(leaves: dict, specs: dict) -> dict:
    """Port parameter name -> `resident_spec` of its JAX leaf's spec
    (`leaves` = `convert.jax_leaves(cfg)`, `specs` = leaf path -> spec)."""
    out = {}
    for path, leaf in leaves.items():
        spec = specs[path] or (None,) * len(leaf.shape)
        for name in leaf.names:
            out[name] = resident_spec(spec, leaf.stacked)
    return out


def _marks(spec: tuple) -> tuple:
    """(the dim `compute_spec` cuts over `model`, the dim cut over data
    axes, those axes) of a resident spec, None / () where there is none."""
    tp = next((d for d, e in enumerate(compute_spec(spec, False)) if e), None)
    data = [(d, spec_axes(e)) for d, e in enumerate(spec) if e is not None and e != "model"]
    fsdp, axes = data[0] if data else (None, ())
    return tp, fsdp, axes


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


def shard_model(model: torch.nn.Module, specs: dict, mesh, device,
                trainable: bool = False) -> torch.nn.Module:
    """Materialise a model built on the meta device on `device` (the meta
    device itself for a dry run), each parameter in its resident shape
    under `specs` (port name -> resident spec, `port_specs`) and marked
    with the dim it is cut along over `model` (`split_dim`) and the dim
    and axes it is cut along over the data axes (`fsdp_dim`,
    `fsdp_axes`), every module on the way to the latter marked for
    `gathered`; the cut parameters take part in autograd when
    `trainable` (the train step), not for the serve and prefill steps.
    The values are uninitialised: load them with `load_whole`."""
    marks = {}
    for name, p in list(model.named_parameters()):
        spec = specs[name]
        if all(e is None for e in spec):
            continue
        mod_name, _, attr = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        shape = local_shape(p.shape, spec, mesh)
        mod.register_parameter(attr, torch.nn.Parameter(
            torch.empty(shape, dtype=p.dtype, device="meta"), requires_grad=trainable))
        marks[name] = _marks(spec)
    model.to_empty(device=device)
    params = dict(model.named_parameters())
    for name, (tp, fsdp, axes) in marks.items():
        if tp is not None:
            params[name]._tp_dim = tp
        if fsdp is not None:
            params[name]._fsdp_dim, params[name]._fsdp_axes = fsdp, axes
            path = name.split(".")[:-1]     # the modules `gathered` walks to it
            for i in range(len(path) + 1):
                model.get_submodule(".".join(path[:i]))._holds_fsdp = True
    return model


@torch.no_grad()
def load_whole(model: torch.nn.Module, state: dict, specs: dict, mesh,
               partial: bool = False) -> None:
    """Copy a whole state dict (every tensor whole, the same on every
    rank) into a `shard_model` model: each tensor cut to its shard. With
    `partial` the state may hold only some of the parameters."""
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(state))
    if missing and not partial:
        raise ValueError(f"state lacks {missing[:4]}")
    for name, p in params.items():
        if name not in state:
            continue
        src = state[name]
        if split_dim(p) is not None or fsdp_dim(p) is not None:
            src = cut(src, specs[name], mesh)
        if tuple(src.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shard {tuple(src.shape)}, parameter {tuple(p.shape)}")
        p.copy_(src)


def whole(t: torch.Tensor, like: torch.Tensor, mesh) -> torch.Tensor:
    """A tensor in the resident shape of the weight `like` (the weight
    itself, or its gradient) whole on every rank: all-gathered over its
    data axes along its FSDP dim, then over `model` along its split dim;
    `t` as it is where `like` is not cut."""
    if fsdp_dim(like) is not None:
        t = all_gather_axes(t, mesh, fsdp_axes(like), dim=fsdp_dim(like))
    if split_dim(like) is not None:
        t = all_gather_axes(t, mesh, ("model",), dim=split_dim(like))
    return t


@torch.no_grad()
def gather_whole(model: torch.nn.Module, mesh) -> dict:
    """Every parameter of a `shard_model` model whole, by port name (the
    same on every rank): each cut one all-gathered over its data axes and
    over `model` (`whole`), the others as they are (detached, not
    copied)."""
    return {name: whole(p.detach(), p, mesh) for name, p in model.named_parameters()}


@torch.no_grad()
def whole_grads(grads: dict, params: dict, mesh, data_axes) -> dict:
    """Gradients of a `shard_model` model's parameters (by name, in their
    resident shapes, each rank's from its data shard of the batch) whole
    on every rank: summed over the data axes a weight is not cut over
    (there each rank's gradient is partial; over its FSDP axes the
    backward's reduce-scatter summed it already), then gathered
    (`whole`). Every rank takes part."""
    out = {}
    for n, t in grads.items():
        partial = tuple(a for a in data_axes if a not in fsdp_axes(params[n]))
        if partial:
            t = all_reduce_axes(t.clone(), mesh, partial)
        out[n] = whole(t, params[n], mesh)
    return out
