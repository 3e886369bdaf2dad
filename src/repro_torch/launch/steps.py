"""The production steps — counterpart of `repro.launch.steps`: the train
step (`build_train_step`), the inference steps on a device mesh
(`build_serve_step`, `build_prefill_step`, `build_cell`) and the
placement tables (`batch_shardings`, `cache_shardings`,
`inference_param_shardings`).

One step: the loss and its gradients (over `grad_accum` microbatches),
then the AdamW update. With accum > 1 the batch splits into contiguous
microbatches along the batch axis (dim 1 of M-RoPE `positions`, which is
(3, B, S)); each microbatch's gradients are taken with
`torch.autograd.grad` and summed in fp32 buffers as `acc + g.float() /
accum`, the loss as `l / accum`, as the reference sums them. `.backward()`
would sum into `.grad` in the parameter's dtype (bf16 at full width).

Under a device mesh (`mesh=`, a `DeviceMesh` over ("data", "model") or
("pod", "data", "model"), `launch.mesh`) the step is the reference's
sharded one in `torch.distributed` terms:
  * every rank takes its data shard of each microbatch
    (`batch_shardings`: the batch dim over the data axes);
  * the loss is the global mean: each rank's loss is weighted by its
    share of the microbatch's valid labels (the label counts are summed
    over the data axes), so ranks with unequal counts still give the
    mean over all labels;
  * the fp32 master and moments live as DTensors per JAX leaf (a stacked
    leaf's layers stacked again) in the ZeRO-1 placement of
    `optim.adamw.state_shardings`, so a layer-dim shard gives each rank
    whole layers;
  * each leaf's gradient is reduced over the data axes only (ranks along
    `model` hold the same batch shard and the same gradient) and
    re-sharded into the state's placement (a reduce-scatter), in the
    parameter's dtype, as the reference pins it before the fp32 cast;
  * the clip norm adds each element's square once (the rank at
    coordinate 0 of every dim the shard is replicated over counts it),
    in the order of the model's parameters, then sums over the mesh;
  * the update runs on each rank's shards; the new master, cast to the
    parameter dtype, is all-gathered whole from the state's placement
    into the model's weights, which the next forward reads (GSPMD's FSDP
    all-gather, here once a step for the whole model).
Tensor-parallel compute (column / row-parallel matmuls with their
all-reduce) is not in this step: ranks along `model` run the same
forward and backward, and `model` shards storage only. MoE routing
takes capacity from the whole batch, so a MoE model refuses a data axis
larger than 1. At world size 1 the step repeats the mesh-less one bit
for bit.

The serve and prefill steps run tensor-parallel over `model`: weights
in the inference placement (`inference_param_shardings`; each rank
holds its `model` shards, `models.sharding.shard_model`), the decode
caches in the reference's "SP / flash-decoding" layout
(`cache_shardings`: batch over the data axes, KV sequence over
`model`), the residual stream replicated along `model`, each rank
taking its data shard of the batch (`batch_shardings`). The layers
(`models.layers`, `attention`, `moe`) do the column / row-parallel
matmuls, the vocabulary-parallel embedding, head and argmax, and the
sequence-sharded decode attention. Every rank runs the same program on
its shards, as the reference's SPMD program does; nothing crosses the
data axes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig, shape_applicable
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.spmd import (all_reduce_axes, batch_axes, flat_index, local_shard,
                              mesh_shape, placements, spec_axes)
from repro_torch.models import build_model, cache_specs, input_specs, layers, sharding
from repro_torch.models.convert import jax_leaves
from repro_torch.models.transformer import FAMILIES
from repro_torch.optim import adamw


def split_batch(batch: dict, accum: int) -> list:
    """`accum` microbatches of `batch`, contiguous along the batch axis."""
    def part(k, x, i):
        dim = 1 if k == "positions" and x.ndim == 3 else 0
        n = x.shape[dim] // accum
        return x.narrow(dim, i * n, n)
    return [{k: part(k, v, i) for k, v in batch.items()} for i in range(accum)]


def loss_and_grads(model, batch: dict, params: dict, weight=None):
    """(loss, {name: gradient in the parameter's dtype}) of the model's
    loss times `weight` (None: 1); a parameter the loss does not read gets
    zeros, as `jax.grad` gives it."""
    loss, _ = model.loss(batch)
    if weight is not None:
        loss = loss * weight
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), dict(zip(params, grads))


# ------------------------------------------------------------- shardings
def batch_shardings(mesh, specs: dict) -> dict:
    """Batch key -> spec (see `models.sharding`): the batch dim over the
    data axes where it divides their product; M-RoPE `positions` (3, b,
    s) on dim 1. `specs` maps each key to a tensor or a shape; `mesh` is
    a `DeviceMesh` or a bare shape."""
    ba = batch_axes(mesh)
    sizes = mesh_shape(mesh)
    sz = math.prod(sizes[a] for a in ba)
    entry = (ba if len(ba) > 1 else ba[0]) if ba else None
    out = {}
    for k, v in specs.items():
        shape = tuple(getattr(v, "shape", v))
        if k == "positions" and len(shape) == 3:   # (3, b, s): b is dim 1
            out[k] = (None, entry, None)
        else:
            out[k] = (entry if shape[0] % sz == 0 else None, *([None] * (len(shape) - 1)))
    return out


def shard_batch(batch: dict, mesh) -> dict:
    """This rank's data shard of `batch` (views), by `batch_shardings`.
    A batch dim that does not divide over the data axes raises."""
    sizes = mesh_shape(mesh)
    n = math.prod(sizes[a] for a in batch_axes(mesh))
    out = {}
    for k, x in batch.items():
        spec = batch_shardings(mesh, {k: x})[k]
        dim = 1 if k == "positions" and x.ndim == 3 else 0
        if n > 1 and spec[dim] is None:
            raise ValueError(f"batch {k} of {x.shape[dim]} rows does not divide over "
                             f"the data axes' {n} ranks")
        if spec[dim] is not None:
            rows = x.shape[dim] // n
            x = x.narrow(dim, flat_index(mesh, spec_axes(spec[dim])) * rows, rows)
        out[k] = x
    return out


def _stacked(tensors: dict, leaf) -> torch.Tensor:
    """A JAX leaf's value from the port tensors that make it up."""
    if leaf.stacked:
        return torch.stack([tensors[n] for n in leaf.names])
    return tensors[leaf.names[0]]


def _layer_offset(local: torch.Tensor, mesh, place: tuple) -> int:
    """Index of the first layer a stacked leaf's local shard holds."""
    from torch.distributed.tensor import Shard

    off = 0
    for i, p in enumerate(place):
        if isinstance(p, Shard) and p.dim == 0:
            off = off * mesh.size(i) + mesh.get_local_rank(i)
    return off * local.shape[0]


class MeshPlan:
    """What a sharded step needs of a config over a mesh: each JAX leaf's
    param and state spec, the state's placements, and its weight-decay
    flag."""

    def __init__(self, cfg: ModelConfig, mesh):
        self.mesh = mesh
        self.leaves = jax_leaves(cfg)
        self.param_specs = sharding.param_shardings(mesh, self.leaves, cfg)
        shapes = {p: leaf.shape for p, leaf in self.leaves.items()}
        self.state_specs = adamw.state_shardings(mesh, self.param_specs, shapes).master
        self.state_place = {p: placements(s, mesh) for p, s in self.state_specs.items()}
        self.decay = {p: leaf.ndim >= 2 for p, leaf in self.leaves.items()}
        self.data_axes = batch_axes(mesh)
        self.all_axes = tuple(mesh.mesh_dim_names)

    def shard(self, full: torch.Tensor, path: str, zeros: bool = False):
        """A DTensor in the state placement from a value every rank holds
        (its shard copied out), or zeros of that DTensor's shape."""
        from torch.distributed.tensor import DTensor

        place = self.state_place[path]
        local = local_shard(full, self.mesh, place)
        local = torch.zeros_like(local) if zeros else local.clone()
        return DTensor.from_local(local, self.mesh, place)

    def counted(self, path: str) -> bool:
        """Whether this rank counts the local shard's squares: the rank at
        coordinate 0 of every mesh dim the shard is replicated over."""
        from torch.distributed.tensor import Replicate

        return all(self.mesh.get_local_rank(i) == 0
                   for i, p in enumerate(self.state_place[path]) if isinstance(p, Replicate))


def init_sharded(params: dict, cfg: ModelConfig, mesh) -> adamw.AdamWState:
    """`adamw.init` of the model's parameters (the same on every rank),
    each JAX leaf's fp32 master and zero moments as DTensors in the ZeRO-1
    placement. Slicing only: no collective."""
    plan = MeshPlan(cfg, mesh)
    master, mu, nu = {}, {}, {}
    for path, leaf in plan.leaves.items():
        full = _stacked({n: params[n].detach().float() for n in leaf.names}, leaf)
        master[path] = plan.shard(full, path)
        mu[path] = plan.shard(full, path, zeros=True)
        nu[path] = plan.shard(full, path, zeros=True)
        del full
    dev = next(iter(params.values())).device
    return adamw.AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                            master=master, mu=mu, nu=nu)


def gather_state(opt: adamw.AdamWState, cfg: ModelConfig) -> adamw.AdamWState:
    """A sharded state whole on the host, by port parameter name (the
    mesh-less state's layout, which checkpoints hold): every rank
    all-gathers, one leaf at a time."""
    leaves = jax_leaves(cfg)

    def whole(tree):
        out = {}
        for path, t in tree.items():
            full = t.full_tensor().cpu()
            leaf = leaves[path]
            out.update(zip(leaf.names, full.unbind(0)) if leaf.stacked
                       else {leaf.names[0]: full})
        return out
    return opt._replace(master=whole(opt.master), mu=whole(opt.mu), nu=whole(opt.nu))


def scatter_state(full: adamw.AdamWState, cfg: ModelConfig, mesh,
                  device: torch.device) -> adamw.AdamWState:
    """The inverse of `gather_state`: a whole state by port name (on any
    device, the same on every rank) -> this rank's shards on `device`."""
    plan = MeshPlan(cfg, mesh)

    def shards(tree):
        return {path: plan.shard(_stacked(tree, leaf).to(device), path)
                for path, leaf in plan.leaves.items()}
    return adamw.AdamWState(step=full.step.to(device), master=shards(full.master),
                            mu=shards(full.mu), nu=shards(full.nu))


def state_template(params: dict) -> adamw.AdamWState:
    """A whole state's structure, shapes and dtypes on the meta device: a
    restore target that allocates nothing."""
    def meta(p):
        return torch.empty(p.shape, dtype=torch.float32, device="meta")
    return adamw.AdamWState(
        step=torch.empty((), dtype=torch.int32, device="meta"),
        master={k: meta(p) for k, p in params.items()},
        mu={k: meta(p) for k, p in params.items()},
        nu={k: meta(p) for k, p in params.items()})


# ------------------------------------------------------------ train step
def _grads(model, batch: dict, params: dict, accum: int, mesh=None, data_axes=()):
    """(loss, grads by name) over `accum` microbatches; under a mesh each
    microbatch is this rank's data shard, weighted by its share of the
    microbatch's valid labels (summed over the data axes)."""
    parts = split_batch(batch, accum) if accum > 1 else [batch]
    loss = grads = None
    for mb in parts:
        weight = None
        if mesh is not None:
            mb = shard_batch(mb, mesh)
            count = (mb["labels"] >= 0).sum()
            total = all_reduce_axes(count.clone(), mesh, data_axes)
            weight = count / torch.clamp(total, min=1)
        lval, g = loss_and_grads(model, mb, params, weight)
        if accum <= 1:
            return lval, g
        if grads is None:
            grads = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for k, p in params.items()}
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
        for k, gk in g.items():
            grads[k].add_(gk.float() / accum)
        loss = loss + lval / accum
    return loss, grads


def _mesh_train_step(cfg: ModelConfig, ocfg: adamw.AdamWConfig, accum: int, mesh):
    from torch.distributed.tensor import DTensor, Partial, Replicate

    if cfg.moe is not None and math.prod(mesh_shape(mesh)[a] for a in batch_axes(mesh)) > 1:
        raise NotImplementedError(
            f"{cfg.name}: MoE routing takes capacity and ranks from the whole batch, "
            "which a data axis splits: ROADMAP item 8's 'MoE routing over the global "
            "batch under a data axis'")
    plan = MeshPlan(cfg, mesh)
    partial = tuple(Partial() if a in plan.data_axes else Replicate()
                    for a in mesh.mesh_dim_names)

    @torch.no_grad()
    def update(opt: adamw.AdamWState, grads: dict, params: dict):
        g_local = {}
        for path, leaf in plan.leaves.items():
            g = _stacked(grads, leaf)
            for n in leaf.names:
                del grads[n]
            g_local[path] = DTensor.from_local(g, mesh, partial).redistribute(
                mesh, plan.state_place[path]).to_local()
            del g
        # each element's square once, summed in the parameters' order
        sq = {}
        for path, leaf in plan.leaves.items():
            gl = g_local[path]
            if not plan.counted(path):
                continue
            if leaf.stacked:
                off = _layer_offset(gl, mesh, plan.state_place[path])
                for j in range(gl.shape[0]):
                    sq[leaf.names[off + j]] = torch.sum(gl[j].float() ** 2)
            else:
                sq[leaf.names[0]] = torch.sum(gl.float() ** 2)
        zero = torch.zeros((), dtype=torch.float32, device=opt.step.device)
        total = sum(sq.get(k, zero) for k in params)
        gnorm = torch.sqrt(all_reduce_axes(total, mesh, plan.all_axes))
        step, lr, clip, bc1, bc2 = adamw.schedule(ocfg, opt.step, gnorm)
        for path, leaf in plan.leaves.items():
            m = opt.master[path].to_local()
            adamw.adam_step(ocfg, g_local.pop(path), m, opt.mu[path].to_local(),
                            opt.nu[path].to_local(), lr, clip, bc1, bc2, plan.decay[path])
            p0 = params[leaf.names[0]]
            new = DTensor.from_local(m.to(p0.dtype), mesh, plan.state_place[path])
            full = new.full_tensor()
            for n, layer in (zip(leaf.names, full.unbind(0)) if leaf.stacked
                             else [(leaf.names[0], full)]):
                params[n].copy_(layer)
        return opt._replace(step=step), {"lr": lr, "grad_norm": gnorm}

    def train_step(model, opt: adamw.AdamWState, batch: dict):
        model.requires_grad_(True)
        params = dict(model.named_parameters())
        loss, grads = _grads(model, batch, params, accum, mesh, plan.data_axes)
        opt, metrics = update(opt, grads, params)
        metrics["loss"] = all_reduce_axes(loss.clone(), mesh, plan.data_axes)
        return opt, metrics

    return train_step


def build_train_step(cfg: ModelConfig, ocfg: Optional[adamw.AdamWConfig] = None,
                     grad_accum: Optional[int] = None, mesh=None) -> Callable:
    """-> step(model, opt_state, batch) -> (opt_state, metrics {loss, lr,
    grad_norm}); the model's params (made trainable) and the state are
    updated in place. `grad_accum` None takes `cfg.grad_accum_steps`.
    With `mesh` the state comes from `init_sharded` and every rank passes
    the same global batch (see the module note)."""
    ocfg = ocfg or adamw.AdamWConfig()
    accum = grad_accum if grad_accum is not None else cfg.grad_accum_steps
    if mesh is not None:
        return _mesh_train_step(cfg, ocfg, accum, mesh)
    decay = adamw.decay_mask(jax_leaves(cfg))

    def train_step(model, opt: adamw.AdamWState, batch: dict):
        model.requires_grad_(True)
        params = dict(model.named_parameters())
        loss, grads = _grads(model, batch, params, accum)
        _, opt, metrics = adamw.update(ocfg, grads, opt, params, decay)
        metrics["loss"] = loss
        return opt, metrics

    return train_step


# --------------------------------------------------- inference placement
def cache_leaves(caches, prefix: str = "") -> dict:
    """Leaf path -> tensor of a cache tree (NamedTuples of tensors), the
    paths the reference's `tree_map_with_path` gives: "k", "length",
    "mamba/ssm", ..."""
    out = {}
    for name, leaf in zip(caches._fields, caches):
        path = f"{prefix}{name}"
        if isinstance(leaf, tuple):
            out.update(cache_leaves(leaf, path + "/"))
        else:
            out[path] = leaf
    return out


def map_caches(caches, fn, prefix: str = ""):
    """The cache tree with each leaf replaced by fn(path, leaf)."""
    return type(caches)(*(
        map_caches(leaf, fn, f"{prefix}{name}/") if isinstance(leaf, tuple)
        else fn(f"{prefix}{name}", leaf) for name, leaf in zip(caches._fields, caches)))


def _cache_path_spec(path_str: str, shape, mesh) -> tuple:
    """Decode-cache placement: batch over the data axes, KV sequence over
    `model` (SP / flash-decoding layout), SSM heads and `conv_x` channels
    over `model`, lengths replicated."""
    ba = batch_axes(mesh)
    sizes = mesh_shape(mesh)
    bsz = math.prod(sizes[a] for a in ba)
    msz = sizes.get("model", 1)
    entry = (ba if len(ba) > 1 else ba[0]) if ba else None

    def b_ok(dim):
        return entry if dim % bsz == 0 and dim >= bsz else None

    name = path_str.split("/")[-1]
    nd = len(shape)
    if name in ("k", "v", "shared_k", "shared_v", "self_k", "self_v", "cross_k", "cross_v",
                "ssm"):
        # (L, b, S, kh, hd): the sequence over `model`; (L, b, h, p, n): the heads
        return (None, b_ok(shape[1]), "model" if shape[2] % msz == 0 else None, None, None)
    if name.startswith("conv_x"):
        return (None, b_ok(shape[1]), None, "model" if shape[-1] % msz == 0 else None)
    if name.startswith("conv_"):
        return (None, b_ok(shape[1]), None, None)
    return (None,) * nd


def cache_shardings(mesh, caches) -> dict:
    """Cache leaf path -> spec over `mesh` (a `DeviceMesh` or a bare
    shape) for a cache tree (`models.cache_specs` or live caches)."""
    return {path: _cache_path_spec(path, tuple(leaf.shape), mesh)
            for path, leaf in cache_leaves(caches).items()}


def inference_param_shardings(cfg: ModelConfig, mesh, leaves: Optional[dict] = None) -> dict:
    """JAX leaf path -> spec of the serve and prefill steps' weights:
    tensor-parallel and replicated over the data axes when they fit
    (`sharding.inference_rules`), else the training placement with FSDP.
    `leaves` defaults to `convert.jax_leaves(cfg)`."""
    leaves = jax_leaves(cfg) if leaves is None else leaves
    return sharding.param_shardings(mesh, leaves, cfg,
                                    rules=sharding.inference_rules(mesh, cfg, leaves))


# ------------------------------------------------------ inference steps
def last_logits(model, batch: dict) -> torch.Tensor:
    """fp32 logits at the last position of a prefill batch (`frames` for
    audio, `positions` for vlm): this rank's vocabulary columns under a
    vocabulary split. The reference takes the argmax of `logits[:, -1]`
    and reads no other position, so the head runs there only, which keeps
    (b, s, V) fp32 logits (52 GB at phi4-mini's prefill_32k share) off
    the card."""
    family = model.cfg.family
    if family == "audio":
        x = model.hidden_states(batch["tokens"], batch["frames"])
    elif family in FAMILIES:
        x = model.hidden_states(batch["tokens"], positions=batch.get("positions"))[0]
    else:
        x = model.hidden_states(batch["tokens"])
    return model.head_logits(x[:, -1])


def _refuse(cfg: ModelConfig, mesh, shape: ShapeConfig) -> None:
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        raise ValueError(why)
    sizes = mesh_shape(mesh)
    if sizes.get("model", 1) > 1 and cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family runs on a `model` axis of 1 only: "
            "ROADMAP item 8's 'Tensor-parallel compute for the ssm, hybrid and audio "
            "families'")
    if cfg.moe is not None and math.prod(sizes[a] for a in batch_axes(mesh)) > 1:
        raise NotImplementedError(
            f"{cfg.name}: MoE routing takes capacity and ranks from the whole batch, "
            "which a data axis splits: ROADMAP item 8's 'MoE routing over the global "
            "batch under a data axis'")


@dataclasses.dataclass
class StepArtifacts:
    """One cell's step on this rank (the reference's `StepArtifacts` and
    its lowered program): `fn`, the model holding this rank's weight
    shards, and every placement as data: `param_specs` (JAX leaf path ->
    spec, the inference table), `port_specs` (port name -> the spec a
    rank computes in, `sharding.compute_spec`), `batch_specs` and, for a
    serve step, `cache_specs` (cache leaf path -> spec). The local shapes
    follow from them (`param_shapes`, `cache_shapes`, `batch_shapes`).
    A train cell's `fn` is `build_train_step(mesh=)` over a model that
    holds every weight whole."""

    fn: Callable
    model: torch.nn.Module
    mesh: object
    shape: ShapeConfig
    rules: dict
    param_specs: dict
    port_specs: dict
    batch_specs: dict
    cache_specs: Optional[dict] = None

    def context(self):
        """The mesh and rules installed for the layers (`sharding_ctx`)."""
        return sharding.sharding_ctx(self.mesh, self.rules)

    @property
    def param_shapes(self) -> dict:
        return {n: tuple(p.shape) for n, p in self.model.named_parameters()}

    @property
    def batch_shapes(self) -> dict:
        specs = input_specs(self.model.cfg, self.shape)
        return {k: sharding.local_shape(v.shape, self.batch_specs[k], self.mesh)
                for k, v in specs.items()}

    @property
    def cache_shapes(self) -> dict:
        caches = cache_leaves(cache_specs(self.model.cfg, self.shape))
        return {p: sharding.local_shape(v.shape, self.cache_specs[p], self.mesh)
                for p, v in caches.items()}

    def load_state_dict(self, state: dict) -> None:
        """Load whole weights (a port state dict, the same on every rank),
        each cut to this rank's shard."""
        sharding.load_whole(self.model, state, self.port_specs, self.mesh)

    def local_batch(self, batch: dict) -> dict:
        """This rank's shard (views) of a whole batch, by `batch_specs`."""
        return {k: sharding.cut(torch.as_tensor(v), self.batch_specs[k], self.mesh)
                for k, v in batch.items()}

    def local_caches(self, caches):
        """This rank's shard (views) of whole caches, by `cache_specs`."""
        return map_caches(caches, lambda p, t: sharding.cut(t, self.cache_specs[p], self.mesh))

    @torch.inference_mode()
    def new_caches(self, prefix_len: Optional[int] = None):
        """Zero local caches at logical length `prefix_len` (default
        `seq_len - 1`, as `cache_specs`), allocated at their local shapes
        (the lengths whole, as they are replicated)."""
        want = self.cache_shapes
        k = next((s for p, s in want.items() if p.split("/")[-1] in ("k", "self_k", "shared_k")),
                 None)
        prefix = self.shape.seq_len - 1 if prefix_len is None else prefix_len
        caches = self.model.init_caches(self.batch_shapes["token"][0],
                                        self.shape.seq_len if k is None else k[2], prefix)
        caches = caches._replace(length=torch.full(want["length"], prefix, dtype=torch.int32,
                                                   device=caches.length.device))
        got = {p: tuple(t.shape) for p, t in cache_leaves(caches).items()}
        if got != want:
            raise ValueError(f"local caches {got} are not the placement's {want}")
        return caches


def _mesh_device(mesh, device: DeviceLike) -> torch.device:
    dev = resolve_device(device)
    if dev.type != mesh.device_type:
        raise ValueError(f"the mesh is on {mesh.device_type}, the step asked for {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _inference_model(cfg: ModelConfig, mesh, device: DeviceLike):
    """(model with this rank's weight shards, rules, leaf specs, port specs)."""
    dev = _mesh_device(mesh, device)
    leaves = jax_leaves(cfg)
    rules = sharding.inference_rules(mesh, cfg, leaves)
    specs = sharding.param_shardings(mesh, leaves, cfg, rules=rules)
    port = sharding.port_specs(leaves, specs)
    model = sharding.shard_model(build_model(cfg, device="meta"), port, mesh, dev)
    return model, rules, specs, port


def build_serve_step(cfg: ModelConfig, mesh, shape: ShapeConfig,
                     device: DeviceLike = None) -> StepArtifacts:
    """One-token decode against caches of capacity `shape.seq_len`: `fn(
    caches, batch) -> (token (b,) int32, caches)`, all of them this rank's
    shards (the lengths whole: they are replicated). The caches are
    written in place (the reference donates them). `model.decode_step`,
    then the greedy token over the (split) vocabulary."""
    _refuse(cfg, mesh, shape)
    model, rules, specs, port = _inference_model(cfg, mesh, device)
    c_specs = cache_shardings(mesh, cache_specs(cfg, shape))
    if mesh_shape(mesh).get("model", 1) > 1 and any(
            p.split("/")[-1] in ("k", "v") and s[2] is None for p, s in c_specs.items()):
        raise ValueError(f"a cache of {shape.seq_len} positions does not divide over "
                         f"model ({mesh_shape(mesh)['model']})")
    b_specs = batch_shardings(mesh, input_specs(cfg, shape))

    data = batch_axes(mesh)

    @torch.inference_mode()
    def serve_step(caches, batch: dict):
        # the lengths are replicated: this rank reads those of its rows
        length, n = caches.length, batch["token"].shape[0]
        if n != length.shape[0]:
            i = flat_index(mesh, data) * n
            caches = caches._replace(length=length[i:i + n])
        with sharding.sharding_ctx(mesh, rules):
            logits, caches = model.decode_step(caches, batch["token"])
            token = layers.greedy_token(cfg, logits)
        return token, caches._replace(length=length + 1)

    return StepArtifacts(serve_step, model, mesh, shape, rules, specs, port, b_specs, c_specs)


def build_prefill_step(cfg: ModelConfig, mesh, shape: ShapeConfig,
                       device: DeviceLike = None) -> StepArtifacts:
    """Full-sequence forward to the greedy token at the last position:
    `fn(batch) -> token (b,) int32` on this rank's shard of the batch
    (`frames` for audio, `positions` for vlm)."""
    _refuse(cfg, mesh, shape)
    model, rules, specs, port = _inference_model(cfg, mesh, device)
    b_specs = batch_shardings(mesh, input_specs(cfg, shape))

    @torch.inference_mode()
    def prefill_step(batch: dict):
        with sharding.sharding_ctx(mesh, rules):
            return layers.greedy_token(cfg, last_logits(model, batch))

    return StepArtifacts(prefill_step, model, mesh, shape, rules, specs, port, b_specs)


def build_cell(cfg: ModelConfig, mesh, shape: ShapeConfig,
               device: DeviceLike = None) -> StepArtifacts:
    """The step of one (arch x shape x mesh) cell, picked by `shape.kind`
    — the counterpart of the reference's `lower_cell`. PyTorch has no
    "lowered" program: what stands for each reference function is a
    callable over this rank's shards, built now and run eagerly:
    `prefill_step_lowered` -> `build_prefill_step`, `serve_step_lowered`
    -> `build_serve_step`, `train_step_lowered` -> `build_train_step(
    mesh=)` (its `fn(model, opt, batch)` over a model holding every weight
    whole, `init_sharded` making the state). A cell that does not apply
    raises ValueError with `shape_applicable`'s reason; one the port does
    not run yet raises NotImplementedError naming its ROADMAP item."""
    if shape.kind == "prefill":
        return build_prefill_step(cfg, mesh, shape, device)
    if shape.kind == "decode":
        return build_serve_step(cfg, mesh, shape, device)
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        raise ValueError(why)
    dev = _mesh_device(mesh, device)
    fn = build_train_step(cfg, mesh=mesh)
    leaves = jax_leaves(cfg)
    specs = sharding.param_shardings(mesh, leaves, cfg)
    whole = {n: (None,) * len(p.shape) for n, p in
             build_model(cfg, device="meta").named_parameters()}
    return StepArtifacts(fn, build_model(cfg, device=dev), mesh, shape, sharding.default_rules(mesh),
                         specs, whole, batch_shardings(mesh, input_specs(cfg, shape)))
