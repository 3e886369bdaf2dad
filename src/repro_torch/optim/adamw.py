"""AdamW with mixed-precision master weights — counterpart of
`repro.optim.adamw` (`AdamWConfig`, `cosine_lr`, `global_norm`, `init`,
`update`).

Model params may be bf16 (FULL configs); the optimizer keeps an fp32
master copy and two fp32 moments. Plain functions over dicts of tensors
keyed by parameter name (`dict(model.named_parameters())`): `update`
writes the moments, the master and the params IN PLACE (a 3.8B-param
model cannot afford a second copy of its state) and returns them.

What follows the JAX package's arithmetic: global-norm clipping with
`+1e-9`; fp32 bias corrections `1 - b**step`; the learning rate computed
in fp32 from the integer step; each moment and parameter expression in
the reference's operation order. Weight decay applies where the
parameter's JAX leaf has rank >= 2. The JAX package stacks a family's
layers on a leading axis, so every per-layer leaf (norm scales, biases,
Mamba2's `A_log` / `D` / `dt_bias`) is decayed there while a port layer
holds it as a (d,) tensor: models pass `decay` from
`models.convert.jax_leaves` (`decay_mask`); a plain dict of tensors
decays by its own ranks.

The ZeRO-1 tables (`zero1_spec`, `state_shardings`) are the reference's,
over JAX leaf paths; `launch.steps.build_train_step(mesh=...)` places
the state by them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable, NamedTuple, Optional, Sequence

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor   # () int32
    master: dict         # fp32 master params, by name
    mu: dict             # fp32
    nu: dict             # fp32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up then cosine decay to `min_lr_ratio`, in fp32."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    scale = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * scale


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32."""
    return torch.sqrt(sum(torch.sum(t.float() ** 2) for t in tensors))


def decay_mask(leaves: dict) -> dict:
    """Parameter name -> decayed, from `models.convert.jax_leaves(cfg)`:
    a parameter is decayed where its JAX leaf has rank >= 2."""
    return {n: leaf.ndim >= 2 for leaf in leaves.values() for n in leaf.names}


def init(params: dict) -> AdamWState:
    dev = next(iter(params.values())).device
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        master={k: p.detach().float().clone() for k, p in params.items()},
        mu={k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()},
        nu={k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()})


def schedule(cfg: AdamWConfig, state_step: torch.Tensor, gnorm: torch.Tensor):
    """(step + 1, lr, clip factor, bias corrections 1 - b1**t and 1 -
    b2**t) for gradients of global norm `gnorm`, shared by both
    optimizers and the sharded step."""
    step = state_step + 1
    lr = cosine_lr(cfg, step)
    clip = (torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0) if cfg.grad_clip
            else torch.ones((), device=gnorm.device))
    t = step.float()
    bc1 = 1 - torch.tensor(cfg.b1, dtype=torch.float32, device=t.device) ** t
    bc2 = 1 - torch.tensor(cfg.b2, dtype=torch.float32, device=t.device) ** t
    return step, lr, clip, bc1, bc2


def adam_step(cfg: AdamWConfig, g: torch.Tensor, m: torch.Tensor, mu: torch.Tensor,
              nu: torch.Tensor, lr, clip, bc1, bc2, decay: bool) -> None:
    """One element-wise AdamW update of the fp32 `m`, `mu`, `nu` in place,
    in the reference's operation order: mu = b1 mu + (1 - b1) g, nu = b2
    nu + ((1 - b2) g) g, m -= lr (mu / bc1 / (sqrt(nu / bc2) + eps) + wd
    m [decay])."""
    g = g.float() * clip
    mu.mul_(cfg.b1).add_(g * (1 - cfg.b1))
    g2 = (g * (1 - cfg.b2)) * g
    del g
    nu.mul_(cfg.b2).add_(g2)
    del g2
    den = (nu / bc2).sqrt_().add_(cfg.eps)
    upd = (mu / bc1).div_(den)
    del den
    if decay:
        upd.add_(cfg.weight_decay * m)
    m.sub_(upd.mul_(lr))


@torch.no_grad()
def update(cfg: AdamWConfig, grads: dict, state: AdamWState, params: dict,
           decay: Optional[dict] = None):
    """One AdamW step -> (params (model dtype), state, metrics {lr,
    grad_norm}). `grads` and `params` are keyed like the state; `decay`
    maps a name to whether it is decayed (default: its rank >= 2). The
    state and the params are updated in place."""
    gnorm = global_norm(grads.values())
    step, lr, clip, bc1, bc2 = schedule(cfg, state.step, gnorm)
    for k, g in grads.items():
        m = state.master[k]
        adam_step(cfg, g, m, state.mu[k], state.nu[k], lr, clip, bc1, bc2,
                  m.ndim >= 2 if decay is None else decay[k])
        params[k].copy_(m)
    return params, state._replace(step=step), {"lr": lr, "grad_norm": gnorm}


# ---------------------------------------------------------- ZeRO-1 specs
def zero1_spec(param_spec: Sequence, shape, data_axes=("data",),
               mesh_shape: Optional[dict] = None) -> tuple:
    """Extend a param spec (see `models.sharding`) with the data axes on
    the first unsharded dim whose size divides the data-axis product
    (ZeRO-1). On a JAX leaf's shape that dim may be the stacked layer dim:
    the state then goes to ranks by whole layers."""
    entries = list(param_spec) + [None] * (len(shape) - len(param_spec))
    # A mesh axis may appear at most once in a spec: if the param is
    # already (partially) FSDP-sharded over a data axis, leave it alone.
    used = set()
    for e in entries:
        for a in (e if isinstance(e, tuple) else (e,)):
            if a is not None:
                used.add(a)
    if any(a in used for a in data_axes):
        return tuple(entries)
    size = 1
    if mesh_shape:
        for a in data_axes:
            size *= mesh_shape.get(a, 1)
    if size <= 1:
        return tuple(entries)
    for i, (e, dim) in enumerate(zip(entries, shape)):
        if e is None and dim % size == 0 and dim >= size:
            entries[i] = data_axes if len(data_axes) > 1 else data_axes[0]
            return tuple(entries)
    return tuple(entries)


def state_shardings(mesh, param_specs: dict, shapes: dict) -> AdamWState:
    """Specs of the fp32 master and moments (ZeRO-1 over `param_specs`,
    both keyed by JAX leaf path; `shapes` the JAX leaves' shapes) and of
    the step (replicated, `()`). `mesh` is a `DeviceMesh` or a bare shape."""
    from repro_torch.spmd import batch_axes, mesh_shape

    sizes = mesh_shape(mesh)
    data_axes = batch_axes(sizes) or ("data",)
    tree = {p: zero1_spec(spec, shapes[p], data_axes, sizes)
            for p, spec in param_specs.items()}
    return AdamWState(step=(), master=tree, mu=dict(tree), nu=dict(tree))
