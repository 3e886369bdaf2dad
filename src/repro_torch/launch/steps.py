"""The train step — counterpart of `repro.launch.steps.build_train_step`.

One step: the loss and its gradients (over `grad_accum` microbatches),
then the AdamW update. With accum > 1 the batch splits into contiguous
microbatches along the batch axis (dim 1 of M-RoPE `positions`, which is
(3, B, S)); each microbatch's gradients are taken with
`torch.autograd.grad` and summed in fp32 buffers as `acc + g.float() /
accum`, the loss as `l / accum`, as the reference sums them. `.backward()`
would sum into `.grad` in the parameter's dtype (bf16 at full width).
The device mesh, the shardings and the lowered serve / prefill / train
steps of the reference belong to its dry-run and are not ported yet
(ROADMAP item 8, the scale-out half).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.convert import jax_leaves
from repro_torch.optim import adamw


def split_batch(batch: dict, accum: int) -> list:
    """`accum` microbatches of `batch`, contiguous along the batch axis."""
    def part(k, x, i):
        dim = 1 if k == "positions" and x.ndim == 3 else 0
        n = x.shape[dim] // accum
        return x.narrow(dim, i * n, n)
    return [{k: part(k, v, i) for k, v in batch.items()} for i in range(accum)]


def loss_and_grads(model, batch: dict, params: dict):
    """(loss, {name: gradient in the parameter's dtype}); a parameter the
    loss does not read gets zeros, as `jax.grad` gives it."""
    loss, _ = model.loss(batch)
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), dict(zip(params, grads))


def build_train_step(cfg: ModelConfig, ocfg: Optional[adamw.AdamWConfig] = None,
                     grad_accum: Optional[int] = None) -> Callable:
    """-> step(model, opt_state, batch) -> (opt_state, metrics {loss, lr,
    grad_norm}); the model's params (made trainable) and the state are
    updated in place. `grad_accum` None takes `cfg.grad_accum_steps`."""
    ocfg = ocfg or adamw.AdamWConfig()
    accum = grad_accum if grad_accum is not None else cfg.grad_accum_steps
    decay = adamw.decay_mask(jax_leaves(cfg))

    def train_step(model, opt: adamw.AdamWState, batch: dict):
        model.requires_grad_(True)
        params = dict(model.named_parameters())
        if accum <= 1:
            loss, grads = loss_and_grads(model, batch, params)
        else:
            grads = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for k, p in params.items()}
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            for mb in split_batch(batch, accum):
                l, g = loss_and_grads(model, mb, params)
                for k, gk in g.items():
                    grads[k].add_(gk.float() / accum)
                loss = loss + l / accum
        _, opt, metrics = adamw.update(ocfg, grads, opt, params, decay)
        metrics["loss"] = loss
        return opt, metrics

    return train_step
