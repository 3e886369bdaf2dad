"""INT8 error-feedback gradient compression — counterpart of
`repro.optim.grad_compression`.

Gradients are symmetric-INT8 quantized (one scale per tensor) with
local error feedback. `quantize_tree` / `dequantize_tree` /
`init_error_feedback` take a dict or a list of tensors. The scale is
`absmax * float32(1/127)` (rule T1: what XLA makes of `absmax / 127.0`
in a jitted step). `compressed_psum` is the data-parallel all-reduce of
the compressed gradients over a device mesh (`launch.mesh`).
"""
from __future__ import annotations

import math

import numpy as np
import torch


def _q(x: torch.Tensor):
    absmax = x.abs().amax()
    recip = torch.tensor(np.float32(1) / np.float32(127), device=x.device)
    scale = torch.where(absmax > 0, absmax * recip, torch.ones_like(absmax))
    q = torch.clamp(torch.round(x / scale), -128, 127).to(torch.int8)
    return q, scale


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: fn(v) for k, v in tree.items()}
    return [fn(v) for v in tree]


def quantize_tree(tree):
    """-> (int8 codes, fp32 scales), each with the structure of `tree`."""
    qs = _map(lambda t: _q(t.float()), tree)
    if isinstance(qs, dict):
        return {k: v[0] for k, v in qs.items()}, {k: v[1] for k, v in qs.items()}
    return [v[0] for v in qs], [v[1] for v in qs]


def dequantize_tree(qtree, stree):
    if isinstance(qtree, dict):
        return {k: q.float() * stree[k] for k, q in qtree.items()}
    return [q.float() * s for q, s in zip(qtree, stree)]


def compressed_psum(grads, err, mesh, axis_names=("data",)):
    """Error-feedback INT8 all-reduce over the mesh dims `axis_names` (of
    a `DeviceMesh`; every rank of them calls it together), the
    reference's body inside `shard_map`: each rank quantizes g + e to
    INT8 with one scale a tensor, the fp32 q * scale is summed over the
    ranks and divided by their count, and g + e - q * scale is the new
    error feedback. grads / err: matching dicts or lists (err fp32).
    Returns (mean-reduced fp32 grads, new error feedback)."""
    from repro_torch.spmd import all_reduce_axes, mesh_shape

    sizes = mesh_shape(mesh)
    n = math.prod(sizes[a] for a in axis_names)

    def one(g, e):
        g32 = g.float() + e
        q, scale = _q(g32)
        local = q.float() * scale
        new_e = g32 - local
        return all_reduce_axes(local, mesh, axis_names) / n, new_e

    keys = grads.keys() if isinstance(grads, dict) else range(len(grads))
    out = {k: one(grads[k], err[k]) for k in keys}
    if isinstance(grads, dict):
        return {k: v[0] for k, v in out.items()}, {k: v[1] for k, v in out.items()}
    return [out[k][0] for k in keys], [out[k][1] for k in keys]


def init_error_feedback(params):
    return _map(lambda t: torch.zeros(t.shape, dtype=torch.float32, device=t.device),
                params)
