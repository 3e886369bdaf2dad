"""INT8 error-feedback gradient compression — counterpart of
`repro.optim.grad_compression`.

Gradients are symmetric-INT8 quantized (one scale per tensor) with
local error feedback. `quantize_tree` / `dequantize_tree` /
`init_error_feedback` take a dict or a list of tensors. The scale is
`absmax * float32(1/127)` (rule T1: what XLA makes of `absmax / 127.0`
in a jitted step). The data-parallel all-reduce `compressed_psum` needs a
device mesh and is not ported yet.
"""
from __future__ import annotations

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


def compressed_psum(grads, err, axis_names):
    raise NotImplementedError(
        "compressed_psum runs inside a data-parallel mesh: ROADMAP item 8's "
        "scale-out half (Training and scale-out (multi-GPU))")


def init_error_feedback(params):
    return _map(lambda t: torch.zeros(t.shape, dtype=torch.float32, device=t.device),
                params)
