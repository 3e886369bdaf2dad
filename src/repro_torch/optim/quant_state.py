"""Block-wise 8-bit AdamW moments — counterpart of
`repro.optim.quant_state`.

The second moment is stored as block-128 uint8 codes with one fp32 scale
per block (1.03 bytes/param instead of 4), the first moment as bf16;
with the fp32 master that is 7.03 bytes/param of optimizer state against
12 for fp32 AdamW.

The JAX package quantizes each (layer-stacked) leaf as one flat vector,
so where a layer's element count is not a multiple of 128 a block spans
two layers and shares one scale. The port holds a model's layers as
separate tensors; `init` / `update` take `groups` (JAX leaf -> the port
parameters that make it up, in layer order: `models.convert.jax_leaves`)
and quantize each group's concatenation, the same flattening, so codes
and scales are bit-equal to the JAX package's. A plain dict of tensors is
one group per tensor.

The scale is `max * float32(1/255)`, which is what XLA makes of the
reference's `max / 255.0` inside a jitted step (rule T1); the codes are a
true division.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .adamw import AdamWConfig, adam_step, global_norm, schedule

BLOCK = 128


class QuantMoment(NamedTuple):
    codes: torch.Tensor   # uint8 (n_blocks, BLOCK)
    scales: torch.Tensor  # fp32 (n_blocks, 1)
    size: int             # the unpadded element count


class Adam8State(NamedTuple):
    step: torch.Tensor    # () int32
    master: dict          # fp32, by parameter name
    mu: dict              # bf16, by parameter name
    nu: dict              # QuantMoment, by group


def quantize_nonneg(x: torch.Tensor) -> QuantMoment:
    """Non-negative tensor -> block-wise uint8 codes over its flattening."""
    flat = x.float().reshape(-1)
    blocks = F.pad(flat, (0, (-flat.numel()) % BLOCK)).reshape(-1, BLOCK)
    recip = torch.tensor(np.float32(1) / np.float32(255), device=x.device)
    scales = blocks.amax(dim=-1, keepdim=True) * recip
    safe = torch.where(scales > 0, scales, torch.ones_like(scales))
    codes = torch.clamp(torch.round(blocks / safe), 0, 255).to(torch.uint8)
    return QuantMoment(codes=codes, scales=scales, size=flat.numel())


def dequantize_nonneg(qm: QuantMoment, shape) -> torch.Tensor:
    flat = (qm.codes.float() * qm.scales).reshape(-1)
    return flat[: qm.size].reshape(shape)


def _groups(params: dict, groups: Optional[dict]) -> dict:
    return groups if groups is not None else {k: (k,) for k in params}


def init(params: dict, groups: Optional[dict] = None) -> Adam8State:
    """`groups`: group name -> parameter names whose concatenation (in that
    order) one quantized moment covers (default: one per parameter)."""
    dev = next(iter(params.values())).device
    return Adam8State(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        master={k: p.detach().float().clone() for k, p in params.items()},
        mu={k: torch.zeros(p.shape, dtype=torch.bfloat16, device=p.device)
            for k, p in params.items()},
        nu={gname: quantize_nonneg(torch.zeros(sum(params[n].numel() for n in names),
                                               device=dev))
            for gname, names in _groups(params, groups).items()})


def state_bytes_per_param() -> float:
    return 4.0 + 2.0 + (1.0 + 4.0 / BLOCK)  # master + mu + nu (+ scales)


@torch.no_grad()
def update(cfg: AdamWConfig, grads: dict, state: Adam8State, params: dict,
           groups: Optional[dict] = None, decay: Optional[dict] = None):
    """One 8-bit-moment AdamW step -> (params, state, metrics), the fp32
    AdamW step on the dequantized second moment and the fp32 first moment,
    which are then stored back as uint8 codes and bf16. Params, master and
    mu are updated in place."""
    gnorm = global_norm(grads.values())
    step, lr, clip, bc1, bc2 = schedule(cfg, state.step, gnorm)
    new_nu = {}
    for gname, names in _groups(params, groups).items():
        nu = dequantize_nonneg(state.nu[gname], (-1,))
        off = 0
        for k in names:
            m = state.master[k]
            n = m.numel()
            nu_k = nu[off:off + n].view(m.shape)
            off += n
            mu32 = state.mu[k].float()
            adam_step(cfg, grads[k], m, mu32, nu_k, lr, clip, bc1, bc2,
                      m.ndim >= 2 if decay is None else decay[k])
            state.mu[k].copy_(mu32)
            params[k].copy_(m)
        new_nu[gname] = quantize_nonneg(nu)
    return params, state._replace(step=step, nu=new_nu), \
        {"lr": lr, "grad_norm": gnorm}
