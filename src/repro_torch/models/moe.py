"""Top-k MoE with capacity-based scatter dispatch (Phi-3.5-MoE, Arctic) —
counterpart of `repro.models.moe.apply_moe`, in plain PyTorch as the JAX
package computes it (no Pallas kernel).

Every one of the call's T = b * s rows routes, padding and inactive
decode lanes included, and takes capacity: the capacity C comes from T
(the global batch's, under a data split: below), so a request's output
depends on what else shares its call, exactly as in the reference.
Each (token, k) pair ranks within its expert in token-major order (t0
k0, t0 k1, t1 k0, ...); ranks >= C are dropped.
Tokens are scattered into an (E, C + 1, d) buffer whose last row takes
the drops, every expert runs its SwiGLU on its (C, d) rows (one batched
matmul per weight, `ecd,edf->ecf`), and the kept results are gathered
back, weighted by the normalised gates and summed over k in the compute
dtype. Arctic adds a dense residual MLP on the same input.

Expert parallelism over a mesh's `model` dim of m > 1 ranks (the serve
and prefill steps; `sharding.shard_model` cuts `w_gate` / `w_up` /
`w_down` along E): every rank routes every one of the (replicated) rows
with the whole router, so the capacity, the ranks and the drops are the
reference's; it runs only its E/m experts, combines the (token, k) pairs
they took, and the partial outputs are summed over `model` in one
all-reduce before the dense residual is added. With top-2 routing a
token's two terms meet in that sum exactly as in the mesh-less `a + b`.

Routing over the global batch (row axes of D > 1 ranks, installed by
the steps: `sharding.row_axes`). The call's T rows are this rank's block
of the global batch (contiguous, rank-major), and the reference routes
the global batch: C = capacity(T D); each rank's (E,) counts of its
(token, k) pairs, and of its top-1 choices, go round in one all-gather
in rank order, and a pair's global rank is its local rank plus the
counts of its expert on the ranks before this one, so the ranks, the
keeps and the drops are the whole batch's. Each rank scatters its kept
pairs into their global slots of the (E, C + 1, d) buffer, the other
ranks' slots left zero, runs its experts over all C slots and gathers
its own back: no activation crosses the data axes, and rows are
independent in the expert matmuls, so its rows equal the whole batch's
bit for bit (the buffer's shape, and with it the GEMM, is the mesh-less
one). The aux losses are global: the (E,) router mass and the summed
logsumexp^2 go round in one all-reduce (`sharding.row_sum`, whose
backward sums the ranks' gradients: every data rank's loss carries the
same global aux weighted by its label share), the top-1 loads and the
kept pairs come from the gathered counts. Two collectives a MoE layer
forward, one more backward. With D of 1 nothing is gathered: the
mesh-less program.

In the backward pass (the train step) a rank's combine reaches only its
experts, so the gradients it gives the experts' input rows and the gate
probabilities are partial: both pass `sharding.tp_copy`, whose backward
sums them over `model`. The aux losses are computed whole on every rank
from the probabilities before that copy, so their gradient joins the
summed one once, not once a rank, and the router's and the input's
gradients come out whole on every rank.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import dtype as dt
from . import layers, sharding


class MoEAux(NamedTuple):
    load_balance_loss: torch.Tensor
    router_z_loss: torch.Tensor
    dropped_fraction: torch.Tensor


def capacity(tokens: int, cfg: ModelConfig) -> int:
    """Rows per expert for a call of `tokens` rows: int(T k / E * cf),
    clamped to [k, T] with k winning."""
    m = cfg.moe
    c = int(tokens * m.top_k / m.n_experts * m.capacity_factor)
    return max(m.top_k, min(tokens, c))


def route(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of each row of `probs` as `lax.top_k` gives it: values
    descending, the lower expert first on ties (a stable sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def apply_moe(cfg: ModelConfig, p, x: torch.Tensor) -> tuple[torch.Tensor, MoEAux]:
    """x (b, s, d) -> (y (b, s, d) in the compute dtype, MoEAux).

    `p` holds `router` (d, E), `w_gate` / `w_up` (E, d, f), `w_down` (E,
    f, d) and, for Arctic, `dense_residual` (an object with `w_gate`,
    `w_up`, `w_down`). `cfg.moe.router_jitter` is not applied: the
    reference adds it only when its caller passes a key, and none does."""
    m = cfg.moe
    p = sharding.gathered(p)                   # FSDP-cut router / experts, whole over data
    cdt = dt(cfg.compute_dtype)
    b, s, d = x.shape
    T = b * s
    E, K = m.n_experts, m.top_k
    D = sharding.row_size()                    # ranks splitting the global batch
    C = capacity(T * D, cfg)
    xt = x.reshape(T, d).to(cdt)

    logits = (xt @ p.router.to(cdt)).float()                    # (T, E)
    probs = torch.softmax(logits, dim=-1)
    split = sharding.split_dim(p.w_gate) is not None
    x_in, gates = (sharding.tp_copy(xt), sharding.tp_copy(probs)) if split else (xt, probs)
    gate_vals, expert_idx = route(gates, K)                     # (T, K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(dim=-1, keepdim=True), min=1e-9)

    # rank of each (token, k) within its expert: cumsum of one-hot counts
    flat_expert = expert_idx.reshape(-1)                        # (T*K,)
    onehot = F.one_hot(flat_expert, E).int()                    # (T*K, E)
    ranks = onehot.cumsum(dim=0) - onehot                       # rank before me
    my_rank = ranks.gather(1, flat_expert[:, None])[:, 0]
    if D > 1:
        # every rank's pair and top-1 counts, in rank order: the pairs of
        # the ranks before this one come first in global token order
        top1 = F.one_hot(expert_idx[:, 0], E).int()
        every = sharding.row_all_gather(torch.stack([onehot.sum(0), top1.sum(0)])[None])
        counts = every.sum(0)                                   # (2, E) global
        my_rank = my_rank + every[:sharding.row_index(), 0].sum(0)[flat_expert]
    keep = my_rank < C
    slot = torch.where(keep, my_rank, C).long()                 # C = overflow row

    # this rank's experts: all of them, or its E/m under expert parallelism
    n_local = p.w_gate.shape[0]
    local = flat_expert - sharding.tp_rank() * n_local
    mine = (local >= 0) & (local < n_local)
    local = torch.where(mine, local, 0)
    slot = torch.where(mine, slot, C)          # another rank's pair: the overflow row

    # scatter into (E, C+1, d); only the overflow row takes several writes
    buf = torch.zeros((n_local, C + 1, d), dtype=cdt, device=x.device)
    buf[local, slot] = x_in.repeat_interleave(K, dim=0)
    expert_in = buf[:, :C]                                      # (E, C, d)

    h = F.silu(torch.bmm(expert_in, p.w_gate.to(cdt))) * torch.bmm(expert_in, p.w_up.to(cdt))
    expert_out = torch.bmm(h, p.w_down.to(cdt))                 # (E, C, d)

    # combine: gather each kept (token, k) result, weight by its gate
    gathered = expert_out[local, torch.clamp(slot, max=C - 1)]  # (T*K, d)
    w = (gate_vals.reshape(-1) * (keep & mine).float()).to(cdt)
    y = (gathered * w[:, None]).reshape(T, K, d).sum(dim=1)
    if split:
        y = sharding.tp_all_reduce(y)

    dense = getattr(p, "dense_residual", None)
    if dense is not None:
        sub = dataclasses.replace(cfg, moe=None)
        y = y + layers.apply_mlp(sub, dense.w_gate, dense.w_up, dense.w_down, xt)

    if D > 1:
        # global means: the sums over every rank's rows, over T D
        sums = sharding.row_sum(torch.cat([probs.sum(dim=0),
                                           (torch.logsumexp(logits, dim=-1) ** 2).sum()[None]]))
        me, zl = sums[:E] / (T * D), sums[E] / (T * D)
        ce = counts[1].float().div(T * D)
        kept = torch.clamp(counts[0], max=C).sum()
        dropped = 1.0 - kept.float().div(T * D * K)
    else:
        me = probs.mean(dim=0)                                  # (E,) router mass
        ce = F.one_hot(expert_idx[:, 0], E).float().mean(dim=0)  # top-1 load
        zl = (torch.logsumexp(logits, dim=-1) ** 2).mean()
        dropped = 1.0 - keep.float().mean()
    aux = MoEAux(load_balance_loss=E * (me * ce).sum(), router_z_loss=zl,
                 dropped_fraction=dropped)
    return y.reshape(b, s, d), aux
