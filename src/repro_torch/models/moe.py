"""Top-k MoE with capacity-based scatter dispatch (Phi-3.5-MoE, Arctic) —
counterpart of `repro.models.moe.apply_moe`, in plain PyTorch as the JAX
package computes it (no Pallas kernel).

Every one of the call's T = b * s rows routes, padding and inactive
decode lanes included, and takes capacity: the capacity C comes from T,
so a request's output depends on what else shares its call, exactly as
in the reference. Each (token, k) pair ranks within its expert in
token-major order (t0 k0, t0 k1, t1 k0, ...); ranks >= C are dropped.
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
A data axis larger than 1 would split the batch that capacity counts:
the steps refuse it (ROADMAP item 8).

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
    cdt = dt(cfg.compute_dtype)
    b, s, d = x.shape
    T = b * s
    E, K = m.n_experts, m.top_k
    C = capacity(T, cfg)
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

    me = probs.mean(dim=0)                                      # (E,) router mass
    ce = F.one_hot(expert_idx[:, 0], E).float().mean(dim=0)     # top-1 load
    aux = MoEAux(load_balance_loss=E * (me * ce).sum(),
                 router_z_loss=(torch.logsumexp(logits, dim=-1) ** 2).mean(),
                 dropped_fraction=1.0 - keep.float().mean())
    return y.reshape(b, s, d), aux
