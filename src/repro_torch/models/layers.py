"""Shared model building blocks: RMSNorm / LayerNorm, Mamba2's gated
RMSNorm, SwiGLU / GELU MLPs, embedding, logits, and the losses
(`cross_entropy_loss`, the fused head loss `lm_head_loss`) — counterpart
of `repro.models.layers`.

Parameters keep the JAX package's (d_in, d_out) layout, so a layer is
`x @ W`. They are stored in `cfg.param_dtype` and cast to
`cfg.compute_dtype` at each use, and every bf16 rounding site of the JAX
model is mirrored (norm in fp32 then cast back, fp32 logits, padded
vocab slots masked to -1e30), so greedy tokens agree.

The embedding and head functions gather an FSDP-cut table over the
data axes where they read it (`sharding.full`). Under a mesh whose
`model` dim is larger than 1 (`sharding.shard_model`)
the MLP is column-parallel in `w_gate` / `w_up` and row-parallel in
`w_down`, with one all-reduce over `model`; the embedding and the head
are split by vocabulary: `embed_tokens` looks up the tokens of its rows
(zeros elsewhere) and all-reduces, `logits_from_hidden` gives this
rank's vocabulary columns, and `greedy_token` takes the argmax across
ranks, the lower index winning a tie as `jnp.argmax` does. With
gradients (the train step) the MLP's input passes `sharding.tp_copy`,
whose backward sums the column-parallel partial gradients over `model`;
the row-parallel sum passes its gradient back as it is; and the fused head
loss `_HeadCE` takes its max, exponential sums and gold logits over
the vocabulary ranks.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import dtype as dt
from . import sharding


def apply_norm(cfg: ModelConfig, scale: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """RMSNorm or LayerNorm (`cfg.norm`; scale only, no bias) in fp32,
    cast back to x's dtype. LayerNorm divides by the population variance,
    as `jnp.var` does."""
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, correction=0)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
    else:
        y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + cfg.norm_eps)
    return (y * scale.float()).to(x.dtype)


def gated_rmsnorm(scale: torch.Tensor, x: torch.Tensor, z: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """Mamba2's gated RMSNorm, norm(x * silu(z)), in fp32, cast back to
    x's dtype. Given this rank's channels of x and z (fewer than the
    whole `scale`'s, which every rank holds), the mean square is the
    fp32 sum of squares over every rank's channels (`tp_all_reduce`)
    over the whole width, and this rank's slice of the scale applies. The
    statistic feeds this rank's channels only, so its gradient is partial
    and is summed over `model` too (`tp_copy` after the reduce, ROADMAP
    T62), as is the scale's."""
    g = x.float() * F.silu(z.float())
    n, width = g.shape[-1], scale.shape[-1]
    if n == width:
        ms = (g * g).mean(dim=-1, keepdim=True)
    else:
        ss = sharding.tp_copy(sharding.tp_all_reduce((g * g).sum(dim=-1, keepdim=True)))
        ms = ss / width
        r = sharding.tp_rank()
        scale = sharding.tp_copy(scale)[r * n:(r + 1) * n]
    y = g * torch.rsqrt(ms + eps) * scale.float()
    return y.to(x.dtype)


def apply_mlp(cfg: ModelConfig, w_gate: Optional[torch.Tensor], w_up: torch.Tensor,
              w_down: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU, or GELU (tanh approximation, `jax.nn.gelu`'s default) where
    there is no gate (`w_gate` None: `cfg.mlp == "gelu"`, and every
    encoder layer), in the compute dtype. The hidden width is the
    weights' (Arctic's dense residual passes its own)."""
    cdt = dt(cfg.compute_dtype)
    x = x.to(cdt)
    if sharding.split_dim(w_up) is not None:       # column-parallel: partial input grads
        x = sharding.tp_copy(x)
    if w_gate is not None:
        h = F.silu(x @ w_gate.to(cdt)) * (x @ w_up.to(cdt))
    else:
        h = F.gelu(x @ w_up.to(cdt), approximate="tanh")
    y = h @ w_down.to(cdt)
    if sharding.split_dim(w_down) is not None:     # row-parallel: partial sums
        y = sharding.tp_all_reduce(y)
    return y


def embed_tokens(cfg: ModelConfig, embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of `embed` at `tokens`, in the compute dtype. A
    vocabulary-split table looks up the tokens in its rows, zeros the
    others, and sums over `model`: exactly one rank adds a nonzero row.
    An FSDP-cut table is gathered over the data axes first."""
    embed = sharding.full(embed)
    w = embed.to(dt(cfg.compute_dtype))
    if sharding.split_dim(embed) is None:
        return w[tokens]
    rows = w.shape[0]
    local = tokens - sharding.tp_rank() * rows
    mine = (local >= 0) & (local < rows)
    x = torch.where(mine[..., None], w[local.clamp(0, rows - 1)], 0)
    return sharding.tp_all_reduce(x)


def vocab_offset(cfg: ModelConfig, logits: torch.Tensor) -> int:
    """The global column of this rank's first logit (0 when whole)."""
    n = logits.shape[-1]
    return 0 if n == cfg.padded_vocab_size else sharding.tp_rank() * n


def logits_from_hidden(cfg: ModelConfig, embed: torch.Tensor, x: torch.Tensor,
                       lm_head: Optional[torch.Tensor] = None) -> torch.Tensor:
    """fp32 logits over the padded vocab through the tied head (`embed`ᵀ)
    or, with `cfg.tie_embeddings` off, the (d, V) `lm_head`; soft-capped
    as c·tanh(logits / c) when `cfg.logit_softcap` is c > 0; pad slots
    -> -1e30. With the head split by vocabulary, this rank's columns. An
    FSDP-cut head is gathered over the data axes first."""
    cdt = dt(cfg.compute_dtype)
    embed, lm_head = sharding.full(embed), sharding.full(lm_head)
    w = embed.to(cdt).T if cfg.tie_embeddings else lm_head.to(cdt)
    logits = (x.to(cdt) @ w).float()
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    if cfg.padded_vocab_size != cfg.vocab_size:
        logits[..., max(cfg.vocab_size - vocab_offset(cfg, logits), 0):] = -1e30
    return logits


def greedy_token(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    """int32 argmax over the vocabulary of logits (..., V), or of this
    rank's columns of them (`logits_from_hidden` under a vocabulary
    split): the global index, the lowest one on a tie, as `jnp.argmax`."""
    if logits.shape[-1] == cfg.padded_vocab_size:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    return sharding.tp_argmax(logits, vocab_offset(cfg, logits)).to(torch.int32)


def gather_vocab(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    """The whole vocabulary's logits from every rank's columns."""
    if logits.shape[-1] == cfg.padded_vocab_size:
        return logits
    return sharding.tp_all_gather(logits.contiguous(), dim=-1)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross-entropy over the labels >= 0 (and `mask`). The gold
    logit is a gather, which equals the JAX package's one-hot sum bit for
    bit."""
    valid = labels >= 0 if mask is None else mask & (labels >= 0)
    safe = torch.clamp(labels, min=0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (logz - gold) * valid
    return nll.sum() / torch.clamp(valid.sum(), min=1)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with fp32 accumulation, rounded once to a's dtype. cuBLAS
    accumulates bf16 products in fp32; the CPU's bf16 GEMM is not promised
    to, so there the operands go up to fp32 first."""
    if a.device.type == "cuda" or a.dtype == torch.float32:
        return a @ b
    return (a.float() @ b.float()).to(a.dtype)


def _head_logits(real_v: int, softcap: float, offset: int, hidden: torch.Tensor,
                 w: torch.Tensor) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(b, s, n) logits of `w`'s n rows, global columns from `offset`: in
    the compute dtype, or fp32 soft-capped as c·tanh(l / c) (then also the
    tanh, for the backward); global columns >= `real_v` -> -1e30."""
    logits, t = hidden @ w.T, None
    if softcap:
        t = torch.tanh(logits.float() / softcap)
        logits = softcap * t
    pad = real_v - offset
    if pad < w.shape[0]:
        logits[..., max(pad, 0):] = -1e30
    return logits, t


class _HeadCE(torch.autograd.Function):
    """Fused LM-head cross-entropy, mean(logsumexp(h W^T) - gold), the JAX
    package's `_head_ce` custom VJP. The logits stay in the compute dtype
    with fp32 reductions (fp32 once soft-capped); the gold logit is the
    dot of h with the label's row of W. The backward recomputes the
    logits, forms the softmax in fp32, subtracts 1 at the gold index (no
    one-hot), scales and rounds dlogits to the compute dtype, then
    dh = dlogits W and dW = dlogits^T h contracted over (b, s) in fp32.

    With `mesh` the head is split by vocabulary over `model`: each rank
    holds the rows of `w` from global row `offset`. The row max is taken
    over ranks (an all-reduce of the max), then the sum of exponentials
    and the gold logit go round in one all-reduce of the sum (the gold
    from the rank that owns the label's column, zeros elsewhere: one
    nonzero addend); soft-capping and the pad mask act on global
    columns; the backward gives each rank the gradient of its columns and
    sums dh over `model`. The same loss on every rank. Without a mesh no
    collective runs."""

    @staticmethod
    def forward(ctx, real_v: int, softcap: float, hidden: torch.Tensor, w: torch.Tensor,
                labels: torch.Tensor, offset: int = 0, mesh=None) -> torch.Tensor:
        from torch.distributed import ReduceOp

        from repro_torch.spmd import all_reduce_axes

        logits, _ = _head_logits(real_v, softcap, offset, hidden, w)
        m = logits.amax(dim=-1, keepdim=True)                       # (b, s, 1)
        if mesh is not None:
            all_reduce_axes(m, mesh, ("model",), op=ReduceOp.MAX)
        z = torch.exp((logits - m).float()).sum(dim=-1)             # (b, s)
        del logits
        valid = labels >= 0
        local = labels.long() - offset
        mine = valid & (local >= 0) & (local < w.shape[0])
        safe = torch.where(mine, local, 0)
        gold = (hidden.float() * w[safe].float()).sum(dim=-1)
        if softcap:
            gold = softcap * torch.tanh(gold / softcap)
        zg = torch.stack([z, gold * mine])
        if mesh is not None:
            all_reduce_axes(zg, mesh, ("model",))
        logz = torch.log(zg[0]) + m[..., 0].float()
        count = torch.clamp(valid.sum(), min=1)
        ctx.args = (real_v, softcap, offset, mesh)
        ctx.save_for_backward(hidden, w, m, zg[0], valid, mine, safe, count)
        return ((logz - zg[1]) * valid).sum() / count

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        from repro_torch.spmd import all_reduce_axes

        real_v, softcap, offset, mesh = ctx.args
        hidden, w, m, z, valid, mine, safe, count = ctx.saved_tensors
        logits, t = _head_logits(real_v, softcap, offset, hidden, w)
        p = torch.exp((logits - m).float())
        del logits
        p /= z[..., None]
        p.scatter_add_(-1, safe[..., None], -mine[..., None].float())   # p - onehot
        p *= (g * valid.float() / count)[..., None]
        if softcap:
            p *= 1 - t * t
        dlogits = p.to(hidden.dtype)
        del p, t
        dh = dlogits @ w
        if mesh is not None:
            all_reduce_axes(dh, mesh, ("model",))
        v, d = w.shape
        dw = _mm_f32(dlogits.reshape(-1, v).T, hidden.reshape(-1, d))
        return None, None, dh, dw.to(w.dtype), None, None, None


def lm_head_loss(cfg: ModelConfig, embed: torch.Tensor, hidden: torch.Tensor,
                 labels: torch.Tensor,
                 lm_head: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The LM loss through the tied head (`embed`) or the untied `lm_head`
    (d, V): the fused `_HeadCE`, soft-capped under `logit_softcap`, over
    this rank's vocabulary rows when the head is split over `model`. An
    FSDP-cut head is gathered over the data axes first, and its gradient
    reduce-scattered back."""
    cdt = dt(cfg.compute_dtype)
    head = sharding.full(embed if cfg.tie_embeddings else lm_head)
    w = (head if cfg.tie_embeddings else head.T).to(cdt)
    if sharding.split_dim(head) is None:
        return _HeadCE.apply(cfg.vocab_size, cfg.logit_softcap, hidden.to(cdt), w, labels)
    return _HeadCE.apply(cfg.vocab_size, cfg.logit_softcap, hidden.to(cdt), w, labels,
                         sharding.tp_rank() * w.shape[0], sharding.ambient_mesh())
