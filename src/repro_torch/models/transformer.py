"""Decoder-only transformer LM for the dense, MoE and VLM families —
counterpart of `repro.models.transformer.DecoderLM` (init, prefill,
init_caches, decode_step, init_paged_caches, paged_step) — and what
every family's LM shares (`TokenLM`: embedding, head, final norm;
`Block` and its initializer, which the hybrid's shared block and the
encoder-decoder's layers reuse).

The JAX package stacks per-layer params on a leading L axis and scans;
here each layer is a `Block` module in an `nn.ModuleList`, run in a
Python loop. Pre-norm blocks: x + attn(norm(x)), then + ffn(norm(x));
parallel blocks (command-r): x + attn(h) + ffn(h) with h = norm(x). The
ffn is a dense MLP or a sparse-expert layer (`models.moe`); rotary
angles are RoPE or, for the VLM backbone, M-RoPE over three position
channels.
Parameters are created on the model's device (`device=None` is the card)
and filled by `init(generator)` with the JAX initializer's stds, or
loaded from a converted JAX tree (`models.convert.params_from_jax`).
Under the steps' mesh (`launch.steps`) the same code runs tensor-parallel
over `model`, as every family's does: the layers split by the marks
`models.sharding.shard_model` leaves on the weights, the residual stream
stays replicated along `model`, and `decode_step`'s logits are this
rank's vocabulary columns (`layers.greedy_token` takes the argmax).
Weights the placement cuts over the data axes (FSDP) are gathered per
layer where the layer runs (`sharding.gathered`) and dropped after it.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, NamedTuple, Optional

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, dtype as dt, resolve_device
from . import attention, layers, moe as moe_mod, rope, sharding

FAMILIES = ("dense", "moe", "vlm")


class DecodeCaches(NamedTuple):
    k: torch.Tensor        # (L, b, S, kh, hd)
    v: torch.Tensor        # (L, b, S, kh, hd)
    length: torch.Tensor   # (b,) int32, shared across layers


class PagedDecodeCaches(NamedTuple):
    """Block-pooled decode caches shared by every sequence; block tables
    and lengths are inputs to `paged_step`, owned by the host-side
    `serving.paged_cache.PagedCacheManager`."""

    k_pool: torch.Tensor   # (L, n_blocks, block_size, kh, hd)
    v_pool: torch.Tensor   # (L, n_blocks, block_size, kh, hd)


# Matmuls without batch dimensions (`x @ W` after flattening): what the
# JAX package's "dots" remat policy (checkpoint_dots_with_no_batch_dims)
# saves. Attention's einsums run as bmm and are recomputed.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat(cfg: ModelConfig, fn: Callable) -> Callable:
    """`cfg.remat` around a layer body, as the JAX package's `_remat`:
    "full" saves only the layer's inputs and recomputes it in the backward
    pass; "dots" saves the matmul outputs and recomputes the rest; "none"
    returns `fn`. Values are the same either way. The recompute runs
    under the mesh installed when `remat` was called
    (`sharding.carry_ctx`): on the card the backward pass runs on
    autograd's device thread, which does not see this thread's."""
    if cfg.remat != "none":
        fn = sharding.carry_ctx(fn)
    if cfg.remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if cfg.remat == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _dots_policy))
    if cfg.remat != "none":
        raise ValueError(f"unknown remat {cfg.remat!r}")
    return fn


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class MLP(nn.Module):
    """A dense MLP's weights: `w_gate` (SwiGLU only; None for GELU),
    `w_up`, `w_down`, of hidden width `d_ff` over `d_model` (None: the
    config's; an encoder passes its own, with `gated=False`)."""

    def __init__(self, cfg: ModelConfig, d_ff: int, device: torch.device,
                 d_model: Optional[int] = None, gated: Optional[bool] = None):
        super().__init__()
        d, pdt = d_model or cfg.d_model, dt(cfg.param_dtype)
        gated = cfg.mlp == "swiglu" if gated is None else gated
        self.register_parameter(
            "w_gate", _param((d, d_ff), pdt, device) if gated else None)
        self.w_up = _param((d, d_ff), pdt, device)
        self.w_down = _param((d_ff, d), pdt, device)


class MoE(nn.Module):
    """A sparse-expert layer's weights: `router` (d, E), the experts'
    SwiGLU `w_gate` / `w_up` (E, d, f) and `w_down` (E, f, d), and
    Arctic's `dense_residual` MLP."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        m = cfg.moe
        d, f, E, pdt = cfg.d_model, cfg.d_ff, m.n_experts, dt(cfg.param_dtype)
        self.router = _param((d, E), pdt, device)
        self.w_gate = _param((E, d, f), pdt, device)
        self.w_up = _param((E, d, f), pdt, device)
        self.w_down = _param((E, f, d), pdt, device)
        self.dense_residual = (MLP(cfg, m.dense_residual_d_ff, device)
                               if m.dense_residual_d_ff else None)


class Block(nn.Module):
    """One block, weights in (d_in, d_out) layout: attention (`wq` ..
    `wo`, with `bq` / `bk` / `bv` when `cfg.attn_bias`), then a dense
    `mlp` or a sparse-expert layer `moe` (the other one is None). Pre-norm
    blocks normalise again before the MLP (`mlp_norm`); a parallel block
    feeds attention and MLP the same normed input."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        d = cfg.d_model
        h, kh, hd = attention.heads(cfg)
        pdt = dt(cfg.param_dtype)
        self.attn_norm = _param((d,), pdt, device)
        self.wq = _param((d, h * hd), pdt, device)
        self.wk = _param((d, kh * hd), pdt, device)
        self.wv = _param((d, kh * hd), pdt, device)
        self.wo = _param((h * hd, d), pdt, device)
        if cfg.attn_bias:
            self.bq = _param((h * hd,), pdt, device)
            self.bk = _param((kh * hd,), pdt, device)
            self.bv = _param((kh * hd,), pdt, device)
        self.mlp_norm = None if cfg.parallel_block else _param((d,), pdt, device)
        self.moe = MoE(cfg, device) if cfg.moe is not None else None
        self.mlp = MLP(cfg, cfg.d_ff, device) if cfg.moe is None else None

    def ffn(self, cfg: ModelConfig,
            h: torch.Tensor) -> tuple[torch.Tensor, Optional[moe_mod.MoEAux]]:
        """The MLP or MoE branch on h, with the MoE's aux losses (None for
        a dense MLP)."""
        if self.moe is not None:
            return moe_mod.apply_moe(cfg, self.moe, h)
        return layers.apply_mlp(cfg, self.mlp.w_gate, self.mlp.w_up, self.mlp.w_down,
                                h), None

    def join(self, cfg: ModelConfig, x: torch.Tensor, h: torch.Tensor,
             y: torch.Tensor) -> tuple[torch.Tensor, Optional[moe_mod.MoEAux]]:
        """Residual join after attention (x the block input, h its normed
        copy, y the attention output), then the MLP / MoE branch: (x + y)
        + ffn(h) for a parallel block, else x' + ffn(norm(x')) with x' = x
        + y. Also returns the MoE's aux losses (None for a dense MLP)."""
        if cfg.parallel_block:
            m, aux = self.ffn(cfg, h)
            return x + y + m, aux
        x = x + y
        m, aux = self.ffn(cfg, layers.apply_norm(cfg, self.mlp_norm, x))
        return x + m, aux

    def forward_seq(self, cfg: ModelConfig, x: torch.Tensor,
                    angles: Optional[torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
        """A whole sequence through the block (training and full-sequence
        forwards): x (b, s, d) -> (y, aux (3,) fp32: load balance, router
        z, dropped fraction; zeros for a dense MLP). The block's FSDP-cut
        weights are gathered here, inside what `remat` wraps, so that a
        recompute gathers them again and nothing holds them past the
        block."""
        blk = sharding.gathered(self)
        h = layers.apply_norm(cfg, blk.attn_norm, x)
        y, aux = blk.join(cfg, x, h, attention.attend_train(cfg, blk, h, angles))
        if aux is None:
            return y, torch.zeros(3, dtype=torch.float32, device=x.device)
        return y, torch.stack([aux.load_balance_loss, aux.router_z_loss,
                               aux.dropped_fraction])


def _rebind(model: nn.Module, name: str, device: torch.device) -> None:
    """Give parameter `name` of `model` fresh (uninitialised) storage on
    `device`, its shape, dtype and grad flag kept."""
    mod_name, _, attr = name.rpartition(".")
    mod = model.get_submodule(mod_name) if mod_name else model
    p = getattr(mod, attr)
    mod.register_parameter(attr, nn.Parameter(
        torch.empty(p.shape, dtype=p.dtype, device=device), requires_grad=p.requires_grad))


def normal_(w: Optional[torch.Tensor], std: float,
            generator: Optional[torch.Generator]) -> None:
    """Fill `w` (skipped when None) with N(0, std^2) draws."""
    if w is not None:
        w.normal_(0.0, std, generator=generator)


def init_mlp(m: MLP, d: int, f: int, n_layers: int,
             generator: Optional[torch.Generator]) -> None:
    """The JAX `init_mlp` stds: in d^-0.5, out f^-0.5 / sqrt(2 L)."""
    for w in (m.w_gate, m.w_up):
        normal_(w, d**-0.5, generator)
    normal_(m.w_down, f**-0.5 / math.sqrt(2 * n_layers), generator)


@torch.no_grad()
def init_block(cfg: ModelConfig, blk: Block, generator: Optional[torch.Generator]) -> None:
    """A `Block` at the JAX initializer's stds: q/k/v, MLP-in, router and
    expert-in d^-0.5; attention-out (h*hd)^-0.5/sqrt(2L) over the padded
    heads; MLP-out and expert-out f^-0.5/sqrt(2L) with f the layer's own
    hidden width; biases 0, norm scales 1."""
    d, L = cfg.d_model, cfg.n_layers
    h, _, hd = attention.heads(cfg)
    for w in (blk.wq, blk.wk, blk.wv):
        normal_(w, d**-0.5, generator)
    normal_(blk.wo, (h * hd) ** -0.5 / math.sqrt(2 * L), generator)
    for w in (blk.attn_norm, blk.mlp_norm):
        if w is not None:
            w.fill_(1.0)
    if cfg.attn_bias:
        for w in (blk.bq, blk.bk, blk.bv):
            w.zero_()
    if blk.mlp is not None:
        init_mlp(blk.mlp, d, cfg.d_ff, L, generator)
        return
    normal_(blk.moe.router, d**-0.5, generator)
    init_mlp(blk.moe, d, cfg.d_ff, L, generator)
    if blk.moe.dense_residual is not None:
        init_mlp(blk.moe.dense_residual, d, cfg.moe.dense_residual_d_ff, L, generator)


class TokenLM(nn.Module):
    """What every family's LM holds around its layers: the token
    embedding over the padded vocab (`embed`), the untied head (`lm_head`,
    None when `cfg.tie_embeddings`), the final norm (`final_norm`), on
    the model's device (`device=None` is the card)."""

    def __init__(self, cfg: ModelConfig, device: DeviceLike = None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        pdt = dt(cfg.param_dtype)
        self.embed = _param((cfg.padded_vocab_size, cfg.d_model), pdt, dev)
        self.lm_head = (None if cfg.tie_embeddings
                        else _param((cfg.d_model, cfg.padded_vocab_size), pdt, dev))
        self.final_norm = _param((cfg.d_model,), pdt, dev)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _init_plan(self, generator: Optional[torch.Generator]) -> list:
        """`init`'s steps in `init`'s order: [(the port names a step fills,
        the step)], each step drawing from `generator`."""
        raise NotImplementedError

    def _part(self, prefix: str, mod: nn.Module) -> list:
        """The port names of `mod`'s parameters (`mod` at `prefix`)."""
        return [prefix + n for n, _ in mod.named_parameters()]

    @torch.no_grad()
    def init(self, generator: Optional[torch.Generator] = None) -> "TokenLM":
        """Fill every weight at the JAX initializer's stds (`_init_plan`),
        drawn from `generator`, which must live on the model's device; the
        draws are not the JAX package's."""
        for _, fill in self._init_plan(generator):
            fill()
        return self

    @torch.no_grad()
    def init_parts(self, generator: Optional[torch.Generator], device: DeviceLike):
        """`init` a part at a time, on a model built on the meta device: each
        step's parameters (the head's, then each layer's, ...) are
        materialised on `device`, filled with `init`'s draws in `init`'s
        order and yielded as {port name: tensor}, then go back to meta
        before the next. The parts hold `init(generator)`'s values, one
        part allocated at once (ROADMAP T59)."""
        dev = resolve_device(device)
        for names, fill in self._init_plan(generator):
            for n in names:
                _rebind(self, n, dev)
            fill()
            yield {n: self.get_parameter(n) for n in names}
            for n in names:
                _rebind(self, n, torch.device("meta"))

    @torch.no_grad()
    def _init_head(self, generator: Optional[torch.Generator]) -> None:
        """Embedding N(0, 0.02), untied head N(0, d^-0.5), final norm 1."""
        normal_(self.embed, 0.02, generator)
        normal_(self.lm_head, self.cfg.d_model**-0.5, generator)
        self.final_norm.fill_(1.0)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return self.head_logits(layers.apply_norm(self.cfg, self.final_norm, x))

    def head_logits(self, x: torch.Tensor) -> torch.Tensor:
        """fp32 logits of final-normed hidden states x."""
        return layers.logits_from_hidden(self.cfg, self.embed, x, self.lm_head)

    def head_loss(self, x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """The fused head loss of final-normed hidden states x."""
        return layers.lm_head_loss(self.cfg, self.embed, x, labels.to(self.device),
                                   self.lm_head)

    def _lengths(self, batch: int, prefix_len) -> torch.Tensor:
        """(batch,) int32 cache lengths, all `prefix_len`."""
        return torch.full((batch,), int(prefix_len), dtype=torch.int32, device=self.device)

    def _rope(self, positions) -> torch.Tensor:
        """RoPE angles (b, s, hd/2) at `positions` (b, s)."""
        positions = torch.as_tensor(positions, device=self.device)
        return rope.rope_angles(positions, self.cfg.resolved_head_dim, self.cfg.rope_theta)


class DecoderLM(TokenLM):
    def __init__(self, cfg: ModelConfig, device: DeviceLike = None):
        if cfg.family not in FAMILIES:
            raise ValueError(f"{cfg.name}: family {cfg.family!r} is not a DecoderLM "
                             f"family {FAMILIES}")
        super().__init__(cfg, device)
        self.blocks = nn.ModuleList(Block(cfg, self.device) for _ in range(cfg.n_layers))

    # ------------------------------------------------------------- params
    def _init_plan(self, generator: Optional[torch.Generator]) -> list:
        """The head (embedding 0.02, untied head d^-0.5), then each block
        as `init_block`."""
        head = [n for n, _ in self.named_parameters(recurse=False)]
        return [(head, functools.partial(self._init_head, generator))] + [
            (self._part(f"blocks.{i}.", blk),
             functools.partial(init_block, self.cfg, blk, generator))
            for i, blk in enumerate(self.blocks)]

    # ------------------------------------------------------------- angles
    def _angles(self, positions: Optional[torch.Tensor],
                default: torch.Tensor) -> Optional[torch.Tensor]:
        """Rotary angles at `positions`, (b, s) or for M-RoPE (3, b, s);
        None takes the text positions `default` (b, s), broadcast over
        M-RoPE's three channels as the JAX package does. No angles for
        `rope_style == "none"`."""
        cfg = self.cfg
        if cfg.rope_style == "none":
            return None
        if positions is None:
            positions = default
            if cfg.rope_style == "mrope":
                positions = positions[None].expand(3, *positions.shape)
        if cfg.rope_style == "mrope":
            positions = torch.as_tensor(positions, device=self.device)
            return rope.mrope_angles(positions, cfg.resolved_head_dim, cfg.rope_theta,
                                     cfg.mrope_sections)
        return self._rope(positions)

    # ------------------------------------------------------------ forward
    def hidden_states(self, tokens: Optional[torch.Tensor] = None,
                      embeds: Optional[torch.Tensor] = None,
                      positions: Optional[torch.Tensor] = None):
        """The stack over a whole sequence, with gradients: tokens (b, s)
        or `embeds` (b, s, d) -> (final-normed hidden (b, s, d), aux (3,)
        the mean over layers of (load balance, router z, dropped
        fraction)). Each block runs under `cfg.remat`. `positions` (b,
        s), or (3, b, s) for M-RoPE, default to 0 .. s-1."""
        cfg = self.cfg
        if embeds is None:
            embeds = layers.embed_tokens(cfg, self.embed, tokens.to(self.device))
        x = embeds.to(self.device)
        b, s, _ = x.shape
        angles = self._angles(positions,
                              torch.arange(s, device=self.device)[None, :].expand(b, s))
        auxes = []
        for blk in self.blocks:
            x, aux = remat(cfg, functools.partial(blk.forward_seq, cfg))(x, angles)
            auxes.append(aux)
        x = layers.apply_norm(cfg, self.final_norm, x)
        return x, torch.stack(auxes).mean(dim=0)

    def forward(self, tokens: Optional[torch.Tensor] = None,
                embeds: Optional[torch.Tensor] = None,
                positions: Optional[torch.Tensor] = None):
        """-> (fp32 logits (b, s, V), aux (3,)), as `hidden_states`."""
        x, aux = self.hidden_states(tokens, embeds, positions)
        return self.head_logits(x), aux

    def loss(self, batch: dict) -> tuple[torch.Tensor, dict]:
        """(total loss, metrics) for a batch of `labels` (b, s) and
        `tokens` or `embeds`, with optional `positions`: the head's cross
        entropy, plus for MoE configs aux_loss_weight * load balance +
        1e-4 * router z."""
        cfg = self.cfg
        x, aux = self.hidden_states(batch.get("tokens"), batch.get("embeds"),
                                    batch.get("positions"))
        ce = self.head_loss(x, batch["labels"])
        total = ce
        if cfg.moe is not None:
            total = total + cfg.moe.aux_loss_weight * aux[0] + 1e-4 * aux[1]
        return total, {"ce": ce, "load_balance": aux[0], "router_z": aux[1],
                       "dropped": aux[2]}

    # ------------------------------------------------------------ serving
    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor, cache_len: Optional[int] = None,
                positions: Optional[torch.Tensor] = None):
        """tokens (b, s) -> (logits of the last position (b, V), DecodeCaches).
        `positions` (b, s), or (3, b, s) for M-RoPE, defaults to 0 .. s-1."""
        cfg = self.cfg
        tokens = tokens.to(self.device)
        x = layers.embed_tokens(cfg, self.embed, tokens)
        b, s, _ = x.shape
        cache_len = cache_len or s
        angles = self._angles(positions,
                              torch.arange(s, device=self.device)[None, :].expand(b, s))
        ks, vs = [], []
        for blk in self.blocks:
            blk = sharding.gathered(blk)
            h = layers.apply_norm(cfg, blk.attn_norm, x)
            y, cache = attention.prefill(cfg, blk, h, angles, cache_len)
            x = blk.join(cfg, x, h, y)[0]
            ks.append(cache.k)
            vs.append(cache.v)
        logits = self._logits(x[:, -1])
        return logits, DecodeCaches(k=torch.stack(ks), v=torch.stack(vs),
                                    length=cache.length)

    def init_caches(self, batch: int, cache_len: int, prefix_len) -> DecodeCaches:
        """Empty caches of logical length `prefix_len` (decode dry-run)."""
        cfg = self.cfg
        shape = (cfg.n_layers, batch, cache_len, cfg.n_kv_heads, cfg.resolved_head_dim)
        cdt = dt(cfg.compute_dtype)
        return DecodeCaches(k=torch.zeros(shape, dtype=cdt, device=self.device),
                            v=torch.zeros(shape, dtype=cdt, device=self.device),
                            length=self._lengths(batch, prefix_len))

    @torch.inference_mode()
    def decode_step(self, caches: DecodeCaches, token: torch.Tensor,
                    positions: Optional[torch.Tensor] = None):
        """token (b, 1) -> (logits (b, V), caches'). The caches' K/V are
        written in place; the returned length is advanced by one.
        `positions` (b, 1), or (3, b, 1) for M-RoPE, defaults to each
        row's cache length."""
        cfg = self.cfg
        token = token.to(self.device)
        x = layers.embed_tokens(cfg, self.embed, token)
        angles = self._angles(positions, caches.length.long()[:, None])
        for i, blk in enumerate(self.blocks):
            blk = sharding.gathered(blk)
            h = layers.apply_norm(cfg, blk.attn_norm, x)
            cache = attention.KVCache(k=caches.k[i], v=caches.v[i], length=caches.length)
            y, _ = attention.decode_step(cfg, blk, h, cache, angles)
            x = blk.join(cfg, x, h, y)[0]
        logits = self._logits(x[:, -1])
        return logits, DecodeCaches(k=caches.k, v=caches.v, length=caches.length + 1)

    # ----------------------------------------------------- paged serving
    @torch.inference_mode()
    def init_paged_caches(self, n_blocks: int, block_size: int) -> PagedDecodeCaches:
        """Zeroed K/V block pools in the compute dtype. Created in inference
        mode, like every tensor `paged_step` writes in place, so the pools
        can be written from any thread (grad mode is thread-local)."""
        cfg = self.cfg
        shape = (cfg.n_layers, n_blocks, block_size, cfg.n_kv_heads,
                 cfg.resolved_head_dim)
        cdt = dt(cfg.compute_dtype)
        return PagedDecodeCaches(
            k_pool=torch.zeros(shape, dtype=cdt, device=self.device),
            v_pool=torch.zeros(shape, dtype=cdt, device=self.device))

    @torch.inference_mode()
    def paged_step(self, pools: PagedDecodeCaches, block_tables, lengths, tokens,
                   n_valid, positions: Optional[torch.Tensor] = None,
                   paged_kernel: Optional[bool] = None):
        """Advance each row by its next `n_valid[b] <= t` tokens.

        tokens (b, t) holds row b's tokens for logical positions
        `lengths[b] .. lengths[b] + n_valid[b] - 1` (entries past n_valid
        are padding); t == 1 is the batched decode step, t ==
        prefill_chunk at b == 1 one chunked-prefill piece. Returns
        (logits (b, V) at each row's LAST VALID position, pools). The
        pools are written IN PLACE (the JAX package's
        `input_output_aliases` become true in-place writes) and the same
        `pools` comes back. Inactive rows (all-NULL table, length 0,
        n_valid 0) touch only the scratch block; their logits are
        garbage, and every row's tokens, padding included, go through the
        MoE layers and take capacity there, as in the JAX package.
        `positions` (b, t), or (3, b, t) for M-RoPE, defaults to
        `lengths[b] + i`. `paged_kernel` picks the fused K3 path in
        `attention.paged_attend` (None defers to `cfg.paged_kernel`)."""
        cfg = self.cfg
        dev = self.device
        tokens = torch.as_tensor(tokens, device=dev).long()
        block_tables = torch.as_tensor(block_tables, device=dev).to(torch.int32)
        lengths = torch.as_tensor(lengths, device=dev).to(torch.int32)
        n_valid = torch.as_tensor(n_valid, device=dev).to(torch.int32)
        x = layers.embed_tokens(cfg, self.embed, tokens)
        b, t, _ = x.shape
        angles = self._angles(
            positions, lengths.long()[:, None] + torch.arange(t, device=dev)[None, :])
        for i, blk in enumerate(self.blocks):
            blk = sharding.gathered(blk)
            cache = attention.PagedKVCache(
                k_pool=pools.k_pool[i], v_pool=pools.v_pool[i],
                block_table=block_tables, length=lengths)
            h = layers.apply_norm(cfg, blk.attn_norm, x)
            y, _, _ = attention.paged_attend(cfg, blk, h, cache, angles, n_valid,
                                             paged_kernel=paged_kernel)
            x = blk.join(cfg, x, h, y)[0]
        idx = torch.clamp(n_valid.long() - 1, 0, t - 1)
        return self._logits(x[torch.arange(b, device=dev), idx]), pools
