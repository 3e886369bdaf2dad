"""Mamba2 / SSD (state-space duality) blocks — counterpart of
`repro.models.mamba2` (arXiv:2405.21060).

Chunked SSD forward (a whole sequence): the intra-chunk quadratic term
under a segment-sum decay mask plus the inter-chunk state recurrence, a
Python loop over chunks. Single-token decode updates the (b, h, p, n)
fp32 state in closed form. As in the JAX package the projections are
separate matrices (`in_z`, `in_x`, `in_B`, `in_C`, `in_dt`) and the
depthwise causal conv runs per segment.

Heads are grouped (g, r), g-major: head j reads B/C group j // r, so the
decode step repeats each group r times with `repeat_interleave`. The
SSD math runs in fp32 whatever the compute dtype; the conv state is kept
in the compute dtype, the SSM state in fp32 (`init_mamba_state`).

Tensor-parallel over a mesh's `model` dim (`sharding.shard_model` cuts
the weights as the reference's rules place them): `in_z` / `in_x`,
`conv_x_*`, `A_log` / `dt_bias` / `D` and `out_proj`'s rows hold this
rank's d_inner / m channels, which are its h / m heads, so the SSD, the
D skip and the gated norm (its statistic summed over `model`,
`layers.gated_rmsnorm`) run on them, and `out_proj` ends in one
all-reduce. `in_B` / `in_C` / `in_dt` and the B / C convs stay whole:
every rank computes the whole B and C (the decode's `conv_B` / `conv_C`
state stays whole too), then takes the groups its heads read and its
heads' columns of dt. With gradients, the block's input and those whole
weights pass `sharding.tp_copy`, since only this rank's heads read what
they give. The decode state holds this rank's heads (`ssm`) and channels
(`conv_x`), as `launch.steps.cache_shardings` places them. The weights
the rules cut over the data axes (FSDP: `in_z` / `in_x` / `in_B` /
`in_C` / `in_dt` on d, `out_proj` on its output) are gathered per layer
(`sharding.gathered`) before any of this, so `tp_copy` acts on the
gathered tensors. Without a cut the mesh-less code runs, bit for bit.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.device import dtype as dt
from . import layers, sharding

NEG_INF = -1.0e30


class MambaState(NamedTuple):
    ssm: torch.Tensor     # (b, h, p, n) fp32
    conv_x: torch.Tensor  # (b, cw-1, d_inner)
    conv_B: torch.Tensor  # (b, cw-1, g*n)
    conv_C: torch.Tensor  # (b, cw-1, g*n)


# --------------------------------------------------------------------- SSD
def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a (..., cl) -> (..., cl, cl) with T[i, j] = sum_{k in (j, i]} a[k]
    on and below the diagonal, -1e30 above it (a large finite value, so
    that exp gives 0 and no inf - inf difference makes a NaN)."""
    cl = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    i = torch.arange(cl, device=a.device)
    return torch.where(i[:, None] >= i[None, :], diff, NEG_INF)


def ssd_chunked(
    x: torch.Tensor,      # (b, s, h, p)
    dt: torch.Tensor,     # (b, s, h), post-softplus
    A: torch.Tensor,      # (h,), negative
    B: torch.Tensor,      # (b, s, g, n)
    C: torch.Tensor,      # (b, s, g, n)
    chunk: int,
    initial_state: Optional[torch.Tensor] = None,  # (b, h, p, n)
):
    """Returns (y (b, s, h, p) in x's dtype, final state (b, h, p, n) fp32).
    A sequence longer than `chunk` must be a multiple of it (ValueError
    otherwise; nothing is padded)."""
    b, s, h, p = x.shape
    g, n = B.shape[-2:]
    r = h // g
    cl = min(chunk, s)
    if s % cl:
        raise ValueError(f"seq {s} not divisible by chunk {cl}")
    nc = s // cl

    a = (dt.float() * A.float()).reshape(b, nc, cl, g, r)
    xd = (x.float() * dt.float()[..., None]).reshape(b, nc, cl, g, r, p)
    Bc = B.float().reshape(b, nc, cl, g, n)
    Cc = C.float().reshape(b, nc, cl, g, n)

    a_t = a.permute(0, 1, 3, 4, 2)              # (b, nc, g, r, cl)
    a_cum = torch.cumsum(a_t, dim=-1)           # within-chunk cumsum
    L = torch.exp(_segsum(a_t))                 # (b, nc, g, r, cl, cl)

    # Intra-chunk term, contracted pairwise: C.B over n, times the decay
    # mask, then over s against x*dt (never an (l, s, r, p) intermediate).
    cb = torch.einsum("bclgn,bcsgn->bcgls", Cc, Bc)
    y_diag = torch.einsum("bcgrls,bcsgrp->bclgrp", cb[:, :, :, None] * L, xd)

    # Per-chunk input states.
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)          # (b, nc, g, r, cl)
    states = torch.einsum("bcsgn,bcsgrp->bcgrpn", Bc,
                          xd * decay_states.permute(0, 1, 4, 2, 3)[..., None])

    # Inter-chunk recurrence: each chunk sees the state before it.
    chunk_decay = torch.exp(a_cum[..., -1])                     # (b, nc, g, r)
    prev = (torch.zeros((b, g, r, p, n), dtype=torch.float32, device=x.device)
            if initial_state is None
            else initial_state.float().reshape(b, g, r, p, n))
    prev_states = []
    for c in range(nc):
        prev_states.append(prev)
        prev = prev * chunk_decay[:, c, ..., None, None] + states[:, c]
    prev_states = torch.stack(prev_states, dim=1)               # (b, nc, g, r, p, n)

    y_off = torch.einsum("bclgn,bcgrpn->bclgrp", Cc, prev_states)
    y_off = y_off * torch.exp(a_cum).permute(0, 1, 4, 2, 3)[..., None]
    y = (y_diag + y_off).reshape(b, s, h, p)
    return y.to(x.dtype), prev.reshape(b, h, p, n)


def ssd_decode_step(
    state: torch.Tensor,  # (b, h, p, n) fp32
    x: torch.Tensor,      # (b, h, p)
    dt: torch.Tensor,     # (b, h), post-softplus
    A: torch.Tensor,      # (h,)
    B: torch.Tensor,      # (b, g, n)
    C: torch.Tensor,      # (b, g, n)
):
    """One recurrent step; returns (y (b, h, p) in x's dtype, new state)."""
    r = x.shape[1] // B.shape[1]
    dA = torch.exp(dt.float() * A.float())                      # (b, h)
    Bh = torch.repeat_interleave(B.float(), r, dim=1)           # (b, h, n)
    Ch = torch.repeat_interleave(C.float(), r, dim=1)
    dBx = (dt.float()[..., None] * x.float())[..., None] * Bh[:, :, None, :]
    new_state = state * dA[..., None, None] + dBx               # (b, h, p, n)
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch)
    return y.to(x.dtype), new_state


# ------------------------------------------------------------------- block
def _dims(cfg: ModelConfig) -> tuple[SSMConfig, int, int, int, int]:
    s = cfg.ssm
    return s, s.d_inner(cfg.d_model), s.n_heads(cfg.d_model), s.state_dim, s.n_groups


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class MambaBlock(nn.Module):
    """One Mamba2 block's weights, named and shaped as the JAX
    `init_mamba_block` tree: the projections `in_z` / `in_x` (d, d_inner),
    `in_B` / `in_C` (d, g*n), `in_dt` (d, h); the depthwise convs
    `conv_{x,B,C}_w` (cw, c) and `_b` (c,); `A_log`, `dt_bias`, `D` (h,);
    the gated norm's scale `norm` (d_inner,); `out_proj` (d_inner, d)."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        s, di, h, n, g = _dims(cfg)
        d, cw, pdt = cfg.d_model, s.conv_width, dt(cfg.param_dtype)
        for name, shape in (("in_z", (d, di)), ("in_x", (d, di)), ("in_B", (d, g * n)),
                            ("in_C", (d, g * n)), ("in_dt", (d, h)),
                            ("conv_x_w", (cw, di)), ("conv_x_b", (di,)),
                            ("conv_B_w", (cw, g * n)), ("conv_B_b", (g * n,)),
                            ("conv_C_w", (cw, g * n)), ("conv_C_b", (g * n,)),
                            ("A_log", (h,)), ("dt_bias", (h,)), ("D", (h,)),
                            ("norm", (di,)), ("out_proj", (di, d))):
            setattr(self, name, _param(shape, pdt, device))

    @torch.no_grad()
    def init(self, cfg: ModelConfig, generator: Optional[torch.Generator] = None) -> None:
        """The JAX initializer's distributions (its draws are not
        reproduced): projections N(0, d^-0.5), convs N(0, 0.2) with
        `conv_C_w` a copy of `conv_B_w` (the JAX init draws both from one
        key), conv biases 0, A_log = log(linspace(1, 16, h)), dt_bias =
        softplus^-1(exp(U(log dt_min, log dt_max))), D 1, norm 1, out_proj
        N(0, d_inner^-0.5 / sqrt(2 L))."""
        s, di, h, _, _ = _dims(cfg)
        d = cfg.d_model
        for w in (self.in_z, self.in_x, self.in_B, self.in_C, self.in_dt):
            w.normal_(0.0, d**-0.5, generator=generator)
        self.conv_x_w.normal_(0.0, 0.2, generator=generator)
        self.conv_B_w.normal_(0.0, 0.2, generator=generator)
        self.conv_C_w.copy_(self.conv_B_w)
        for w in (self.conv_x_b, self.conv_B_b, self.conv_C_b):
            w.zero_()
        dev = self.A_log.device
        self.A_log.copy_(torch.log(torch.linspace(1.0, 16.0, h, device=dev)))
        u = torch.empty(h, device=dev).uniform_(math.log(s.dt_min), math.log(s.dt_max),
                                                generator=generator)
        self.dt_bias.copy_(torch.log(torch.expm1(torch.exp(u))))
        self.D.fill_(1.0)
        self.norm.fill_(1.0)
        self.out_proj.normal_(0.0, di**-0.5 / math.sqrt(2 * cfg.n_layers),
                              generator=generator)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv, x (b, s, c), w (cw, c), then silu(y + b).

    The cw taps are summed in the JAX package's order (tap 0 first), each
    product and partial sum in x's dtype. Returns (y (b, s, c), new state
    (b, cw-1, c): the last cw-1 inputs, a view of the padded input)."""
    cw, s = w.shape[0], x.shape[1]
    if state is None:
        xp = F.pad(x, (0, 0, cw - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = xp[:, 0:s] * w[0]
    for i in range(1, cw):
        y = y + xp[:, i:i + s] * w[i]
    return F.silu(y + b), xp[:, xp.shape[1] - (cw - 1):]


class _Local(NamedTuple):
    """The heads this rank computes and the B / C groups they read."""
    split: bool      # `in_x` is cut over `model`
    h0: int          # the first head
    h: int           # the head count
    g0: int          # the first group read
    g: int           # the groups, as `ssd_chunked` takes them (h % g == 0)
    per_head: bool   # one group a head, (h0 + j) // r, for heads that do not
    #                  split evenly over whole groups
    r: int           # the model's heads a group


def _local(cfg: ModelConfig, p: MambaBlock) -> _Local:
    """Where `in_x` (and with it `in_z`, `conv_x_*`, `A_log`, `dt_bias`,
    `D` and `out_proj`'s rows) is cut over `model`, this rank's heads are
    h0 .. h0 + hl and they read groups (h0 + j) // r (T30): a contiguous
    run of groups when every group read holds the same count of local
    heads, else one group a head (T64). All of them without a cut."""
    s, di, h, _, g = _dims(cfg)
    dl = p.in_x.shape[1]
    r = h // g
    if dl == di:
        return _Local(False, 0, h, 0, g, False, r)
    if dl % s.head_dim:
        raise ValueError(f"{cfg.name}: {dl} channels a rank are not whole heads of "
                         f"{s.head_dim}")
    hl = dl // s.head_dim
    h0 = sharding.tp_rank() * hl
    groups = [(h0 + j) // r for j in range(hl)]
    counts = {k: groups.count(k) for k in groups}
    if len(set(counts.values())) == 1:
        return _Local(True, h0, hl, groups[0], len(counts), False, r)
    return _Local(True, h0, hl, 0, hl, True, r)


def _groups(t: torch.Tensor, loc: _Local, g: int, n: int) -> torch.Tensor:
    """(..., g * n) -> (..., groups, n): the groups this rank's heads read
    (all `g` without a cut)."""
    t = t.reshape(*t.shape[:-1], g, n)
    if not loc.split:
        return t
    if loc.per_head:
        idx = (loc.h0 + torch.arange(loc.h, device=t.device)) // loc.r
        return t.index_select(-2, idx)
    return t.narrow(-2, loc.g0, loc.g)


def _project(cfg: ModelConfig, p: MambaBlock, x: torch.Tensor, loc: _Local):
    """(z, x, B, C, dt) of x: z / x this rank's channels, B / C whole, dt
    this rank's heads. Under a cut the input and the whole `in_B` /
    `in_C` / `in_dt` pass `tp_copy`: only this rank's heads read them, so
    their gradients are partial (T63)."""
    cdt = dt(cfg.compute_dtype)
    x = x.to(cdt)
    w_B, w_C, w_dt = p.in_B, p.in_C, p.in_dt
    if loc.split:
        x = sharding.tp_copy(x)
        w_B, w_C, w_dt = (sharding.tp_copy(w) for w in (w_B, w_C, w_dt))
        w_dt = w_dt[:, loc.h0:loc.h0 + loc.h]
    return (x @ p.in_z.to(cdt), x @ p.in_x.to(cdt), x @ w_B.to(cdt),
            x @ w_C.to(cdt), x @ w_dt.to(cdt))


def _convs(cfg: ModelConfig, p: MambaBlock, xs, Bc, Cc, state: Optional[MambaState],
           loc: _Local):
    cdt = dt(cfg.compute_dtype)
    out = []
    for name, v in (("x", xs), ("B", Bc), ("C", Cc)):
        w, b = getattr(p, f"conv_{name}_w"), getattr(p, f"conv_{name}_b")
        if loc.split and name != "x":          # whole, read by this rank's heads only
            w, b = sharding.tp_copy(w), sharding.tp_copy(b)
        out.append(_causal_conv(v, w.to(cdt), b.to(cdt),
                                None if state is None else getattr(state, f"conv_{name}")))
    return out


def _out(cfg: ModelConfig, p: MambaBlock, y: torch.Tensor, z: torch.Tensor,
         loc: _Local) -> torch.Tensor:
    """The gated norm and `out_proj` of this rank's channels; a cut
    `out_proj` (row-parallel) sums over `model`."""
    cdt = dt(cfg.compute_dtype)
    y = layers.gated_rmsnorm(p.norm, y, z, cfg.norm_eps)
    out = y.to(cdt) @ p.out_proj.to(cdt)
    return sharding.tp_all_reduce(out) if loc.split else out


def apply_mamba_block(cfg: ModelConfig, p: MambaBlock, x: torch.Tensor,
                      state: Optional[MambaState] = None, return_state: bool = False):
    """Full-sequence forward, x (b, s, d) -> y (b, s, d), continuing from
    `state` when given; with `return_state` also the MambaState after the
    last token. Under a cut over `model`, on this rank's heads."""
    s_cfg, _, _, n, g = _dims(cfg)
    loc = _local(cfg, p)
    b, s, _ = x.shape
    z, xs, Bc, Cc, dt_raw = _project(cfg, p, x, loc)
    (xs, st_x), (Bc, st_B), (Cc, st_C) = _convs(cfg, p, xs, Bc, Cc, state, loc)
    delta = F.softplus(dt_raw.float() + p.dt_bias.float())
    A = -torch.exp(p.A_log.float())
    y, final = ssd_chunked(xs.reshape(b, s, loc.h, s_cfg.head_dim), delta, A,
                           _groups(Bc, loc, g, n), _groups(Cc, loc, g, n),
                           chunk=s_cfg.chunk_size,
                           initial_state=None if state is None else state.ssm)
    y = y + p.D.to(y.dtype)[:, None] * xs.reshape(b, s, loc.h, -1)
    out = _out(cfg, p, y.reshape(b, s, -1), z, loc)
    if return_state:
        return out, MambaState(ssm=final, conv_x=st_x, conv_B=st_B, conv_C=st_C)
    return out


def decode_mamba_block(cfg: ModelConfig, p: MambaBlock, x: torch.Tensor,
                       state: MambaState):
    """One-token decode, x (b, 1, d) -> (y (b, 1, d), new MambaState). The
    new state's conv leaves are views of this step's padded inputs. Under
    a cut the state holds this rank's heads (`ssm`) and channels
    (`conv_x`), and `conv_B` / `conv_C` whole."""
    s_cfg, _, _, n, g = _dims(cfg)
    loc = _local(cfg, p)
    b = x.shape[0]
    z, xs, Bc, Cc, dt_raw = _project(cfg, p, x, loc)
    (xs, st_x), (Bc, st_B), (Cc, st_C) = _convs(cfg, p, xs, Bc, Cc, state, loc)
    delta = F.softplus(dt_raw[:, 0].float() + p.dt_bias.float())
    A = -torch.exp(p.A_log.float())
    y, new_ssm = ssd_decode_step(state.ssm, xs[:, 0].reshape(b, loc.h, s_cfg.head_dim), delta,
                                 A, _groups(Bc[:, 0], loc, g, n), _groups(Cc[:, 0], loc, g, n))
    y = y + p.D.to(y.dtype)[:, None] * xs[:, 0].reshape(b, loc.h, -1)
    out = _out(cfg, p, y.reshape(b, 1, -1), z, loc)
    return out, MambaState(ssm=new_ssm, conv_x=st_x, conv_B=st_B, conv_C=st_C)


def init_mamba_state(cfg: ModelConfig, batch: int, device=None) -> MambaState:
    """Zero state: the SSM state in fp32, the conv states in the compute
    dtype."""
    s_cfg, di, h, n, g = _dims(cfg)
    cdt = dt(cfg.compute_dtype)
    cw = s_cfg.conv_width
    return MambaState(
        ssm=torch.zeros((batch, h, s_cfg.head_dim, n), dtype=torch.float32, device=device),
        conv_x=torch.zeros((batch, cw - 1, di), dtype=cdt, device=device),
        conv_B=torch.zeros((batch, cw - 1, g * n), dtype=cdt, device=device),
        conv_C=torch.zeros((batch, cw - 1, g * n), dtype=cdt, device=device))


class MambaLayer(nn.Module):
    """A pre-norm Mamba2 layer: `norm` (d,), then the block `mamba`."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        self.norm = _param((cfg.d_model,), dt(cfg.param_dtype), device)
        self.mamba = MambaBlock(cfg, device)

    @torch.no_grad()
    def init(self, cfg: ModelConfig, generator: Optional[torch.Generator]) -> None:
        self.norm.fill_(1.0)
        self.mamba.init(cfg, generator)

    def forward_seq(self, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
        """The layer over a whole sequence, its FSDP-cut weights gathered
        here (inside what `remat` wraps) and dropped after."""
        layer = sharding.gathered(self)
        return x + apply_mamba_block(cfg, layer.mamba, layers.apply_norm(cfg, layer.norm, x))

    def decode(self, cfg: ModelConfig, x: torch.Tensor, state: MambaState,
               i: int) -> torch.Tensor:
        """One token through this layer; layer `i`'s slice of the stacked
        `state` is overwritten with the new state in place."""
        layer = sharding.gathered(self)
        h = layers.apply_norm(cfg, layer.norm, x)
        one = MambaState(*(leaf[i] for leaf in state))
        y, new = decode_mamba_block(cfg, layer.mamba, h, one)
        for dst, src in zip(one, new):
            dst.copy_(src)
        return x + y


def init_layer_states(cfg: ModelConfig, batch: int, device) -> MambaState:
    """Zero Mamba states for every layer, each leaf stacked (L, b, ...)."""
    st = init_mamba_state(cfg, batch, device)
    return MambaState(*(torch.zeros((cfg.n_layers, *x.shape), dtype=x.dtype, device=device)
                        for x in st))
