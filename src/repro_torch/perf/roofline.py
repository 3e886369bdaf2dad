"""Roofline terms of one step on one H100 — counterpart of
`repro.perf.roofline`.

Hardware model, one NVIDIA H100 SXM (NVIDIA's H100 data sheet, dense
rates without sparsity, at the full 700 W power limit):
    peak compute   989e12 FLOP/s in bf16 (tensor cores)
    HBM bandwidth  3.35e12 B/s            (80 GB of HBM3)
    NVLink 4       450e9 B/s a direction  (900 GB/s total, 18 links)

Terms, seconds per step, from per-rank quantities (each rank runs the
per-rank program, so the "/ chips" of the cell formulas cancels):
    compute_s    = FLOPs a rank   / 989e12
    memory_s     = HBM bytes      / 3.35e12
    collective_s = collective bytes / 450e9
`step_time_s` is the largest term: the bound with perfect overlap.

The reference reads FLOPs and collectives out of XLA's compiled HLO
(`analyze_compiled`, `parse_collectives`), which PyTorch has no
counterpart of. Here `analyze` runs the step once: FLOPs are counted by
`torch.utils.flop_counter.FlopCounterMode` (every matmul, bmm and
einsum the step dispatches; element-wise work is not counted, as
XLA's dot-dominated count is), and collectives by the counter that
`repro_torch.spmd`'s collectives bump (an all-reduce's output bytes
weighted 2x, as the reference weights it). The step's HBM bytes are the
caller's: what it must move once (weights and caches read, caches
written), `tensor_bytes` of them. The 1- and 2-unit extrapolation
(`extrapolate`) carries over as arithmetic.

`model_flops` / `attention_flops` are the reference's analytic counts,
unchanged.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import spmd

PEAK_FLOPS = 989e12       # bf16 dense, tensor cores
HBM_BW = 3.35e12          # bytes/s
LINK_BW = 450e9           # NVLink 4, bytes/s a direction
HBM_BYTES = 80e9

_COLL_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
             "collective-permute")


@dataclasses.dataclass
class CellAnalysis:
    flops: float                 # per rank
    hbm_bytes: float
    collective_bytes: float
    collectives: dict
    memory_args_bytes: int = 0
    memory_temp_bytes: int = 0
    memory_output_bytes: int = 0

    @property
    def compute_s(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """No-overlap upper bound; perfect-overlap lower bound is max."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def to_dict(self) -> dict:
        return {
            "flops_per_device": self.flops,
            "hbm_bytes_per_device": self.hbm_bytes,
            "collective_bytes_per_device": self.collective_bytes,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "collectives": self.collectives,
            "memory_args_gib": self.memory_args_bytes / 2**30,
            "memory_temp_gib": self.memory_temp_bytes / 2**30,
            "memory_output_gib": self.memory_output_bytes / 2**30,
        }


def tensor_bytes(*trees) -> int:
    """Bytes of every tensor in `trees` (tensors, NamedTuples, dicts,
    lists, modules' parameters), each counted once."""
    seen, total = set(), 0

    def walk(x):
        nonlocal total
        if isinstance(x, torch.nn.Module):
            x = list(x.parameters())
        if isinstance(x, torch.Tensor):
            if id(x) not in seen:
                seen.add(id(x))
                total += x.numel() * x.element_size()
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
    for t in trees:
        walk(t)
    return total


def analyze(fn, hbm_bytes: float = 0.0):
    """Run `fn()` once, counting its FLOPs and the collectives it issues:
    (fn's result, {"flops", "bytes", "collective_bytes", "collectives"})
    as `repro.perf.roofline.analyze_compiled` reports them, `bytes` being
    the caller's `hbm_bytes`. The collective counts are reset first."""
    from torch.utils.flop_counter import FlopCounterMode

    spmd.reset_collectives()
    with FlopCounterMode(display=False) as counter:
        out = fn()
    coll = spmd.read_collectives()
    colls = {op: coll.get(op, {"count": 0, "bytes": 0}) for op in _COLL_OPS}
    colls["total_bytes"] = coll["total_bytes"]
    return out, {"flops": float(counter.get_total_flops()), "bytes": float(hbm_bytes),
                 "collective_bytes": float(coll["total_bytes"]), "collectives": colls}


def extrapolate(a1: dict, a2: dict, n_units: int) -> dict:
    """Linear extrapolation base + n_units * per_unit from 1u/2u minis."""
    out = {}
    for k in ("flops", "bytes", "collective_bytes"):
        per = max(a2[k] - a1[k], 0.0)
        base = max(a1[k] - per, 0.0)
        out[k] = base + n_units * per
    coll = {}
    for op in _COLL_OPS:
        c1 = a1["collectives"][op]
        c2 = a2["collectives"][op]
        per_b = max(c2["bytes"] - c1["bytes"], 0)
        per_c = max(c2["count"] - c1["count"], 0)
        coll[op] = {
            "bytes": int(max(c1["bytes"] - per_b, 0) + n_units * per_b),
            "count": int(max(c1["count"] - per_c, 0) + n_units * per_c),
        }
    out["collectives"] = coll
    return out


def model_flops(cfg, shape) -> float:
    """Analytic MODEL_FLOPS: 6*N*D train, 2*N*D forward-only (prefill),
    2*N_active*D for MoE; decode D = batch tokens (one step)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch      # one new token per sequence


def attention_flops(cfg, shape) -> float:
    """Intrinsic attention-score flops (NOT in 6*N*D): per token pair
    2*hd (QK^T) + 2*hd (PV) per head; causal halves it; x3 for train bwd.
    Zero for attention-free archs; hybrid counts the shared block only."""
    heads = getattr(cfg, "effective_n_heads", cfg.n_heads)
    if not heads:
        return 0.0
    hd = cfg.resolved_head_dim
    b, s = shape.global_batch, shape.seq_len
    if cfg.family == "audio":
        e = cfg.encoder
        enc = e.n_layers * 4 * b * e.n_heads * e.n_frames**2 * (e.d_model // e.n_heads)
        dec = cfg.n_layers * (2 * b * heads * s * s * hd          # causal self
                              + 4 * b * heads * s * e.n_frames * hd)
        base = enc + dec
        return 3.0 * base if shape.kind == "train" else base
    if cfg.family == "hybrid":
        n_attn = cfg.n_layers // max(cfg.hybrid_attn_every, 1)
    else:
        n_attn = cfg.n_layers
    base = n_attn * 2.0 * b * heads * s * s * hd               # causal: 4*s^2/2
    if shape.kind == "train":
        return 3.0 * base
    if shape.kind == "prefill":
        return base
    return n_attn * 4.0 * b * heads * s * hd                   # decode: one query
