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
counterpart of. Here `analyze` runs the step once, on real tensors or on
the meta device (the dry run, `launch.dryrun`): FLOPs are counted by
`torch.utils.flop_counter.FlopCounterMode` (every matmul, bmm and
einsum the step dispatches, the backward's included; element-wise work
is not counted, as XLA's dot-dominated count is), and collectives by
the counter that `repro_torch.spmd`'s collectives bump (an all-reduce's
output bytes weighted 2x, as the reference weights it) plus those that
DTensor issues (the ZeRO-1 reduce-scatters and all-gathers of the train
step), which `StepCounter` sees as `_c10d_functional` ops and weighs
the same way.

`StepCounter`, a `TorchDispatchMode`, also counts the step's HBM bytes
and its temporary memory:
  * bytes: the sum over every op the step dispatches of its tensor
    inputs' and outputs' bytes, views counting 0 (an op whose schema
    aliases its output to an input without writing it), and so do the
    ops that only wait on a collective's result or wrap it for
    autograd. This is what the eager program moves: XLA's "bytes
    accessed" without fusion, so above what a fused program would move;
  * temp: the peak of the bytes of storages the step allocated that are
    alive at once (each storage counted once, from its first op output
    to its release; storages that existed before the step, weights and
    state, are not counted). A host process group's worker may hold a
    collective's tensors past the call (gloo drops them on its own
    thread, later under load), so each `c10d` collective on host or
    meta tensors runs on untracked copies, is waited on and copied back:
    a counted storage dies when the program drops it, on real gloo ranks
    as on the fake group. On the card the collective runs as it is (a
    NCCL work waited on inside the dispatch mode crashes the process),
    so the card's temp peak is a reading of that run.
A caller may pass its own bytes (`hbm_bytes`): what the step must move
at the least (weights and caches read once), `tensor_bytes` of them.
The 1- and 2-unit extrapolation (`extrapolate`) carries over as
arithmetic.

`model_flops` / `attention_flops` are the reference's analytic counts,
unchanged.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map

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
    lists, modules' parameters), each counted once; a DTensor counts its
    local shard."""
    seen, total = set(), 0

    def walk(x):
        nonlocal total
        if isinstance(x, torch.nn.Module):
            x = list(x.parameters())
        if isinstance(x, torch.Tensor):
            if id(x) not in seen:
                seen.add(id(x))
                local = x.to_local() if hasattr(x, "to_local") else x
                total += local.numel() * local.element_size()
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
    for t in trees:
        walk(t)
    return total


_FUNCTIONAL = {"all_reduce": "all-reduce", "all_reduce_": "all-reduce",
               "reduce_scatter_tensor": "reduce-scatter",
               "all_gather_into_tensor": "all-gather", "all_to_all_single": "all-to-all"}
# ops that only wait on a collective's output or wrap it for autograd (a
# real group dispatches `wait_tensor`, the fake one does not): no bytes
_BOOKKEEPING = ("wait_tensor", "_wrap_tensor_autograd")


def _plain(t) -> bool:
    return isinstance(t, torch.Tensor) and type(t) in (torch.Tensor, torch.nn.Parameter)


def _on_copies(func, args, kwargs):
    """Run the `c10d` collective `func` on copies of its tensors (made
    here, inside the dispatch mode, so it does not track them), wait for
    it, copy every tensor back, and return its result with the originals
    in place of the copies."""
    pairs = {}

    def copy(t):
        if not _plain(t):
            return t
        if id(t) not in pairs:
            pairs[id(t)] = (t, t.clone())
        return pairs[id(t)][1]
    out = func(*tree_map(copy, args), **tree_map(copy, kwargs))
    for x in tree_leaves(out):
        if not isinstance(x, torch.Tensor) and hasattr(x, "wait"):
            x.wait()
    for t, c in pairs.values():
        t.copy_(c)
    back = {id(c): t for t, c in pairs.values()}
    return tree_map(lambda x: back.get(id(x), x), out)


class StepCounter(TorchDispatchMode):
    """Counts, over the ops dispatched inside it: `bytes` (each non-view
    op's tensor inputs and outputs), `peak` (the most bytes of storages
    allocated inside it that were alive at once) and `collectives` (the
    `_c10d_functional` collectives DTensor issues: {op: {"count",
    "bytes"}}, output bytes weighted as the reference's roofline weighs
    them). See the module note."""

    def __init__(self):
        super().__init__()
        from torch.utils.weak import WeakIdKeyDictionary

        self._seen = WeakIdKeyDictionary()
        self.bytes = self.live = self.peak = 0
        self.collectives = {op: {"count": 0, "bytes": 0} for op in _COLL_OPS}

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        import weakref

        kwargs = kwargs or {}
        ins = [t for t in tree_leaves((args, kwargs)) if _plain(t)]
        for t in ins:                       # storages from before the step
            st = t.untyped_storage()
            if st not in self._seen:
                self._seen[st] = 0
        host = func.namespace == "c10d" and not any(t.is_cuda for t in ins)
        out = _on_copies(func, args, kwargs) if host else func(*args, **kwargs)
        outs = [t for t in tree_leaves(out) if _plain(t)]
        for t in outs:
            st = t.untyped_storage()
            if st not in self._seen:
                n = st.nbytes()
                self._seen[st] = n
                self.live += n
                weakref.finalize(st, self._free, n)
        self.peak = max(self.peak, self.live)
        if not func.is_view and func.overloadpacket.__name__ not in _BOOKKEEPING:
            self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        op = _FUNCTIONAL.get(func.overloadpacket.__name__)
        if op is not None and func.namespace == "_c10d_functional" and outs:
            c = self.collectives[op]
            c["count"] += 1
            nbytes = sum(t.numel() * t.element_size() for t in outs)
            c["bytes"] += spmd.COLLECTIVE_WEIGHT[op] * nbytes
        return out


def analyze(fn, hbm_bytes: float | None = None):
    """Run `fn()` once, counting its FLOPs, the collectives it issues
    (`spmd`'s and DTensor's), its bytes and its temporary memory
    (`StepCounter`): (fn's result, {"flops", "bytes", "collective_bytes",
    "collectives", "temp_bytes"}) as `repro.perf.roofline.analyze_compiled`
    reports them, plus the temp peak. `bytes` is the caller's `hbm_bytes`
    where given, else the counted bytes. The collective counts are reset
    first, and the garbage collector waits while `fn` runs, so that the
    temp peak does not depend on when it would have run."""
    import gc

    from torch.utils.flop_counter import FlopCounterMode

    spmd.reset_collectives()
    gc.collect()
    gc.disable()        # storages held in reference cycles go at the same point every run
    try:
        with FlopCounterMode(display=False) as counter, StepCounter() as step:
            out = fn()
    finally:
        gc.enable()
    coll = spmd.read_collectives()
    colls = {}
    for op in _COLL_OPS:
        mine, theirs = coll.get(op, {"count": 0, "bytes": 0}), step.collectives[op]
        colls[op] = {"count": mine["count"] + theirs["count"],
                     "bytes": mine["bytes"] + theirs["bytes"]}
    colls["total_bytes"] = sum(c["bytes"] for c in colls.values())
    return out, {"flops": float(counter.get_total_flops()),
                 "bytes": float(step.bytes if hbm_bytes is None else hbm_bytes),
                 "collective_bytes": float(colls["total_bytes"]), "collectives": colls,
                 "temp_bytes": float(step.peak)}


def extrapolate(a1: dict, a2: dict, n_units: int) -> dict:
    """Linear extrapolation base + n_units * per_unit from 1u/2u minis
    (the temp peak and the output bytes too, where both carry them)."""
    out = {}
    for k in ("flops", "bytes", "collective_bytes", "temp_bytes", "output_bytes"):
        if k not in a1 or k not in a2:
            continue
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
