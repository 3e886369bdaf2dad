"""K4: per-block top-k, a DIRC-RAG core's local comparator, CUDA for Hopper;
and the cores' global comparator fused behind it.

Port of `repro.kernels.topk_select.blockwise_topk` (a Pallas TPU kernel):
scores (b, n) fp32 with n % block_n == 0 and k <= block_n -> vals
(b, nb, k) fp32 and block-local indices (b, nb, k) int32, the top k of
each `block_n` block, value descending and the lower index first among
equal values: the order of `jax.lax.top_k`, which the JAX package's
oracle `repro.kernels.ref.blockwise_topk` uses. `lax.top_k` compares
floats in XLA's total order, so +0.0 ranks above -0.0 (they are not
equal there); `order_key` gives that order as int32 keys.

Where that order and the TPU body part, the port follows the order. The
TPU body masks a taken score by overwriting it with -3e38, which ranks
above -inf; the sharded index hands the comparator -inf for dead and
padded slots, so in a block with fewer than k scores above -inf the TPU
body would return a taken index twice. The kernel (`csrc/topk_select.cu`)
excludes what it took by the order instead and returns the -inf slots in
index order, as `lax.top_k` does. NaN scores are outside the contract
(cosine scores clamp their denominator, so none arise).

`hierarchical_select` is `core.topk.hierarchical_topk`'s whole selection
in one launch of the same kernel file: each core's local top-k, then the
top k over the cores' candidates (paper Fig. 3a).

Both wrappers launch the kernel for CUDA tensors and take the plain
versions (`blockwise_topk_ref`, `hierarchical_select_ref`: stable sorts)
only for CPU tensors.
"""
from __future__ import annotations

import torch

from .counters import LOCK as _COUNT_LOCK

BLOCK_N = 512
NEG_INF = -3.0e38   # the TPU kernel's mask value; `ops.local_topk_blocks` pads with it
# the fused launch keeps n_cores * min(k, per) candidates in 48 KB of shared
# memory; above that `hierarchical_select` composes K4 with a merge here
MAX_CANDIDATES = 6144

LAUNCHES = 0   # kernel launches in this process (never counts the plain path)


def order_key(scores: torch.Tensor) -> torch.Tensor:
    """fp32 -> int32 keys whose integer order is `lax.top_k`'s float order
    (XLA's total order: -0.0 below +0.0, -inf below every finite score)."""
    if scores.dtype != torch.float32:
        raise TypeError(f"scores must be float32, got {scores.dtype}")
    bits = scores.view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def sort_desc(scores: torch.Tensor) -> torch.Tensor:
    """Positions of a stable descending sort of the last axis in
    `lax.top_k`'s order: equal values keep their order."""
    return torch.sort(order_key(scores), dim=-1, descending=True, stable=True).indices


def blockwise_topk_ref(scores: torch.Tensor, k: int,
                       block_n: int = BLOCK_N) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: a stable descending sort of each block."""
    b, n = scores.shape
    s = scores.reshape(b, n // block_n, block_n)
    i = sort_desc(s)[..., :k]
    return torch.gather(s, -1, i), i.int()


def _merge_cores(lv: torch.Tensor, li: torch.Tensor, k: int,
                 per: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The global comparator over (rows, n_cores, kk) local winners: core
    offsets added, then the top k of the core-major candidates by a stable
    sort. Within a core the candidates are value descending with lower
    indices first, so among equal values a lower position is a lower id."""
    rows, n_cores, _ = lv.shape
    ids = li + (torch.arange(n_cores, dtype=torch.int32, device=li.device) * per)[:, None]
    flat_v, flat_i = lv.reshape(rows, -1), ids.reshape(rows, -1)
    pos = sort_desc(flat_v)[:, :k]
    return torch.gather(flat_v, 1, pos), torch.gather(flat_i, 1, pos)


def hierarchical_select_ref(scores: torch.Tensor, k: int,
                            n_cores: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of `hierarchical_select`: K4's plain version
    over the cores, then the stable merge."""
    per = scores.shape[1] // n_cores
    lv, li = blockwise_topk_ref(scores, min(k, per), per)
    return _merge_cores(lv, li, k, per)


def _check(scores: torch.Tensor, k: int, block_n: int) -> None:
    if scores.dtype != torch.float32:
        raise TypeError(f"scores must be float32, got {scores.dtype}")
    if scores.ndim != 2:
        raise ValueError(f"scores must be (b, n), got {tuple(scores.shape)}")
    n = scores.shape[1]
    if block_n < 1 or n % block_n or not 1 <= k <= block_n:
        raise ValueError(f"need n % block_n == 0 and 1 <= k <= block_n; got n {n}, "
                         f"block_n {block_n}, k {k}")


def _on_card(scores: torch.Tensor) -> bool:
    """False for a CPU tensor (the plain version's); raises off CUDA."""
    if scores.device.type == "cpu":
        return False
    if scores.device.type != "cuda":
        raise ValueError(f"scores on {scores.device}: must be on a CUDA device "
                         "(or the CPU)")
    return True


def _launch(entry: str, scores: torch.Tensor, out_shape: tuple, *args: int):
    """Launch C entry point `entry` on contiguous `scores` into new (vals,
    idx) of `out_shape`; counts the launch."""
    global LAUNCHES
    from . import _build

    lib = _build.load_library()
    vals = torch.empty(out_shape, dtype=torch.float32, device=scores.device)
    idx = torch.empty(out_shape, dtype=torch.int32, device=scores.device)
    if vals.numel() == 0:
        return vals, idx
    s = scores.contiguous()
    with torch.cuda.device(s.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = getattr(lib, entry)(s.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                                     s.shape[0], s.shape[1], *args, stream)
    _build.check(status, entry)
    with _COUNT_LOCK:
        LAUNCHES += 1
    return vals, idx


def blockwise_topk(scores: torch.Tensor, k: int,
                   block_n: int = BLOCK_N) -> tuple[torch.Tensor, torch.Tensor]:
    """scores (b, n) fp32 -> (vals (b, nb, k), block-local idx (b, nb, k))."""
    _check(scores, k, block_n)
    if not _on_card(scores):
        return blockwise_topk_ref(scores, k, block_n)
    b, n = scores.shape
    return _launch("topk_select_launch", scores, (b, n // block_n, k), block_n, k)


def hierarchical_select(scores: torch.Tensor, k: int,
                        n_cores: int) -> tuple[torch.Tensor, torch.Tensor]:
    """scores (b, n) fp32, n % n_cores == 0 -> (vals (b, kg), global ids
    (b, kg) int32), kg = min(k, n): each core's top min(k, n / n_cores),
    then the top k of their candidates, lower id first among equal values.
    One launch on the card."""
    if k < 1 or n_cores < 1 or scores.ndim != 2 or scores.shape[1] % n_cores:
        raise ValueError(f"need k >= 1 and n % n_cores == 0; got shape "
                         f"{tuple(scores.shape)}, n_cores {n_cores}, k {k}")
    b, n = scores.shape
    per = n // n_cores
    kk = min(k, per)
    _check(scores, kk, per)
    if not _on_card(scores):
        return hierarchical_select_ref(scores, k, n_cores)
    if n_cores * kk > MAX_CANDIDATES:
        lv, li = blockwise_topk(scores, kk, per)
        return _merge_cores(lv, li, k, per)
    kg = min(k, n_cores * kk)
    return _launch("hierarchical_select_launch", scores, (b, kg), n_cores, kk, kg)
