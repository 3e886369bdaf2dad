"""K4: per-block top-k, a DIRC-RAG core's local comparator, CUDA for Hopper.

Port of `repro.kernels.topk_select.blockwise_topk` (a Pallas TPU kernel):
scores (b, n) fp32 with n % block_n == 0 and k <= block_n -> vals
(b, nb, k) fp32 and block-local indices (b, nb, k) int32, the top k of
each `block_n` block, value descending and the lower index first among
equal values: the order of `jax.lax.top_k`, which the JAX package's
oracle `repro.kernels.ref.blockwise_topk` uses.

Where that order and the TPU body part, the port follows the order. The
TPU body masks a taken score by overwriting it with -3e38, which ranks
above -inf; the sharded index hands the comparator -inf for dead and
padded slots, so in a block with fewer than k scores above -inf the TPU
body would return a taken index twice. The kernel (`csrc/topk_select.cu`)
excludes what it took by the order instead and returns the -inf slots in
index order, as `lax.top_k` does. NaN scores are outside the contract
(cosine scores clamp their denominator, so none arise).

`blockwise_topk` launches the kernel for CUDA tensors and takes the plain
version `blockwise_topk_ref` (a stable descending sort per block) only
for CPU tensors.
"""
from __future__ import annotations

import torch

BLOCK_N = 512
NEG_INF = -3.0e38   # the TPU kernel's mask value; `ops.local_topk_blocks` pads with it

LAUNCHES = 0   # kernel launches in this process (never counts the plain path)


def blockwise_topk_ref(scores: torch.Tensor, k: int,
                       block_n: int = BLOCK_N) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: a stable descending sort of each block."""
    b, n = scores.shape
    s = scores.reshape(b, n // block_n, block_n)
    v, i = torch.sort(s, dim=-1, descending=True, stable=True)
    return v[..., :k].contiguous(), i[..., :k].int()


def _check(scores: torch.Tensor, k: int, block_n: int) -> None:
    if scores.dtype != torch.float32:
        raise TypeError(f"scores must be float32, got {scores.dtype}")
    if scores.ndim != 2:
        raise ValueError(f"scores must be (b, n), got {tuple(scores.shape)}")
    n = scores.shape[1]
    if block_n < 1 or n % block_n or not 1 <= k <= block_n:
        raise ValueError(f"need n % block_n == 0 and 1 <= k <= block_n; got n {n}, "
                         f"block_n {block_n}, k {k}")


def blockwise_topk(scores: torch.Tensor, k: int,
                   block_n: int = BLOCK_N) -> tuple[torch.Tensor, torch.Tensor]:
    """scores (b, n) fp32 -> (vals (b, nb, k), block-local idx (b, nb, k))."""
    global LAUNCHES
    _check(scores, k, block_n)
    if scores.device.type == "cpu":
        return blockwise_topk_ref(scores, k, block_n)
    if scores.device.type != "cuda":
        raise ValueError(f"scores on {scores.device}: must be on a CUDA device "
                         "(or the CPU)")
    from . import _build

    lib = _build.load_library()
    b, n = scores.shape
    nb = n // block_n
    vals = torch.empty((b, nb, k), dtype=torch.float32, device=scores.device)
    idx = torch.empty((b, nb, k), dtype=torch.int32, device=scores.device)
    if b == 0 or n == 0:
        return vals, idx
    s = scores.contiguous()
    with torch.cuda.device(s.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.topk_select_launch(s.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                                        b, n, block_n, k, stream)
    _build.check(status, "topk_select_launch")
    LAUNCHES += 1
    return vals, idx
