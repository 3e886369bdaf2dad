"""K2: exact INT8 score GEMM, CUDA for Hopper.

Port of `repro.kernels.score_matmul.score_matmul_int` (a Pallas TPU
kernel): q (b, dim) int8 x docs (n, dim) int8 -> (b, n) int32 = q @ D^T,
exact. The kernel (`csrc/score_matmul.cu`) takes any n and needs
dim % 16 == 0 (16-byte doc-row vectors).

`score_matmul_int` launches the kernel for CUDA tensors and takes the
plain version `score_matmul_int_ref` only for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.core.quantization import int_matmul_nt

LAUNCHES = 0   # kernel launches in this process (never counts the plain path)


def score_matmul_int_ref(q: torch.Tensor, docs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: (b, n) int32 = q @ docs^T, exact."""
    return int_matmul_nt(q, docs).int()


def score_matmul_int(q: torch.Tensor, docs: torch.Tensor) -> torch.Tensor:
    """q (b, dim) int8 x docs (n, dim) int8 -> (b, n) int32."""
    global LAUNCHES
    if q.dtype != torch.int8 or docs.dtype != torch.int8:
        raise TypeError("q and docs must be int8")
    if q.ndim != 2 or docs.ndim != 2 or q.shape[1] != docs.shape[1]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, docs {tuple(docs.shape)}")
    if q.device.type == "cpu" and docs.device.type == "cpu":
        return score_matmul_int_ref(q, docs)
    if q.device.type != "cuda" or docs.device != q.device:
        raise ValueError(f"tensors on {q.device} and {docs.device}: both must "
                         "be on one CUDA device (or both on the CPU)")
    b, dim = q.shape
    n = docs.shape[0]
    if dim % 16:
        raise ValueError(f"the CUDA kernel needs dim % 16 == 0, got {dim}")
    if not (q.is_contiguous() and docs.is_contiguous()):
        raise ValueError("q and docs must be contiguous")
    if q.data_ptr() % 16 or docs.data_ptr() % 16:
        raise ValueError("q and docs must be 16-byte aligned")
    from . import _build

    lib = _build.load_library()
    out = torch.empty((b, n), dtype=torch.int32, device=q.device)
    if b == 0 or n == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.score_matmul_launch(q.data_ptr(), docs.data_ptr(),
                                         out.data_ptr(), b, dim, n, stream)
    _build.check(status, "score_matmul_launch")
    LAUNCHES += 1
    return out
