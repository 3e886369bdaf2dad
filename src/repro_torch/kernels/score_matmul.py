"""K2: exact INT8 score GEMM, and K5: the same GEMM with a fused cosine
epilogue, CUDA for Hopper.

K2 ports `repro.kernels.score_matmul.score_matmul_int` (a Pallas TPU
kernel): q (b, dim) int8 x docs (n, dim) int8 -> (b, n) int32 = q @ D^T,
exact. K5 ports `score_matmul_cosine` from the same module: (b, n) fp32 =
ip / max(q_norms * doc_norms, 1e-12), with q_norms (b, 1) and doc_norms
(1, n) fp32. The TPU kernel takes the dot in fp32; the CUDA kernel
converts the exact int32 dot, which is the same number while |ip| <= 2^24,
i.e. for dim <= 1024 (the range the TPU kernel's docstring states), so
`score_matmul_cosine` refuses a wider dim on every device. Both
kernels are one kernel body in `csrc/score_matmul.cu` with two
epilogues; they take any n and need dim % 16 == 0 (rows are copied in
16-byte pieces) and 16-byte-aligned q and docs.

`score_matmul_int` / `score_matmul_cosine` launch their kernel for CUDA
tensors and take the plain versions `score_matmul_int_ref` /
`score_matmul_cosine_ref` only for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.core.quantization import int_matmul_nt
from .counters import LOCK as _COUNT_LOCK

LAUNCHES = 0          # K2 launches in this process (never counts the plain path)
COSINE_LAUNCHES = 0   # K5 launches in this process
COSINE_MAX_DIM = 1024  # |ip| <= 2^24 (exact in fp32) for int8 codes up to here


def score_matmul_int_ref(q: torch.Tensor, docs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: (b, n) int32 = q @ docs^T, exact."""
    return int_matmul_nt(q, docs).int()


def score_matmul_cosine_ref(q: torch.Tensor, docs: torch.Tensor,
                            q_norms: torch.Tensor, doc_norms: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K5: (b, n) fp32 = ip / max(qn * dn, 1e-12)."""
    ip = int_matmul_nt(q, docs).float()
    return ip / torch.clamp_min(q_norms * doc_norms, 1e-12)


def _check(q: torch.Tensor, docs: torch.Tensor, *norms: torch.Tensor) -> bool:
    """Validate the operands; True when all lie on the CPU (the plain
    path), False when all lie on one CUDA device; raise otherwise."""
    if q.dtype != torch.int8 or docs.dtype != torch.int8:
        raise TypeError("q and docs must be int8")
    if q.ndim != 2 or docs.ndim != 2 or q.shape[1] != docs.shape[1]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, docs {tuple(docs.shape)}")
    if norms:
        qn, dn = norms
        if qn.dtype != torch.float32 or dn.dtype != torch.float32:
            raise TypeError("q_norms and doc_norms must be float32")
        if tuple(qn.shape) != (q.shape[0], 1) or tuple(dn.shape) != (1, docs.shape[0]):
            raise ValueError(f"q_norms must be (b, 1) and doc_norms (1, n); got "
                             f"{tuple(qn.shape)}, {tuple(dn.shape)}")
        if q.shape[1] > COSINE_MAX_DIM:
            raise ValueError(f"score_matmul_cosine matches the fp32 dot only for dim <= "
                             f"{COSINE_MAX_DIM}, got {q.shape[1]}")
    tensors = (q, docs, *norms)
    if all(x.device.type == "cpu" for x in tensors):
        return True
    if q.device.type != "cuda" or any(x.device != q.device for x in tensors):
        raise ValueError(f"tensors on {sorted({str(x.device) for x in tensors})}: all "
                         "must be on one CUDA device (or all on the CPU)")
    if q.shape[1] % 16:
        raise ValueError(f"the CUDA kernel needs dim % 16 == 0, got {q.shape[1]}")
    if not (q.is_contiguous() and docs.is_contiguous()):
        raise ValueError("q and docs must be contiguous")
    if q.data_ptr() % 16 or docs.data_ptr() % 16:
        raise ValueError("q and docs must be 16-byte aligned")
    return False


def score_matmul_cosine(q: torch.Tensor, docs: torch.Tensor, q_norms: torch.Tensor,
                        doc_norms: torch.Tensor) -> torch.Tensor:
    """K5: q (b, dim) int8, docs (n, dim) int8, q_norms (b, 1), doc_norms
    (1, n) fp32 -> (b, n) fp32 cosine scores."""
    global COSINE_LAUNCHES
    if _check(q, docs, q_norms, doc_norms):
        return score_matmul_cosine_ref(q, docs, q_norms, doc_norms)
    from . import _build

    lib = _build.load_library()
    b, dim = q.shape
    n = docs.shape[0]
    out = torch.empty((b, n), dtype=torch.float32, device=q.device)
    if b == 0 or n == 0:
        return out
    qn, dn = q_norms.contiguous(), doc_norms.contiguous()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.score_matmul_cosine_launch(q.data_ptr(), docs.data_ptr(),
                                                qn.data_ptr(), dn.data_ptr(),
                                                out.data_ptr(), b, dim, n, stream)
    _build.check(status, "score_matmul_cosine_launch")
    with _COUNT_LOCK:
        COSINE_LAUNCHES += 1
    return out


def score_matmul_int(q: torch.Tensor, docs: torch.Tensor) -> torch.Tensor:
    """q (b, dim) int8 x docs (n, dim) int8 -> (b, n) int32."""
    global LAUNCHES
    if _check(q, docs):
        return score_matmul_int_ref(q, docs)
    b, dim = q.shape
    n = docs.shape[0]
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
    with _COUNT_LOCK:
        LAUNCHES += 1
    return out
