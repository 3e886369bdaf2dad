"""K1: DIRC bit-serial bit-plane MAC (paper Fig. 4), CUDA for Hopper.

Port of `repro.kernels.dirc_mac.dirc_mac_packed` (a Pallas TPU kernel).
Computes exact INT8/INT4 inner products from packed two's-complement
bit-planes by AND + popcount with signed bit weights:

    out[b, n] = sum_bq sum_bd w(bq) * w(bd) * popcount(Q[b, bq] & D[bd, :, n])

Layouts, as the TPU kernel's (docs on the fast axis):
    q_planes  (b, bits, nw)  int32 holding uint32 words
    d_planes  (bits, nw, n)  int32 holding uint32 words
    out       (b, n)         int32
with nw = dim / 32. Every bit pattern of the planes is a two's-complement
code, so the weighted popcount sum equals the int32 dot product of the
codes the planes encode (`bitplane.from_bitplanes`): the kernel
(`csrc/dirc_mac.cu`) decodes the planes to int8 codes in shared memory and
multiplies them on the int8 tensor cores, bit-exact. It takes any n,
bits 4 or 8 and nw <= 96.

`dirc_mac_packed` launches the kernel for CUDA tensors and takes the
plain version `dirc_mac_packed_ref` only for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.core import bitplane
from .counters import LOCK as _COUNT_LOCK

LAUNCHES = 0   # kernel launches in this process (never counts the plain path)


def dirc_mac_packed_ref(q_planes: torch.Tensor, d_planes: torch.Tensor,
                        bits: int = 8) -> torch.Tensor:
    """Plain PyTorch version of the kernel, same layouts, exact."""
    b, qbits, nw = q_planes.shape
    q = bitplane.unpack_words(q_planes)                    # (b, bits, dim)
    d = bitplane.unpack_words(d_planes.permute(2, 0, 1))   # (n, bits, dim)
    counts = bitplane.plane_counts(q, d)                   # (b, bq, n, bd)
    w = torch.tensor([bitplane.bit_weight(i, bits) for i in range(bits)],
                     dtype=torch.int64, device=q_planes.device)
    return (counts * w[:, None, None] * w).sum(dim=(1, 3)).int()


def _check(q_planes: torch.Tensor, d_planes: torch.Tensor, bits: int) -> None:
    if q_planes.dtype != torch.int32 or d_planes.dtype != torch.int32:
        raise TypeError("q_planes and d_planes must be int32 (uint32 words)")
    if q_planes.ndim != 3 or d_planes.ndim != 3:
        raise ValueError("q_planes must be (b, bits, nw), d_planes (bits, nw, n)")
    b, qbits, nw = q_planes.shape
    dbits, dnw, _ = d_planes.shape
    if not qbits == dbits == bits or dnw != nw:
        raise ValueError(f"shape mismatch: q {tuple(q_planes.shape)}, "
                         f"d {tuple(d_planes.shape)}, bits {bits}")
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")


def dirc_mac_packed(q_planes: torch.Tensor, d_planes: torch.Tensor,
                    bits: int = 8) -> torch.Tensor:
    """q_planes (b, bits, nw), d_planes (bits, nw, n) -> (b, n) int32."""
    global LAUNCHES
    _check(q_planes, d_planes, bits)
    if q_planes.device.type == "cpu" and d_planes.device.type == "cpu":
        return dirc_mac_packed_ref(q_planes, d_planes, bits)
    if q_planes.device.type != "cuda" or d_planes.device != q_planes.device:
        raise ValueError(f"tensors on {q_planes.device} and {d_planes.device}: "
                         "both must be on one CUDA device (or both on the CPU)")
    if not (q_planes.is_contiguous() and d_planes.is_contiguous()):
        raise ValueError("q_planes and d_planes must be contiguous")
    from . import _build

    lib = _build.load_library()
    b, _, nw = q_planes.shape
    n = d_planes.shape[2]
    out = torch.empty((b, n), dtype=torch.int32, device=q_planes.device)
    if b == 0 or n == 0:
        return out
    with torch.cuda.device(q_planes.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.dirc_mac_launch(q_planes.data_ptr(), d_planes.data_ptr(),
                                     out.data_ptr(), b, bits, nw, n, stream)
    _build.check(status, "dirc_mac_launch")
    with _COUNT_LOCK:
        LAUNCHES += 1
    return out
