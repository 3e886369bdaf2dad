"""Retrieval as the paper's INT8 macro computes it, in NumPy: symmetric
per-row quantisation (scale = absmax times the float32 reciprocal of
qmax; codes rounded half to even), exact integer dot products, cosine
over the codes' integer norms, and the top k by (-score, id)."""
from __future__ import annotations

import numpy as np

QMAX = {8: 127, 4: 7}


def quantize(x: np.ndarray, bits: int = 8) -> np.ndarray:
    """(n, dim) float32 -> (n, dim) int8 codes."""
    qmax = QMAX[bits]
    x = np.asarray(x, np.float32)
    absmax = np.abs(x).max(axis=-1, keepdims=True)
    recip = np.float32(1) / np.float32(qmax)
    scale = np.where(absmax > 0, absmax * recip, np.float32(1)).astype(np.float32)
    return np.clip(np.round(x / scale), -qmax - 1, qmax).astype(np.int8)


def int_norms(codes: np.ndarray) -> np.ndarray:
    """Norms of integer codes: the exact sum of squares, its root in
    float64 rounded once to float32."""
    ss = (codes.astype(np.int64) ** 2).sum(axis=-1)
    return np.sqrt(ss.astype(np.float64)).astype(np.float32)


def cosine_scores(q_codes: np.ndarray, d_codes: np.ndarray,
                  d_norms: np.ndarray) -> np.ndarray:
    """(b, n) float32: <q, d> (exact: float64 holds every such sum) over
    max(|q| |d|, 1e-12), each step rounded to float32 once."""
    ip = np.rint(q_codes.astype(np.float64) @ d_codes.astype(np.float64).T)
    qn = int_norms(q_codes)[:, None]
    den = np.maximum(qn * d_norms[None, :], np.float32(1e-12))
    return ip.astype(np.float32) / den


def top_k(scores: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """(ids, scores) of the k best of each row, the lower id first on a
    tie."""
    order = np.argsort(-scores, axis=-1, kind="stable")[:, :k]
    return order.astype(np.int64), np.take_along_axis(scores, order, axis=-1)
