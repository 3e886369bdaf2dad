"""The corpus's embeddings, made once in one batched pass, as a deployment
embeds its corpus offline; and the plain per-text embedding that the
reference uses for queries.

The function is the one the port's `HashEmbedder` computes (seeded
FNV-1a buckets of byte 4-grams, projected to `dim` by a seeded random
matrix with unit rows, then L2-normalised), written here again so that
the benchmark owns its inputs: the port embeds only the queries, on the
timed path.
"""
from __future__ import annotations

import numpy as np
import torch

FNV_PRIME = np.uint32(16777619)
FNV_BASIS = np.uint32(2166136261)
SEED, BUCKETS = 0, 8192        # the embedder's defaults


def projection(dim: int, seed: int = SEED, buckets: int = BUCKETS) -> np.ndarray:
    g = np.random.default_rng(seed)
    proj = g.normal(size=(buckets, dim)).astype(np.float32)
    proj /= np.linalg.norm(proj, axis=-1, keepdims=True)
    return proj


def grams(data: np.ndarray, seed: int = SEED, buckets: int = BUCKETS) -> np.ndarray:
    """Bucket ids of every byte 4-gram of each row of `data` (n, L >= 4)
    uint8 -> (n, L - 3) int64."""
    w = np.lib.stride_tricks.sliding_window_view(data, 4, axis=-1)
    h = np.full(w.shape[:-1], np.uint32(FNV_BASIS ^ np.uint32(seed & 0xFFFFFFFF)), np.uint32)
    with np.errstate(over="ignore"):
        for col in range(4):
            h = (h ^ w[..., col]) * FNV_PRIME
    return (h % np.uint32(buckets)).astype(np.int64)


@torch.no_grad()
def embed_corpus(doc_bytes: np.ndarray, dim: int, device: torch.device,
                 rows: int = 2048) -> np.ndarray:
    """(n, dim) float32 embeddings of the corpus rows, on `device` in
    blocks of `rows` documents: counts by scatter-add, one fp32 matmul
    (TF32 off), row norms."""
    proj = torch.as_tensor(projection(dim), device=device)
    ids = grams(doc_bytes)
    out = np.empty((doc_bytes.shape[0], dim), np.float32)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for lo in range(0, len(ids), rows):
            idx = torch.as_tensor(ids[lo:lo + rows], device=device)
            counts = torch.zeros((idx.shape[0], BUCKETS), dtype=torch.float32, device=device)
            counts.scatter_add_(1, idx, torch.ones_like(idx, dtype=torch.float32))
            v = counts @ proj
            n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
            out[lo:lo + rows] = torch.where(n > 0, v / n, v).cpu().numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return out


def embed_text(text: str, proj: np.ndarray) -> np.ndarray:
    """One text, in the order of operations of the port's embedder:
    bucket counts, a float32 vector-matrix product, the norm."""
    data = text.encode("utf-8", errors="replace")
    if len(data) < 4:
        data = data.ljust(4, b"\x00")
    feats = np.zeros((proj.shape[0],), np.float32)
    np.add.at(feats, grams(np.frombuffer(data, np.uint8)), 1.0)
    v = feats @ proj
    n = np.linalg.norm(v)
    return v / n if n > 0 else v
