"""Synthetic corpora: LM token streams + IR datasets with planted relevance.

A copy of `repro.data.synthetic` (numpy only), kept in the port so that
it imports nothing of the JAX package; the same seed gives the same
arrays in both packages.

BEIR is unavailable offline, so the retrieval-precision experiments (paper
Table II / Fig. 6) run on synthetic datasets that reproduce the structure
that makes P@k meaningful: clustered document embeddings and queries whose
RELEVANT set is planted (queries are noisy mixtures of docs from one
cluster). FP32 retrieval then lands mid-range P@k (like BEIR's 0.2-0.6),
leaving measurable headroom for quantization/error effects in both
directions — exactly the regime the paper's tables live in.

The LM corpus is a seeded bigram language so a ~100M-param model visibly
learns (loss drops) within a few hundred CPU steps.
"""
from __future__ import annotations

import dataclasses

import numpy as np


# ------------------------------------------------------------ IR datasets
@dataclasses.dataclass
class IRDataset:
    name: str
    doc_embeddings: np.ndarray   # (n_docs, dim) fp32, L2-normalized
    query_embeddings: np.ndarray  # (n_q, dim)
    relevant: np.ndarray          # (n_q, max_rel) doc ids, -1 padded
    doc_texts: list
    query_texts: list

    @property
    def embedding_mb(self) -> float:
        return self.doc_embeddings.size * 4 / 2**20


def make_ir_dataset(
    name: str = "synth",
    n_docs: int = 4096,
    dim: int = 512,
    n_queries: int = 128,
    n_clusters: int = 64,
    relevant_per_query: int = 8,
    doc_noise: float = 0.7,
    hidden_frac: float = 0.5,
    seed: int = 0,
) -> IRDataset:
    """Hidden-dimension relevance model.

    Ground-truth relevance is judged in a (dim + hidden) "semantic" space;
    the retrievable embeddings are the truncated first `dim` coordinates
    (renormalized) — modeling the information an embedding model loses.
    FP32 retrieval therefore lands mid-band P@k (like BEIR's 0.2-0.6),
    with measurable headroom for quantization / bit-error effects.
    """
    rng = np.random.default_rng(seed)
    h = int(dim * hidden_frac)
    D = dim + h
    centers = rng.normal(size=(n_clusters, D)).astype(np.float32)
    assign = rng.integers(0, n_clusters, size=n_docs)
    full = centers[assign] + doc_noise * rng.normal(
        size=(n_docs, D)).astype(np.float32)
    full /= np.linalg.norm(full, axis=-1, keepdims=True)
    q_assign = rng.integers(0, n_clusters, size=n_queries)
    qfull = centers[q_assign] + doc_noise * rng.normal(
        size=(n_queries, D)).astype(np.float32)
    qfull /= np.linalg.norm(qfull, axis=-1, keepdims=True)

    # true relevance: full-space cosine top-R
    sims = qfull @ full.T
    relevant = np.argsort(-sims, axis=-1)[:, :relevant_per_query].astype(np.int64)

    docs = full[:, :dim] / np.linalg.norm(full[:, :dim], axis=-1,
                                          keepdims=True)
    queries = qfull[:, :dim] / np.linalg.norm(qfull[:, :dim], axis=-1,
                                              keepdims=True)
    doc_texts = [f"[{name} doc {i} cluster {assign[i]}]" for i in range(n_docs)]
    query_texts = [f"[{name} query {i}]" for i in range(n_queries)]
    return IRDataset(name, docs.astype(np.float32),
                     queries.astype(np.float32), relevant,
                     doc_texts, query_texts)


# Synthetic analogues of the paper's five BEIR datasets, sized so the INT8
# embedding image matches Table II's "Embedding Size (MB)" column scale.
BEIR_ANALOGUES = {
    # name: (n_docs @ dim 512 -> INT8 MB), queries
    "synth-scifact": dict(n_docs=3_888, n_queries=100, seed=1),     # 1.90 MB
    "synth-nfcorpus": dict(n_docs=2_720, n_queries=128, seed=2),    # 1.33 MB
    "synth-trec-covid": dict(n_docs=8_028, n_queries=50, seed=3),   # 3.92 MB
    "synth-arguana": dict(n_docs=6_512, n_queries=100, seed=4),     # 3.18 MB
    "synth-scidocs": dict(n_docs=6_410, n_queries=100, seed=5),     # 3.13 MB
}


def beir_analogue(name: str, dim: int = 512) -> IRDataset:
    kw = BEIR_ANALOGUES[name]
    return make_ir_dataset(name=name, dim=dim, **kw)


# -------------------------------------------------------------- LM corpus
class BigramLM:
    """Seeded synthetic language with learnable bigram structure."""

    def __init__(self, vocab_size: int, seed: int = 0, temp: float = 0.35):
        rng = np.random.default_rng(seed)
        logits = rng.normal(size=(vocab_size, vocab_size)) / temp
        self.vocab_size = vocab_size
        self.probs = np.exp(logits - logits.max(-1, keepdims=True))
        self.probs /= self.probs.sum(-1, keepdims=True)

    def sample(self, rng: np.random.Generator, batch: int, seq: int) -> np.ndarray:
        out = np.empty((batch, seq), np.int32)
        out[:, 0] = rng.integers(0, self.vocab_size, size=batch)
        for t in range(1, seq):
            p = self.probs[out[:, t - 1]]
            cum = p.cumsum(-1)
            u = rng.random((batch, 1))
            out[:, t] = (u < cum).argmax(-1)
        return out
