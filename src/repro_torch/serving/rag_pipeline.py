"""End-to-end edge RAG pipeline (paper Fig. 1) — counterpart of
`repro.serving.rag_pipeline` for the synchronous query path:

    user query --embed--> query embedding
      --DIRC retrieve--> top-k document ids (quantized CIM search)
      --augment--> [BOS] doc1 SEP doc2 ... SEP query prompt
      --generate--> answer tokens

The embedder is the same numpy stub as the JAX package's (seeded FNV-1a
bucketing of byte 4-grams through a random projection), so both packages
embed every text identically. Retrieval runs on the monolithic
`DircRagIndex` (`n_shards=0`); generation on `GenerationEngine`.

Not ported yet (each raises NotImplementedError naming its ROADMAP
item): the sharded index (`n_shards >= 1`, `add_docs`/`delete_docs`,
`drift`/`recal`) and the streaming stack (`scheduler`, `decode_engine`,
`query_stream`, `generate_stream`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.retrieval import DircRagIndex, RetrievalConfig
from repro_torch.core.simulator import simulate_query
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.device import DeviceLike, resolve_device
from .engine import GenerationEngine

_FNV_PRIME = np.uint32(16777619)
_FNV_BASIS = np.uint32(2166136261)

_SLICE2 = "ROADMAP: port slice 2, paged serving"
_SHARDED = "ROADMAP: modules to port, sharded index"


class HashEmbedder:
    """Deterministic byte-4-gram hashing embedder (frontend stub), a numpy
    copy of the JAX package's: seeded FNV-1a buckets, stable across
    processes, projected to `dim` and L2-normalised."""

    def __init__(self, dim: int = 512, seed: int = 0, buckets: int = 8192):
        self.dim = dim
        self.buckets = buckets
        rng = np.random.default_rng(seed)
        self._basis = np.uint32(_FNV_BASIS ^ np.uint32(seed & 0xFFFFFFFF))
        self.proj = rng.normal(size=(buckets, dim)).astype(np.float32)
        self.proj /= np.linalg.norm(self.proj, axis=-1, keepdims=True)

    def _bucket_4grams(self, data: bytes) -> np.ndarray:
        """Bucket ids of every byte 4-gram (short inputs are NUL-padded)."""
        if len(data) < 4:
            data = data.ljust(4, b"\x00")
        arr = np.frombuffer(data, np.uint8)
        grams = np.lib.stride_tricks.sliding_window_view(arr, 4)
        h = np.full((grams.shape[0],), self._basis, np.uint32)
        with np.errstate(over="ignore"):  # uint32 wraparound is the point
            for col in range(4):
                h = (h ^ grams[:, col]) * _FNV_PRIME
        return h % np.uint32(self.buckets)

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), np.float32)
        for i, t in enumerate(texts):
            feats = np.zeros((self.buckets,), np.float32)
            np.add.at(feats, self._bucket_4grams(
                t.encode("utf-8", errors="replace")), 1.0)
            v = feats @ self.proj
            n = np.linalg.norm(v)
            out[i] = v / n if n > 0 else v
        return out


@dataclasses.dataclass
class RagResult:
    doc_ids: np.ndarray
    doc_scores: np.ndarray
    retrieved_texts: list
    answer_text: Optional[str]
    answer_tokens: Optional[np.ndarray]
    sim_latency_us: float
    sim_energy_uj: float


class RagPipeline:
    def __init__(
        self,
        doc_texts: Sequence[str],
        retrieval_config: RetrievalConfig,
        model=None,
        embedder: Optional[HashEmbedder] = None,
        dim: int = 512,
        max_prompt_len: int = 512,
        n_shards: int = 0,
        device: DeviceLike = None,
        drift=None,
        recal=None,
    ):
        """Embed `doc_texts` and build the monolithic DIRC index on
        `device` (`None` is the card). `model` is an optional `DecoderLM`
        on the same device; with one, queries also generate answers."""
        if n_shards > 0:
            raise NotImplementedError(f"n_shards >= 1 is not ported ({_SHARDED})")
        if drift is not None or recal:
            raise NotImplementedError(f"drift/recal are not ported ({_SHARDED})")
        self.device = resolve_device(device)
        self.tokenizer = ByteTokenizer()
        self.embedder = embedder or HashEmbedder(dim=dim)
        self.doc_texts = list(doc_texts)
        embs = self.embedder.embed(self.doc_texts)
        self.index = DircRagIndex.build(embs, retrieval_config, device=self.device)
        self.engine = (GenerationEngine(model, device=self.device)
                       if model is not None else None)
        self.max_prompt_len = max_prompt_len

    # ------------------------------------------------------------ retrieval
    def search_batch(self, texts: Sequence[str], k: int,
                     generator: Optional[torch.Generator] = None,
                     ) -> tuple[np.ndarray, np.ndarray]:
        """Embed + search a whole batch as one (b, dim) call.

        Returns (ids (b, k) int32, scores (b, k) fp32). `generator` (on the
        pipeline's device) drives the sensing-error channel, if enabled."""
        q = self.embedder.embed(list(texts))
        res = self.index.search(q, k=k, generator=generator)
        return res.indices.cpu().numpy(), res.scores.cpu().numpy()

    def encode_prompt(self, text: str, retrieved_texts: Sequence[str]) -> list:
        """Augmented-prompt token ids, folded into the model vocab."""
        return self.encode_prompt_with_prefix(text, retrieved_texts)[0]

    def encode_prompt_with_prefix(
            self, text: str, retrieved_texts: Sequence[str],
    ) -> tuple[list, int]:
        """(augmented-prompt token ids, shareable prefix length): the prefix
        is the `[BOS] doc1 SEP ... SEP` context header before the query;
        0 when `max_prompt_len` truncation left none of it."""
        prompt = self.tokenizer.encode_rag_prompt(
            text, list(retrieved_texts), self.max_prompt_len)
        n_query = len(self.tokenizer.encode(text, bos=False))
        prefix_len = max(len(prompt) - n_query, 0)
        vocab = self.engine.model.cfg.vocab_size
        return [t % vocab for t in prompt], prefix_len

    # --------------------------------------------------------------- query
    def query(self, text: str, k: int = 3, max_new_tokens: int = 32,
              generator: Optional[torch.Generator] = None) -> RagResult:
        return self.query_many([text], k=k, max_new_tokens=max_new_tokens,
                               generator=generator)[0]

    def query_many(self, texts: Sequence[str], k: int = 3,
                   max_new_tokens: int = 32,
                   generator: Optional[torch.Generator] = None) -> list:
        """Serve a batch of queries with ONE embed + ONE batched search;
        generation (if a model is attached) runs per query, since prompt
        lengths differ."""
        ids_b, scores_b = self.search_batch(texts, k, generator=generator)

        # DIRC hardware supports dims 128..1024 (paper Table I); round the
        # simulated dim up to the nearest supported column folding.
        sim_dim = min(max((self.index.dim + 127) // 128 * 128, 128), 1024)
        sim = simulate_query(self.index.n_docs, sim_dim,
                             bits=self.index.config.bits)

        results = []
        for text, ids, scores in zip(texts, ids_b, scores_b):
            texts_k = [self.doc_texts[i] for i in ids if i >= 0]
            answer_text = answer_tokens = None
            if self.engine is not None and max_new_tokens > 0:
                prompt = self.encode_prompt(text, texts_k)
                answer_tokens = self.engine.generate(
                    np.asarray(prompt, np.int64)[None], max_new_tokens=max_new_tokens)
                answer_text = self.tokenizer.decode(answer_tokens[0])
            results.append(RagResult(
                doc_ids=ids,
                doc_scores=scores,
                retrieved_texts=texts_k,
                answer_text=answer_text,
                answer_tokens=answer_tokens,
                sim_latency_us=sim.latency_s * 1e6,
                sim_energy_uj=sim.energy_j * 1e6,
            ))
        return results

    # ------------------------------------------------------- not ported yet
    def scheduler(self, *args, **kwargs):
        raise NotImplementedError(f"scheduler is not ported ({_SLICE2})")

    def decode_engine(self, *args, **kwargs):
        raise NotImplementedError(f"decode_engine is not ported ({_SLICE2})")

    def query_stream(self, *args, **kwargs):
        raise NotImplementedError(f"query_stream is not ported ({_SLICE2})")

    def generate_stream(self, *args, **kwargs):
        raise NotImplementedError(f"generate_stream is not ported ({_SLICE2})")

    def add_docs(self, texts):
        raise NotImplementedError(f"add_docs is not ported ({_SHARDED})")

    def delete_docs(self, doc_ids):
        raise NotImplementedError(f"delete_docs is not ported ({_SHARDED})")
