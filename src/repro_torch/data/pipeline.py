"""Deterministic, resumable, shardable data pipeline — a copy of
`repro.data.pipeline` (numpy only): the same (seed, step) gives the same
tokens and labels in both packages.

Seeded per-step generation (no files): batch at step t is a pure function
of (seed, t), which gives three production properties for free:
  * resume-exactness — restoring `state()` reproduces the stream bit-for-bit
    after a preemption (tested in tests/test_torch_train.py);
  * elasticity — the GLOBAL batch is generated and then sliced per data
    shard, so re-meshing does not change the data order;
  * zero skew — no host-side file sharding to drift across workers.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from .synthetic import BigramLM


@dataclasses.dataclass
class PipelineState:
    step: int
    seed: int


class DataPipeline:
    def __init__(self, vocab_size: int, batch: int, seq: int,
                 seed: int = 0, start_step: int = 0):
        self.lm = BigramLM(min(vocab_size, 4096), seed=seed)
        self.vocab_size = vocab_size
        self.batch = batch
        self.seq = seq
        self.seed = seed
        self.step = start_step

    def state(self) -> PipelineState:
        return PipelineState(step=self.step, seed=self.seed)

    @classmethod
    def restore(cls, st: PipelineState, vocab_size: int, batch: int,
                seq: int) -> "DataPipeline":
        return cls(vocab_size, batch, seq, seed=st.seed, start_step=st.step)

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        toks = self.lm.sample(rng, self.batch, self.seq + 1)
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }

    def __iter__(self) -> Iterator[dict]:
        while True:
            b = self.batch_at(self.step)
            self.step += 1
            yield b

    def shard_slice(self, batch: dict, shard: int, n_shards: int) -> dict:
        per = self.batch // n_shards
        return {k: v[shard * per : (shard + 1) * per] for k, v in batch.items()}
