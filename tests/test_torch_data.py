"""The port's copies of the synthetic corpora and the resumable data
pipeline against the JAX package's: the same seeds give array_equal
datasets, bigram samples and batches at every step and start step."""
import numpy as np
import pytest

from repro.data import pipeline as jax_pipeline
from repro.data import synthetic as jax_synthetic
from repro_torch.data import (BigramLM, DataPipeline, PipelineState, beir_analogue,
                              make_ir_dataset)
from repro_torch.data import synthetic


def _same_dataset(a, b):
    assert a.name == b.name
    for f in ("doc_embeddings", "query_embeddings", "relevant"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
        assert getattr(a, f).dtype == getattr(b, f).dtype
    assert a.doc_texts == b.doc_texts and a.query_texts == b.query_texts
    assert a.embedding_mb == b.embedding_mb


@pytest.mark.parametrize("kw", [dict(n_docs=300, dim=64, n_queries=12, seed=2),
                                dict(n_docs=129, dim=32, n_queries=5, n_clusters=7,
                                     relevant_per_query=3, hidden_frac=0.25, seed=9)])
def test_make_ir_dataset_equal(kw):
    _same_dataset(make_ir_dataset(**kw), jax_synthetic.make_ir_dataset(**kw))


def test_beir_analogues_equal():
    assert synthetic.BEIR_ANALOGUES == jax_synthetic.BEIR_ANALOGUES
    _same_dataset(beir_analogue("synth-nfcorpus", dim=64),
                  jax_synthetic.beir_analogue("synth-nfcorpus", dim=64))


def test_bigram_equal():
    a, b = BigramLM(200, seed=4), jax_synthetic.BigramLM(200, seed=4)
    np.testing.assert_array_equal(a.probs, b.probs)
    np.testing.assert_array_equal(a.sample(np.random.default_rng(1), 3, 40),
                                  b.sample(np.random.default_rng(1), 3, 40))


@pytest.mark.parametrize("vocab,seed", [(512, 0), (5000, 3)])
def test_pipeline_batches_equal(vocab, seed):
    p = DataPipeline(vocab, batch=4, seq=16, seed=seed)
    q = jax_pipeline.DataPipeline(vocab, batch=4, seq=16, seed=seed)
    for step in (0, 1, 7, 123):
        a, b = p.batch_at(step), q.batch_at(step)
        assert set(a) == set(b) == {"tokens", "labels"}
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert a[k].dtype == b[k].dtype == np.int32
        np.testing.assert_array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    its = iter(DataPipeline(vocab, 4, 16, seed=seed, start_step=5))
    itj = iter(jax_pipeline.DataPipeline(vocab, 4, 16, seed=seed, start_step=5))
    for _ in range(3):
        a, b = next(its), next(itj)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_pipeline_resume_and_shard_slice():
    p = DataPipeline(512, batch=8, seq=8, seed=0)
    it = iter(p)
    for _ in range(5):
        next(it)
    st = p.state()
    assert st == PipelineState(step=5, seed=0)
    p2 = DataPipeline.restore(st, 512, 8, 8)
    np.testing.assert_array_equal(next(iter(p2))["tokens"], p.batch_at(5)["tokens"])
    b = p.batch_at(0)
    parts = [p.shard_slice(b, i, 4) for i in range(4)]
    want = [jax_pipeline.DataPipeline(512, 8, 8).shard_slice(b, i, 4) for i in range(4)]
    for x, y in zip(parts, want):
        np.testing.assert_array_equal(x["tokens"], y["tokens"])
    np.testing.assert_array_equal(np.concatenate([x["tokens"] for x in parts]), b["tokens"])
