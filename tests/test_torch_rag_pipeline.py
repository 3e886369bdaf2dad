"""Port vs JAX: one RAG query batch end to end (`RagPipeline.query_many`,
n_shards=0) over the same 256-document corpus, the same embedder and the
same converted smoke weights at fp32: doc ids and scores, greedy answer
tokens and the analytic latency/energy all equal."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from _torch_parity import converted_models, make_corpus, to_numpy  # noqa: E402

from repro.core.retrieval import RetrievalConfig as JaxRetrievalConfig  # noqa: E402
from repro.serving.rag_pipeline import HashEmbedder as JaxHashEmbedder  # noqa: E402
from repro.serving.rag_pipeline import RagPipeline as JaxRagPipeline  # noqa: E402
from repro_torch.core.retrieval import RetrievalConfig  # noqa: E402
from repro_torch.serving import HashEmbedder, RagPipeline  # noqa: E402

DIM = 128


@pytest.fixture(scope="module")
def setup():
    jmodel, params, tmodel = converted_models(seed=0)
    return make_corpus(256), jmodel, params, tmodel


@pytest.mark.parametrize("path", ["int_exact", "kernel_bitserial", "kernel_mxu"])
def test_query_many_matches_jax(setup, path):
    corpus, jmodel, params, tmodel = setup
    jpipe = JaxRagPipeline(corpus, JaxRetrievalConfig(bits=8, metric="cosine", path=path),
                           model=jmodel, params=params, embedder=JaxHashEmbedder(dim=DIM),
                           dim=DIM, max_prompt_len=64)
    tpipe = RagPipeline(corpus, RetrievalConfig(bits=8, metric="cosine", path=path),
                        model=tmodel, embedder=HashEmbedder(dim=DIM), dim=DIM,
                        max_prompt_len=64, device="cpu")
    queries = [corpus[3], corpus[200], "w17 w400 w3 document"]
    want = jpipe.query_many(queries, k=3, max_new_tokens=6)
    got = tpipe.query_many(queries, k=3, max_new_tokens=6)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.doc_ids, w.doc_ids)
        np.testing.assert_allclose(g.doc_scores, w.doc_scores, rtol=1e-6)
        np.testing.assert_array_equal(g.answer_tokens, w.answer_tokens)
        assert g.answer_text == w.answer_text
        assert g.retrieved_texts == w.retrieved_texts
        assert g.sim_latency_us == w.sim_latency_us
        assert g.sim_energy_uj == w.sim_energy_uj
    assert [r.doc_ids[0] for r in got[:2]] == [3, 200]       # self-retrieval
    one = tpipe.query(queries[0], k=3, max_new_tokens=6)
    np.testing.assert_array_equal(one.answer_tokens, got[0].answer_tokens)
    assert tpipe.encode_prompt_with_prefix(queries[0], got[0].retrieved_texts) == \
        jpipe.encode_prompt_with_prefix(queries[0], want[0].retrieved_texts)


def test_embedder_and_search_batch_match(setup):
    corpus = setup[0]
    np.testing.assert_array_equal(HashEmbedder(dim=DIM, seed=2).embed(corpus[:20]),
                                  JaxHashEmbedder(dim=DIM, seed=2).embed(corpus[:20]))
    jpipe = JaxRagPipeline(corpus, JaxRetrievalConfig(path="int_exact"), dim=DIM)
    tpipe = RagPipeline(corpus, RetrievalConfig(path="int_exact"), dim=DIM, device="cpu")
    jids, jscores = jpipe.search_batch(corpus[:5], k=4)
    tids, tscores = tpipe.search_batch(corpus[:5], k=4)
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_array_equal(tscores, jscores)
    assert tids.dtype == np.int32 and tscores.dtype == np.float32
    assert tpipe.query_many(corpus[:1], k=2)[0].answer_tokens is None   # no model
    assert to_numpy(tpipe.index.planes).shape == (256, 8, DIM)


def test_constructing_without_device_needs_cuda(setup, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        RagPipeline(setup[0][:32], RetrievalConfig(), dim=DIM)


def test_unported_features_raise(setup):
    corpus = setup[0][:32]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        RagPipeline(corpus, RetrievalConfig(), dim=DIM, n_shards=2, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        RagPipeline(corpus, RetrievalConfig(), dim=DIM, recal=True, device="cpu")
    pipe = RagPipeline(corpus, RetrievalConfig(), dim=DIM, device="cpu")
    for call in (pipe.scheduler, pipe.decode_engine, pipe.query_stream,
                 pipe.generate_stream, lambda: pipe.add_docs(["x"]),
                 lambda: pipe.delete_docs([0])):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()
