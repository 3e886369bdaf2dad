"""Port vs JAX: one RAG query batch end to end (`RagPipeline.query_many`,
n_shards=0) over the same 256-document corpus, the same embedder and the
same converted smoke weights at fp32: doc ids and scores, greedy answer
tokens and the analytic latency/energy all equal."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _torch_parity import converted_models, make_corpus, to_numpy  # noqa: E402

from repro.core.retrieval import RetrievalConfig as JaxRetrievalConfig  # noqa: E402
from repro.serving.rag_pipeline import HashEmbedder as JaxHashEmbedder  # noqa: E402
from repro.serving.rag_pipeline import RagPipeline as JaxRagPipeline  # noqa: E402
from repro.serving import GenerationEngine as JaxGenerationEngine  # noqa: E402
from repro_torch.core.retrieval import RetrievalConfig  # noqa: E402
from repro_torch.serving import (ContinuousBatchingEngine, EngineConfig,  # noqa: E402
                                 HashEmbedder, RagPipeline)

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
    """What the port did not have raised NotImplementedError naming its
    ROADMAP item; `parallelism="shard_map"` is ported now, and in a
    process with no process group it scores every macro here, as the
    reference's one-device fallback does (the mesh runs are in
    test_torch_mesh_retrieval.py). The sharded index's features asked of
    the monolithic one raise the
    JAX package's TypeError. A paged engine over a model without pageable
    KV, refused before, is the slot-resident engine now: its greedy
    tokens equal the JAX generator's. The fleet, SLO, retention and
    preemption calls that used to raise here are served too
    (tests/test_torch_router.py, test_torch_slo_controller.py,
    test_torch_prefix_retention.py, test_torch_preemption.py)."""
    corpus, tmodel = setup[0][:32], setup[3]
    with pytest.raises(TypeError, match="n_shards"):
        RagPipeline(corpus, RetrievalConfig(), dim=DIM, recal=True, device="cpu")
    pipe = RagPipeline(corpus, RetrievalConfig(), model=tmodel, dim=DIM, device="cpu")
    for call in (lambda: pipe.add_docs(["x"]), lambda: pipe.delete_docs([0])):
        with pytest.raises(TypeError, match="n_shards"):
            call()
    from repro_torch.core.sharded_index import ShardedDircIndex

    emb = HashEmbedder(dim=DIM).embed(corpus)
    sm = ShardedDircIndex.build(emb, RetrievalConfig(), n_shards=2, parallelism="shard_map",
                                device="cpu")
    vm = ShardedDircIndex.build(emb, RetrievalConfig(), n_shards=2, device="cpu")
    assert sm.mesh is None and sm._macro_block() is None
    assert torch.equal(sm.search(emb[:4], 3).indices, vm.search(emb[:4], 3).indices)
    # a paged engine over mamba2 (no pageable KV): slot-resident
    jmamba, jparams, mamba = converted_models(seed=0, arch="mamba2-2.7b")
    pipe = RagPipeline(corpus, RetrievalConfig(), model=mamba, dim=DIM, max_prompt_len=24,
                       device="cpu")
    eng = pipe.decode_engine(EngineConfig(n_slots=2, paged=True, prefill_chunk=8),
                             max_new_tokens=3, start=False)
    assert isinstance(eng, ContinuousBatchingEngine) and eng.paged
    assert eng._pcm is None and eng.prefix_sharing is False
    prompt = pipe.encode_prompt(corpus[3], corpus[:2])
    got = eng.submit(prompt, max_new_tokens=3).result()
    want = JaxGenerationEngine(jmamba, jparams).generate(
        jnp.asarray(prompt, jnp.int32)[None], max_new_tokens=3)
    np.testing.assert_array_equal(got, np.asarray(want)[0])
    assert "pool" not in eng.stats() and eng.stats()["n_prefill_chunks"] == 3


def test_fleet_and_slo_knobs_served(setup):
    """The pipeline's fleet and SLO knobs, refused before: `decode_engine`
    returns an `EngineRouter` for `n_replicas=` / `router=` / `affinity=`,
    `generate_stream` serves over it, and `query_stream(slo=...)` leaves the
    controller's final counters on `last_slo_stats`."""
    from repro_torch.serving import EngineRouter, RouterConfig, SLOConfig

    corpus, tmodel = setup[0][:32], setup[3]
    pipe = RagPipeline(corpus, RetrievalConfig(), model=tmodel, dim=DIM, max_prompt_len=48,
                       device="cpu")
    cfg = EngineConfig(n_slots=2, paged=True, block_size=8, retain_blocks=8,
                       host_blocks=8)
    fleet = pipe.decode_engine(cfg, n_replicas=2, start=False)
    assert isinstance(fleet, EngineRouter) and fleet.n_replicas == 2
    assert fleet.engines[0].prefix_sharing and fleet.cache_len == 48 + 32
    assert pipe.decode_engine(cfg, router=RouterConfig(n_replicas=3),
                              start=False).n_replicas == 3
    assert pipe.decode_engine(cfg, affinity=False, start=False).affinity is False
    with pytest.raises(ValueError, match="not both"):
        pipe.decode_engine(cfg, router=RouterConfig(), n_replicas=2, start=False)
    gens = list(pipe.generate_stream(["hello", ("b", "world", 1)], max_new_tokens=2,
                                     config=cfg, n_replicas=2))
    assert sorted(len(g.tokens) for g in gens) == [2, 2]
    items = list(pipe.query_stream([("a", corpus[1], 1), ("b", corpus[2])], k=2,
                                   generate=True, max_new_tokens=2, config=cfg,
                                   n_replicas=2, slo=SLOConfig(ttft_p95_ms=1e4)))
    assert all(it._error is None and len(it.tokens) == 2 for it in items)
    assert pipe.last_slo_stats is not None and pipe.last_slo_stats["n_polls"] >= 1
    with pytest.raises(TypeError, match="generate=True"):
        next(pipe.query_stream(["q"], slo=SLOConfig(ttft_p95_ms=1.0)))
