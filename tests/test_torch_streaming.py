"""Port vs JAX: the streaming front door. Both `AsyncBatchScheduler`s on
one fake clock form the same batches in the same tenant order; and
`RagPipeline.query_stream(generate=True, paged=True)`,
`generate_stream`, the retrieval-only stream and the fixed-slot stream
yield the JAX package's doc ids and greedy tokens (fp32 SMOKE weights
converted across)."""
import pytest

torch = pytest.importorskip("torch")

import asyncio  # noqa: E402

import numpy as np  # noqa: E402
from _torch_parity import converted_models, make_corpus  # noqa: E402

from repro.core.retrieval import RetrievalConfig as JaxRetrievalConfig  # noqa: E402
from repro.serving import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serving.async_scheduler import AsyncBatchScheduler as JaxScheduler  # noqa: E402
from repro.serving.rag_pipeline import HashEmbedder as JaxHashEmbedder  # noqa: E402
from repro.serving.rag_pipeline import RagPipeline as JaxRagPipeline  # noqa: E402
from repro_torch.core.retrieval import RetrievalConfig  # noqa: E402
from repro_torch.serving import (AsyncBatchScheduler, EngineConfig,  # noqa: E402
                                 GenerationTicket, HashEmbedder, RagPipeline,
                                 SchedulerError)

DIM = 128


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _sched_trace(cls):
    """Drive one scheduler in manual mode on a fake clock; returns the
    batches it formed (texts per search call) and per-ticket stamps."""
    clock = FakeClock()
    calls = []

    def search(texts, k):
        calls.append(list(texts))
        n = len(texts)
        return (np.arange(n * k).reshape(n, k).astype(np.int32),
                np.ones((n, k), np.float32))

    s = cls(search, max_batch=4, max_wait_ms=10.0, quantum=1,
            tenant_weights={"pro": 2.0, "lite": 0.5}, clock=clock, start=False)
    tickets = []
    plan = [("free", 5), ("pro", 6), ("lite", 3), ("free", 1)]
    for step, (tenant, n) in enumerate(plan):
        for i in range(n):
            tickets.append(s.submit(f"{tenant}-{step}-{i}", k=2 + i % 2, tenant=tenant))
        clock.t += 0.004
        s.poll()
    s.set_tenant_weight("lite", 3.0)
    clock.t += 0.02
    s.poll()
    s.flush()
    stamps = [(t.flush_seq, t.batch_size, round(t.wait_s, 9), t.doc_ids.tolist())
              for t in tickets]
    return calls, stamps, s.stats(), s.tenants()


def test_schedulers_form_the_same_batches():
    jcalls, jstamps, jstats, jten = _sched_trace(JaxScheduler)
    tcalls, tstamps, tstats, tten = _sched_trace(AsyncBatchScheduler)
    assert tcalls == jcalls and len(tcalls) > 3
    assert tstamps == jstamps
    assert tstats == jstats
    assert tten == jten


def test_scheduler_failure_fails_the_chunk():
    def boom(texts, k):
        raise RuntimeError("search down")

    s = AsyncBatchScheduler(boom, max_batch=2)
    t = s.submit("q")
    with pytest.raises(SchedulerError, match="search down"):
        t.result()
    assert s.stats()["n_failed"] == 1


@pytest.fixture(scope="module")
def pipes():
    jmodel, params, tmodel = converted_models(seed=0)
    corpus = make_corpus(96)
    cfg = dict(bits=8, metric="cosine", path="int_exact")
    jpipe = JaxRagPipeline(corpus, JaxRetrievalConfig(**cfg), model=jmodel, params=params,
                           embedder=JaxHashEmbedder(dim=DIM), dim=DIM, max_prompt_len=48)
    tpipe = RagPipeline(corpus, RetrievalConfig(**cfg), model=tmodel,
                        embedder=HashEmbedder(dim=DIM), dim=DIM, max_prompt_len=48,
                        device="cpu")
    # eight requests: four corpus docs asked twice, under two tenants, so
    # repeated retrieved contexts share prefixes
    reqs = [(f"t{i % 2}", corpus[d]) for i, d in enumerate([3, 40, 77, 12] * 2)]
    reqs[5] = (reqs[5][0], reqs[5][1] + " again")
    return jpipe, tpipe, reqs


def _by_text(items):
    out = {}
    for it in items:
        out.setdefault((it.tenant, it.text), []).append(it)
    return out


@pytest.fixture(scope="module")
def jax_stream(pipes):
    """The JAX package's paged `query_stream(generate=True)` on the eight
    requests, grouped by (tenant, text)."""
    jpipe, _, reqs = pipes
    return _by_text(jpipe.query_stream(
        reqs, k=2, max_batch=4, max_wait_ms=1.0, generate=True, max_new_tokens=5,
        config=JaxEngineConfig(n_slots=3, paged=True, block_size=8, prefill_chunk=16)))


def _assert_stream_matches(got, want, n):
    assert len(got) == n
    assert all(isinstance(g, GenerationTicket) and g._error is None for g in got)
    gmap = _by_text(got)
    assert gmap.keys() == want.keys()
    for key, gs in gmap.items():
        for g, w in zip(gs, want[key]):
            assert g.tokens == w.tokens
            assert g.answer_text == w.answer_text
            np.testing.assert_array_equal(g.retrieval.doc_ids, w.retrieval.doc_ids)
            assert g.first_token_s is not None and g.wait_s >= g.first_token_s


def test_query_stream_paged_matches_jax(pipes, jax_stream):
    _, tpipe, reqs = pipes
    got = list(tpipe.query_stream(
        reqs, k=2, max_batch=4, max_wait_ms=1.0, generate=True, max_new_tokens=5,
        config=EngineConfig(n_slots=3, paged=True, block_size=8, prefill_chunk=16,
                            paged_kernel=True)))
    _assert_stream_matches(got, jax_stream, len(reqs))


def test_query_stream_fixed_slot_and_retrieval_only(pipes, jax_stream):
    """The fixed-slot stream (the default memory model) yields the same
    greedy tokens; the retrieval-only stream the JAX doc ids."""
    jpipe, tpipe, reqs = pipes
    got = list(tpipe.query_stream(reqs, k=2, max_batch=4, generate=True,
                                  max_new_tokens=5, config=EngineConfig(n_slots=2)))
    _assert_stream_matches(got, jax_stream, len(reqs))
    ret = {t.text: t.doc_ids.tolist() for t in tpipe.query_stream(
        [r[1] for r in reqs], k=3, max_batch=3)}
    jret = {t.text: t.doc_ids.tolist() for t in jpipe.query_stream(
        [r[1] for r in reqs], k=3, max_batch=3)}
    assert ret == jret
    ids, _ = tpipe.search_batch([reqs[0][1]], 3)
    assert ret[reqs[0][1]] == ids[0].tolist()


def test_generate_stream_matches_jax(pipes):
    jpipe, tpipe, _ = pipes
    prompts = ["hello there", ("a", "paged stream"), ("b", "w12 w400 w7", 1)]
    knobs = dict(n_slots=2, cache_len=40, paged=True, block_size=8)
    want = {w.text: w.tokens for w in jpipe.generate_stream(
        prompts, max_new_tokens=4, config=JaxEngineConfig(**knobs))}
    got = {g.text: g.tokens for g in tpipe.generate_stream(
        prompts, max_new_tokens=4, config=EngineConfig(**knobs))}
    assert got == want and len(got) == 3
    with pytest.raises(ValueError, match="cache_len"):
        next(tpipe.generate_stream(["x"], max_new_tokens=4,
                                   config=EngineConfig(cache_len=4)))


def test_decode_engine_resolves_pipeline_defaults(pipes):
    _, tpipe, _ = pipes
    eng = tpipe.decode_engine(EngineConfig(paged=True), max_new_tokens=8, start=False)
    assert eng.cache_len == tpipe.max_prompt_len + 8
    assert eng.prefix_sharing is True
    assert eng.eos_id == tpipe.tokenizer.eos_id
    eng.close()
    fixed = tpipe.decode_engine(EngineConfig(), start=False)
    assert fixed.prefix_sharing is False
    fixed.close()


def test_engine_loop_failure_surfaces_as_a_failed_item(pipes, monkeypatch):
    """A fault inside the engine's loop fails every ticket; the stream then
    yields error-carrying tickets instead of hanging or dropping them."""
    _, tpipe, reqs = pipes

    def broken(*a, **kw):
        raise RuntimeError("device fault")

    monkeypatch.setattr(tpipe.engine.model, "paged_step", broken)
    items = list(tpipe.query_stream(reqs[:3], k=2, generate=True, max_new_tokens=2,
                                    config=EngineConfig(paged=True)))
    assert len(items) == 3
    for it in items:
        with pytest.raises(SchedulerError):
            it.result()


def test_aquery_stream(pipes):
    _, tpipe, reqs = pipes

    async def run():
        return [t async for t in tpipe.aquery_stream([r[1] for r in reqs[:4]], k=2)]

    got = asyncio.run(run())
    assert sorted(t.text for t in got) == sorted(r[1] for r in reqs[:4])
