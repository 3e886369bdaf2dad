"""The port's tracer (`repro_torch.perf.trace`): off, a span site reads
no clock and records nothing; on, spans (and decorated calls) nest per
thread, counters are exact across threads and the cap counts what it
drops; and on a toy RAG
run on the CPU (scheduler, pipeline and paged engine in manual mode over
the MoE smoke model) the spans match the engine's own counters and the
tickets' stamps."""
import pytest

torch = pytest.importorskip("torch")

import sys  # noqa: E402
import threading  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.error_model import ErrorModelConfig  # noqa: E402
from repro_torch.core.retrieval import RetrievalConfig  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.perf import trace  # noqa: E402
from repro_torch.serving import EngineConfig, RagPipeline  # noqa: E402

CORPUS = [f"document {i} holds fact {i * 7 % 13} about topic {i % 5}" for i in range(24)]
QUERIES = ["fact about topic 1", "topic 3 facts", "document 7", "what of topic 2",
           "fact 5", "document 11 topic"]


@pytest.fixture(autouse=True)
def tracer_off():
    trace.disable()
    trace.drain()
    yield
    trace.disable()
    trace.drain()


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    return build_model(get_config("phi3.5-moe-42b-a6.6b", smoke=True),
                       device="cpu").init(torch.Generator().manual_seed(0))


def _rag_run(model):
    """Retrieval through a manual scheduler, each retrieved prompt into a
    paged engine of 2 slots (so requests wait for a slot), drained; returns
    (retrieval tickets, generation tickets, the engine's stats)."""
    pipe = RagPipeline(CORPUS, RetrievalConfig(path="int_exact",
                                               error=ErrorModelConfig(enabled=False)),
                       model=model, dim=32, max_prompt_len=40, device="cpu")
    eng = pipe.decode_engine(EngineConfig(n_slots=2, paged=True, block_size=8,
                                          prefill_chunk=8), max_new_tokens=4, start=False)
    sched = pipe.scheduler(max_batch=len(QUERIES))
    gens = []

    def retrieved(t):
        prompt, prefix = pipe.encode_prompt_with_prefix(
            t.text, [CORPUS[i] for i in t.doc_ids])
        gens.append(eng.submit(prompt, max_new_tokens=3, prefix_len=prefix))

    tickets = [sched.submit(q, k=2) for q in QUERIES]
    for t in tickets:
        t.add_done_callback(retrieved)
    sched.flush()
    eng.run_until_drained()
    eng.close()
    return tickets, gens, eng.stats()


def _raise(*a, **k):
    raise AssertionError("read while tracing is off")


def test_off_a_site_reads_no_clock_and_records_nothing(model, monkeypatch):
    ref_tickets, ref_gens, _ = _rag_run(model)
    for name in ("monotonic_ns", "thread_time_ns"):
        monkeypatch.setattr(time, name, _raise)
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(threading, "get_native_id", _raise)
    with trace.span("x", 1) as sp:
        pass
    assert sp is trace.NOOP
    assert trace.spanned("y")(lambda v: v + 1)(2) == 3
    tickets, gens, _ = _rag_run(model)       # every site in the stack, off
    assert [g.tokens for g in gens] == [g.tokens for g in ref_gens]
    assert trace.drain() == ([], {})


def test_on_parents_nest_per_thread():
    trace.enable()
    barrier = threading.Barrier(4)
    made = {}

    @trace.spanned("decorated")
    def decorated(k):
        barrier.wait(timeout=10)
        with trace.span("leaf") as c:
            pass
        return c

    def work(k):
        with trace.span("outer", k) as a:
            barrier.wait(timeout=10)
            with trace.span("inner") as b:
                c = decorated(k)
            made[k] = (a, b, c)

    threads = [threading.Thread(target=work, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    spans, _ = trace.drain()
    assert len(spans) == 16
    by_sid = {s.sid: s for s in spans}
    for k, (a, b, c) in made.items():
        d = by_sid[c.parent]
        assert d.name == "decorated" and d.parent == b.sid
        assert a.parent is None and b.parent == a.sid
        assert a.tid == b.tid == c.tid == d.tid
        assert a.rid == k and b.rid is None and c.rid is None and d.rid is None
        assert a.t0 <= b.t0 <= d.t0 <= c.t0 <= c.t1 <= d.t1 <= b.t1 <= a.t1
        assert by_sid[c.sid] is c
    assert len({made[k][0].tid for k in made}) == 4


def test_counters_exact_across_threads():
    trace.enable()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(5000):
                trace.count("hits")
                trace.count("tokens", 3)

        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    _, counters = trace.drain()
    assert counters == {"hits": 40000, "tokens": 120000}


def test_the_cap_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(trace, "CAP", 5)
    trace.enable()
    for i in range(8):
        with trace.span("s", i):
            pass
    spans, counters = trace.drain()
    assert [s.rid for s in spans] == list(range(5))
    assert counters == {"trace.dropped": 3}


def test_a_traced_rag_run_matches_the_engine_and_the_stamps(model):
    trace.enable()
    tickets, gens, st = _rag_run(model)
    trace.disable()
    spans, counters = trace.drain()
    assert counters == {}
    assert trace.drain() == ([], {})               # drained means cleared
    by = {}
    for s in spans:
        by.setdefault(s.name, []).append(s)
    sid = {s.sid: s for s in spans}
    assert len(by["engine.piece"]) == st["n_prefill_chunks"]
    assert len(by["engine.decode"]) == st["n_decode_steps"]
    # the flush holds each ticket's serving stamp; embedding, search and
    # the prompts of its callbacks run inside it
    (flush,) = by["sched.flush"]
    for t in tickets:
        assert flush.t0 <= (t.submit_time + t.wait_s) * 1e9 <= flush.t1
    for name in ("rag.embed", "rag.search"):
        assert [s.parent for s in by[name]] == [flush.sid]
    assert [s.parent for s in by["rag.prompt"]] == [flush.sid] * len(QUERIES)
    # each step admits, then runs its pieces (each naming its request) and
    # its decode, where a row has one to run
    rids = {g.rid for g in gens}
    assert {s.rid for s in by["engine.piece"]} == rids
    for s in by["engine.piece"] + by["engine.decode"] + by["engine.admit"]:
        assert sid[s.parent].name == "engine.step"
    assert len(by["engine.admit"]) == len(by["engine.step"])
    for s in by["engine.forward"]:
        assert sid[s.parent].name in ("engine.piece", "engine.decode")
    for s in by["model.forward"]:
        assert sid[s.parent].name == "engine.forward"
    n_layers = model.cfg.n_layers
    assert len(by["model.moe"]) == n_layers * len(by["model.forward"])
    for s in by["model.moe"]:
        assert sid[s.parent].name == "model.forward"
    for s in by["engine.sample"]:
        assert sid[s.parent].name in ("engine.step", "engine.decode")
    # every finished ticket took its slot after it was submitted and
    # before its first token
    for g in gens:
        assert g.done() and g._error is None
        assert g.submit_time <= g.admit_time <= g.submit_time + g.first_token_s
    assert sum(g.admit_time > g.submit_time for g in gens) >= 1
    assert len({g.rid for g in gens}) == len(gens)
    assert np.all(np.diff([s.t1 for s in spans]) >= 0)   # kept as they closed
