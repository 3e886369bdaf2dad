"""End-to-end edge RAG serving on the port: embed -> sharded DIRC
retrieve -> augment -> generate, with micro-batched requests against a
small LM (paper Fig. 1, scaled to a 4-macro ShardedDircIndex) plus live
corpus updates. The twin of `examples/rag_serve.py`: the same corpus,
model config, pipeline, schedulers and lines (see that file for the
serving model), on the card by default.

The generator is phi4-mini's smoke config from the port's seeded init
(the reference draws its init from `jax.random.key(0)`); `main(model=...)`
serves a model built elsewhere instead. On the card, each shard's search
ends in the fused top-k kernel (K4) wherever the shard's capacity divides
over the 16 cores. Offered-load sweeps: `python -m repro_torch.launch.serve
--rag --open-loop ...` (the flags of the reference's CLI, plus `--device`).

Run: PYTHONPATH=src python examples_torch/rag_serve.py [--device cpu]
"""
import argparse
import time

from repro_torch.configs import get_config
from repro_torch.core.retrieval import RetrievalConfig
from repro_torch.device import make_generator, resolve_device
from repro_torch.models import build_model
from repro_torch.serving import EngineConfig, HashEmbedder, RagPipeline

CORPUS = [
    "DIRC couples a multi-level ReRAM subarray with an SRAM cell.",
    "The query-stationary dataflow pins the query in input registers.",
    "Sixteen cores each run a local top-k comparator.",
    "Bit-wise remapping puts MSBs in the most reliable ReRAM positions.",
    "The Sigma-D LUT detects sensing errors and triggers re-sensing.",
    "INT8 quantized embeddings retrieve almost as well as FP32.",
    "The macro reaches 1176 TOPS/W at 250 MHz and 0.8 V.",
    "A 4MB database is searched in 5.6 microseconds per query.",
] + [f"filler document number {i} about unrelated topics" for i in range(56)]
QUERIES = [
    "how does the error detection work?",
    "what dataflow does DIRC use for retrieval?",
    "how fast is a 4MB database search?",
]
MERGE_DOC = "The global comparator merges per-macro candidate lists by score."
MERGE_QUERY = "who merges the per-macro candidate lists?"


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs on the host)")
    return ap.parse_args(argv)


def generator_model(dev):
    """phi4-mini's smoke model on `dev`, from the seeded init."""
    cfg = get_config("phi4-mini-3.8b", smoke=True)
    return build_model(cfg, device=dev).init(make_generator(dev, 0))


def pipeline(model, dev) -> RagPipeline:
    return RagPipeline(
        CORPUS,
        RetrievalConfig(bits=8, metric="cosine", path="int_exact"),
        model=model,
        dim=256, embedder=HashEmbedder(dim=256),
        max_prompt_len=96,
        n_shards=4,
        device=dev,
    )


def batched_wave(pipe: RagPipeline) -> list:
    t0 = time.time()
    results = pipe.query_many(QUERIES, k=2, max_new_tokens=12)
    out = []
    for q, res in zip(QUERIES, results):
        print(f"\nQ: {q}")
        for i, t in zip(res.doc_ids, res.retrieved_texts):
            print(f"   retrieved[{i}]: {t[:70]}")
        print(f"   DIRC sim: {res.sim_latency_us:.2f} us, "
              f"{res.sim_energy_uj:.3f} uJ per query")
        print(f"   generated {res.answer_tokens.shape[1]} tokens "
              f"(untrained model -> noise)")
        out.append({"query": q, "doc_ids": res.doc_ids.tolist(),
                    "scores": res.doc_scores.tolist(),
                    "answer_tokens": res.answer_tokens[0].tolist(),
                    "sim_latency_us": res.sim_latency_us,
                    "sim_energy_uj": res.sim_energy_uj})
    print(f"\nbatched wave of {len(QUERIES)} queries: "
          f"{time.time() - t0:.2f}s wall (ONE embed + ONE search)")
    return out


def live_update(pipe: RagPipeline) -> dict:
    print("\n== live corpus update: add a doc, retrieve it, tombstone it ==")
    new_ids = pipe.add_docs([MERGE_DOC])
    res = pipe.query(MERGE_QUERY, k=1, max_new_tokens=0)
    print(f"   added id {new_ids[0]}, retrieved id {res.doc_ids[0]}: "
          f"{res.retrieved_texts[0][:60]}")
    out = {"added_id": int(new_ids[0]), "retrieved_id": int(res.doc_ids[0])}
    pipe.delete_docs(new_ids.tolist())
    res = pipe.query(MERGE_QUERY, k=1, max_new_tokens=0)
    print(f"   after delete, retrieved id {res.doc_ids[0]} "
          f"(tombstone never returned)")
    out["after_delete_id"] = int(res.doc_ids[0])
    return out


def pull_scheduler(pipe: RagPipeline) -> dict:
    print("\n== micro-batching scheduler (max_batch=2, pull-based) ==")
    sched = pipe.scheduler(max_batch=2)
    tickets = [sched.submit(q, k=1) for q in QUERIES]
    print(f"   queued {sched.pending()} queries")
    sched.flush()
    out = {"ids": [], "scores": []}
    for q, t in zip(QUERIES, tickets):
        ids, scores = t.result()
        out["ids"].append(int(ids[0]))
        out["scores"].append(float(scores[0]))
        print(f"   [{ids[0]:3d}] score {scores[0]:+.3f}  <- {q}")
    print(f"   served {sched.n_served} queries in {sched.n_flushes} "
          f"batched flushes")
    out.update(n_served=sched.n_served, n_flushes=sched.n_flushes)
    return out


def async_scheduler(pipe: RagPipeline) -> dict:
    print("\n== async scheduler (max_wait_ms=10, two tenants, no blocking) ==")
    sched = pipe.scheduler(max_batch=16, max_wait_ms=10.0)
    try:
        tickets = [sched.submit(q, k=1, tenant=f"user{i % 2}")
                   for i, q in enumerate(QUERIES)]
        # nobody calls result(): the background loop's deadline trigger fires
        for t in tickets:
            t.result(timeout=30.0)
        for t in tickets:
            print(f"   tenant {t.tenant}: [{t.doc_ids[0]:3d}] after "
                  f"{t.wait_s * 1e3:.1f} ms (batch of {t.batch_size})")
    finally:
        sched.close()
    return {t.text: {"tenant": t.tenant, "doc_ids": [int(i) for i in t.doc_ids]}
            for t in tickets}


def stream(pipe: RagPipeline) -> dict:
    print("\n== query_stream: results in completion order ==")
    out = {}
    for t in pipe.query_stream([("alice", q) for q in QUERIES], k=1,
                               max_wait_ms=5.0):
        print(f"   {t.tenant}: [{t.doc_ids[0]:3d}] <- {t.text[:50]}")
        out[t.text] = [int(i) for i in t.doc_ids]
    return out


def stream_generate(pipe: RagPipeline) -> dict:
    print("\n== continuous batching: retrieval chained into decode slots ==")
    # generate=True: each completed retrieval's augmented prompt joins the
    # n_slots-wide decode batch at the next token boundary; answers stream
    # back in completion order with TTFT/e2e stamps per ticket
    out = {}
    for t in pipe.query_stream(QUERIES, k=2, max_wait_ms=5.0, generate=True,
                               max_new_tokens=8, config=EngineConfig(n_slots=2)):
        print(f"   slot {t.slot}: {len(t.tokens)} tokens in "
              f"{t.wait_s * 1e3:.0f} ms (TTFT {t.first_token_s * 1e3:.0f} ms)"
              f" <- {t.text[:40]}")
        out[t.text] = {"doc_ids": [int(i) for i in t.retrieval.doc_ids],
                       "tokens": list(t.tokens)}
    return out


def token_stream(pipe: RagPipeline) -> list:
    print("\n== token_stream: live per-token consumption ==")
    engine = pipe.decode_engine(EngineConfig(n_slots=2), max_new_tokens=8,
                                start=True)
    try:
        prompt = pipe.encode_prompt(QUERIES[0], [CORPUS[0]])
        ticket = engine.submit(prompt, max_new_tokens=8)
        toks = [tok for tok in ticket.token_stream(timeout=60.0)]
        print(f"   streamed {len(toks)} tokens one at a time: {toks}")
    finally:
        engine.close()
    return toks


def main(argv=None, model=None) -> dict:
    """Serve the example; return what was printed, by section: `shard_loads`,
    `wave` (per query: doc ids, scores, answer tokens, the simulator's
    figures), `update`, `pull`, `async` / `stream` / `generate` (by query
    text) and `token_stream`. `model` (on the device) replaces the
    seeded generator."""
    dev = resolve_device(parse_args(argv).device)
    print("== loading generator (phi4-mini smoke config) ==")
    if model is None:
        model = generator_model(dev)

    print("== building 4-shard RAG pipeline over", len(CORPUS), "documents ==")
    pipe = pipeline(model, dev)
    loads = pipe.index.shard_loads()
    print("   shard loads:", loads)
    return {"shard_loads": [int(n) for n in loads], "wave": batched_wave(pipe),
            "update": live_update(pipe), "pull": pull_scheduler(pipe),
            "async": async_scheduler(pipe), "stream": stream(pipe),
            "generate": stream_generate(pipe), "token_stream": token_stream(pipe)}


if __name__ == "__main__":
    main()
