"""One run of a cell: set-up, the measured window, the drain, and the
records the metric readers read.

Set-up makes everything from the seed: the corpus (`traffic`), its
embeddings in one batched pass (`embed`), the port's model with its
weights made on the card (`weights`), the pipeline over the sharded
DIRC index, the engine and the retrieval scheduler; then it warms every
shape the cell's traffic uses. The window then drives the pipeline as a
deployment does: each query goes into the `AsyncBatchScheduler`
(`RagPipeline.search_batch` on its flush), each retrieved prompt into
the engine's `submit`. The open loop submits each request when it is
due, at a fixed rate; the closed loop keeps a fixed number of clients,
each sending its next request when its last one has finished.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import queue
import sys
import time
from typing import Optional

import numpy as np
import torch

from bench import embed, traffic, weights
from bench.trace import Recorder, Slice

SLICE_S = 3.0      # a profiled slice of a traced run; the last ends at the close
N_SLICES = 3       # slices a traced run profiles; the latest whole one is read
CLOSED_MAX_QPS = 50   # more than any closed loop here finishes: requests to draw


@dataclasses.dataclass
class Record:
    """One request: when it was due (open loop) or sent (closed loop),
    and what the pipeline made of it."""
    req: traffic.Request
    due: float
    retrieval: object = None      # the AsyncTicket
    gen: object = None            # the GenerationTicket
    error: Optional[str] = None
    finished: Optional[float] = None

    @property
    def ok(self) -> bool:
        return self.error is None and self.gen is not None and self.finished is not None

    def first_token_at(self) -> Optional[float]:
        g = self.gen
        if g is None or g.first_token_s is None:
            return None
        return g.submit_time + g.first_token_s

    def done_at(self) -> Optional[float]:
        g = self.gen
        if not self.ok or g.wait_s is None:
            return None
        return g.submit_time + g.wait_s


@dataclasses.dataclass
class Run:
    """What the readers read."""
    cell: object
    seed: int
    seconds: float
    trace: bool
    setup_s: float
    t_open: float
    t_close: float
    records: list                 # the requests due (sent) in the window
    cut: set                      # id() of those unfinished when the drain ended
    stats_open: dict
    stats_close: dict
    prefill_tokens: int           # valid prompt tokens prefilled in the window
    emitted_tokens: int           # answer tokens emitted in the window
    rec: Recorder
    slice: Optional[dict] = None
    extra: dict = dataclasses.field(default_factory=dict)

    @property
    def model(self) -> dict:
        return self.cell.config

    @property
    def window_s(self) -> float:
        return self.t_close - self.t_open

    def in_window(self, t0: float, t1: float) -> bool:
        return t0 >= self.t_open and t1 <= self.t_close


# ------------------------------------------------------------------ set-up
def model_config(cfg: dict):
    """The port's `ModelConfig` from a configuration file's top-level keys."""
    from repro_torch.configs.base import ModelConfig, MoEConfig

    names = {f.name for f in dataclasses.fields(ModelConfig)}
    fields = {k: v for k, v in cfg.items() if k in names and k != "moe"}
    moe = cfg.get("moe")
    return ModelConfig(moe=MoEConfig(**moe) if moe else None, **fields)


class CorpusEmbedder:
    """The port's `HashEmbedder` for queries; for the whole corpus, the rows
    the benchmark embedded in one batched pass."""

    def __init__(self, dim: int, corpus: list, embs: np.ndarray):
        from repro_torch.serving import HashEmbedder

        self.inner = HashEmbedder(dim=dim, seed=embed.SEED, buckets=embed.BUCKETS)
        self.dim = dim
        self.corpus, self.embs = corpus, embs

    def embed(self, texts) -> np.ndarray:
        texts = list(texts)
        if texts is self.corpus or texts == self.corpus:
            return self.embs
        return self.inner.embed(texts)


@dataclasses.dataclass
class Setup:
    cell: object
    seed: int
    device: torch.device
    texts: list
    embs: np.ndarray
    requests: list
    model: object
    pipe: object
    engine: object
    sched: object
    rec: Recorder
    max_prompt: int
    times: dict


def n_requests(cell, seconds: float) -> int:
    mix = cell.traffic
    if mix["loop"] == "open":
        return int(math.ceil(mix["rate_qps"] * seconds * 1.25)) + 64
    return int(mix["clients"] + seconds * CLOSED_MAX_QPS) + 64


def retrieval_config(index: dict):
    from repro_torch.core.error_model import ErrorModelConfig
    from repro_torch.core.retrieval import RetrievalConfig

    return RetrievalConfig(bits=index["bits"], metric=index["metric"],
                           n_cores=index["n_cores"], path=index["path"],
                           mapping=index["mapping"], error=ErrorModelConfig(enabled=False),
                           detect=index["detect"])


def engine_config(cell, max_prompt: int):
    from repro_torch.serving import EngineConfig

    e = cell.config["engine"]
    return EngineConfig(
        n_slots=e["n_slots"], paged=e["paged"], paged_kernel=e["paged_kernel"],
        block_size=e["block_size"], prefill_chunk=e["prefill_chunk"],
        prefix_sharing=e["prefix_sharing"],
        cache_len=max_prompt + int(cell.traffic["answer_tokens"][1]))


def set_up(cell, seed: int, seconds: float, trace: bool, device: torch.device) -> Setup:
    from repro_torch.models import build_model
    from repro_torch.serving import RagPipeline

    times = {}
    t = time.monotonic()
    cfg, index = cell.config, cell.config["index"]
    docs = traffic.documents(index["n_docs"], index["doc_tokens"], seed)
    texts = traffic.texts(docs)
    reqs = traffic.requests(cell.traffic, docs, seed, n_requests(cell, seconds))
    times["traffic"] = time.monotonic() - t
    t = time.monotonic()
    embs = embed.embed_corpus(docs, index["dim"], device)
    times["embed"] = time.monotonic() - t
    t = time.monotonic()
    model = build_model(model_config(cfg), device=device)
    weights.fill_model(model, cfg, seed)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    times["weights"] = time.monotonic() - t
    t = time.monotonic()
    max_prompt = traffic.max_prompt_tokens(cell.traffic, index["doc_tokens"])
    pipe = RagPipeline(texts, retrieval_config(index), model=model,
                       embedder=CorpusEmbedder(index["dim"], texts, embs),
                       dim=index["dim"], max_prompt_len=max_prompt,
                       n_shards=index["n_shards"], device=device)
    engine = pipe.decode_engine(engine_config(cell, max_prompt))
    sc = cfg["scheduler"]
    sched = pipe.scheduler(max_batch=sc["max_batch"], max_wait_ms=sc["max_wait_ms"])
    rec = Recorder(model, pipe, trace)
    times["pipeline"] = time.monotonic() - t
    s = Setup(cell=cell, seed=seed, device=device, texts=texts, embs=embs,
              requests=reqs, model=model, pipe=pipe, engine=engine, sched=sched, rec=rec,
              max_prompt=max_prompt, times=times)
    t = time.monotonic()
    warm_up(s)
    if trace:
        Slice.warm_up(device)
    times["warm_up"] = time.monotonic() - t
    print(f"bench: set-up {times}", file=sys.stderr, flush=True)
    return s


def warm_up(s: Setup) -> None:
    """Every shape the cell's traffic sends, and no other: a prefill piece
    at each table width its prompts narrow to, a decode step at each
    power-of-two width up to the slots, all on the null block (the pool's
    scratch, which no sequence owns), and a search at each power-of-two
    batch up to the scheduler's largest; the engine is idle meanwhile."""
    from repro_torch.serving.paged_cache import blocks_for, pow2_at_least

    eng, cell = s.engine, s.cell
    chunk, bs = eng.prefill_chunk, eng.block_size
    width = eng._pcm.max_blocks_per_seq
    prompt = s.max_prompt
    with torch.inference_mode():
        for start in range(0, prompt, chunk):
            n = min(chunk, prompt - start)
            tw = min(pow2_at_least(blocks_for(start + n, bs)), width)
            toks = np.zeros((1, chunk), np.int32)
            s.model.paged_step(eng._pools, np.zeros((1, tw), np.int32),
                               np.asarray([start], np.int32), toks,
                               np.asarray([n], np.int32), paged_kernel=eng.paged_kernel)
        b = 1
        while b <= eng.n_slots:
            s.model.paged_step(eng._pools, np.zeros((b, width), np.int32),
                               np.full((b,), prompt, np.int32), np.zeros((b, 1), np.int32),
                               np.ones((b,), np.int32), paged_kernel=eng.paged_kernel)
            b *= 2
    b = 1
    while b <= cell.config["scheduler"]["max_batch"]:
        s.pipe.search_batch([r.query for r in s.requests[:b]], cell.traffic["k"])
        b *= 2
    if s.device.type == "cuda":
        torch.cuda.synchronize()
    s.rec.prefill_tokens = 0
    s.rec.steps.clear()
    s.rec.searches.clear()


# ------------------------------------------------------------------ window
class Driver:
    """Sends requests into the pipeline and collects what comes back."""

    def __init__(self, s: Setup):
        self.s = s
        self.done: "queue.Queue" = queue.Queue()
        self.records: list = []

    def send(self, req: traffic.Request, due: float) -> Record:
        s = self.s
        r = Record(req=req, due=due)
        self.records.append(r)

        def generated(gen):
            r.finished = time.monotonic()
            if gen._error is not None:
                r.error = f"generation: {gen._error}"
            self.done.put(r)

        def retrieved(ticket):
            r.retrieval = ticket
            try:
                if ticket._error is not None:
                    raise ticket._error
                docs = [s.texts[i] for i in ticket.doc_ids if i >= 0]
                prompt, prefix = s.pipe.encode_prompt_with_prefix(ticket.text, docs)
                r.gen = s.engine.submit(prompt, max_new_tokens=req.max_new_tokens,
                                        prefix_len=prefix)
                r.gen.add_done_callback(generated)
            except Exception as e:  # noqa: BLE001 - a failed request is counted, not fatal
                r.error = f"retrieval or submit: {e}"
                r.finished = time.monotonic()
                self.done.put(r)

        ticket = s.sched.submit(req.query, k=req.k)
        ticket.add_done_callback(retrieved)
        return r

    def wait(self, until: float, tick) -> Optional[Record]:
        """The next finished request, or None at `until`."""
        while True:
            now = time.monotonic()
            if tick is not None:
                tick(now)
            if now >= until:
                return None
            try:
                return self.done.get(timeout=min(0.02, until - now))
            except queue.Empty:
                continue


def _engine_tokens(engine) -> tuple[dict, int]:
    st = engine.stats()
    return st, st["n_tokens"]


def drive(s: Setup, seconds: float, trace: bool, rate: Optional[float] = None) -> Run:
    """The measured window, then the drain. `rate` replaces the cell's
    open-loop rate (the knee sweep)."""
    cell = s.cell
    mix = cell.traffic
    drv = Driver(s)
    rec = s.rec
    t_open = time.monotonic()
    slices = []
    if trace:   # up to N_SLICES slices a second apart, the last at the close
        close = t_open + seconds
        for j in reversed(range(1, N_SLICES)):
            if seconds >= (j + 1) * (SLICE_S + 1) + 1:
                end = close - j * (SLICE_S + 1)
                slices.append(Slice(rec, end - SLICE_S, end))
        slices.append(Slice(rec, close - min(SLICE_S, seconds / 2), close))
    stats_open, tok_open = _engine_tokens(s.engine)
    pre_open = rec.prefill_tokens
    t_close = t_open + seconds
    marks = [t_open + seconds * q for q in (0.25, 0.5, 0.75)]
    backlog: list = []

    def sample_backlog(now: float) -> None:
        if marks and now >= marks[0]:
            marks.pop(0)
            backlog.append(sum(1 for r in drv.records if r.finished is None))

    def tick(now: float) -> None:
        sample_backlog(now)
        for sl in slices:
            sl.tick(now)

    if mix["loop"] == "open":
        due = t_open + traffic.arrivals(rate or mix["rate_qps"], len(s.requests),
                                        mix["block"])
        i = 0
        while i < len(s.requests) and due[i] < t_close:
            now = time.monotonic()
            tick(now)
            if now >= due[i]:
                drv.send(s.requests[i], float(due[i]))
                i += 1
            else:
                time.sleep(min(0.005, due[i] - now))
        while drv.wait(t_close, tick) is not None:
            pass                  # the window's arrivals are sent; it runs to its close
    else:
        nxt = 0
        for _ in range(mix["clients"]):
            drv.send(s.requests[nxt], time.monotonic())
            nxt += 1
        while True:
            r = drv.wait(t_close, tick)
            if r is None:
                break
            drv.send(s.requests[nxt], time.monotonic())
            nxt += 1
    t_close = time.monotonic()
    backlog.append(sum(1 for r in drv.records if r.finished is None))
    stats_close, tok_close = _engine_tokens(s.engine)
    pre_close = rec.prefill_tokens
    for sl in slices:
        sl.stop()
    # the drain: the open loop waits for every request due in the window;
    # a closed loop's requests in flight at the close are cut
    drain_until = time.monotonic() + (mix["drain_s"] if mix["loop"] == "open" else 0.0)
    while any(r.finished is None for r in drv.records):
        if drv.wait(drain_until, None) is None:
            break
    cut = {id(r) for r in drv.records if r.finished is None}
    return Run(cell=cell, seed=s.seed, seconds=seconds, trace=trace, setup_s=0.0,
               t_open=t_open, t_close=t_close, records=list(drv.records), cut=cut,
               stats_open=stats_open, stats_close=stats_close,
               prefill_tokens=pre_close - pre_open, emitted_tokens=tok_close - tok_open,
               rec=rec, extra={"slices": slices, "backlog": backlog})


class Outcome:
    """What a request's ticket said, kept once the ticket (which holds its
    engine or scheduler, and so the port's state) is dropped."""

    FIELDS = ("tokens", "submit_time", "first_token_s", "wait_s", "_error",
              "doc_ids", "doc_scores", "text")

    def __init__(self, ticket):
        for f in self.FIELDS:
            setattr(self, f, getattr(ticket, f, None))


def tear_down(s: Setup, records: list = ()) -> None:
    """Stop the scheduler's and the engine's threads (whatever is still in
    flight fails), keep what each request's tickets said, and free the
    port's state on the card."""
    s.sched.close(drain=False)
    s.engine.close(drain=False)
    s.rec.close()
    for r in records:
        r.gen = Outcome(r.gen) if r.gen is not None else None
        r.retrieval = Outcome(r.retrieval) if r.retrieval is not None else None
    s.pipe = s.engine = s.sched = s.model = None
    gc.collect()
    if s.device.type == "cuda":
        torch.cuda.empty_cache()


def in_use_intervals(run: Run) -> list:
    """Host intervals in which the engine held at least one request."""
    out = []
    for r in run.records:
        g = r.gen
        if g is None:
            continue
        end = r.finished if r.finished is not None else run.t_close
        out.append((g.submit_time, end))
    return out
