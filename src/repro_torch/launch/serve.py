"""Serving CLI of the port: batched generation with --arch, or batched
sharded retrieval with --rag — counterpart of `repro.launch.serve`.

--arch runs `GenerationEngine` over random prompts (`serve`). --rag stands
up a ShardedDircIndex-backed RagPipeline plus a batch scheduler and
reports retrieval queries/sec under micro-batched traffic. Adding
--open-loop switches to simulated streaming traffic: Poisson arrivals
from several tenants (one optionally --skew times chattier) submitted to
the AsyncBatchScheduler's background flush loop, reporting p50/p95/p99
latency and the achieved batch-size histogram. --sense-errors turns on
the per-macro device-physics error channel (seeded from a generator on
the device), --drift-mag lets each macro's error map drift over wall-clock
time and --recal attaches the online recalibration controller.

Adding --generate to --open-loop chains every completed retrieval into a
ContinuousBatchingEngine decode slot, reporting end-to-end, time-to-first-
token and per-token latency and slot occupancy. --paged serves decode
from the paged KV block pool with chunked prefill (--paged-kernel: K3),
--retain-blocks / --host-blocks turn on the tiered prefix cache,
--n-replicas N serves decode from an EngineRouter fleet with
prefix-affinity placement, and --slo-ttft-ms / --slo-e2e-ms attach the
SLO controller (with --hi-pri-tenants N marking a protected priority
class for preemption). --json FILE ('-' = stdout) also emits any --rag
report as JSON.

Everything runs on the card unless --device cpu is given. --arch takes
any of the ten registry architectures, every family (the ssm, hybrid
and audio ones stream their prompts through `decode_step` and keep
their state slot-resident under --paged); an unknown one is a CLI
error.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b \
      --batch 4 --prompt-len 16 --new-tokens 32
  PYTHONPATH=src python -m repro_torch.launch.serve --rag --n-shards 4 \
      --rag-docs 1024 --batch 16 --rag-queries 64 --path kernel_bitserial
  PYTHONPATH=src python -m repro_torch.launch.serve --rag --open-loop \
      --offered-qps 500 --n-tenants 4 --skew 10 --max-wait-ms 5
  PYTHONPATH=src python -m repro_torch.launch.serve --rag --open-loop --generate \
      --paged --paged-kernel --n-slots 4 --retain-blocks 64 --host-blocks 128 \
      --n-replicas 2 --slo-ttft-ms 500 --hi-pri-tenants 1 --json report.json
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.device_physics import DriftConfig
from repro_torch.core.error_model import ErrorModelConfig
from repro_torch.core.retrieval import PATHS, RetrievalConfig
from repro_torch.device import DeviceLike, make_generator, resolve_device
from repro_torch.models import build_model
from repro_torch.serving import (
    AsyncBatchScheduler,
    EngineConfig,
    EngineRouter,
    GenerationEngine,
    HashEmbedder,
    RagPipeline,
    RouterConfig,
    SLOConfig,
    SLOController,
)
from repro_torch.serving.config import resolve_config

def _seeded_model(arch: str, smoke: bool, seed: int, device: torch.device):
    """`arch`'s model on `device`, weights drawn from `seed`."""
    cfg = get_config(arch, smoke=smoke)
    return build_model(cfg, device=device).init(make_generator(device, seed))


def serve(arch: str, smoke: bool = True, batch: int = 4, prompt_len: int = 16,
          new_tokens: int = 32, temperature: float = 0.0, seed: int = 0,
          device: DeviceLike = None) -> dict:
    """Batched generation with `arch` (weights and prompts from `seed`):
    `GenerationEngine.generate` over (batch, prompt_len) random prompts.
    Returns the (batch, new_tokens) tokens, the wall and tokens/s."""
    dev = resolve_device(device)
    model = _seeded_model(arch, smoke, seed, dev)
    engine = GenerationEngine(model, temperature=temperature, device=dev)
    prompts = torch.randint(0, model.cfg.vocab_size, (batch, prompt_len),
                            generator=make_generator(dev, seed + 1), device=dev)
    t0 = time.perf_counter()
    toks = engine.generate(prompts, max_new_tokens=new_tokens,
                           cache_len=prompt_len + new_tokens,
                           generator=make_generator(dev, seed + 2))
    dt = time.perf_counter() - t0
    return {"tokens": toks, "wall_s": dt, "tok_per_s": toks.size / dt}


def serve_rag(n_docs: int = 1024, n_shards: int = 4, dim: int = 256,
              batch: int = 16, n_queries: int = 64, k: int = 3,
              path: str = "int_exact", seed: int = 0,
              sense_errors: bool = False, drift_mag: float = 0.0,
              recal: bool = False, device: DeviceLike = None,
              pipe: Optional[RagPipeline] = None) -> dict:
    """Stand up a sharded RAG front end and drive micro-batched traffic.

    `pipe` serves instead of a pipeline built from the other arguments
    (its corpus then sets `n_docs`)."""
    rng = np.random.default_rng(seed)
    if pipe is None:
        pipe = build_rag_pipeline(n_docs=n_docs, n_shards=n_shards, dim=dim,
                                  path=path, seed=seed, sense_errors=sense_errors,
                                  drift_mag=drift_mag, recal=recal, device=device)
    corpus = pipe.doc_texts
    n_docs = len(corpus)
    queries = [corpus[rng.integers(0, n_docs)] for _ in range(n_queries)]
    sched = pipe.scheduler(max_batch=batch, generator=_sense_generator(pipe, seed))
    for q in queries:
        sched.submit(q, k=k)
    sched.flush()  # warm-up on the first full traffic wave
    warmup_flushes = sched.n_flushes
    t0 = time.perf_counter()
    tickets = [sched.submit(q, k=k) for q in queries]
    sched.flush()
    dt = time.perf_counter() - t0
    exact = sum(corpus[int(t.result()[0][0])] == q for t, q in zip(tickets, queries))
    out = {"wall_s": dt, "qps": n_queries / dt,
           "flushes": sched.n_flushes - warmup_flushes,
           "self_retrieval": exact / n_queries}
    return _attach_retrieval_stats(out, pipe)


def _sense_generator(pipe: RagPipeline, seed: int):
    """A seeded generator on the pipeline's device for the transient error
    channel (the JAX driver's `_sense_key`) — None (clean planes) unless
    the pipeline's error model is on."""
    if getattr(pipe.index.config.error, "enabled", False):
        return make_generator(pipe.device, seed + 2)
    return None


def _attach_retrieval_stats(out: dict, pipe: RagPipeline) -> dict:
    """Fold per-shard error/recal counters into a --rag report dict."""
    stats = pipe.retrieval_stats()
    if stats:
        out["retrieval"] = stats
    return out


def _print_retrieval_stats(out: dict) -> None:
    """Per-shard error/recal counter lines for the --rag reports."""
    stats = out.get("retrieval")
    if not stats or not stats.get("error_enabled"):
        return
    print(f"error channel: {stats['total_senses']} senses, "
          f"{stats['total_detected']} detected, "
          f"{stats['total_residual']} residual, "
          f"{stats['total_recals']} recals "
          f"(drift {'on' if stats['drift_enabled'] else 'off'})")
    for s, row in enumerate(stats["shards"]):
        line = (f"  shard {s}: detected rate {row['detected_rate']:.4f}, "
                f"residual rate {row['residual_rate']:.5f}, "
                f"recals {row['recal_events']}")
        if "drift_amplitude" in row:
            line += (f", drift amp {row['drift_amplitude']:.3f}, "
                     f"exposure {row['exposure']:.2f}")
        print(line)
    recal = stats.get("recalibration")
    if recal:
        ests = [r["drift_estimate"] for r in recal["shards"]
                if r["drift_estimate"] is not None]
        est = f"{max(ests):.2f}x" if ests else "n/a"
        print(f"recalibration: {recal['total_triggers']} triggers "
              f"(window {recal['window']}, ratio {recal['trigger_ratio']}), "
              f"max drift estimate {est}")


def _jsonable(obj):
    """Report dict -> something json.dump accepts: histogram keys become
    strings, numpy scalars/arrays become Python numbers/lists."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return obj


def _emit_json(out: dict, dest: str) -> None:
    """Write a --rag report as JSON to `dest` ('-' = stdout)."""
    payload = json.dumps(_jsonable(out), indent=2, sort_keys=True)
    if dest == "-":
        sys.stdout.write(payload + "\n")
    else:
        with open(dest, "w") as f:
            f.write(payload + "\n")


def _sum_pools(pools: list) -> dict:
    """Key-wise sum of per-replica pool stats dicts, with the hit rates
    recomputed over the pooled attempt counts (a mean of per-pool rates
    would weigh an idle replica as much as a busy one)."""
    out = {k: sum(p[k] for p in pools) for k in pools[0]}
    out["block_size"] = pools[0]["block_size"]
    attempts = out["n_prefix_hits"] + out["n_prefix_misses"]
    for rate, hits in (("prefix_hit_rate", "n_prefix_hits"),
                       ("device_hit_rate", "n_device_hits"),
                       ("host_hit_rate", "n_host_hits")):
        out[rate] = out[hits] / attempts if attempts else 0.0
    return out


def _pct(values, q) -> float:
    """np.percentile that reports 0.0 for an empty sample instead of
    raising, so a run that served nothing still gives a NaN-free report."""
    arr = np.asarray(values, np.float64)
    return float(np.percentile(arr, q)) if arr.size else 0.0


def _percentiles_ms(wait_s) -> dict:
    lat = np.asarray(wait_s, np.float64) * 1e3
    return {
        "p50_ms": _pct(lat, 50),
        "p95_ms": _pct(lat, 95),
        "p99_ms": _pct(lat, 99),
        "mean_ms": float(lat.mean()) if lat.size else 0.0,
    }


def build_rag_pipeline(n_docs: int = 512, n_shards: int = 4, dim: int = 256,
                       path: str = "int_exact", seed: int = 0,
                       arch: Optional[str] = None,
                       max_prompt_len: int = 96,
                       sense_errors: bool = False,
                       drift_mag: float = 0.0,
                       recal: bool = False,
                       clock=time.monotonic,
                       device: DeviceLike = None) -> RagPipeline:
    """A ShardedDircIndex-backed pipeline over a synthetic corpus, on
    `device` (`None` is the card).

    Passing `arch` attaches that architecture's smoke-size generator,
    weights from `seed`, enabling the generation paths
    (`query_stream(generate=True)`, `decode_engine`).

    `sense_errors=True` turns on the per-macro device-physics channel
    (jittered per-shard calibration, error-aware remapping, Sigma-D
    detection); `drift_mag` scales temporal drift of each macro's true
    map over `clock` (0 = static maps); `recal=True` attaches the online
    `RecalibrationController`. Drift and recal require `sense_errors`."""
    if (drift_mag > 0 or recal) and not sense_errors:
        raise ValueError("drift/recal require sense_errors=True")
    rng = np.random.default_rng(seed)
    corpus = [f"document {i}: " + " ".join(
        f"w{rng.integers(0, 997)}" for _ in range(12)) for i in range(n_docs)]
    model = None
    if arch is not None:
        model = _seeded_model(arch, True, seed, resolve_device(device))
    if sense_errors:
        retrieval = RetrievalConfig(
            bits=8, metric="cosine", path=path, mapping="error_aware",
            error=ErrorModelConfig(enabled=True, p_min=5e-3, p_max=4e-2,
                                   jitter_sigma=0.25, seed=seed),
            detect=True, max_retries=2)
    else:
        retrieval = RetrievalConfig(bits=8, metric="cosine", path=path)
    drift = None
    if drift_mag > 0:
        drift = DriftConfig(enabled=True, amp_mu=2e-3 * drift_mag, amp_sigma=0.0,
                            rotate_rate=2e-3 * drift_mag, seed=seed)
    return RagPipeline(corpus, retrieval, model=model, dim=dim,
                       embedder=HashEmbedder(dim=dim),
                       max_prompt_len=max_prompt_len, n_shards=n_shards,
                       device=device, clock=clock, drift=drift, recal=recal)


def _padded_search(pipe: RagPipeline, max_batch: int, generator=None):
    """Pad retrieval batches to one (max_batch, dim) serving shape.

    With `generator` set, every flush senses through the transient error
    channel with fresh draws from it (flips independent per batch)."""
    def padded(texts, kk):
        pad = max_batch - len(texts)
        ids, scores = pipe.search_batch(list(texts) + [texts[0]] * pad, kk,
                                        generator=generator)
        return ids[: len(texts)], scores[: len(texts)]

    return padded


def _poisson_arrivals(pipe: RagPipeline, n_tenants: int, skew: float,
                      offered_qps: float, n_queries: int, seed: int):
    """Sampled corpus queries, per-arrival tenant ids, and Poisson gaps.

    One aggregate Poisson process at `offered_qps` (exponential
    inter-arrival gaps); each arrival lands on one of `n_tenants`
    tenants, tenant 0 receiving `skew`x the probability mass of each
    other tenant."""
    n_docs = len(pipe.doc_texts)
    rng = np.random.default_rng(seed + 1)
    queries = [pipe.doc_texts[rng.integers(0, n_docs)] for _ in range(n_queries)]
    weights = np.array([skew] + [1.0] * max(n_tenants - 1, 0), np.float64)
    weights /= weights.sum()
    tenants = rng.choice(n_tenants, size=n_queries, p=weights)
    gaps = rng.exponential(1.0 / offered_qps, size=n_queries)
    return queries, tenants, gaps


def _pace_arrivals(gaps, submit) -> float:
    """Open-loop pacing: sleep to each arrival, call submit(i); returns t0."""
    t0 = time.perf_counter()
    next_arrival = t0
    for i, gap in enumerate(gaps):
        next_arrival += gap
        delay = next_arrival - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        submit(i)
    return t0


def serve_rag_open_loop(n_docs: int = 512, n_shards: int = 4, dim: int = 256,
                        max_batch: int = 16, max_wait_ms: float = 5.0,
                        n_tenants: int = 4, skew: float = 1.0,
                        offered_qps: float = 500.0, n_queries: int = 200,
                        k: int = 3, path: str = "int_exact", seed: int = 0,
                        sense_errors: bool = False, drift_mag: float = 0.0,
                        recal: bool = False, device: DeviceLike = None,
                        pipe: Optional[RagPipeline] = None) -> dict:
    """Open-loop streaming traffic against the async dual-trigger scheduler.

    Arrivals are one aggregate Poisson process at `offered_qps`; each is
    assigned to one of `n_tenants` tenants, tenant 0 receiving `skew`x
    the probability mass of each other tenant. No caller ever blocks:
    tickets complete via the background flush loop's dual trigger, and
    latency is each ticket's submit->serve wait. Batches are padded to
    the fixed `max_batch` serving shape before the index search.
    """
    if pipe is None:
        pipe = build_rag_pipeline(n_docs=n_docs, n_shards=n_shards, dim=dim,
                                  path=path, seed=seed, sense_errors=sense_errors,
                                  drift_mag=drift_mag, recal=recal, device=device)
    queries, arrival_tenant, gaps = _poisson_arrivals(
        pipe, n_tenants, skew, offered_qps, n_queries, seed)

    padded_search = _padded_search(pipe, max_batch,
                                   generator=_sense_generator(pipe, seed))
    padded_search([queries[0]], k)  # warm the serving shape off the clock
    sched = AsyncBatchScheduler(padded_search, max_batch=max_batch,
                                max_wait_ms=max_wait_ms, start=True)
    tickets = []

    def submit(i):
        tickets.append(sched.submit(queries[i], k=k,
                                    tenant=f"tenant{arrival_tenant[i]}"))

    t0 = _pace_arrivals(gaps, submit)
    sched.close(drain=True)
    wall = time.perf_counter() - t0

    # a failed flush leaves wait_s=None on its tickets: they count in
    # n_failed and stay out of the percentiles
    served = [t for t in tickets if t.wait_s is not None]
    per_tenant = {}
    for t in served:
        per_tenant.setdefault(t.tenant, []).append(t.wait_s)
    out = {
        "offered_qps": offered_qps,
        "achieved_qps": len(served) / wall,
        "n_queries": n_queries,
        "n_failed": sched.n_failed,
        "n_tenants": n_tenants,
        "skew": skew,
        "max_batch": max_batch,
        "max_wait_ms": max_wait_ms,
        "n_flushes": sched.n_flushes,
        "mean_batch": sched.stats()["mean_batch"],
        "batch_hist": sched.batch_size_hist(),
        "per_tenant_p95_ms": {
            name: _pct(np.asarray(w) * 1e3, 95)
            for name, w in sorted(per_tenant.items()) if w
        },
    }
    out.update(_percentiles_ms([t.wait_s for t in served]))
    return _attach_retrieval_stats(out, pipe)


def serve_rag_open_loop_generate(
        n_docs: int = 512, n_shards: int = 4, dim: int = 256,
        max_batch: int = 16, max_wait_ms: float = 5.0,
        n_tenants: int = 4, skew: float = 1.0,
        offered_qps: float = 50.0, n_queries: int = 32,
        k: int = 3, max_new_tokens: int = 16,
        config: Optional[EngineConfig] = None,
        n_slots: Optional[int] = None,
        paged: Optional[bool] = None, block_size: Optional[int] = None,
        n_blocks: Optional[int] = None, prefill_chunk: Optional[int] = None,
        prefix_sharing: Optional[bool] = None,
        paged_kernel: Optional[bool] = None,
        retain_blocks: Optional[int] = None,
        host_blocks: Optional[int] = None,
        router: Optional[RouterConfig] = None,
        n_replicas: Optional[int] = None,
        affinity: Optional[bool] = None,
        max_imbalance: Optional[int] = None,
        arch: str = "phi4-mini-3.8b", path: str = "int_exact",
        seed: int = 0, sense_errors: bool = False, drift_mag: float = 0.0,
        recal: bool = False,
        slo: Optional[SLOConfig] = None,
        hi_pri_tenants: int = 0,
        device: DeviceLike = None,
        pipe: Optional[RagPipeline] = None) -> dict:
    """Open-loop retrieval + generation through the streaming front door.

    Poisson arrivals go to the async retrieval scheduler; each completed
    retrieval's augmented prompt goes straight into a
    `ContinuousBatchingEngine` decode slot (the `query_stream(generate=
    True)` wiring, instrumented). Reports end-to-end (arrival -> last
    token) p50/p95/p99, time-to-first-token, per-token decode latency,
    decode throughput and slot occupancy.

    Engine shape is best passed as `config=EngineConfig(...)`; the
    per-knob parameters are the deprecated shim. `paged=True` adds pool
    utilisation and admission counters to the report, `prefix_sharing`
    (None: on for paged attention) the sharing counters, and
    `retain_blocks` / `host_blocks` the retention and per-tier hit
    counters. `router=RouterConfig(...)` (or the `n_replicas` /
    `affinity` / `max_imbalance` sugar) serves decode from an
    `EngineRouter` fleet; the report then adds `n_replicas`,
    `per_replica_submits` and the affinity counters, with occupancy and
    pool counters summed over replicas. `slo=SLOConfig(...)` attaches an
    `SLOController` (background poll thread) for the paced traffic, its
    final counters under `"slo"`; `hi_pri_tenants=N` submits the first N
    tenants' traffic at priority 1, everyone else at 0. `pipe` serves
    instead of a pipeline built from the other arguments (it must carry
    a model).
    """
    if pipe is None:
        pipe = build_rag_pipeline(n_docs=n_docs, n_shards=n_shards, dim=dim,
                                  path=path, seed=seed, arch=arch,
                                  sense_errors=sense_errors, drift_mag=drift_mag,
                                  recal=recal, device=device)
    if pipe.engine is None:
        raise ValueError("generate mode needs a pipeline with a model "
                         "(build_rag_pipeline(arch=...))")
    config = resolve_config(config, dict(
        n_slots=n_slots, paged=paged, block_size=block_size,
        n_blocks=n_blocks, prefill_chunk=prefill_chunk,
        prefix_sharing=prefix_sharing, paged_kernel=paged_kernel,
        retain_blocks=retain_blocks, host_blocks=host_blocks))
    queries, arrival_tenant, gaps = _poisson_arrivals(
        pipe, n_tenants, skew, offered_qps, n_queries, seed)

    padded_search = _padded_search(pipe, max_batch,
                                   generator=_sense_generator(pipe, seed))
    sched = AsyncBatchScheduler(padded_search, max_batch=max_batch,
                                max_wait_ms=max_wait_ms, start=True)
    engine = pipe.decode_engine(config, router=router, n_replicas=n_replicas,
                                affinity=affinity, max_imbalance=max_imbalance,
                                max_new_tokens=max_new_tokens, start=True)
    fleet = isinstance(engine, EngineRouter)
    replicas = engine.engines if fleet else [engine]

    # warm every serving shape off the clock: the (max_batch, dim) search
    # and one request through each replica. Warm-up submits go straight to
    # the engines so the router's counters stay clean.
    ids_w, _ = padded_search([queries[0]], k)
    warm_prompt = pipe.encode_prompt(
        queries[0], [pipe.doc_texts[i] for i in ids_w[0] if i >= 0])
    for rep in replicas:
        rep.submit(warm_prompt, max_new_tokens=max_new_tokens).result(timeout=120.0)
    warm_stats = engine.stats()  # excluded from the occupancy report

    controller = None
    if slo is not None:
        controller = SLOController(slo, engine=engine, scheduler=sched, start=True)

    gens: list = []
    n_chain_failed = [0]

    def on_retrieved(rt):
        try:
            texts_k = [pipe.doc_texts[i] for i in rt.doc_ids if i >= 0]
            prompt, prefix_len = pipe.encode_prompt_with_prefix(rt.text, texts_k)
            gt = engine.submit(prompt, max_new_tokens=max_new_tokens,
                               tenant=rt.tenant, prefix_len=prefix_len,
                               priority=getattr(rt, "priority", 0))
            gt.retrieval = rt
            gens.append(gt)
        except Exception:  # noqa: BLE001 - failed retrieval or closed engine
            n_chain_failed[0] += 1  # counted instead of vanishing silently

    def submit(i):
        ticket = sched.submit(queries[i], k=k, tenant=f"tenant{arrival_tenant[i]}")
        # the priority class rides retrieval onto the decode submit
        ticket.priority = 1 if arrival_tenant[i] < hi_pri_tenants else 0
        ticket.add_done_callback(on_retrieved)

    t0 = _pace_arrivals(gaps, submit)
    sched.close(drain=True)
    slo_stats = None
    if controller is not None:
        # stop actuating before the engines drain their tail: the final
        # counters describe the paced-traffic window
        slo_stats = controller.stats()
        controller.close()
    engine.close(drain=True)
    wall = time.perf_counter() - t0

    # a clean finish with a first token, or the TTFT / e2e math below would
    # see Nones; an empty `done` still gives a zeroed report
    done = [g for g in gens
            if g.done() and g._error is None and g.first_token_s is not None]
    # end to end: retrieval submit (arrival) -> last token, on the shared
    # monotonic clock the scheduler and the engines both stamp
    e2e_s = [(g.submit_time + g.wait_s) - g.retrieval.submit_time for g in done]
    ttft_s = [(g.submit_time + g.first_token_s) - g.retrieval.submit_time
              for g in done]
    per_tok_ms = [1e3 * (g.wait_s - g.first_token_s) / (len(g.tokens) - 1)
                  for g in done if len(g.tokens) > 1]
    # occupancy / step counters past the warm-up, summed over replicas
    est = engine.stats()
    pairs = (list(zip(est["replicas"], warm_stats["replicas"]))
             if fleet else [(est, warm_stats)])
    occ_hist: dict = {}
    n_steps = 0
    for e, w in pairs:
        for occ, n_occ in e["occupancy_hist"].items():
            d = n_occ - w["occupancy_hist"].get(occ, 0)
            if d > 0:
                occ_hist[occ] = occ_hist.get(occ, 0) + d
        n_steps += e["n_decode_steps"] - w["n_decode_steps"]
    mean_occ = (sum(occ * n for occ, n in occ_hist.items()) / n_steps
                if n_steps else 0.0)
    n_tokens = sum(len(g.tokens) for g in done)
    out = {
        "offered_qps": offered_qps,
        "achieved_qps": len(done) / wall,
        "n_queries": n_queries,
        "n_finished": len(done),
        "n_failed": n_queries - len(done),
        "n_chain_failed": n_chain_failed[0],
        "n_tenants": n_tenants,
        "skew": skew,
        "max_batch": max_batch,
        "max_wait_ms": max_wait_ms,
        "max_new_tokens": max_new_tokens,
        "n_slots": replicas[0].n_slots,
        "n_tokens": n_tokens,
        "decode_tok_per_s": n_tokens / wall,
        "mean_retrieval_batch": sched.stats()["mean_batch"],
        "n_decode_steps": n_steps,
        "mean_slot_occupancy": mean_occ,
        "occupancy_hist": occ_hist,
        "ttft_p50_ms": _pct(np.asarray(ttft_s) * 1e3, 50),
        "ttft_p95_ms": _pct(np.asarray(ttft_s) * 1e3, 95),
        "per_token_ms_mean": float(np.mean(per_tok_ms)) if per_tok_ms else 0.0,
        "per_token_ms_p95": _pct(per_tok_ms, 95),
        "paged": replicas[0].paged,
    }
    if fleet:
        out["n_replicas"] = engine.n_replicas
        out["affinity"] = est["affinity"]
        out["per_replica_submits"] = est["per_replica_submits"]
        for key_ in ("n_affinity_hits", "n_affinity_misses",
                     "n_affinity_spills", "affinity_hit_rate"):
            out[key_] = est[key_]
    if replicas[0].paged:
        eng_stats = [e for e, _ in pairs]
        out["n_backpressure"] = sum(e["n_backpressure"] for e in eng_stats)
        out["n_skip_ahead"] = sum(e.get("n_skip_ahead", 0) for e in eng_stats)
        out["n_prefill_chunks"] = sum(e.get("n_prefill_chunks", 0) for e in eng_stats)
        out["prefix_sharing"] = eng_stats[0].get("prefix_sharing", False)
        out["paged_kernel"] = eng_stats[0].get("paged_kernel")
        out["retain_blocks"] = replicas[0].retain_blocks
        out["host_blocks"] = replicas[0].host_blocks
        pools = [e["pool"] for e in eng_stats if "pool" in e]
        if pools:
            out["pool"] = _sum_pools(pools)
    if slo_stats is not None:
        out["slo"] = slo_stats
        out["hi_pri_tenants"] = hi_pri_tenants
    out.update(_percentiles_ms(e2e_s))
    return _attach_retrieval_stats(out, pipe)


def _print_generate_report(out: dict) -> None:
    """The human-readable lines of a --generate report."""
    print(f"open-loop generate: offered {out['offered_qps']:.0f} q/s, "
          f"finished {out['n_finished']}/{out['n_queries']} requests "
          f"({out['achieved_qps']:.1f} q/s end-to-end)")
    print(f"e2e ms: p50 {out['p50_ms']:.1f}  p95 {out['p95_ms']:.1f}  "
          f"p99 {out['p99_ms']:.1f}   TTFT p50 {out['ttft_p50_ms']:.1f} "
          f"p95 {out['ttft_p95_ms']:.1f}")
    print(f"decode: {out['decode_tok_per_s']:.0f} tok/s, per-token "
          f"{out['per_token_ms_mean']:.2f} ms mean / "
          f"{out['per_token_ms_p95']:.2f} ms p95")
    print(f"slots: mean occupancy {out['mean_slot_occupancy']:.2f}"
          f"/{out['n_slots']}, hist {out['occupancy_hist']}, "
          f"retrieval mean batch {out['mean_retrieval_batch']:.1f}")
    if "n_replicas" in out:
        print(f"fleet: {out['n_replicas']} replicas, affinity "
              f"{'on' if out['affinity'] else 'off'}, per-replica "
              f"submits {out['per_replica_submits']}")
        if out["affinity"]:
            print(f"affinity: hit rate {out['affinity_hit_rate']:.2f} "
                  f"({out['n_affinity_hits']} hits / "
                  f"{out['n_affinity_misses']} misses / "
                  f"{out['n_affinity_spills']} spills)")
    if out["paged"]:
        pool = out.get("pool", {})
        print(f"paged: {out['n_prefill_chunks']} prefill chunks, "
              f"{out['n_backpressure']} backpressure deferrals, "
              f"{out['n_skip_ahead']} skip-ahead admissions, "
              f"pool {pool.get('free_blocks', '?')}/"
              f"{pool.get('n_usable_blocks', '?')} blocks free at end")
        if out.get("prefix_sharing"):
            print(f"prefix sharing: hit rate {pool.get('prefix_hit_rate', 0.0):.2f} "
                  f"({pool.get('n_prefix_hits', 0)} hits / "
                  f"{pool.get('n_prefix_misses', 0)} misses), "
                  f"{pool.get('n_cow_copies', 0)} CoW copies, "
                  f"{pool.get('n_shared_blocks', 0)} blocks still shared at end")
        if out.get("retain_blocks"):
            print(f"retention: {pool.get('n_retained', 0)} prefixes "
                  f"({pool.get('n_retained_blocks', 0)} blocks) pinned at end, "
                  f"{pool.get('n_evictions', 0)} evictions, device hit rate "
                  f"{pool.get('device_hit_rate', 0.0):.2f}")
        if out.get("host_blocks"):
            print(f"host tier: {pool.get('n_host_entries', 0)} prefixes "
                  f"({pool.get('host_bytes', 0)} bytes) resident, "
                  f"{pool.get('n_host_hits', 0)} swap-ins, host hit rate "
                  f"{pool.get('host_hit_rate', 0.0):.2f}")
    if "slo" in out:
        s = out["slo"]
        print(f"slo: {s['n_polls']} polls, {s['n_tightens']} tightens / "
              f"{s['n_relaxes']} relaxes, {s['n_weight_updates']} weight updates, "
              f"{s['n_preemptions']} preemptions, worst p95/target "
              f"{s['worst_ratio']:.2f}, final max_wait {s['max_wait_ms']} ms / "
              f"lookahead {s['admit_lookahead']}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", help="generator architecture: batched generation "
                                   "without --rag, the --generate model with it")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--rag", action="store_true",
                    help="serve sharded batched retrieval instead of an LM")
    ap.add_argument("--rag-docs", type=int, default=1024)
    ap.add_argument("--rag-queries", type=int, default=64)
    ap.add_argument("--n-shards", type=int, default=4)
    ap.add_argument("--k", type=int, default=3)
    ap.add_argument("--path", choices=PATHS, default="int_exact",
                    help="retrieval compute path (kernel_bitserial: K1, "
                         "kernel_mxu: K2)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--sense-errors", action="store_true",
                    help="--rag: per-macro device-physics error channel "
                         "(jittered per-shard calibration, error-aware "
                         "remapping, Sigma-D detection); adds per-shard "
                         "detected/residual counters to the report")
    ap.add_argument("--drift-mag", type=float, default=0.0,
                    help="--sense-errors: temporal drift magnitude of each "
                         "macro's true error map over wall-clock time "
                         "(0 = static maps)")
    ap.add_argument("--recal", action="store_true",
                    help="--sense-errors: attach the online "
                         "RecalibrationController (drifted shards "
                         "re-extract their error map from detection "
                         "counters and re-encode in place mid-serving)")
    ap.add_argument("--open-loop", action="store_true",
                    help="--rag: simulated Poisson open-loop streaming "
                         "traffic against the async scheduler")
    ap.add_argument("--offered-qps", type=float, default=500.0)
    ap.add_argument("--n-tenants", type=int, default=4)
    ap.add_argument("--skew", type=float, default=1.0,
                    help="tenant 0 arrival-rate multiple vs the others")
    ap.add_argument("--max-wait-ms", type=float, default=5.0)
    ap.add_argument("--generate", action="store_true",
                    help="--rag --open-loop: chain completed retrievals "
                         "into continuous-batching generation and report "
                         "end-to-end/per-token latency + slot occupancy")
    ap.add_argument("--n-slots", type=int, default=4,
                    help="--generate: continuous-batching decode slots")
    ap.add_argument("--paged", action="store_true",
                    help="--generate: serve decode from the paged KV block "
                         "pool (chunked prefill + admission backpressure)")
    ap.add_argument("--block-size", type=int, default=None,
                    help="--paged: tokens per KV block (default 16)")
    ap.add_argument("--n-blocks", type=int, default=None,
                    help="--paged: pool size in blocks (default: the "
                         "fixed-slot n_slots*cache_len footprint)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="--paged: prompt tokens prefilled per engine step "
                         "(default 32)")
    ap.add_argument("--prefix-sharing", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="--paged: share identical retrieved-context "
                         "prefixes as refcounted blocks with copy-on-write "
                         "divergence (default: on for paged attention)")
    ap.add_argument("--paged-kernel", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="--paged: route paged attention through the fused "
                         "K3 kernel instead of the dense-window gather path "
                         "(default: defer to the model config)")
    ap.add_argument("--retain-blocks", type=int, default=None,
                    help="--paged: device retention budget (pool blocks) "
                         "for published prefixes that outlive their "
                         "publisher (default: off)")
    ap.add_argument("--host-blocks", type=int, default=None,
                    help="--paged: host-RAM tier budget (pool blocks) for "
                         "prefixes evicted from the device retention LRU "
                         "(requires --retain-blocks)")
    ap.add_argument("--n-replicas", type=int, default=None,
                    help="--generate: serve decode from an EngineRouter "
                         "fleet of this many replicated engines (default: "
                         "one engine, no router)")
    ap.add_argument("--affinity", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="--n-replicas: prefix-affinity placement (default: "
                         "on; --no-affinity balances by load only)")
    ap.add_argument("--max-imbalance", type=int, default=None,
                    help="--n-replicas: spill an affinity-routed request "
                         "to the least-loaded replica once its holder is "
                         "this many requests deeper (default: n_slots)")
    ap.add_argument("--slo-ttft-ms", type=float, default=None,
                    help="--generate: p95 time-to-first-token target (ms); "
                         "setting this (or --slo-e2e-ms) attaches the "
                         "SLOController")
    ap.add_argument("--slo-e2e-ms", type=float, default=None,
                    help="--generate: p95 end-to-end latency target (ms)")
    ap.add_argument("--slo-window-s", type=float, default=10.0,
                    help="--slo-*: sliding sample window (seconds)")
    ap.add_argument("--slo-interval-s", type=float, default=1.0,
                    help="--slo-*: actuation interval (seconds)")
    ap.add_argument("--slo-preempt", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="--slo-*: allow the controller to preempt running "
                         "low-priority decodes when a higher-priority "
                         "request is blocked on the pool")
    ap.add_argument("--hi-pri-tenants", type=int, default=0,
                    help="--generate: submit the first N tenants' traffic "
                         "at priority 1 (preemption's protected class)")
    ap.add_argument("--json", metavar="FILE", default=None,
                    help="--rag: also emit the report dict as JSON to FILE "
                         "('-' = stdout)")
    args = ap.parse_args(argv)
    if args.arch is not None:
        try:
            get_config(args.arch, args.smoke)
        except KeyError as e:
            ap.error(e.args[0])
    if args.rag and args.open_loop and args.generate:
        config = EngineConfig(
            n_slots=args.n_slots, paged=args.paged,
            block_size=args.block_size, n_blocks=args.n_blocks,
            prefill_chunk=args.prefill_chunk,
            prefix_sharing=args.prefix_sharing,
            paged_kernel=args.paged_kernel,
            retain_blocks=args.retain_blocks,
            host_blocks=args.host_blocks)
        slo = None
        if args.slo_ttft_ms is not None or args.slo_e2e_ms is not None:
            slo = SLOConfig(ttft_p95_ms=args.slo_ttft_ms, e2e_p95_ms=args.slo_e2e_ms,
                            window_s=args.slo_window_s,
                            interval_s=args.slo_interval_s,
                            preempt=args.slo_preempt)
        out = serve_rag_open_loop_generate(
            n_docs=args.rag_docs, n_shards=args.n_shards,
            max_batch=args.batch, max_wait_ms=args.max_wait_ms,
            n_tenants=args.n_tenants, skew=args.skew,
            offered_qps=args.offered_qps, n_queries=args.rag_queries,
            k=args.k, max_new_tokens=args.new_tokens, config=config,
            n_replicas=args.n_replicas, affinity=args.affinity,
            max_imbalance=args.max_imbalance,
            arch=args.arch or "phi4-mini-3.8b", path=args.path,
            sense_errors=args.sense_errors, drift_mag=args.drift_mag,
            recal=args.recal, slo=slo, hi_pri_tenants=args.hi_pri_tenants,
            device=args.device)
        _print_generate_report(out)
    elif args.rag and args.open_loop:
        out = serve_rag_open_loop(
            n_docs=args.rag_docs, n_shards=args.n_shards,
            max_batch=args.batch, max_wait_ms=args.max_wait_ms,
            n_tenants=args.n_tenants, skew=args.skew,
            offered_qps=args.offered_qps, n_queries=args.rag_queries,
            k=args.k, path=args.path, sense_errors=args.sense_errors,
            drift_mag=args.drift_mag, recal=args.recal, device=args.device)
        print(f"open-loop: offered {out['offered_qps']:.0f} q/s, achieved "
              f"{out['achieved_qps']:.0f} q/s over {out['n_queries']} queries")
        print(f"latency ms: p50 {out['p50_ms']:.2f}  p95 {out['p95_ms']:.2f} "
              f"p99 {out['p99_ms']:.2f}  (max_wait_ms={out['max_wait_ms']})")
        print(f"batches: {out['n_flushes']} flushes, mean size "
              f"{out['mean_batch']:.1f}, hist {out['batch_hist']}")
        print(f"per-tenant p95 ms: {out['per_tenant_p95_ms']}")
    elif args.rag:
        out = serve_rag(n_docs=args.rag_docs, n_shards=args.n_shards,
                        batch=args.batch, n_queries=args.rag_queries, k=args.k,
                        path=args.path, sense_errors=args.sense_errors,
                        drift_mag=args.drift_mag, recal=args.recal,
                        device=args.device)
        print(f"served {args.rag_queries} queries in {out['wall_s']:.3f}s "
              f"({out['qps']:.0f} q/s, {out['flushes']} flushes, "
              f"self-retrieval {out['self_retrieval']:.2f})")
    else:
        if not args.arch:
            ap.error("--arch is required unless --rag is set")
        out = serve(args.arch, smoke=args.smoke, batch=args.batch,
                    prompt_len=args.prompt_len, new_tokens=args.new_tokens,
                    temperature=args.temperature, device=args.device)
        print(f"generated {out['tokens'].shape} tokens in {out['wall_s']:.2f}s "
              f"({out['tok_per_s']:.0f} tok/s)")
        print(out["tokens"][:2])
        return
    _print_retrieval_stats(out)
    if args.json:
        _emit_json(out, args.json)


if __name__ == "__main__":
    main()
