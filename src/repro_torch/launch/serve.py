"""Serving driver of the port: batched sharded retrieval with --rag.

Counterpart of the retrieval modes of `repro.launch.serve`. --rag stands
up a ShardedDircIndex-backed RagPipeline plus a batch scheduler and
reports retrieval queries/sec under micro-batched traffic. Adding
--open-loop switches to simulated streaming traffic: Poisson arrivals
from several tenants (one optionally --skew times chattier) submitted to
the AsyncBatchScheduler's background flush loop, reporting p50/p95/p99
latency and the achieved batch-size histogram. --sense-errors turns on
the per-macro device-physics error channel (seeded from a generator on
the device), --drift-mag lets each macro's error map drift over wall-clock
time and --recal attaches the online recalibration controller. --json
FILE ('-' = stdout) also emits the report as JSON.

Everything runs on the card unless --device cpu is given. Generation
serving (--generate, --arch) and the fleet and SLO flags are not ported:
they stop with an error naming their ROADMAP item.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --rag --n-shards 4 \
      --rag-docs 1024 --batch 16 --rag-queries 64 --path kernel_bitserial
  PYTHONPATH=src python -m repro_torch.launch.serve --rag --open-loop \
      --offered-qps 500 --n-tenants 4 --skew 10 --max-wait-ms 5
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional

import numpy as np

from repro_torch.core.device_physics import DriftConfig
from repro_torch.core.error_model import ErrorModelConfig
from repro_torch.core.retrieval import PATHS, RetrievalConfig
from repro_torch.device import DeviceLike, make_generator
from repro_torch.serving import AsyncBatchScheduler, HashEmbedder, RagPipeline

_GENERATE = "ROADMAP: modules to port, serve CLI generation modes"
_FLEET = "ROADMAP: modules to port, fleet and control plane"


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
                       max_prompt_len: int = 96,
                       sense_errors: bool = False,
                       drift_mag: float = 0.0,
                       recal: bool = False,
                       clock=time.monotonic,
                       device: DeviceLike = None) -> RagPipeline:
    """A ShardedDircIndex-backed pipeline over a synthetic corpus, on
    `device` (`None` is the card).

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
    return RagPipeline(corpus, retrieval, dim=dim, embedder=HashEmbedder(dim=dim),
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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--rag", action="store_true",
                    help="serve sharded batched retrieval (the only mode ported)")
    ap.add_argument("--batch", type=int, default=4)
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
    ap.add_argument("--json", metavar="FILE", default=None,
                    help="--rag: also emit the report dict as JSON to FILE "
                         "('-' = stdout)")
    # generation serving and its fleet / SLO control plane: not ported
    ap.add_argument("--arch", help=f"not ported ({_GENERATE})")
    ap.add_argument("--generate", action="store_true", help=f"not ported ({_GENERATE})")
    for flag in ("--n-replicas", "--max-imbalance", "--slo-ttft-ms", "--slo-e2e-ms"):
        ap.add_argument(flag, default=None, help=f"not ported ({_FLEET})")
    ap.add_argument("--affinity", action=argparse.BooleanOptionalAction, default=None,
                    help=f"not ported ({_FLEET})")
    args = ap.parse_args(argv)
    if args.arch is not None or args.generate:
        ap.error(f"--arch / --generate: generation serving is not ported ({_GENERATE})")
    fleet = [f"--{k.replace('_', '-')}" for k in
             ("n_replicas", "max_imbalance", "slo_ttft_ms", "slo_e2e_ms", "affinity")
             if getattr(args, k) is not None]
    if fleet:
        ap.error(f"{', '.join(fleet)}: engine fleets and the SLO control plane "
                 f"are not ported ({_FLEET})")
    if not args.rag:
        ap.error("--rag is required (the port serves retrieval only)")
    if args.open_loop:
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
    else:
        out = serve_rag(n_docs=args.rag_docs, n_shards=args.n_shards,
                        batch=args.batch, n_queries=args.rag_queries, k=args.k,
                        path=args.path, sense_errors=args.sense_errors,
                        drift_mag=args.drift_mag, recal=args.recal,
                        device=args.device)
        print(f"served {args.rag_queries} queries in {out['wall_s']:.3f}s "
              f"({out['qps']:.0f} q/s, {out['flushes']} flushes, "
              f"self-retrieval {out['self_retrieval']:.2f})")
    _print_retrieval_stats(out)
    if args.json:
        _emit_json(out, args.json)


if __name__ == "__main__":
    main()
