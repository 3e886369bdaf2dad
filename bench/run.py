"""Run one cell of BENCHMARK.json on the card and print its result.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (from the seed), the measured window of `--seconds`, the drain;
then the comparison with the plain reference decides `correct`. The last
line of standard output is one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics with `--trace 0`, its
per-layer metrics with `--trace 1`), `device`, with `--trace 1`
`breakdown`, and last `checks`, each number compared beside its limit;
the last lines of standard error say the same. Exits 2, printing no
result, without a CUDA card (or fewer cards than the cell asks for), and
3 when JAX or the JAX package was loaded. `--rate` replaces an open
loop's rate (the knee sweep only).
"""
from __future__ import annotations

import time

T_IMPORT = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")   # top-level module names, whole


def process_start() -> float:
    """The process's start on the monotonic clock (Linux: from its start
    time since boot); else when this file was loaded."""
    try:
        stat = Path("/proc/self/stat").read_text()
        ticks = int(stat[stat.rindex(")") + 2:].split()[19])
        since_boot = ticks / os.sysconf("SC_CLK_TCK")
        now_boot = time.clock_gettime(time.CLOCK_BOOTTIME)
        return time.monotonic() - (now_boot - since_boot)
    except (OSError, ValueError, IndexError, AttributeError):
        return T_IMPORT


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _latencies(run) -> dict:
    """Every request's due -> first and -> last token, ms, sorted (None:
    failed or unfinished)."""
    first = [(r.first_token_at() - r.due) * 1e3 if r.ok else None for r in run.records]
    last = [(r.done_at() - r.due) * 1e3 if r.ok else None for r in run.records]
    key = (lambda v: float("inf") if v is None else v)
    return {"first": sorted(first, key=key), "last": sorted(last, key=key)}


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
             rate=None, root=ROOT) -> dict:
    """Set-up, window, drain, metrics and the comparison of one run; the
    result line as a dict."""
    import torch

    from bench import check, harness, spec

    setup = harness.set_up(cell, seed, seconds, trace, device)
    setup_s = time.monotonic() - t_start
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    run = harness.drive(setup, seconds, trace, rate=rate)
    run.setup_s = setup_s
    peak = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
    harness.tear_down(setup, run.records)
    in_use = harness.in_use_intervals(run) if cell.traffic["loop"] == "open" else None
    for i, sl in reversed(list(enumerate(run.extra.pop("slices")))):   # the latest whole
        if run.slice is None:
            run.slice = sl.summary(cell.config, in_use)
            if run.slice is None:
                print(f"bench: profiled slice {i} read nothing: {sl.why}", file=sys.stderr)
        sl.prof = None
    metrics = {}
    for m in spec.metrics_for(cell.name, trace, root):
        value = spec.reader(m["name"], root)(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    # a request unfinished when the drain ended: failed in an open loop
    # (it was due in the window), cut by the window's close in a closed one
    failed = sum(1 for r in run.records if not r.ok and (
        id(r) not in run.cut or cell.traffic["loop"] == "open"))
    cmp = check.compare(setup, run.records, device)
    if device.type == "cuda":
        kind, platform = torch.cuda.get_device_name(device), "gpu"
    else:
        kind, platform = "cpu", "cpu"
    dev = {"platform": platform, "kind": kind, "count": int(cell.chips),
           "memory_peak_bytes": peak}
    out = {"correct": check.correct(cmp), "attempted": len(run.records), "failed": failed,
           "metrics": metrics, "device": dev}
    if trace and run.slice:
        dev["busy_s"], dev["window_s"] = run.slice["busy_s"], run.slice["window_s"]
        out["breakdown"] = {"device_ops": [list(kv) for kv in run.slice["device_ops"]],
                            "idle_gaps": [list(kv) for kv in run.slice["idle_gaps"]]}
    out["info"] = {"setup": setup.times, "window_s": run.window_s,
                   "cut": len(run.cut), "compared": {
                       k: cmp[k] for k in ("searched", "sampled", "tokens", "seconds")},
                   "offered_qps": rate or cell.traffic.get("rate_qps"),
                   "backlog": run.extra["backlog"],
                   "latency_ms": _latencies(run),
                   "completed": sum(1 for r in run.records if r.ok),
                   "completed_in_window": sum(1 for r in run.records
                                              if r.ok and r.done_at() <= run.t_close),
                   "engine": {k: run.stats_close[k] - run.stats_open[k]
                              for k in ("n_decode_steps", "n_prefill_chunks", "n_tokens")}}
    out["checks"] = cmp["checks"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rate", type=float, default=None)
    args = ap.parse_args(argv)
    t_start = process_start()

    import torch

    from bench import spec

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"bench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), t_start, rate=args.rate)
    found = loaded_forbidden()
    if found:
        print(f"bench: loaded {found}; the benchmark runs the port alone", file=sys.stderr)
        return 3
    for c in out["checks"].values():   # JSON has no infinity: past every limit
        c["value"] = c["value"] if math.isfinite(c["value"]) else 1e30
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct {out['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
