"""The arithmetic the metric readers share. Each reader takes a `Run`
(`harness.Run`) and returns a number, or None where the run holds
nothing to read; it never stands a 0 in for a missing share."""
from __future__ import annotations

import math
import statistics
from typing import Optional

from bench import roofline

INF_MS = 1e12   # a request that failed or never finished: past every limit


def nearest_rank(values: list, q: float) -> Optional[float]:
    """The q-th percentile by nearest rank: a value that was measured."""
    if not values:
        return None
    vals = sorted(values)
    return vals[max(0, math.ceil(q / 100.0 * len(vals)) - 1)]


def tail_ms(run, which: str, q: float) -> Optional[float]:
    """q-th percentile over every request due in the window of due time
    -> first answer token (`which` "first") or last ("last"), in ms."""
    out = []
    for r in run.records:
        t = r.first_token_at() if which == "first" else r.done_at()
        out.append(INF_MS if (t is None or not r.ok) else (t - r.due) * 1e3)
    return nearest_rank(out, q)


def tokens_per_s(run) -> Optional[float]:
    n = run.prefill_tokens + run.emitted_tokens
    return n / run.window_s if n > 0 else None


def median_or_none(values: list) -> Optional[float]:
    return statistics.median(values) if values else None


def retrieval_wait_ms(run) -> Optional[float]:
    return median_or_none([r.retrieval.wait_s * 1e3 for r in run.records
                           if r.retrieval is not None and r.retrieval.wait_s is not None
                           and r.retrieval._error is None])


def search_ms(run) -> Optional[float]:
    return median_or_none([(t1 - t0) * 1e3 for t0, t1, _ in run.rec.searches
                           if run.in_window(t0, t1)])


def prefill_useful_pct(run) -> Optional[float]:
    pieces = run.stats_close["n_prefill_chunks"] - run.stats_open["n_prefill_chunks"]
    if pieces <= 0:
        return None
    return 100.0 * run.prefill_tokens / (pieces * run.stats_close["prefill_chunk"])


def _steps(run, prefill: bool) -> list:
    return [s for s in run.rec.steps if run.in_window(s[0], s[1]) and (s[2] > 1) == prefill]


def step_ms(run, prefill: bool) -> Optional[float]:
    return median_or_none([(t1 - t0) * 1e3 for t0, t1, *_ in _steps(run, prefill)])


def mfu_pct(run) -> Optional[float]:
    steps = _steps(run, True) + _steps(run, False)
    wall = sum(t1 - t0 for t0, t1, *_ in steps)
    if wall <= 0:
        return None
    flops = sum(roofline.step_flops(run.model, ln, nv) for _, _, _, ln, nv in steps)
    return 100.0 * flops / (wall * roofline.BF16_FLOP_PER_S)


def roofline_pct(run, kernel: str) -> Optional[float]:
    sl = run.slice
    if not sl or sl[f"{kernel}_device_s"] <= 0 or sl[f"{kernel}_bound_s"] <= 0:
        return None
    return 100.0 * sl[f"{kernel}_bound_s"] / sl[f"{kernel}_device_s"]


def idle_pct(run, in_use: bool) -> Optional[float]:
    sl = run.slice
    if not sl:
        return None
    if in_use:
        if sl.get("in_use_s", 0) <= 0:
            return None
        return 100.0 * (1.0 - sl["busy_in_use_s"] / sl["in_use_s"])
    return 100.0 * (1.0 - sl["busy_s"] / sl["window_s"])
