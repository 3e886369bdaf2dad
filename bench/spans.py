"""The port's own spans (`repro_torch.perf.trace`) read in a run of a
cell.

    python3 bench/spans.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs the cell as `bench/run.py` does, with the same arguments, refusals
and exit codes, and with the port's tracer on from the window's open to
the end of the drain (`bench/run.py` leaves it off; here the harness's
`drive` is wrapped to switch it). Its result line holds, beside what
`bench/run.py`'s holds:
- `--trace 0` (no profiler, no synchronised step; the readings that need
  only the spans and the tickets' stamps): under `metrics`, each with the
  cell's suffix (`.open`, `.closed`, `.moe`), `admit_wait_ms`,
  `prefill_interleave_pct`, `embed_ms`, `step_host_ms` and
  `forward_in_flush_pct`; `info.ttft_parts_ms` (open loops): the
  requests at and above the TTFT p90, each due time -> first token split
  into its parts;
- `--trace 1` (the profiled slices): `forward_idle_pct` and
  `moe_device_pct`, the slice's kernels laid over the spans, and
  `breakdown.idle_by_span`: the slice's idle time by the innermost span
  open on the engine's thread at each gap's midpoint (`between_spans`
  outside every span);
- both: `info.trace`, the spans kept, the tracer's counters, and the
  decode steps' and prefill pieces' `model.forward` spans (their wall,
  the time a retrieval flush ran beside them and, traced, the time a
  kernel ran on the card while one was open); traced, the share of the
  slice's kernels placed in a span.

A kernel is charged to the innermost span that holds its launch on the
launching thread: the CUDA API call with the kernel's correlation id
carries the host time and the thread, as its native id or, for a thread
the profiler recorded no CPU op of (the port's engine and scheduler
threads), as CUPTI's low 32 bits of its `pthread_t`, read signed. The
readings take the spans inside the window and the requests due in it.
"""
from __future__ import annotations

import bisect
import dataclasses
import functools
import re
import statistics
import sys
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent.parent
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from bench import readers  # noqa: E402
from bench.trace import _interval_union, _overlap  # noqa: E402

LAUNCH = re.compile(r"cu(da)?[A-Z]")   # a CUDA API call (`cudaLaunchKernel`, `cuLaunchKernel`)
HOST_SPANS = ("engine.forward", "engine.sample")   # not the step's own host work


@dataclasses.dataclass
class Request:
    """One request due in the window, as its tickets stamped it (host
    clock, s); None where it never got that far."""
    due: float
    ok: bool
    served: Optional[float] = None      # the flush's search was done
    gen_rid: Optional[int] = None
    submit: Optional[float] = None      # into the engine
    admit: Optional[float] = None       # took a slot
    first: Optional[float] = None       # first answer token


@dataclasses.dataclass
class Device:
    """A profiled slice on the trace's clock (ns): `[lo, hi]`, its device
    activities `(name, start, end, correlation id)`, the launches `{correlation
    id: (host ns, thread)}` and `offset` = trace clock - `time.monotonic_ns()`."""
    lo: int
    hi: int
    kernels: list
    launches: dict
    offset: int

    def busy(self) -> list:
        return _interval_union([(max(a, self.lo), min(b, self.hi))
                                for _, a, b, _ in self.kernels if b > self.lo and a < self.hi])


@dataclasses.dataclass
class Traced:
    """What a traced run leaves for the readings below: the tracer's spans
    and counters, the window (host s), the requests due in it, and the
    profiled slice (None where none read)."""
    spans: list
    counters: dict
    t_open: float
    t_close: float
    requests: list
    device: Optional[Device] = None

    def in_window(self, name: str) -> list:
        lo, hi = self.t_open * 1e9, self.t_close * 1e9
        return [s for s in self.spans if s.name == name and s.t0 >= lo and s.t1 <= hi]

    def engine_tid(self) -> Optional[int]:
        tids = [s.tid for s in self.spans if s.name == "engine.step"]
        return statistics.mode(tids) if tids else None

    @functools.cached_property
    def pieces(self) -> dict:
        """Request id -> its `engine.piece` spans."""
        out: dict = {}
        for s in self.spans:
            if s.name == "engine.piece":
                out.setdefault(s.rid, []).append(s)
        return out

    @functools.cached_property
    def flushes(self) -> list:
        """The `sched.flush` spans' intervals, merged (ns)."""
        return _interval_union([(s.t0, s.t1) for s in self.spans if s.name == "sched.flush"])


def _ms(ns) -> float:
    return ns / 1e6


# ------------------------------------------------------------ program spans
def admit_wait_ms(tr: Traced) -> Optional[float]:
    """Median over requests of submit -> slot, in ms."""
    return readers.median_or_none([(r.admit - r.submit) * 1e3 for r in tr.requests
                                   if r.admit is not None and r.submit is not None])


def _own_piece_s(tr: Traced, r: Request) -> float:
    """Seconds of request `r`'s own `engine.piece` spans between its
    admission and its first token."""
    lo, hi = r.admit * 1e9, r.first * 1e9
    return sum(max(0.0, min(s.t1, hi) - max(s.t0, lo))
               for s in tr.pieces.get(r.gen_rid, ())) / 1e9


def prefill_interleave_pct(tr: Traced) -> Optional[float]:
    """Median over requests of the share of admission -> first token that
    its own prefill pieces do not cover, in %."""
    out = []
    for r in tr.requests:
        if r.admit is None or r.first is None or r.first <= r.admit:
            continue
        out.append(100.0 * (1.0 - _own_piece_s(tr, r) / (r.first - r.admit)))
    return readers.median_or_none(out)


def embed_ms(tr: Traced) -> Optional[float]:
    """Median `rag.embed` span, in ms."""
    return readers.median_or_none([_ms(s.t1 - s.t0) for s in tr.in_window("rag.embed")])


def _ancestor(sid: dict, s, name: str):
    p = sid.get(s.parent)
    while p is not None and p.name != name:
        p = sid.get(p.parent)
    return p


def step_host_ms(tr: Traced) -> Optional[float]:
    """Median over the engine steps that ran a decode of the step's time
    outside its `engine.forward` and `engine.sample` spans (admission,
    tables, copy-on-write, emitting, callbacks), in ms."""
    sid = {s.sid: s for s in tr.spans}
    steps = {s.sid: s for s in tr.in_window("engine.step")}
    inside = dict.fromkeys(steps, 0)
    decoded = set()
    for s in tr.spans:
        if s.name in HOST_SPANS or s.name == "engine.decode":
            step = _ancestor(sid, s, "engine.step")
            if step is None or step.sid not in steps:
                continue
            if s.name == "engine.decode":
                decoded.add(step.sid)
            else:
                inside[step.sid] += s.t1 - s.t0
    return readers.median_or_none([_ms(steps[k].t1 - steps[k].t0 - inside[k])
                                   for k in decoded])


def forward_in_flush_pct(tr: Traced) -> Optional[float]:
    """Share of the `model.forward` spans' wall in which the retrieval
    scheduler ran a flush (embedding, search, the callbacks' prompts and
    submits), in %: the most of the model's time in which that thread's
    Python could hold the GIL the engine's thread waits for."""
    fwd = tr.in_window("model.forward")
    wall = sum(s.t1 - s.t0 for s in fwd)
    if wall <= 0:
        return None
    return 100.0 * sum(_overlap(tr.flushes, s.t0, s.t1) for s in fwd) / wall


# ----------------------------------------------------- spans over the trace
def innermost(spans: list) -> tuple[list, list]:
    """(times, owners) for one thread's spans, which nest: from times[i]
    to times[i + 1] the innermost open span is owners[i] (None: none)."""
    times, owners, stack = [], [], []

    def close_until(t):
        while stack and stack[-1].t1 <= t:
            top = stack.pop()
            times.append(top.t1)
            owners.append(stack[-1] if stack else None)

    for s in sorted(spans, key=lambda s: (s.t0, -s.t1)):
        close_until(s.t0)
        stack.append(s)
        times.append(s.t0)
        owners.append(s)
    close_until(float("inf"))
    return times, owners


def _at(index: tuple, t) -> object:
    times, owners = index
    i = bisect.bisect_right(times, t) - 1
    return owners[i] if i >= 0 else None


def thread_keys(s) -> tuple:
    """The ids a launch may carry for span `s`'s thread: its native id, or
    the low 32 bits of its ident, signed or not."""
    low = s.ident & 0xFFFFFFFF
    return s.tid, low, low - (1 << 32) if low >= 1 << 31 else low


def charge(tr: Traced) -> list:
    """The span each kernel of the slice is charged to (None: its launch
    was not found, or fell outside every span of its thread), in the
    order of `tr.device.kernels`."""
    dev = tr.device
    by_tid: dict = {}
    for s in tr.spans:
        by_tid.setdefault(s.tid, []).append(s)
    index = {}
    for ss in by_tid.values():
        idx = innermost(ss)
        index.update(dict.fromkeys(thread_keys(ss[0]), idx))
    out = []
    for _, _, _, corr in dev.kernels:
        launch = dev.launches.get(corr)
        if launch is None or launch[1] not in index:
            out.append(None)
        else:
            out.append(_at(index[launch[1]], launch[0] - dev.offset))
    return out


def _span_intervals(tr: Traced, name: str) -> list:
    """`name`'s spans on the trace's clock, clipped to the slice."""
    dev = tr.device
    return _interval_union([(max(s.t0 + dev.offset, dev.lo), min(s.t1 + dev.offset, dev.hi))
                            for s in tr.spans if s.name == name
                            and s.t1 + dev.offset > dev.lo and s.t0 + dev.offset < dev.hi])


def forward_idle_pct(tr: Traced) -> Optional[float]:
    """Share of the slice's time inside `model.forward` spans in which no
    kernel ran on the card, in %."""
    if tr.device is None:
        return None
    fwd = _span_intervals(tr, "model.forward")
    total = sum(b - a for a, b in fwd)
    if total <= 0:
        return None
    busy = tr.device.busy()
    return 100.0 * (1.0 - sum(_overlap(busy, a, b) for a, b in fwd) / total)


def moe_device_pct(tr: Traced) -> Optional[float]:
    """Device time of the kernels launched inside `model.moe` spans over
    the slice's busy time, in %."""
    if tr.device is None:
        return None
    dev = tr.device
    busy = sum(b - a for a, b in dev.busy())
    moe = [(max(a, dev.lo), min(b, dev.hi)) for (_, a, b, _), s in zip(dev.kernels, charge(tr))
           if s is not None and s.name == "model.moe" and b > dev.lo and a < dev.hi]
    if busy <= 0 or not moe:
        return None
    return 100.0 * sum(b - a for a, b in _interval_union(moe)) / busy


def idle_by_span(tr: Traced) -> Optional[list]:
    """The slice's idle seconds by the innermost span open on the engine's
    thread at each gap's midpoint, largest first (`between_spans`: none)."""
    tid = tr.engine_tid()
    if tr.device is None or tid is None:
        return None
    dev = tr.device
    index = innermost([s for s in tr.spans if s.tid == tid])
    gaps, prev = [], dev.lo
    for a, b in dev.busy():
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if dev.hi > prev:
        gaps.append((prev, dev.hi))
    out: dict = {}
    for a, b in gaps:
        s = _at(index, (a + b) // 2 - dev.offset)
        name = s.name if s is not None else "between_spans"
        out[name] = out.get(name, 0.0) + (b - a) / 1e9
    return sorted(out.items(), key=lambda kv: -kv[1])


def launches_placed_pct(tr: Traced) -> Optional[float]:
    """Share of the slice's kernels charged to a span, in %."""
    if tr.device is None or not tr.device.kernels:
        return None
    owners = charge(tr)
    return 100.0 * sum(s is not None for s in owners) / len(owners)


def forwards(tr: Traced, kind: str) -> Optional[dict]:
    """The `model.forward` spans under `kind` (`engine.decode` or
    `engine.piece`) inside the window: their count, their mean wall and
    mean time beside a retrieval flush and, over those in the slice, the
    mean time a kernel ran on the card while one was open, in ms."""
    sid = {s.sid: s for s in tr.spans}
    fwd = [s for s in tr.in_window("model.forward") if _ancestor(sid, s, kind) is not None]
    if not fwd:
        return None
    out = {"n": len(fwd),
           "wall_ms": statistics.fmean(_ms(s.t1 - s.t0) for s in fwd),
           "in_flush_ms": statistics.fmean(_ms(_overlap(tr.flushes, s.t0, s.t1))
                                           for s in fwd)}
    if tr.device is not None:
        dev, busy = tr.device, tr.device.busy()
        inside = [_ms(_overlap(busy, s.t0 + dev.offset, s.t1 + dev.offset)) for s in fwd
                  if s.t0 + dev.offset >= dev.lo and s.t1 + dev.offset <= dev.hi]
        if inside:
            out["busy_ms"] = statistics.fmean(inside)
    return out


# ------------------------------------------------------------- TTFT parts
PARTS = ("retrieval_wait", "flush", "prompts", "submit", "admit_wait", "own_pieces",
         "interleaved", "first_sample")


def ttft_parts_ms(tr: Traced, r: Request) -> Optional[dict]:
    """Due time -> first token of a finished request, in ms, as the sum of
    `PARTS`: due -> its flush starts (the flush on the scheduler's thread
    that holds its serving stamp); the flush up to the search's ids on the
    host (with its `flush_embed` and `flush_search` beside it, inside it);
    then, up to its submission to the engine, the prompts built by the
    flush's callbacks for it and the tickets served before it
    (`rag.prompt`), and the rest of those callbacks (the submits); ->
    admitted; its own prefill pieces; other work of the steps up to its
    first token; the sample of its first token. None where a stamp or
    span is missing."""
    if not r.ok or None in (r.served, r.submit, r.admit, r.first):
        return None
    served, submit = r.served * 1e9, r.submit * 1e9
    flush = next((s for s in tr.spans if s.name == "sched.flush"
                  and s.t0 <= served <= s.t1), None)
    sample = max((s for s in tr.spans if s.name == "engine.sample" and s.t1 <= r.first * 1e9
                  and s.t0 >= r.admit * 1e9), key=lambda s: s.t1, default=None)
    if flush is None or sample is None:
        return None
    inner = [s for s in tr.spans if s.parent == flush.sid]
    named = {s.name: s for s in inner}
    prompts = sum(s.t1 - s.t0 for s in inner
                  if s.name == "rag.prompt" and s.t0 >= served and s.t1 <= submit) / 1e9
    own = _own_piece_s(tr, r)
    sample_s = (sample.t1 - sample.t0) / 1e9
    t_flush = flush.t0 / 1e9
    out = {"ttft": (r.first - r.due) * 1e3,
           "retrieval_wait": (t_flush - r.due) * 1e3,
           "flush": (r.served - t_flush) * 1e3,
           "prompts": prompts * 1e3,
           "submit": (r.submit - r.served - prompts) * 1e3,
           "admit_wait": (r.admit - r.submit) * 1e3,
           "own_pieces": own * 1e3,
           "interleaved": (r.first - r.admit - own - sample_s) * 1e3,
           "first_sample": sample_s * 1e3}
    for name in ("rag.embed", "rag.search"):
        s = named.get(name)
        out["flush_" + name[4:]] = _ms(s.t1 - s.t0) if s is not None else None
    return out


def ttft_tail_parts(tr: Traced, q: float = 90) -> list:
    """`ttft_parts_ms` of the requests at and above the TTFT p90 (by
    nearest rank over every request due, a failed one past every limit)."""
    ttft = [(r.first - r.due) * 1e3 if (r.ok and r.first is not None) else readers.INF_MS
            for r in tr.requests]
    cut = readers.nearest_rank(ttft, q)
    if cut is None:
        return []
    tail = sorted((t, i) for i, t in enumerate(ttft) if t >= cut)
    return [p for _, i in tail if (p := ttft_parts_ms(tr, tr.requests[i])) is not None]


PROGRAM = {"admit_wait_ms": admit_wait_ms, "prefill_interleave_pct": prefill_interleave_pct,
           "embed_ms": embed_ms, "step_host_ms": step_host_ms,
           "forward_in_flush_pct": forward_in_flush_pct}     # read in --trace 0 runs
DEVICE = {"forward_idle_pct": forward_idle_pct, "moe_device_pct": moe_device_pct}  # --trace 1
UNITS = {"admit_wait_ms": "ms", "embed_ms": "ms", "step_host_ms": "ms"}


# ------------------------------------------------------------- the run
def _request(rec) -> Request:
    ret, gen = rec.retrieval, rec.gen
    r = Request(due=rec.due, ok=rec.ok)
    if ret is not None and ret.wait_s is not None:
        r.served = ret.submit_time + ret.wait_s
    if gen is not None:
        r.gen_rid, r.submit, r.admit = gen.rid, gen.submit_time, gen.admit_time
        if gen.first_token_s is not None:
            r.first = gen.submit_time + gen.first_token_s
    return r


def device_of(sl) -> Optional[Device]:
    """A stopped `bench.trace.Slice`'s kernels and launches, on its clock."""
    import torch

    events = sl.prof.profiler.kineto_results.events()
    mark = next((e for e in events if e.name() == "bench.mark"), None)
    if mark is None:
        return None
    offset = mark.start_ns() - sl.mark[0]
    kernels = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.correlation_id())
               for e in events
               if e.device_type() == torch.autograd.DeviceType.CUDA and e.duration_ns() > 0]
    launches = {e.correlation_id(): (e.start_ns(), e.device_resource_id()) for e in events
                if e.device_type() != torch.autograd.DeviceType.CUDA
                and LAUNCH.match(e.name())}
    return Device(lo=int(sl.t0 * 1e9) + offset, hi=int(sl.t1 * 1e9) + offset,
                  kernels=kernels, launches=launches, offset=offset)


def _keep_device(sl, held: dict) -> None:
    """Read the slice's kernels into `held["device"]` when `run_cell`
    reads it whole (it reads the latest whole slice, and no other)."""
    summary = sl.summary

    def read(cfg, in_use=None):
        out = summary(cfg, in_use)
        if out is not None:
            held["device"] = device_of(sl)
        return out

    sl.summary = read


def run_with_spans(cell, seed: int, seconds: float, trace_on: bool, device, t_start: float,
                   rate=None, root=ROOT, run_cell=None) -> tuple[dict, Traced]:
    """`bench.run.run_cell` (or `run_cell`) with the port's tracer on from
    the window's open to the end of the drain: its result line with the
    span readings of its kind added (module docstring), and what they were
    read from."""
    from bench import harness
    from bench import run as brun
    from repro_torch.perf import trace

    run_cell = run_cell or brun.run_cell
    held: dict = {}
    drive = harness.drive

    def drive_traced(setup, seconds, trace_on, rate=None):
        trace.enable()
        try:
            run = drive(setup, seconds, trace_on, rate=rate)
        finally:
            trace.disable()
        spans, counters = trace.drain()
        held["traced"] = Traced(spans=spans, counters=counters, t_open=run.t_open,
                                t_close=run.t_close,
                                requests=[_request(r) for r in run.records])
        for sl in run.extra["slices"]:
            _keep_device(sl, held)
        return run

    harness.drive = drive_traced
    try:
        out = run_cell(cell, seed, seconds, trace_on, device, t_start, rate=rate, root=root)
    finally:
        harness.drive = drive
    tr = held["traced"]
    tr.device = held.get("device")
    suffix = cell_suffix(cell, root)
    for name, fn in (DEVICE if trace_on else PROGRAM).items():
        value = fn(tr)
        if value is not None:
            out["metrics"][f"{name}.{suffix}"] = {"value": float(value),
                                                  "unit": UNITS.get(name, "%")}
    info = {"spans": len(tr.spans), "counters": tr.counters,
            "decode_forward": forwards(tr, "engine.decode"),
            "piece_forward": forwards(tr, "engine.piece")}
    if trace_on:
        by_span = idle_by_span(tr)
        if by_span is not None:
            out.setdefault("breakdown", {})["idle_by_span"] = [list(kv) for kv in by_span[:10]]
        info["launches_placed_pct"] = launches_placed_pct(tr)
    elif cell.traffic["loop"] == "open":
        out["info"]["ttft_parts_ms"] = ttft_tail_parts(tr)
    out["info"]["trace"] = info
    return out, tr


def cell_suffix(cell, root=ROOT) -> str:
    """The suffix the cell's per-layer metrics carry (`decode_step_ms.open`
    -> `open`)."""
    from bench import spec

    names = [m["name"] for m in spec.metrics_for(cell.name, True, root)]
    return next(n.split(".", 1)[1] for n in names if n.startswith("decode_step_ms."))


def main(argv=None) -> int:
    """`bench/run.py`'s `main`, its `run_cell` replaced by `run_with_spans`."""
    from bench import run as brun

    run_cell = brun.run_cell

    def with_spans(cell, seed, seconds, trace_on, device, t_start, rate=None, root=ROOT):
        return run_with_spans(cell, seed, seconds, trace_on, device, t_start, rate=rate,
                              root=root, run_cell=run_cell)[0]

    brun.run_cell = with_spans
    try:
        return brun.main(argv)
    finally:
        brun.run_cell = run_cell


if __name__ == "__main__":
    sys.exit(main())
