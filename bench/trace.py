"""What a run records, from the benchmark's own files, around the calls
into the port's layers.

`Recorder` wraps, for the length of a run:
- the model's `paged_step` (the engine's one entry into the model): the
  valid prompt tokens of every prefill piece (t > 1) always; in a traced
  run also a span per call, synchronised on the card before and after,
  with its lengths and valid tokens;
- the pipeline's `search_batch` (embedding and search of one flush): a
  span per call;
- while the profiled slice runs, the lengths of every paged step (one
  K3 call, `kernels.paged_attend.paged_attend_fused`, a layer) and the
  shapes of every K1 call (`kernels.dirc_mac.dirc_mac_packed`), for
  their rooflines.

`Slice` is the profiled part of a traced run: `torch.profiler` over the
last seconds of the window, from which the device's busy time, each
kernel's device time and the idle gaps come. A marker recorded by the
thread that starts it ties the trace's clock to the host's monotonic
clock, so the spans and the requests' intervals can be laid over it.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np
import torch

from bench import roofline

K3_KERNELS = ("paged_attend_", "paged_combine_")
K1_KERNELS = ("dirc_mac_kernel",)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Recorder:
    def __init__(self, model, pipe, trace: bool):
        import repro_torch.kernels.dirc_mac as k1_mod

        self.trace = trace
        self.dev = model.device
        self.lock = threading.Lock()
        self.prefill_tokens = 0    # valid tokens of prefill pieces
        self.steps: list = []      # (t0, t1, t, lengths, n_valid), traced runs
        self.searches: list = []   # (t0, t1, queries)
        self.k3_calls: list = []   # (lengths, n_valid) of the slice's paged steps
        self.k1_calls: list = []   # (b, n, dim, bits) in the slice
                                   # (a Slice takes both lists when it stops)
        self.slicing = False
        self._undo = []

        step = model.paged_step

        def paged_step(pools, tables, lengths, tokens, n_valid, **kw):
            t = int(np.shape(tokens)[1])
            nv = np.array(n_valid, copy=True)
            if t > 1:
                with self.lock:
                    self.prefill_tokens += int(nv.sum())
            if self.slicing:   # each step makes one K3 call a layer
                self.k3_calls.append((np.array(lengths, copy=True), nv))
            if not self.trace:
                return step(pools, tables, lengths, tokens, n_valid, **kw)
            _sync(self.dev)
            t0 = time.monotonic()
            out = step(pools, tables, lengths, tokens, n_valid, **kw)
            _sync(self.dev)
            self.steps.append((t0, time.monotonic(), t, np.array(lengths, copy=True), nv))
            return out

        search = pipe.search_batch

        def search_batch(texts, k, **kw):
            t0 = time.monotonic()
            out = search(texts, k, **kw)
            self.searches.append((t0, time.monotonic(), len(texts)))
            return out

        self._set(model, "paged_step", paged_step, instance=True)
        self._set(pipe, "search_batch", search_batch, instance=True)
        if trace:
            packed = k1_mod.dirc_mac_packed

            def dirc_mac_packed(q_planes, d_planes, bits=8):
                if self.slicing:
                    b, _, nw = q_planes.shape
                    self.k1_calls.append((b, d_planes.shape[2], nw * 32, bits))
                return packed(q_planes, d_planes, bits=bits)

            self._set(k1_mod, "dirc_mac_packed", dirc_mac_packed)

    def _set(self, obj, name: str, fn, instance: bool = False) -> None:
        if instance:
            self._undo.append(lambda: obj.__dict__.pop(name, None))
        else:
            old = getattr(obj, name)
            self._undo.append(lambda: setattr(obj, name, old))
        setattr(obj, name, fn)

    def close(self) -> None:
        while self._undo:
            self._undo.pop()()


def _interval_union(iv: list) -> list:
    out: list = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap(iv: list, lo: float, hi: float) -> float:
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in iv)


class Slice:
    """A profiled slice of a traced run, [start_at, stop_at] on the host's
    monotonic clock. A run profiles up to three, and reads the latest one
    whose trace holds the steps' kernels: a profiler session now and then
    records a few kernels of a 3-s slice and loses the rest (on the card:
    6 ms busy in 3 s of steps), or none that fall inside it."""

    def __init__(self, rec: Recorder, start_at: float, stop_at: float):
        self.rec = rec
        self.start_at, self.stop_at = start_at, stop_at
        self.prof = None
        self.t0 = self.t1 = None
        self.mark: Optional[tuple] = None
        self.done = False
        self.k3_calls: list = []
        self.k1_calls: list = []
        self.why: Optional[str] = None

    @staticmethod
    def warm_up(dev: torch.device, tries: int = 3) -> None:
        """Profiler runs until one records the one kernel of an op: the
        first run of a process can record no device kernel at all."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        x = torch.ones(1024, device=dev)
        for _ in range(tries):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                x.mul_(1.0)
                _sync(dev)
            if any(e.device_type() == DeviceType.CUDA
                   for e in prof.profiler.kineto_results.events()):
                return

    def tick(self, now: float) -> None:
        if self.prof is None and not self.done and now >= self.start_at:
            self.start()
        elif self.prof is not None and now >= self.stop_at:
            self.stop()

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        before = time.monotonic_ns()
        with record_function("bench.mark"):
            pass
        self.mark = (before, time.monotonic_ns())
        self.rec.k3_calls, self.rec.k1_calls = [], []
        self.rec.slicing = True
        self.t0 = time.monotonic()

    def stop(self) -> None:
        if self.prof is None or self.done:
            return
        self.rec.slicing = False
        self.k3_calls, self.k1_calls = self.rec.k3_calls, self.rec.k1_calls
        _sync(self.rec.dev)
        self.t1 = time.monotonic()
        self.prof.__exit__(None, None, None)
        self.done = True

    def summary(self, cfg: dict, in_use: Optional[list] = None) -> Optional[dict]:
        """Busy time, kernel times, rooflines and idle gaps of the slice;
        None where the trace lost the steps' kernels (the card busy for
        under a tenth of the synchronised steps' time inside the slice),
        and `why` then says what the trace held.
        `in_use`: [(t0, t1)] host-clock intervals in which the engine held
        a request; the in-use idle share counts only those."""
        self.why = "not profiled"
        if self.prof is None or self.t1 is None:
            return None
        events = self.prof.profiler.kineto_results.events()
        kernels = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in events
                   if e.device_type() == torch.autograd.DeviceType.CUDA
                   and e.duration_ns() > 0]
        mark = next((e for e in events if e.name() == "bench.mark"), None)
        in_steps = _overlap([(s0, s1) for s0, s1, *_ in self.rec.steps], self.t0, self.t1)
        if mark is not None:
            out = self._read(cfg, kernels, mark.start_ns() - self.mark[0], in_steps, in_use)
            if out is not None:
                return out
        span = (max(b for *_, b in kernels) - min(a for _, a, _ in kernels)) / 1e9 if kernels else 0
        self.why = (f"{len(events)} events, {len(kernels)} kernels over {span:.3f} s, "
                    f"marker {'found' if mark is not None else 'missing'}, "
                    f"slice {self.t1 - self.t0:.3f} s, synchronised steps {in_steps:.3f} s")
        return None

    def _read(self, cfg: dict, kernels: list, offset: int, in_steps: float,
              in_use: Optional[list]) -> Optional[dict]:
        """The slice's readings, the trace's clock at `offset` ns from the
        host's monotonic clock (the marker ties them); None where the card
        reads busy for under a tenth of the synchronised steps."""
        lo = int(self.t0 * 1e9) + offset
        hi = int(self.t1 * 1e9) + offset
        kernels = [k for k in kernels if k[1] < hi and k[2] > lo]
        if not kernels:
            return None
        busy = _interval_union([(max(a, lo), min(b, hi)) for _, a, b in kernels])
        window = (hi - lo) / 1e9
        busy_s = sum(b - a for a, b in busy) / 1e9
        if busy_s < 0.1 * in_steps:
            return None
        by_name: dict = {}
        for name, a, b in kernels:
            by_name[name] = by_name.get(name, 0.0) + (min(b, hi) - max(a, lo)) / 1e9

        def device_s(prefixes) -> float:
            return sum(s for n, s in by_name.items() if any(p in n for p in prefixes))

        out = {"busy_s": busy_s, "window_s": window,
               "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
               "k3_device_s": device_s(K3_KERNELS), "k1_device_s": device_s(K1_KERNELS)}
        heads = (cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"])
        out["k3_bound_s"] = cfg["n_layers"] * sum(
            roofline.bound_s(*roofline.attend_work(ln, nv, *heads))
            for ln, nv in self.k3_calls)
        out["k1_bound_s"] = sum(
            roofline.bound_s(*roofline.k1_work(b, n, dim, bits), peak=roofline.INT8_OPS_PER_S)
            for b, n, dim, bits in self.k1_calls)
        # idle gaps, each named by the host span it falls in
        gaps, prev = [], lo
        for a, b in busy:
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        if hi > prev:
            gaps.append((prev, hi))
        spans = [("prefill_piece" if t > 1 else "decode_step",
                  int(s0 * 1e9) + offset, int(s1 * 1e9) + offset)
                 for s0, s1, t, _, _ in self.rec.steps]
        spans += [("search", int(s0 * 1e9) + offset, int(s1 * 1e9) + offset)
                  for s0, s1, _ in self.rec.searches]
        labels: dict = {}
        for a, b in gaps:
            mid = (a + b) // 2
            name = next((n for n, s0, s1 in spans if s0 <= mid < s1), "between_steps")
            labels[name] = labels.get(name, 0.0) + (b - a) / 1e9
        out["idle_gaps"] = sorted(labels.items(), key=lambda kv: -kv[1])[:10]
        if in_use is not None:
            use = _interval_union([(int(a * 1e9) + offset, int(b * 1e9) + offset)
                                   for a, b in in_use])
            use_s = sum(max(0, min(b, hi) - max(a, lo)) for a, b in use) / 1e9
            busy_use = sum(_overlap(busy, max(a, lo), min(b, hi)) for a, b in use
                           if b > lo and a < hi) / 1e9
            out["in_use_s"], out["busy_in_use_s"] = use_s, busy_use
        return out
