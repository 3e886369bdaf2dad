"""The profiled slice's reading from a trace, on a trace made by hand:
the card's busy time inside the slice, its clock tied to the host's by
the marker, and what a slice that lost its kernels says."""
import types

import pytest
import torch

from bench import trace

CFG = {"n_heads": 4, "n_kv_heads": 2, "head_dim": 16, "n_layers": 2}


class Event:
    def __init__(self, name, start, dur, cuda=True):
        self._n, self._s, self._d, self._c = name, start, dur, cuda

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._c else torch.autograd.DeviceType.CPU


def _slice(events, t0=100.0, t1=103.0, mark_host_ns=None):
    """A stopped slice over host seconds [t0, t1] whose steps fill it."""
    rec = types.SimpleNamespace(steps=[(t0, t1, 1, [8], [1])], searches=[], dev=None)
    sl = trace.Slice(rec, t0, t1)
    sl.t0, sl.t1, sl.done = t0, t1, True
    sl.mark = (mark_host_ns if mark_host_ns is not None else int(t0 * 1e9),) * 2
    sl.prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    return sl


def _kernels(start_ns, n=30, every=100_000_000, dur=50_000_000):
    return [Event("paged_attend_bf16", start_ns + i * every, dur) for i in range(n)]


@pytest.mark.parametrize("shift_s", [0.0, 7.5])
def test_busy_half_of_a_slice(shift_s):
    """Kernels fill half of each 0.1 s of a 3-s slice; the marker ties the
    trace's clock (shifted by `shift_s`) to the host's."""
    base = int(100.0 * 1e9) + int(shift_s * 1e9)
    events = [Event("bench.mark", base, 1000, cuda=False)] + _kernels(base)
    out = _slice(events).summary(CFG)
    assert out["busy_s"] == pytest.approx(1.5, abs=1e-6)
    assert out["window_s"] == pytest.approx(3.0, abs=1e-6)


def test_a_trace_that_lost_its_kernels_reads_nothing_and_says_why():
    base = int(100.0 * 1e9)
    events = [Event("bench.mark", base, 1000, cuda=False)] + _kernels(base, n=2, dur=1_000_000)
    sl = _slice(events)
    assert sl.summary(CFG) is None
    assert "2 kernels" in sl.why and "marker found" in sl.why
