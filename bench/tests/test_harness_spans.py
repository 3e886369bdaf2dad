"""The port's spans read in a run of a cell (`bench/spans.py`): on a
trace made by hand, each kernel is charged to the span that holds its
launch on the launching thread (by correlation id), and the idle and MoE
shares read what the trace holds; on the toy CPU cell an unprofiled run
prints the program-span readings, a profiled one only what its slice
gives, and every finished request's TTFT parts add up to its TTFT."""
import subprocess
import sys
import time
import types

import pytest
import torch

from bench import spans
from bench.tests import _smoke

OFFSET = 7_000          # trace clock - host clock, ns
HOST0 = 5_000_000_000   # host ns of the slice's start
US = 1_000
IDENT = {1: 0x7FB8_0000_1234, 2: 0x7FB8_F6BF_F640}   # pthread_t of threads 1 and 2


def _span(sid, name, tid, a, b, parent=None, rid=None):
    return types.SimpleNamespace(sid=sid, name=name, tid=tid, ident=IDENT[tid],
                                 t0=HOST0 + a * US, t1=HOST0 + b * US, parent=parent, rid=rid)


# engine thread 1: a decode step; scheduler thread 2: a flush's search
SPANS = [_span(1, "engine.step", 1, 0, 100), _span(2, "engine.decode", 1, 10, 90, 1),
         _span(3, "engine.forward", 1, 20, 70, 2), _span(4, "model.forward", 1, 20, 70, 3),
         _span(5, "model.moe", 1, 40, 60, 4), _span(6, "engine.sample", 1, 70, 85, 2),
         _span(7, "sched.flush", 2, 30, 80), _span(8, "rag.search", 2, 35, 50, 7)]


class Event:
    def __init__(self, name, start, dur, corr, cuda, tid=0):
        self._v = (name, start, dur, corr, cuda, tid)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def correlation_id(self):
        return self._v[3]

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._v[4] else torch.autograd.DeviceType.CPU

    def device_resource_id(self):
        return self._v[5]


def _at(us):
    return HOST0 + us * US + OFFSET        # host us -> trace ns


# (name, launched by thread, at host us, runs from / to host us, correlation id);
# a launch names thread 1 by its native id, thread 2 as CUPTI does an
# unknown thread (its pthread_t's low 32 bits, signed)
KERNELS = [("gemm", 1, 25, 25, 45, 11),       # in model.forward
           ("expert", 1, 45, 50, 65, 12),     # in model.moe
           ("topk", 2, 45, 66, 68, 13),       # in rag.search, another thread, same time
           ("copy", 1, 95, 95, 98, 14),       # in the step only
           ("lost", 1, 30, 98, 99, 99),       # no launch recorded
           ("other", 3, 30, 99, 100, 15)]     # a thread with no spans


def _events():
    # CPU ops number their correlation ids apart from CUPTI's: aten::mm's 11
    # is not gemm's launch
    ev = [Event("bench.mark", _at(0), 1, 1, cuda=False, tid=1),
          Event("aten::mm", _at(90), 5, 11, cuda=False, tid=1),
          Event("cudaDeviceSynchronize", _at(96), 5, 16, cuda=False, tid=1)]
    launcher = {1: 1, 2: 0xF6BF_F640 - (1 << 32), 3: 3}
    for name, tid, at, a, b, corr in KERNELS:
        ev.append(Event(name, _at(a), (b - a) * US, corr, cuda=True))
        if corr != 99:
            ev.append(Event("cudaLaunchKernel" if tid != 1 else "cuLaunchKernel", _at(at),
                            2 * US, corr, cuda=False, tid=launcher[tid]))
    return ev


def _traced():
    sl = types.SimpleNamespace(
        prof=types.SimpleNamespace(profiler=types.SimpleNamespace(
            kineto_results=types.SimpleNamespace(events=_events))),
        mark=(HOST0, HOST0), t0=HOST0 / 1e9, t1=(HOST0 + 100 * US) / 1e9)
    return spans.Traced(spans=SPANS, counters={}, t_open=0.0, t_close=1e9, requests=[],
                        device=spans.device_of(sl))


def test_each_kernel_is_charged_to_the_span_that_launched_it():
    tr = _traced()
    assert tr.device.offset == OFFSET
    assert tr.device.lo == _at(0) and tr.device.hi == _at(100)
    owners = [s.name if s is not None else None for s in spans.charge(tr)]
    assert owners == ["model.forward", "model.moe", "rag.search", "engine.step", None, None]
    assert spans.launches_placed_pct(tr) == pytest.approx(400 / 6)


def test_forward_idle_moe_share_and_idle_by_span_read_the_trace():
    tr = _traced()
    # busy 20 + 15 + 2 + 3 + 1 + 1 us; model.forward 50 us, 37 of them busy
    assert spans.forward_idle_pct(tr) == pytest.approx(100 * 13 / 50)
    assert spans.moe_device_pct(tr) == pytest.approx(100 * 15 / 42)
    got = dict(spans.idle_by_span(tr))
    want = {"engine.decode": 25, "model.moe": 5, "model.forward": 1, "engine.sample": 27}
    assert got == pytest.approx({k: v * US / 1e9 for k, v in want.items()})
    assert "between_spans" not in got


def test_innermost_is_the_deepest_open_span():
    times, owners = spans.innermost([s for s in SPANS if s.tid == 1])
    at = {us: spans._at((times, owners), HOST0 + us * US) for us in (-1, 5, 15, 30, 50, 65,
                                                                     75, 95, 101)}
    assert {k: v.name if v else None for k, v in at.items()} == {
        -1: None, 5: "engine.step", 15: "engine.decode", 30: "model.forward",
        50: "model.moe", 65: "model.forward", 75: "engine.sample", 95: "engine.step",
        101: None}


def test_step_host_and_in_flush_read_the_spans():
    tr = spans.Traced(spans=SPANS + [_span(9, "model.forward", 1, 110, 130)],
                      counters={}, t_open=0.0, t_close=1e9, requests=[])
    # the step's 100 us less its forward (50) and sample (15)
    assert spans.step_host_ms(tr) == pytest.approx(35 * US / 1e6)
    # the flush (30-80 us) runs beside 40 of the forwards' 70 us
    assert spans.forward_in_flush_pct(tr) == pytest.approx(100 * 40 / 70)
    assert spans.forward_idle_pct(tr) is None        # no slice
    assert spans.forwards(tr, "engine.decode") == pytest.approx(
        {"n": 1, "wall_ms": 0.05, "in_flush_ms": 0.04})
    assert spans.forwards(tr, "engine.piece") is None


def test_a_decode_forward_reads_its_busy_time():
    tr = _traced()
    assert spans.forwards(tr, "engine.decode") == pytest.approx(
        {"n": 1, "wall_ms": 0.05, "in_flush_ms": 0.04, "busy_ms": 0.037})


@pytest.fixture(scope="module")
def toy_root(tmp_path_factory):
    return _smoke.make_root(tmp_path_factory.mktemp("spans"))


@pytest.fixture(scope="module")
def toy_open(toy_root):
    from bench import spec

    cell = spec.cell("toy.open", toy_root)
    return spans.run_with_spans(cell, 2**31 + 23, 3.0, False, torch.device("cpu"),
                                time.monotonic(), root=toy_root)


def test_a_toy_run_prints_the_program_span_readings(toy_open):
    out, tr = toy_open
    assert out["correct"] and out["failed"] == 0
    for name in ("admit_wait_ms", "prefill_interleave_pct", "embed_ms", "step_host_ms",
                 "forward_in_flush_pct"):
        assert name + ".open" in out["metrics"], name
    assert "ttft_p90_ms" in out["metrics"]
    m = out["metrics"]
    assert 0 <= m["prefill_interleave_pct.open"]["value"] <= 100
    assert 0 <= m["forward_in_flush_pct.open"]["value"] <= 100
    assert m["admit_wait_ms.open"]["value"] >= 0
    assert out["info"]["trace"]["spans"] == len(tr.spans) > 0
    assert out["info"]["trace"]["counters"] == {}
    assert out["info"]["ttft_parts_ms"]            # the tail, split
    dec = out["info"]["trace"]["decode_forward"]
    assert dec["n"] > 0 and dec["wall_ms"] > 0 and "busy_ms" not in dec
    assert "breakdown" not in out


def test_a_profiled_toy_run_prints_no_program_span_reading(toy_root):
    from bench import spec

    cell = spec.cell("toy.open", toy_root)
    out, tr = spans.run_with_spans(cell, 2**31 + 29, 3.0, True, torch.device("cpu"),
                                   time.monotonic(), root=toy_root)
    assert out["correct"] and tr.spans
    assert "decode_step_ms.open" in out["metrics"]
    assert not any(k.startswith(tuple(spans.PROGRAM)) for k in out["metrics"])
    assert "ttft_parts_ms" not in out["info"]
    assert tr.device is None                    # no card: no kernel to read


def test_spans_refuses_as_run_does_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    res = subprocess.run([sys.executable, "bench/spans.py", "--workload",
                          "phi4-mini-rag.docqa-open", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=_smoke.ROOT, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 2 and res.stdout == ""
    assert "CUDA" in res.stderr


def test_ttft_parts_add_up_to_each_finished_requests_ttft(toy_open):
    _, tr = toy_open
    finished = [r for r in tr.requests if r.ok]
    assert finished
    for r in finished:
        parts = spans.ttft_parts_ms(tr, r)
        assert parts is not None
        assert sum(parts[k] for k in spans.PARTS) == pytest.approx(parts["ttft"], abs=1.0)
        assert parts["ttft"] == pytest.approx((r.first - r.due) * 1e3)
        assert all(parts[k] >= -1e-6 for k in spans.PARTS), parts
        assert parts["flush_embed"] + parts["flush_search"] <= parts["flush"] + 1e-6
        assert parts["prompts"] > 0                  # its own prompt at least


@pytest.mark.cuda
def test_the_moe_cell_charges_a_share_of_the_card_to_the_moe_layer(card):
    """24 s: three profiled slices, of which the latest whole one is read."""
    from bench import spec

    cell = spec.cell("phi3.5-moe-rag.longform-closed")
    out, tr = spans.run_with_spans(cell, 2**31 + 301, 24.0, True, card, time.monotonic())
    assert out["failed"] == 0
    assert tr.device is not None, "every profiled slice lost its kernels"
    assert 0 < out["metrics"]["moe_device_pct.moe"]["value"] < 100
    assert 0 <= out["metrics"]["forward_idle_pct.moe"]["value"] < 100
    assert out["info"]["trace"]["launches_placed_pct"] > 90
