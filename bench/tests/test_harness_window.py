"""The window's arithmetic: a tail over every request due, failures past
every limit, and a stall inside the window moving the tail and the rate."""
import types

import pytest

from bench import readers
from bench.harness import Record
from bench.tests import _smoke
from bench.traffic import Request


def _run(latencies, failed=()):
    recs = []
    for i, lat in enumerate(latencies):
        gen = types.SimpleNamespace(submit_time=float(i), first_token_s=lat,
                                    wait_s=2 * lat, tokens=[1], _error=None)
        r = Record(req=Request(i, 0, "q", 1, 1), due=float(i), gen=gen, finished=i + 2 * lat)
        if i in failed:
            r.error = "failed"
        recs.append(r)
    return types.SimpleNamespace(records=recs)


def test_tail_is_nearest_rank_over_every_request_due():
    run = _run([0.1 * (i + 1) for i in range(20)])
    assert readers.tail_ms(run, "first", 95) == pytest.approx(1900.0)
    assert readers.tail_ms(run, "last", 95) == pytest.approx(3800.0)
    failed = _run([0.1 * (i + 1) for i in range(20)], failed={0})
    assert readers.tail_ms(failed, "first", 95) == pytest.approx(2000.0)
    assert readers.tail_ms(_run([0.1] * 20, failed={3}), "first", 100) == readers.INF_MS


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return _smoke.make_root(tmp_path_factory.mktemp("bench"))


def _stall(monkeypatch, seconds):
    """The model's steps stop for `seconds` once, a second into the window."""
    import time

    from repro_torch.models.transformer import DecoderLM

    orig = DecoderLM.paged_step
    state = {"t0": None, "done": False}

    def step(self, *a, **kw):
        now = time.monotonic()
        if state["t0"] is None:
            state["t0"] = now
        if not state["done"] and now - state["t0"] > 1.0:
            state["done"] = True
            time.sleep(seconds)
        return orig(self, *a, **kw)

    monkeypatch.setattr(DecoderLM, "paged_step", step)


def test_a_stall_moves_the_open_loops_tail(root, monkeypatch):
    base = _smoke.run(root, "toy.open", seconds=4.0)
    _stall(monkeypatch, 1.5)
    stalled = _smoke.run(root, "toy.open", seconds=4.0)
    assert base["correct"] and stalled["correct"]
    assert (stalled["metrics"]["ttft_p90_ms"]["value"]
            > base["metrics"]["ttft_p90_ms"]["value"] + 500)


def test_a_stall_moves_the_closed_loops_rate(root, monkeypatch):
    base = _smoke.run(root, "toy.closed", seconds=4.0)
    _stall(monkeypatch, 2.0)
    stalled = _smoke.run(root, "toy.closed", seconds=4.0)
    assert stalled["metrics"]["tok_s"]["value"] < 0.8 * base["metrics"]["tok_s"]["value"]
