"""A run with the timed path broken underneath comes out not correct:
once for each fault a serving cell can have (a token altered where the
engine produces it; an answer, a retrieved document, altered where the
search produces it), and for a MoE model once for each fault of the
expert layer where it routes (the top-1 and top-2 gates swapped, every
expert index shifted by one, the gates left unnormalised). The chip's
look is skipped: the toy cells run on the CPU through the rest of a
run; the MoE faults run on the card too, at the MoE cell's own size."""
import json
import time

import numpy as np
import pytest
import torch

from bench.tests import _smoke


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return _smoke.make_root(tmp_path_factory.mktemp("bench"))


def _alter_tokens(monkeypatch):
    from repro_torch.serving.continuous_batching import ContinuousBatchingEngine

    orig = ContinuousBatchingEngine._sample
    calls = {"n": 0}

    def sample(self, logits):
        out = orig(self, logits)
        calls["n"] += 1
        if calls["n"] % 3 == 0:
            out = out.copy()
            out[0] = (out[0] + 1) % self.model.cfg.vocab_size
        return out

    monkeypatch.setattr(ContinuousBatchingEngine, "_sample", sample)


def _alter_answers(monkeypatch):
    from repro_torch.serving.rag_pipeline import RagPipeline

    orig = RagPipeline.search_batch

    def search_batch(self, texts, k, generator=None):
        ids, scores = orig(self, texts, k, generator=generator)
        return np.roll(ids, 1, axis=1), scores

    monkeypatch.setattr(RagPipeline, "search_batch", search_batch)


def _swap_gates(monkeypatch):
    from repro_torch.models import moe

    orig = moe.route

    def route(probs, k):
        vals, idx = orig(probs, k)
        return vals.flip(-1), idx

    monkeypatch.setattr(moe, "route", route)


def _shift_experts(monkeypatch):
    from repro_torch.models import moe

    orig = moe.route

    def route(probs, k):
        vals, idx = orig(probs, k)
        return vals, (idx + 1) % probs.shape[-1]

    monkeypatch.setattr(moe, "route", route)


def _unnormalised_gates(monkeypatch):
    """Each token's output times the sum of its top-k gates: the combine
    with the raw softmax gates in place of the normalised ones."""
    from repro_torch.models import moe

    orig = moe.apply_moe

    def apply_moe(cfg, p, x):
        y, aux = orig(cfg, p, x)
        xt = x.reshape(-1, x.shape[-1]).to(y.dtype)
        probs = torch.softmax((xt @ p.router.to(y.dtype)).float(), dim=-1)
        total = probs.topk(cfg.moe.top_k, dim=-1).values.sum(dim=-1)
        return (y.reshape(xt.shape) * total[:, None].to(y.dtype)).reshape(y.shape), aux

    monkeypatch.setattr(moe, "apply_moe", apply_moe)


MOE_FAULTS = [_swap_gates, _shift_experts, _unnormalised_gates]
MOE_IDS = ["gates-swapped", "experts-shifted", "gates-unnormalised"]


@pytest.mark.parametrize("fault", MOE_FAULTS, ids=MOE_IDS)
def test_a_moe_fault_is_not_correct(root, monkeypatch, fault):
    fault(monkeypatch)
    out = _smoke.run(root, "toy.closed")
    assert out["correct"] is False
    assert out["checks"]["logit_gap"]["value"] > out["checks"]["logit_gap"]["limit"]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2**31 + 201, 2**31 + 202, 2**31 + 203])
@pytest.mark.parametrize("fault", MOE_FAULTS, ids=MOE_IDS)
def test_a_moe_fault_is_not_correct_on_the_card(card, monkeypatch, fault, seed):
    from bench import run, spec

    fault(monkeypatch)
    cell = spec.cell("phi3.5-moe-rag.longform-closed")
    out = run.run_cell(cell, seed, 20.0, False, card, time.monotonic())
    print(json.dumps({"fault": fault.__name__, "seed": seed, "checks": out["checks"],
                      "compared": out["info"]["compared"]}), flush=True)
    assert out["correct"] is False


@pytest.mark.parametrize("cell", ["toy.open", "toy.closed"])
@pytest.mark.parametrize("fault,number", [(_alter_tokens, "logit_gap"),
                                          (_alter_answers, "search_gap")],
                         ids=["token", "answer"])
def test_a_fault_is_not_correct(root, monkeypatch, cell, fault, number):
    fault(monkeypatch)
    out = _smoke.run(root, cell)
    assert out["correct"] is False
    assert out["checks"][number]["value"] > out["checks"][number]["limit"]
