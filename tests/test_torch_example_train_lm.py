"""`examples_torch/train_lm.py` against `examples/train_lm.py`: the
printed parameter count of the 100M config is identical; with
`CFG_100M` narrowed on both modules (2 layers, d 64, and a vocabulary of
256, over which STEPS steps of 64 tokens see each token ~30 times: at
4096 neither package's loss moves in that many steps) both examples run
their drivers at b 2 x s 32: the batches the twin's driver trains on
equal the reference driver's, the twin's loss falls, both log and
checkpoint at the same steps (every 20 and every 100), and the final
line has the reference's form. The example's own b 8 x s 256 batches over
4096 tokens are held against the reference pipeline's directly."""
import dataclasses
import re
import sys

import numpy as np
import pytest

from _torch_examples import one_thread, printed, reference, twin
from repro.checkpointing import CheckpointManager as JaxManager
from repro.data import pipeline as jax_pipeline
from repro_torch.checkpointing import CheckpointManager
from repro_torch.data import pipeline as torch_pipeline

STEPS, B, S = 120, 2, 32
RECORDED = 3            # steps whose batches are recorded


def _narrow(cfg):
    return dataclasses.replace(cfg, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                               head_dim=16, d_ff=128, vocab_size=256)


def _recording(monkeypatch, cls, into: list):
    real = cls.batch_at

    def batch_at(self, step):
        out = real(self, step)
        if step < RECORDED:
            into.append({k: np.asarray(v).copy() for k, v in out.items()})
        return out
    monkeypatch.setattr(cls, "batch_at", batch_at)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_lm")
    ref, tw = reference("train_lm"), twin("train_lm")
    full = (ref.CFG_100M.param_count(), tw.CFG_100M.param_count())
    ref.CFG_100M, tw.CFG_100M = _narrow(ref.CFG_100M), _narrow(tw.CFG_100M)
    batches = {"ref": [], "twin": []}
    args = ["--steps", str(STEPS), "--batch", str(B), "--seq", str(S)]
    with pytest.MonkeyPatch.context() as mp:
        _recording(mp, jax_pipeline.DataPipeline, batches["ref"])
        _recording(mp, torch_pipeline.DataPipeline, batches["twin"])
        mp.setattr(sys, "argv", ["train_lm.py", *args, "--ckpt-dir", str(tmp / "ref")])
        _, ref_lines = printed(ref.main)
        with one_thread():
            out, lines = printed(tw.main, [*args, "--ckpt-dir", str(tmp / "twin"),
                                           "--device", "cpu"])
    return {"full": full, "ref": ref_lines, "lines": lines, "out": out, "batches": batches,
            "ckpt": (JaxManager(str(tmp / "ref")).all_steps(),
                     CheckpointManager(str(tmp / "twin")).all_steps())}


def test_parameter_count_identical(runs):
    ref_count, twin_count = runs["full"]
    assert ref_count == twin_count
    assert runs["ref"][0] == runs["lines"][0] == \
        f"model: {runs['out']['param_count'] / 1e6:.1f}M params"


def test_driver_batches_equal_the_reference_pipeline(runs):
    want, got = runs["batches"]["ref"], runs["batches"]["twin"]
    assert len(want) == len(got) == RECORDED
    for w, g in zip(want, got):
        assert set(w) == set(g) and g["tokens"].shape == (B, S)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    jp = jax_pipeline.DataPipeline(4096, batch=8, seq=256, seed=0)   # the example's shape
    tp = torch_pipeline.DataPipeline(4096, batch=8, seq=256, seed=0)
    for step in range(RECORDED):
        w, g = jp.batch_at(step), tp.batch_at(step)
        for k in w:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]), err_msg=k)


def test_loss_falls(runs):
    losses = runs["out"]["losses"]
    assert len(losses) == STEPS and np.isfinite(losses).all()
    assert np.mean(losses[-10:]) < losses[0] - 0.2     # ~0.37 nats when written


def test_logs_and_checkpoints_at_the_reference_cadence(runs):
    def logged(lines):
        return [int(m.group(1)) for m in (re.match(r"step +(\d+) loss ", x) for x in lines) if m]
    assert logged(runs["lines"]) == logged(runs["ref"]) == list(range(0, STEPS, 20))
    assert runs["ckpt"][0] == runs["ckpt"][1] == [100]
    final = re.compile(r"final loss: \d+\.\d{4} \(start \d+\.\d{4}, bigram floor ~3\.1\)$")
    assert final.match(runs["ref"][-1]) and final.match(runs["lines"][-1])
    assert runs["lines"][-1].startswith(f"final loss: {runs['out']['final_loss']:.4f} ")
