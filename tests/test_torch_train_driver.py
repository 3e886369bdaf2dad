"""The port's `launch.train.train` on the CPU: it learns (the reference's
`test_training_learns`), resume from a checkpoint reproduces the
uninterrupted losses exactly, async checkpoints and the CLI run, and the
refusals raise."""
import numpy as np
import pytest
import torch

from _torch_train import one_torch_thread  # noqa: F401
from repro_torch.checkpointing import CheckpointManager
from repro_torch.launch import train as train_mod
from repro_torch.launch.train import audio_frames, train


def test_training_learns():
    out = train("phi4-mini-3.8b", smoke=True, steps=60, batch=16, seq=64, lr=1e-2,
                ckpt_dir=None, log_every=1000, device="cpu")
    first, last = np.mean(out["losses"][:5]), np.mean(out["losses"][-5:])
    assert last < first - 0.15, (first, last)
    assert len(out["step_ms"]) == len(out["grad_norms"]) == 60
    assert out["final_loss"] == out["losses"][-1]


class _Preempted(Exception):
    pass


@pytest.mark.parametrize("async_ckpt", [False, True])
def test_preemption_resume_bit_exact(tmp_path, monkeypatch, async_ckpt):
    """12 steps straight through against a run preempted at step 8 (its
    last checkpoint at step 6, the next not yet written) and resumed: the
    resumed run repeats steps 6-11 with the same losses, bit for bit, and
    ends with the same weights and optimizer state."""
    kw = dict(smoke=True, steps=12, batch=4, seq=32, lr=5e-3, log_every=1000,
              device="cpu")
    d = str(tmp_path / "ckpt")
    full = train("mamba2-2.7b", **kw)
    batch_at = train_mod.DataPipeline.batch_at

    def preempt_at_8(self, step):
        if step == 8:
            raise _Preempted
        return batch_at(self, step)
    monkeypatch.setattr(train_mod.DataPipeline, "batch_at", preempt_at_8)
    with pytest.raises(_Preempted):
        train("mamba2-2.7b", ckpt_dir=d, ckpt_every=3, async_ckpt=async_ckpt, **kw)
    monkeypatch.setattr(train_mod.DataPipeline, "batch_at", batch_at)
    assert CheckpointManager(d).all_steps() == [3, 6]
    resumed = train("mamba2-2.7b", ckpt_dir=d, ckpt_every=100, async_ckpt=async_ckpt, **kw)
    assert resumed["losses"] == full["losses"][6:]
    for (k, a), b in zip(full["model"].state_dict().items(),
                         resumed["model"].state_dict().values()):
        assert torch.equal(a, b), k
    for name in ("master", "mu", "nu"):
        for k, v in getattr(full["opt"], name).items():
            assert torch.equal(v, getattr(resumed["opt"], name)[k]), (name, k)
    assert int(resumed["opt"].step) == 12


def test_audio_training_and_frames():
    """The audio family trains on per-step frames from a generator seeded
    with the step: the same step gives the same frames."""
    out = train("whisper-small", smoke=True, steps=3, batch=2, seq=16, log_every=1000,
                device="cpu")
    assert all(np.isfinite(out["losses"]))
    cfg = out["model"].cfg
    a = audio_frames(cfg, 2, 5, torch.device("cpu"))
    assert a.dtype == torch.bfloat16 and a.shape == (2, cfg.encoder.n_frames,
                                                     cfg.encoder.d_model)
    assert torch.equal(a, audio_frames(cfg, 2, 5, torch.device("cpu")))
    assert not torch.equal(a, audio_frames(cfg, 2, 6, torch.device("cpu")))


def test_refusals():
    # model parallelism needs a process group (the sharded runs are in
    # test_torch_train_mesh.py)
    with pytest.raises(ValueError, match="init_distributed"):
        train("phi4-mini-3.8b", steps=1, model_par=2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train("phi4-mini-3.8b", steps=1)
    with pytest.raises(KeyError):
        train("no-such-arch", steps=1, device="cpu")


def test_cli(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr("sys.argv", ["train", "--arch", "zamba2-2.7b", "--steps", "3",
                                     "--batch", "2", "--seq", "16", "--device", "cpu",
                                     "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"])
    train_mod.main()
    out = capsys.readouterr().out
    assert "step     0 loss" in out and "done: final loss" in out
    assert CheckpointManager(str(tmp_path)).latest_step() == 2
