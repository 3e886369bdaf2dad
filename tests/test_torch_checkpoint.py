"""The port's checkpoints: every case of tests/test_checkpoint.py, bf16
leaves bit for bit, a checkpoint read by the other package's restore
(the format is the same), the optimizer states' NamedTuples, and restore
onto a device."""
import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpointing import checkpoint as jax_ckpt
from repro_torch.checkpointing import CheckpointManager, StepWatchdog
from repro_torch.checkpointing import checkpoint as ckpt
from repro_torch.optim import adamw, quant_state


def _tree(rng):
    return {"a": torch.from_numpy(rng.normal(size=(8, 4)).astype(np.float32)),
            "nested": {"b": torch.arange(6, dtype=torch.int32),
                       "c": torch.from_numpy(rng.normal(size=(3,)).astype(np.float32))}}


def _leaves(t):
    return [leaf for _, leaf in ckpt._items(t)]


def test_save_restore_roundtrip(tmp_path, rng):
    t = _tree(rng)
    ckpt.save(str(tmp_path / "x"), t, step=7)
    r = ckpt.restore(str(tmp_path / "x"), t)
    for a, b in zip(_leaves(t), _leaves(r)):
        assert torch.equal(a, b) and a.dtype == b.dtype
    assert ckpt.load_manifest(str(tmp_path / "x"))["step"] == 7


def test_atomicity_no_partial_files(tmp_path, rng):
    ckpt.save(str(tmp_path / "x"), _tree(rng))
    assert glob.glob(str(tmp_path / "*.tmp.npz*")) == []


def test_shape_mismatch_rejected(tmp_path, rng):
    t = _tree(rng)
    ckpt.save(str(tmp_path / "x"), t)
    with pytest.raises(ValueError):
        ckpt.restore(str(tmp_path / "x"), dict(t, a=torch.zeros((2, 2))))
    with pytest.raises(KeyError, match="missing leaf"):
        ckpt.restore(str(tmp_path / "x"), dict(t, d=torch.zeros(2)))


def test_manager_rotation_and_latest(tmp_path, rng):
    t = _tree(rng)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (10, 20, 30, 40):
        mgr.save(s, t)
    assert mgr.all_steps() == [30, 40]
    step, _ = mgr.restore(t)
    assert step == 40
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(t)


def test_manager_async_snapshots_before_return(tmp_path, rng):
    """An async save writes the values as they were at `save`, even if the
    caller updates the tensors in place right after."""
    t = _tree(rng)
    want = {k: v.clone() for k, v in t.items() if isinstance(v, torch.Tensor)}
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=True)
    mgr.save(1, t)
    t["a"].add_(1.0)
    mgr.wait()
    assert mgr.latest_step() == 1
    _, r = mgr.restore(t)
    assert torch.equal(r["a"], want["a"])


def test_preemption_resume_ignores_garbage(tmp_path, rng):
    t = _tree(rng)
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(5, t)
    with open(os.path.join(str(tmp_path), "ckpt_0000000009.npz"), "wb") as f:
        f.write(b"garbage-no-manifest")
    assert mgr.latest_step() == 5


def test_restore_onto_device(tmp_path, rng):
    """`device=` puts every leaf on that device (the reference's elastic
    restore onto new shardings); by default a leaf goes where the
    target's leaf lives."""
    t = _tree(rng)
    ckpt.save(str(tmp_path / "x"), t, step=1)
    r = ckpt.restore(str(tmp_path / "x"), t, device="cpu")
    for a, b in zip(_leaves(t), _leaves(r)):
        assert torch.equal(a, b) and b.device.type == "cpu"
    # a target of shapes only (meta tensors) restores onto a real device
    meta = {"a": torch.empty((8, 4), device="meta"), "nested": t["nested"]}
    r = ckpt.restore(str(tmp_path / "x"), meta, device="cpu")
    assert torch.equal(r["a"], t["a"])


def test_bf16_bit_exact_and_readable_by_reference(tmp_path):
    """bf16 leaves are stored as their uint16 view with "bfloat16" in the
    manifest and come back bit for bit (NaN payloads and -0.0 included);
    the JAX package's restore reads the same files."""
    bits = np.array([0x0000, 0x8000, 0x3F80, 0x7FC1, 0xFF80, 0x0001, 0x7F7F], np.uint16)
    x = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    t = {"w": x, "f": torch.tensor([1.5, -2.0])}
    ckpt.save(str(tmp_path / "x"), t, step=3)
    assert ckpt.load_manifest(str(tmp_path / "x"))["keys"]["w"] == ["bfloat16", [7]]
    r = ckpt.restore(str(tmp_path / "x"), t)
    assert r["w"].dtype == torch.bfloat16
    assert np.array_equal(r["w"].view(torch.int16).numpy().view(np.uint16), bits)
    j = jax_ckpt.restore(str(tmp_path / "x"), {"f": jnp.zeros(2), "w": jnp.zeros(7, jnp.uint16)})
    np.testing.assert_array_equal(np.asarray(j["w"]), bits)
    np.testing.assert_array_equal(np.asarray(j["f"]), [1.5, -2.0])


def test_optimizer_states_round_trip(tmp_path):
    """AdamW and 8-bit AdamW states (NamedTuples, a QuantMoment's static
    size) restore into their own structure."""
    params = {"w": torch.randn(3, 100).bfloat16(), "b": torch.randn(100)}
    for mod in (adamw, quant_state):
        st = mod.init(params)
        st = st._replace(step=torch.tensor(4, dtype=torch.int32))
        ckpt.save(str(tmp_path / mod.__name__), {"params": params, "opt": st})
        r = ckpt.restore(str(tmp_path / mod.__name__), {"params": params, "opt": mod.init(params)})
        assert type(r["opt"]) is type(st) and int(r["opt"].step) == 4
        for a, b in zip(_leaves({"params": params, "opt": st}), _leaves(r)):
            assert torch.equal(a, b) and a.dtype == b.dtype
    assert r["opt"].nu["w"].size == 300


def test_watchdog_flags_stragglers(monkeypatch):
    w = StepWatchdog(factor=3.0)
    times = iter([0.0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 5.0])
    monkeypatch.setattr("time.monotonic", lambda: next(times))
    for step in range(3):
        w.start()
        w.stop(step)
    w.start()
    assert w.stop(3) is True
    assert w.stragglers and w.stragglers[0][0] == 3
