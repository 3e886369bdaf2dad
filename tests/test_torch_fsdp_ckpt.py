"""Checkpoints of `launch.train.train` under FSDP (over a process group
at (data, model) = (2, 2): each rank holds its data slice of every
weight the rules cut over `data`) hold every tensor whole by port name,
the weights gathered over `data` and `model` (`sharding.gather_whole`)
and the AdamW state over every mesh dim, so that the run restores at
(1, 4), at (4, 1) and mesh-less bit for bit (spawned gloo ranks,
phi4-mini's smoke model with fp32 compute). The (2, 2) run's losses and
weights track the mesh-less run's at ROADMAP T42's tolerances."""
import numpy as np
import pytest
import torch

from _torch_dist import Ranks, fp32_configs, train_whole
from repro_torch.checkpointing import CheckpointManager
from repro_torch.launch import train as train_mod

KW = dict(arch="phi4-mini-3.8b", smoke=True, steps=4, batch=4, seq=16, lr=1e-2,
          ckpt_every=4, log_every=100, device="cpu")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    n, get_config = torch.get_num_threads(), train_mod.get_config
    torch.set_num_threads(1)
    fp32_configs(train_mod)
    try:
        tmp = tmp_path_factory.mktemp("fsdp_ckpt")
        ckpt = str(tmp / "fsdp")
        saver = Ranks(train_whole, 4, str(tmp / "s22"), dict(KW, ckpt_dir=ckpt, model_par=2))
        bare = train_mod.train(**KW)
        runs = {"bare": bare, "saved22": saver.results(timeout=150)[0], "dir": ckpt}
        at14 = Ranks(train_whole, 4, str(tmp / "r14"), dict(KW, ckpt_dir=ckpt, model_par=4))
        at41 = Ranks(train_whole, 4, str(tmp / "r41"), dict(KW, ckpt_dir=ckpt, model_par=1))
        runs["restored"] = train_mod.train(**dict(KW, ckpt_dir=ckpt))
        runs.update(at14=at14.results(timeout=150)[0], at41=at41.results(timeout=150)[0])
        yield runs
    finally:
        torch.set_num_threads(n)
        train_mod.get_config = get_config


def _equal(whole: dict, ckpt_dir: str) -> None:
    """Every restored tensor equals the step-4 checkpoint's, as written."""
    mgr = CheckpointManager(ckpt_dir)
    assert mgr.latest_step() == 4 and whole["step"] == 4
    flat = dict(np.load(mgr._path(4) + ".npz"))
    for tree in ("params", "master", "mu", "nu"):
        prefix = "params" if tree == "params" else f"opt/{tree}"
        for k, v in whole[tree].items():
            np.testing.assert_array_equal(v, flat[f"{prefix}/{k}"], err_msg=f"{tree}/{k}")


def test_saved_at_2_2_is_the_run_gathered(runs):
    _equal(runs["saved22"]["whole"], runs["dir"])


@pytest.mark.parametrize("at", ["at14", "at41"])
def test_saved_at_2_2_restores_on_other_meshes(runs, at):
    assert runs[at]["losses"] == []
    _equal(runs[at]["whole"], runs["dir"])


def test_saved_at_2_2_restores_mesh_less(runs):
    res = runs["restored"]
    assert res["losses"] == []
    whole = {"params": {k: v.detach().numpy() for k, v in res["model"].state_dict().items()},
             "step": int(res["opt"].step),
             **{t: {k: v.numpy() for k, v in getattr(res["opt"], t).items()}
                for t in ("master", "mu", "nu")}}
    _equal(whole, runs["dir"])


def test_fsdp_run_tracks_the_mesh_less_run(runs):
    bare, run = runs["bare"], runs["saved22"]
    assert len(run["losses"]) == 4
    for i, (a, b) in enumerate(zip(run["losses"], bare["losses"])):
        assert abs(a - b) <= (1e-5 if i == 0 else 1e-4) * b
    for k, v in run["whole"]["params"].items():
        np.testing.assert_allclose(v, bare["model"].state_dict()[k].detach().numpy(),
                                   rtol=0, atol=2e-3, err_msg=k)
