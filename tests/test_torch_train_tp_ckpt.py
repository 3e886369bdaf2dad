"""Checkpoints of the tensor-parallel train driver (`launch.train.train`
under a process group, `model_par` > 1) hold every tensor whole by port
name, the weights gathered over `model` and the AdamW state over every
mesh dim, so that a run saved at (data, model) = (1, 4) restores at (2,
2) and mesh-less, and a mesh-less one at (1, 4), bit for bit (spawned
gloo ranks, phi4-mini's smoke model with fp32 compute). The (1, 4)
run's losses and weights track the mesh-less run's, and a resumed step's
loss the uninterrupted one's, at ROADMAP T42's tolerances."""
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
        tmp = tmp_path_factory.mktemp("tp_ckpt")
        bare_dir, tp_dir = str(tmp / "bare"), str(tmp / "tp")
        saver = Ranks(train_whole, 4, str(tmp / "s14"), dict(KW, ckpt_dir=tp_dir, model_par=4))
        bare = train_mod.train(**dict(KW, ckpt_dir=bare_dir))
        bare5 = train_mod.train(**dict(KW, steps=5))
        saved14 = saver.results(timeout=150)[0]
        runs = {"bare": bare, "bare5": bare5, "saved14": saved14, "bare_dir": bare_dir,
                "tp_dir": tp_dir}
        at22 = Ranks(train_whole, 4, str(tmp / "r22"), dict(KW, ckpt_dir=tp_dir, model_par=2))
        at14 = Ranks(train_whole, 4, str(tmp / "r14"), dict(KW, ckpt_dir=bare_dir, model_par=4))
        resumed = train_mod.train(**dict(KW, ckpt_dir=tp_dir, steps=5, ckpt_every=100))
        runs["restored"] = train_mod.train(**dict(KW, ckpt_dir=tp_dir))
        runs.update(at22=at22.results(timeout=150)[0], at14=at14.results(timeout=150)[0],
                    resumed=resumed)
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


def test_saved_at_1_4_restores_at_2_2(runs):
    assert runs["at22"]["losses"] == []
    _equal(runs["at22"]["whole"], runs["tp_dir"])


def test_saved_mesh_less_restores_at_1_4(runs):
    _equal(runs["at14"]["whole"], runs["bare_dir"])


def test_saved_at_1_4_restores_mesh_less(runs):
    res = runs["restored"]
    assert res["losses"] == []
    whole = {"params": {k: v.detach().numpy() for k, v in res["model"].state_dict().items()},
             "step": int(res["opt"].step),
             **{t: {k: v.numpy() for k, v in getattr(res["opt"], t).items()}
                for t in ("master", "mu", "nu")}}
    _equal(whole, runs["tp_dir"])


def test_tp_run_tracks_the_mesh_less_run(runs):
    """ROADMAP T42: the (1, 4) run's first loss within 1e-5 of the
    mesh-less run's, later ones within 1e-4, its saved weights within
    2e-3, and the fifth step resumed mesh-less from its checkpoint within
    1e-4 of an uninterrupted mesh-less run's."""
    bare, tp = runs["bare"], runs["saved14"]
    assert len(tp["losses"]) == 4
    for i, (a, b) in enumerate(zip(tp["losses"], bare["losses"])):
        assert abs(a - b) <= (1e-5 if i == 0 else 1e-4) * b
    for k, v in tp["whole"]["params"].items():
        np.testing.assert_allclose(v, bare["model"].state_dict()[k].detach().numpy(),
                                   rtol=0, atol=2e-3, err_msg=k)
    assert len(runs["resumed"]["losses"]) == 1
    want = runs["bare5"]["losses"][4]
    assert abs(runs["resumed"]["losses"][0] - want) <= 1e-4 * want
