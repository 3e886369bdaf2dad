"""FSDP under a `pod` axis: the train step on 4 spawned gloo ranks over
(pod, data, model) = (2, 2, 1) against world size 1, phi4-mini's fp32
smoke model, 3 steps at lr 1e-2, at ROADMAP T42's tolerances
(`_torch_tp.check_close`). The rules cut weights over `data` only, so
each weight is held as a half, replicated over `pod`: its gradient
leaves the backward reduce-scattered over `data` and is summed over
`pod` in the update (the batch is split over both)."""
import pytest
import torch

from _torch_dist import Ranks, jobs, tp_train
from _torch_tp import OCFG, cases, check_close
from repro_torch.launch.mesh import distributed

NAME = "phi4-mini-3.8b"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tmp = tmp_path_factory.mktemp("fsdp_pod")
        todo = cases([NAME])
        ranks = Ranks(jobs, 4, str(tmp / "store"), [(tp_train, (1, todo, OCFG, 2))])
        with distributed(0, 1, store_path=str(tmp / "store1"), device="cpu"):
            world1 = tp_train(0, 1, 1, todo, OCFG)
        return world1, [r[0] for r in ranks.results(timeout=150)]
    finally:
        torch.set_num_threads(n)


def test_pod_data_step_tracks_world_size_1(runs):
    world1, res = runs
    got = [r[NAME] for r in res]
    assert got[0]["fsdp"] and not got[0]["split"]
    check_close(got[0], world1[NAME])
    for r in got[1:]:
        assert r["metrics"] == got[0]["metrics"] and r["loss"] == got[0]["loss"]
    # one reduce-scatter over `data` a gather; the pod sum is DTensor's, not spmd's
    c = got[0]["collectives"]
    assert c["reduce-scatter"]["count"] >= len(got[0]["fsdp"])
    assert all(r[NAME]["init_equal"] for r in res)
