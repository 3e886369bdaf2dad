"""Shared pieces of the FSDP train-step tests
(tests/test_torch_fsdp_train*.py): the meshes, the ranks' run and the
checks against world size 1 (see test_torch_fsdp_train.py)."""
import numpy as np
import torch

from _torch_tp import check_close, run

MESHES = {(2, 2): (4, 2), (4, 1): (4, 1)}    # (data, model) -> (world, model_par)
MESH_IDS = [f"data{d}-model{m}" for d, m in MESHES]


def runs(tmp, names: list) -> dict:
    """`_torch_tp.run` of `names` at every mesh, one torch thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return run(tmp, names, {shape: (world, mp, names)
                                for shape, (world, mp) in MESHES.items()})
    finally:
        torch.set_num_threads(n)


def check_world_size_1(runs: dict, name: str) -> None:
    """World size 1 is the mesh-less step bit for bit, nothing cut, no
    collective."""
    w1 = runs["world1"][name]
    loss, grads, metrics, params = runs["meshless"][name]
    assert w1["loss"] == loss and w1["metrics"] == metrics
    assert w1["split"] == [] and w1["fsdp"] == []
    assert w1["collectives"]["total_bytes"] == 0
    for k, g in grads.items():
        np.testing.assert_array_equal(w1["grads"][k], g, err_msg=k)
    for k, p in params.items():
        np.testing.assert_array_equal(w1["params"][k], p, err_msg=k)


def check_tracks_world_size_1(runs: dict, name: str, shape: tuple) -> None:
    """Something is cut over `data`, rank 0 holds T42 against world size 1,
    and every rank reports the same metrics."""
    res = [r[name] for r in runs[shape]]
    assert res[0]["fsdp"], "nothing was cut over data"
    check_close(res[0], runs["world1"][name])
    for r in res[1:]:
        assert r["metrics"] == res[0]["metrics"] and r["loss"] == res[0]["loss"]
        assert r["fsdp"] == res[0]["fsdp"]


def check_gathers(runs: dict, name: str, shape: tuple) -> None:
    """A step gathers every FSDP-cut weight at least once (forward) and
    reduce-scatters the gradient of each gather (backward)."""
    for r in runs[shape]:
        c, n = r[name]["collectives"], len(r[name]["fsdp"])
        assert c["all-gather"]["count"] >= n
        assert c["reduce-scatter"]["count"] >= n


def check_streamed_init(runs: dict, name: str, shape: tuple) -> None:
    """The seeded init streamed into the shards is the whole init's (T59)."""
    assert all(r[name]["init_equal"] for r in runs[shape])
