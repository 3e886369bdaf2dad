"""Tensor-parallel training of the MoE family over `model` (experts cut
over `model`, the router whole on every rank) and over a data axis
(routing over the global batch) on spawned gloo ranks at (data, model)
= (1, 2), (1, 4), (2, 1) and (2, 2), against world size 1 at ROADMAP
T42's tolerances (`_torch_tp.check_close`): phi3.5-moe (4 experts,
top-2) and arctic (8 experts and its dense residual MLP). A rank's
combine reaches only its experts, so the gradients of the router and of
the input through the gates are partial and are summed over `model`;
the aux losses are computed whole on every rank, and their gradient
must join that sum once. Over a data axis every rank's loss carries the
same global aux weighted by its label share, and the aux statistic's
backward sums those shares (`sharding.row_sum`). `moe-aux` weighs the
load-balance loss 10: with its gradient summed once a `model` rank, or
taken at each data rank's share alone, the router's gradient would be
off by far more than the tolerance (checked against the mesh-less
gradient with the weight multiplied by `model`, and divided by `data`)."""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_tp import MESHES, check_close, config, meshless, run, state, batches

NAMES = ["phi3.5-moe-42b-a6.6b", "arctic-480b", "moe-aux"]
SHAPES = [(1, 2), (1, 4), (2, 1), (2, 2)]
WORLDS = {**MESHES, (2, 1): (2, 1)}   # (data, model) -> (world, model_par)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return run(tmp_path_factory.mktemp("tp_moe"), NAMES,
                   {shape: (*WORLDS[shape], NAMES) for shape in SHAPES})
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("name", NAMES)
def test_world_size_1_is_the_mesh_less_step(runs, name):
    w1 = runs["world1"][name]
    loss, grads, metrics, params = runs["meshless"][name]
    assert w1["loss"] == loss and w1["metrics"] == metrics
    for k, g in grads.items():
        np.testing.assert_array_equal(w1["grads"][k], g, err_msg=k)
    for k, p in params.items():
        np.testing.assert_array_equal(w1["params"][k], p, err_msg=k)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"data{s[0]}-model{s[1]}")
@pytest.mark.parametrize("name", NAMES)
def test_tp_step_tracks_world_size_1(runs, name, shape):
    res = [r[name] for r in runs[shape]]
    if shape[1] > 1:
        assert {"blocks.0.moe.w_gate", "blocks.0.moe.w_down"} <= set(res[0]["split"])
    assert "blocks.0.moe.router" not in res[0]["split"]
    check_close(res[0], runs["world1"][name])
    for r in res[1:]:
        assert r["metrics"] == res[0]["metrics"]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"data{s[0]}-model{s[1]}")
def test_aux_gradient_enters_once(runs, shape):
    """The router's gradient at (data d, `model` m) equals world size 1's,
    and is far from what an aux gradient counted m times (once a `model`
    rank), or taken at about 1 / d (each data rank's label share alone),
    would give."""
    d, m = shape
    got = runs[shape][0]["moe-aux"]["grads"]
    want = runs["world1"]["moe-aux"]["grads"]
    cfg = config("moe-aux")
    wrong = []
    for factor in {m, 1 / d} - {1}:
        heavy = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, aux_loss_weight=factor * cfg.moe.aux_loss_weight))
        wrong.append(meshless(heavy, state(cfg), batches(cfg), grads_only=True)[1])
    assert wrong
    for k in ("blocks.0.moe.router", "blocks.1.moe.router"):
        scale = float(np.abs(want[k]).max())
        assert float(np.abs(got[k] - want[k]).max()) <= 5e-5 * scale, k
        for w in wrong:
            assert float(np.abs(w[k] - want[k]).max()) > 100 * 5e-5 * scale, k
