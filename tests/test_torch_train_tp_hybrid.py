"""Tensor-parallel training of the hybrid family over `model` on spawned
gloo ranks against world size 1 (`_torch_dist.tp_train`, ROADMAP T42's
tolerances: `_torch_tp.check_close`): zamba2's smoke model (its Mamba2
layers on each rank's heads, its one shared attention + MLP block
head-parallel and column / row-parallel, applied after every second
layer), and the same under full remat (the recompute issues the
forward's collectives again, T55), at (data, model) = (1, 2), (1, 4) and
(2, 2), fp32, 3 steps at lr 1e-2. World size 1 repeats the mesh-less
step bit for bit; the streamed init (`HybridLM.init_parts`) equals the
whole one; step 0 at (1, 4) and (2, 2) equals the reference's own
sharded train step on 4 host devices."""
import numpy as np
import pytest
import torch

from _torch_tp import MESHES, check_close, run
from _torch_train import check_step0, reference_result, start_reference_step0

NAMES = ["zamba2-2.7b", "zamba2-full-remat"]
REF_SHAPES = [(1, 4), (2, 2)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks of every mesh run `tp_train`, then at (1, 4) and (2, 2)
    the reference's weights and batch, while the reference's own step
    runs in a subprocess: all at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tmp = tmp_path_factory.mktemp("tp_hybrid")
        proc, ref_jobs = start_reference_step0(tmp, "zamba2-2.7b", REF_SHAPES)
        out = run(tmp, NAMES, {shape: (world, mp, NAMES)
                               for shape, (world, mp) in MESHES.items()},
                  {shape: [job] for shape, job in ref_jobs.items()})
        out["reference"] = reference_result(tmp, proc)
        return out
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("name", NAMES)
def test_world_size_1_is_the_mesh_less_step(runs, name):
    w1 = runs["world1"][name]
    loss, grads, metrics, params = runs["meshless"][name]
    assert w1["loss"] == loss and w1["metrics"] == metrics
    assert w1["split"] == []
    for k, g in grads.items():
        np.testing.assert_array_equal(w1["grads"][k], g, err_msg=k)
    for k, p in params.items():
        np.testing.assert_array_equal(w1["params"][k], p, err_msg=k)


@pytest.mark.parametrize("shape", list(MESHES), ids=lambda s: f"data{s[0]}-model{s[1]}")
@pytest.mark.parametrize("name", NAMES)
def test_tp_step_tracks_world_size_1(runs, name, shape):
    res = [r[name] for r in runs[shape]]
    assert {"blocks.0.mamba.in_x", "blocks.1.mamba.out_proj", "shared.wq", "shared.wk",
            "shared.wo", "shared.mlp.w_up", "shared.mlp.w_down"} <= set(res[0]["split"])
    check_close(res[0], runs["world1"][name])
    for r in res[1:]:      # every rank reports the same metrics
        assert r["metrics"] == res[0]["metrics"] and r["loss"] == res[0]["loss"]


@pytest.mark.parametrize("shape", list(MESHES), ids=lambda s: f"data{s[0]}-model{s[1]}")
@pytest.mark.parametrize("name", NAMES)
def test_streamed_init_is_the_whole_init(runs, name, shape):
    assert all(r[name]["init_equal"] for r in runs[shape])


@pytest.mark.parametrize("i", range(len(REF_SHAPES)),
                         ids=[f"data{d}-model{m}" for d, m in REF_SHAPES])
def test_step_0_matches_the_reference_4_devices(runs, i):
    shape = REF_SHAPES[i]
    check_step0(runs["reference"], [r[0] for r in runs[("extra", shape)]], "zamba2-2.7b",
                shape)
