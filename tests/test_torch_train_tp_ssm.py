"""Tensor-parallel training of the SSM family over `model` on spawned gloo
ranks against world size 1 (`_torch_dist.tp_train`, ROADMAP T42's
tolerances: `_torch_tp.check_close`): mamba2's smoke model, and variants
with `n_groups` 2, 4 and 3, at (data, model) = (1, 2), (1, 4) and (2, 2),
fp32, 3 steps at lr 1e-2. Each rank runs the SSD on its heads (`in_z` /
`in_x`, `conv_x_*`, `A_log` / `dt_bias` / `D` and `out_proj`'s rows cut),
reads the whole B / C / dt projections and convs, whose gradients are
partial and summed over `model` (T63), and slices B / C to the groups its
heads read: at g 3 a rank's heads start or end inside a group (T64).
World size 1 repeats the mesh-less step bit for bit; the streamed init
equals the whole one; step 0 at (1, 4) and (2, 2) equals the reference's
own sharded train step on 4 host devices; the gated norm's gradient
across ranks equals the whole norm's (T62)."""
import numpy as np
import pytest
import torch

from _torch_dist import gated_norm_grads
from _torch_tp import MESHES, check_close, run
from _torch_train import check_step0, reference_result, start_reference_step0
from repro_torch.models import layers

NAMES = ["mamba2-2.7b", "mamba2-g2", "mamba2-g4", "mamba2-g3"]
REF_SHAPES = [(1, 4), (2, 2)]
MAMBA_CUT = {"in_z", "in_x", "conv_x_w", "conv_x_b", "A_log", "dt_bias", "D", "out_proj"}


def norm_cases() -> list:
    rng = np.random.default_rng(3)
    out = []
    for c in (16, 48):
        x, z = (rng.normal(size=(2, 5, c)).astype(np.float32) for _ in range(2))
        scale = (1 + 0.3 * rng.normal(size=c)).astype(np.float32)
        w = rng.normal(size=(c, 8)).astype(np.float32)
        out.append((x, z, scale, w, rng.normal(size=(2, 5, 8)).astype(np.float32)))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks of every mesh run `tp_train`, then at (1, 2) and (1, 4)
    the gated norm's cases and at (1, 4) and (2, 2) the reference's
    weights and batch, while the reference's own step runs in a
    subprocess: all at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tmp = tmp_path_factory.mktemp("tp_ssm")
        proc, ref_jobs = start_reference_step0(tmp, "mamba2-2.7b", REF_SHAPES)
        extra = {shape: [job] for shape, job in ref_jobs.items()}
        for shape in ((1, 2), (1, 4)):
            extra.setdefault(shape, []).append((gated_norm_grads, (shape[1], norm_cases())))
        out = run(tmp, NAMES, {shape: (world, mp, NAMES)
                               for shape, (world, mp) in MESHES.items()}, extra)
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
    assert {f"blocks.0.mamba.{w}" for w in MAMBA_CUT} <= set(res[0]["split"])
    assert not {"blocks.0.mamba.in_B", "blocks.0.mamba.conv_C_w",
                "blocks.0.mamba.norm"} & set(res[0]["split"])
    check_close(res[0], runs["world1"][name])
    for r in res[1:]:      # every rank reports the same metrics
        assert r["metrics"] == res[0]["metrics"] and r["loss"] == res[0]["loss"]


@pytest.mark.parametrize("shape", list(MESHES), ids=lambda s: f"data{s[0]}-model{s[1]}")
@pytest.mark.parametrize("name", NAMES)
def test_streamed_init_is_the_whole_init(runs, name, shape):
    """`train_model(generator=)` streams `MambaLM.init_parts` into the
    shards: each rank ends with the shards of the whole init."""
    assert all(r[name]["init_equal"] for r in runs[shape])


@pytest.mark.parametrize("i", range(len(REF_SHAPES)),
                         ids=[f"data{d}-model{m}" for d, m in REF_SHAPES])
def test_step_0_matches_the_reference_4_devices(runs, i):
    shape = REF_SHAPES[i]
    check_step0(runs["reference"], [r[0] for r in runs[("extra", shape)]], "mamba2-2.7b",
                shape)


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("case", [0, 1], ids=["c16", "c48"])
def test_gated_norm_gradient_across_ranks(runs, m, case):
    """The statistic summed over `model` feeds this rank's channels only:
    its gradient must be summed over `model` too (`tp_copy` after the
    reduce). Without that copy dx and dz lose every other rank's share."""
    x, z, scale, w, weight = norm_cases()[case]
    xt, zt, st = (torch.from_numpy(a).requires_grad_(True) for a in (x, z, scale))
    loss = ((layers.gated_rmsnorm(st, xt, zt, 1e-5) @ torch.from_numpy(w))
            * torch.from_numpy(weight)).sum()
    dx, dz, ds = torch.autograd.grad(loss, [xt, zt, st])
    for rank in runs[("extra", (1, m))]:
        got = rank[-1][case]
        assert abs(got["loss"] - loss.item()) <= 1e-5 * abs(loss.item())
        for k, want in (("dx", dx), ("dz", dz), ("dscale", ds)):
            np.testing.assert_allclose(got[k], want.numpy(), rtol=0,
                                       atol=5e-5 * float(want.abs().max()), err_msg=k)
