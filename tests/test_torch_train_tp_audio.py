"""Tensor-parallel training of the audio family over `model` on spawned
gloo ranks against world size 1 (`_torch_dist.tp_train`, ROADMAP T42's
tolerances: `_torch_tp.check_close`): whisper's smoke model at (data,
model) = (1, 2), (1, 4) and (2, 2), fp32, 3 steps at lr 1e-2. The
encoder's attention and GELU MLP, the decoder's self and cross attention
are head-parallel (the cross attention's queries and its encoder-side
input pass `tp_copy`, its output projection is row-parallel), and the
encoder's positions, which the reference's rules cut over `model`, are
gathered whole. World size 1 repeats the mesh-less step bit for bit; the
streamed init (`EncDecLM.init_parts`) equals the whole one; step 0 at
(1, 4) and (2, 2) equals the reference's own sharded train step on 4
host devices; `precompute_cross` refuses a cut."""
import numpy as np
import pytest
import torch

from _torch_tp import MESHES, check_close, config, run
from _torch_train import check_step0, reference_result, start_reference_step0
from repro_torch.models import build_model, sharding

NAMES = ["whisper-small"]
REF_SHAPES = [(1, 4), (2, 2)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks of every mesh run `tp_train`, then at (1, 4) and (2, 2)
    the reference's weights and batch, while the reference's own step
    runs in a subprocess: all at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tmp = tmp_path_factory.mktemp("tp_audio")
        proc, ref_jobs = start_reference_step0(tmp, "whisper-small", REF_SHAPES)
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
    assert {"encoder.0.wq", "encoder.0.mlp.w_up", "enc_pos_embed", "decoder.0.wq",
            "decoder.0.cross.wq", "decoder.0.cross.wk", "decoder.1.cross.wo",
            "decoder.0.mlp.w_down"} <= set(res[0]["split"])
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
    check_step0(runs["reference"], [r[0] for r in runs[("extra", shape)]], "whisper-small",
                shape)


def test_precompute_cross_refuses_a_cut():
    """`precompute_cross` gives whole cross K/V from whole weights: under a
    `model` dim > 1 it refuses (no serving path calls it, ROADMAP T36, T65)."""
    cfg = config("whisper-small")
    model = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    enc = torch.zeros(1, cfg.encoder.n_frames, cfg.d_model)
    assert model.precompute_cross(enc)[0].shape[2] == cfg.encoder.n_frames
    with sharding.sharding_ctx({"data": 1, "model": 2}):
        with pytest.raises(NotImplementedError, match="precompute_cross"):
            model.precompute_cross(enc)
