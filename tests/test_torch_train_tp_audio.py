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
host devices. `precompute_cross` under the serve step's cut over `model`
(2 and 4) gives the mesh-less cross K/V bit for bit on every rank, and
`local_caches` cuts them to the step's frame shards, over which it
decodes the mesh-less token."""
import numpy as np
import pytest
import torch

from _torch_dist import cross_cut
from _torch_tp import MESHES, check_close, config, run, state
from _torch_train import check_step0, reference_result, start_reference_step0
from repro_torch.models import build_model

NAMES = ["whisper-small"]
REF_SHAPES = [(1, 4), (2, 2)]
CROSS_SHAPES = [(1, 2), (1, 4)]
CROSS_B, CROSS_SEQ = 2, 16


def _cross_inputs():
    """(fp32 config, whole weights, encoder output (b, F, d), token (b, 1))."""
    cfg = config("whisper-small")
    rng = np.random.default_rng(5)
    enc = rng.normal(size=(CROSS_B, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)
    token = rng.integers(0, cfg.vocab_size, (CROSS_B, 1)).astype(np.int32)
    return cfg, state(cfg), enc, token


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
        extra = {shape: [job] for shape, job in ref_jobs.items()}
        for shape in CROSS_SHAPES:
            extra.setdefault(shape, []).append((cross_cut, (shape[1], *_cross_inputs(),
                                                            CROSS_SEQ)))
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


def _meshless_cross():
    """The mesh-less model's cross K/V of `_cross_inputs` and its greedy
    token from zero self caches holding them, at one torch thread (as
    the ranks run)."""
    cfg, st, enc, token = _cross_inputs()
    model = build_model(cfg, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in st.items()})
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        k, v = model.precompute_cross(torch.from_numpy(enc))
        caches = model.init_caches(CROSS_B, CROSS_SEQ, 0)._replace(cross_k=k, cross_v=v)
        logits, _ = model.decode_step(caches, torch.from_numpy(token))
    finally:
        torch.set_num_threads(n)
    return k.numpy(), v.numpy(), logits.argmax(-1).numpy()


def _cross_results(runs, shape):
    res = [r[-1] for r in runs[("extra", shape)]]
    assert {"decoder.0.cross.wk", "decoder.1.cross.wv"} <= set(res[0]["split"])
    return res


@pytest.mark.parametrize("shape", CROSS_SHAPES, ids=lambda s: f"data{s[0]}-model{s[1]}")
def test_precompute_cross_under_a_cut_is_the_whole(runs, shape):
    """Every rank's `precompute_cross` under `model` 2 / 4 returns the
    whole (L, b, F, kh, hd) K and V, bit-equal to the mesh-less call."""
    k, v, _ = _meshless_cross()
    for r in _cross_results(runs, shape):
        np.testing.assert_array_equal(r["k"], k)
        np.testing.assert_array_equal(r["v"], v)


@pytest.mark.parametrize("shape", CROSS_SHAPES, ids=lambda s: f"data{s[0]}-model{s[1]}")
def test_precompute_cross_cut_to_frame_shards_decodes(runs, shape):
    """`local_caches` cuts the whole K/V to each rank's frames (T65: F
    over `model`), and the serve step over those shards decodes the
    mesh-less token."""
    k, v, tok = _meshless_cross()
    f = k.shape[2] // shape[1]
    for r in _cross_results(runs, shape):
        m = r["coord"]
        np.testing.assert_array_equal(r["local_k"], k[:, :, m * f:(m + 1) * f])
        np.testing.assert_array_equal(r["local_v"], v[:, :, m * f:(m + 1) * f])
        np.testing.assert_array_equal(r["token"], tok)
