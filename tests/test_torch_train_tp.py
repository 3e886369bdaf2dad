"""Tensor-parallel training over `model` on spawned gloo ranks
(`_torch_dist.tp_train`) against world size 1, for the dense and VLM
families: phi4-mini (GQA; head-parallel attention at `model` 2), granite
with q / k / v biases (MQA: each rank's query heads read the one whole
KV head, whose weights and biases take their gradient summed over
`model`), a GELU / LayerNorm config with an untied, soft-capped head over
a padded vocabulary under full remat, and qwen2-vl (M-RoPE), each at (data, model) = (1,
2), (1, 4) and (2, 2), fp32, 3 steps at lr 1e-2 (ROADMAP T42's
tolerances: `_torch_tp.check_close`). World size 1 (a one-rank group in
this process) repeats the mesh-less step bit for bit. The vocabulary-
parallel head loss is held against the whole one at `model` 2 and 4."""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_dist import Ranks, jobs, vp_head_ce
from _torch_tp import MESHES, check_close, config, run
from repro_torch.models import layers

NAMES = ["phi4-mini-3.8b", "granite-bias", "gelu-layernorm", "qwen2-vl-72b"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tmp = tmp_path_factory.mktemp("tp")
        head = {m: Ranks(jobs, m, str(tmp / f"head{m}"), [(vp_head_ce, (m, head_cases()))])
                for m in (2, 4)}
        out = run(tmp, NAMES, {shape: (world, mp, NAMES)
                               for shape, (world, mp) in MESHES.items()})
        out["head"] = {m: r.results(timeout=150) for m, r in head.items()}
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
    assert res[0]["split"], "nothing was cut over model"
    check_close(res[0], runs["world1"][name])
    for r in res[1:]:      # every rank reports the same metrics
        assert r["metrics"] == res[0]["metrics"] and r["loss"] == res[0]["loss"]


@pytest.mark.parametrize("shape", list(MESHES), ids=lambda s: f"data{s[0]}-model{s[1]}")
@pytest.mark.parametrize("name", NAMES)
def test_streamed_init_is_the_whole_init(runs, name, shape):
    """`train_model(generator=)` draws the seeded init a part at a time,
    no rank holding the whole model, and each rank ends with the shards
    of the whole init, bit for bit."""
    assert all(r[name]["init_equal"] for r in runs[shape])


def test_what_is_cut(runs):
    """At `model` 2 phi4-mini's attention is head-parallel (q and k/v
    cut), granite's is MQA (q cut, k/v whole); at `model` 4 the MLP, the
    vocabulary and MQA-style query heads are cut."""
    split = {name: set(runs[(1, 2)][0][name]["split"]) for name in NAMES}
    assert {"blocks.0.wq", "blocks.0.wk", "blocks.0.wo", "blocks.0.mlp.w_up",
            "embed"} <= split["phi4-mini-3.8b"]
    assert "blocks.0.wq" in split["granite-bias"] and "blocks.0.bq" in split["granite-bias"]
    assert not {"blocks.0.wk", "blocks.0.bk"} & split["granite-bias"]
    assert {"lm_head", "embed"} <= split["gelu-layernorm"]
    assert "blocks.1.mlp.w_down" in set(runs[(1, 4)][0]["phi4-mini-3.8b"]["split"])


# ------------------------------------------------ the vocabulary-parallel head
V_REAL, V_PAD, D = 500, 512, 24


def head_cases() -> list:
    rng = np.random.default_rng(7)
    out = []
    for softcap in (0.0, 5.0):
        cfg = dataclasses.replace(config("phi4-mini-3.8b"), vocab_size=V_REAL,
                                  logit_softcap=softcap)
        hidden = rng.normal(size=(2, 6, D)).astype(np.float32)
        w = (rng.normal(size=(V_PAD, D)) * 0.5).astype(np.float32)
        labels = rng.integers(0, V_REAL, (2, 6)).astype(np.int32)
        labels[0, :2] = -1
        labels[1, 0] = V_REAL - 1          # the last real column: rank m - 1's
        out.append((cfg, hidden, w, labels))
    return out


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("case", [0, 1], ids=["plain", "softcap"])
def test_vocab_parallel_head_loss(runs, m, case):
    """Loss, the hidden's gradient and the head's (gathered) against the
    whole head (`_HeadCE` without a mesh), pad columns masked on global
    indices; every rank gives the same loss and
    hidden gradient."""
    cfg, hidden, w, labels = head_cases()[case]
    h = torch.from_numpy(hidden).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    loss = layers.lm_head_loss(cfg, wt, h, torch.from_numpy(labels).long())
    dh, dw = torch.autograd.grad(loss, [h, wt])
    want = loss.item()
    got = [r[0][case] for r in runs["head"][m]]
    for g in got:
        assert abs(g["loss"] - want) <= 1e-5 * abs(want)
        np.testing.assert_allclose(g["dh"], dh.numpy(), rtol=0,
                                   atol=5e-5 * float(dh.abs().max()))
        np.testing.assert_allclose(g["dw"], dw.numpy(), rtol=0,
                                   atol=5e-5 * float(dw.abs().max()))
    assert not np.any(got[0]["dw"][V_REAL:])            # pad rows take no gradient
