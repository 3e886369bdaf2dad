"""FSDP in the serve and prefill steps on 4 spawned gloo ranks
(`_torch_dist.inference_steps`) against the mesh-less model in this
process, from the same weights and inputs, at (data, model) = (2, 2) and
(4, 1), for the families whose inference placement keeps FSDP at any
size (`inference_rules`): MoE (phi3.5-moe) and hybrid (zamba2).

  * tokens identical and logits within 1e-5 at fp32 (a gathered weight
    is the whole weight, bit for bit);
  * each rank holds its data slice of every weight the rules cut over
    `data` (its weight bytes are the inference table's, cut over both
    axes);
  * one serve and one prefill step gather every FSDP-cut weight each
    time a layer reads it: once a layer, the hybrid's shared block once
    an application, a tied table twice (the embedding and the head);
    each gather is one all-gather over `data`, and inference issues no
    reduce-scatter."""
import math

import numpy as np
import pytest
import torch

from _torch_dist import Ranks, inference_steps, jobs
from _torch_steps import cell, configs, decode_inputs, prefill_inputs, weights
from repro_torch.launch import steps
from repro_torch.models import build_model
from repro_torch.models.convert import jax_leaves

CASES = [("phi3.5-moe-42b-a6.6b", (2, 2)), ("phi3.5-moe-42b-a6.6b", (4, 1)),
         ("zamba2-2.7b", (2, 2)), ("zamba2-2.7b", (4, 1))]
IDS = [f"{a}-{m[0]}x{m[1]}" for a, m in CASES]
LENGTHS = [6, 15, 16, 1]


def _inputs(i: int, arch: str):
    jcfg, tcfg = configs(arch)
    leaves, token = decode_inputs(jcfg, cell("decode"), LENGTHS, seed=i)
    return tcfg, leaves, token, prefill_inputs(jcfg, cell("prefill", batch=4), seed=i)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    todo = []
    for i, (arch, (data, model)) in enumerate(CASES):
        tcfg, leaves, token, batch = _inputs(i, arch)
        todo.append((inference_steps, (model, tcfg, weights(arch)[1], [(leaves, token)],
                                       [batch], cell("decode").seq_len)))
    return Ranks(jobs, 4, str(tmp_path_factory.mktemp("fsdp_steps") / "store"),
                 todo).results(timeout=150)


def _mesh_less(i: int, arch: str):
    tcfg, leaves, token, batch = _inputs(i, arch)
    model = build_model(tcfg, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in weights(arch)[1].items()})
    caches = steps.map_caches(model.init_caches(4, cell("decode").seq_len, 0),
                              lambda p, t: torch.from_numpy(leaves[p].copy()))
    logits, _ = model.decode_step(caches, torch.from_numpy(token))
    with torch.inference_mode():
        pre = steps.last_logits(model, {k: torch.from_numpy(v) for k, v in batch.items()})
    return logits.numpy(), pre.numpy()


def _reads(cfg, specs: dict) -> int:
    """The FSDP gathers one step makes under the inference placement
    `specs`: one each time a layer reads a weight cut over `data`."""
    n_apps = cfg.n_layers // cfg.hybrid_attn_every if cfg.family == "hybrid" else 1
    gathers = 0
    for path, leaf in jax_leaves(cfg).items():
        if "data" not in specs[path]:
            continue
        reads = n_apps if path.startswith("shared/") else 1
        if path == "embedding/embed" and cfg.tie_embeddings:
            reads = 2
        gathers += reads * len(leaf.names)
    return gathers


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_tokens_equal_the_mesh_less_model(runs, case):
    arch, (data, model) = CASES[case]
    logits, pre = _mesh_less(case, arch)
    n = 4 // data
    for r in runs:
        out = r[case]
        d, _ = out["coord"]
        rows = slice(d * n, (d + 1) * n)
        dec, pf = out["decode"][0], out["prefill"][0]
        np.testing.assert_array_equal(dec["token"], logits[rows].argmax(-1))
        np.testing.assert_allclose(dec["logits"], logits[rows], atol=1e-5, rtol=1e-5)
        np.testing.assert_array_equal(pf["token"], pre[rows].argmax(-1))
        np.testing.assert_allclose(pf["logits"], pre[rows], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_weights_are_held_in_data_slices(runs, case):
    arch, (data, model) = CASES[case]
    cfg = configs(arch)[1]
    shape = {"data": data, "model": model}
    specs = steps.inference_param_shardings(cfg, shape)
    want = sum(math.prod(leaf.shape) * 4 // math.prod(shape[e] for e in specs[path]
                                                        if e is not None)
               for path, leaf in jax_leaves(cfg).items())
    assert any("data" in s for s in specs.values())
    for r in runs:
        assert r[case]["param_bytes"] == want


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_every_layer_gathers_its_weights(runs, case):
    arch, (data, model) = CASES[case]
    cfg = configs(arch)[1]
    want = _reads(cfg, steps.inference_param_shardings(cfg, {"data": data, "model": model}))
    assert want > 0
    for r in runs:
        for step in (r[case]["decode"][0], r[case]["prefill"][0]):
            assert step["fsdp_gathers"] == want
            assert step["collectives"]["all-gather"]["count"] >= want
            assert step["collectives"]["reduce-scatter"]["count"] == 0
