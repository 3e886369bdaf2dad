"""The port's serve and prefill steps across spawned gloo ranks
(`tests/_torch_dist.py`) against world size 1 (the mesh-less model in
this process, from the same weights and inputs), at (1, 2), (2, 2) and
(1, 4):

  * logits within 1e-5 at fp32 and tokens identical, the caches each
    rank writes within 1e-5 of its slice of the mesh-less caches; the
    lengths include one that ends inside a middle rank's slice at (1, 4)
    (6 of 16, rank 1 holding 4-7) and a row at capacity (16: it writes
    nothing);
  * the head layouts: every head split (phi4-mini at (1, 2) / (2, 2)),
    query heads split over whole KV heads (granite's MQA at (1, 2),
    phi3.5-moe at (1, 4)), heads whole (phi4-mini at (1, 4)), experts
    over `model` (phi3.5-moe); M-RoPE's `positions` cross ranks in
    test_torch_steps_mesh.py (qwen2-vl at (2, 2));
  * each rank's resident weight bytes at (1, 4) are what the inference
    spec table implies (no tensor-parallel leaf held whole);
  * the collectives one serve step issues at (2, 2), by op, count and
    bytes, as the design implies a layer (`models.attention`: one
    all-gather of q / k / v, one of the partials, the all-reduces after
    `wo` and `w_down`) plus the embedding's all-reduce and the argmax's
    all-gather;
  * a vocabulary tie across ranks: the lower index wins, as `jnp.argmax`."""
import math

import numpy as np
import pytest
import torch

from _torch_dist import Ranks, greedy_ties, inference_steps, jobs
from _torch_steps import cell, configs, decode_inputs, prefill_inputs, weights
from repro_torch.launch import steps
from repro_torch.models import build_model

WORLD2 = [("phi4-mini-3.8b", (1, 2)), ("granite-34b", (1, 2))]
WORLD4 = [("phi4-mini-3.8b", (2, 2)), ("phi4-mini-3.8b", (1, 4)),
          ("phi3.5-moe-42b-a6.6b", (1, 4))]
LENGTHS = [6, 15, 16, 1]
TIES = np.zeros((4, 512), np.float32)
TIES[0, [100, 300]] = 1.0          # across ranks at m 2 and 4: 100 wins
TIES[1, [300, 400]] = 1.0          # m 2: one rank; m 4: ranks 2 and 3: 300
TIES[2, [10, 260, 500]] = 2.0      # ranks 0, 1 (and 3): 10
TIES[3] = -1.0                     # every column: 0


def _inputs(i: int, arch: str):
    jcfg, tcfg = configs(arch)
    leaves, token = decode_inputs(jcfg, cell("decode"), LENGTHS, seed=i)
    return tcfg, leaves, token, prefill_inputs(jcfg, cell("prefill", batch=4), seed=i)


def _jobs(cases, world):
    todo = []
    for i, (arch, (data, model)) in enumerate(cases):
        tcfg, leaves, token, batch = _inputs(i, arch)
        todo.append((inference_steps, (model, tcfg, weights(arch)[1], [(leaves, token)],
                                       [batch], cell("decode").seq_len)))
    todo.append((greedy_ties, (world, configs(cases[0][0])[1], TIES)))
    return todo


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("steps_ranks")
    two = Ranks(jobs, 2, str(tmp / "two"), _jobs(WORLD2, 2))
    four = Ranks(jobs, 4, str(tmp / "four"), _jobs(WORLD4, 4))
    return {2: two.results(), 4: four.results()}


def _world1(i: int, arch: str):
    """The mesh-less model's decode logits, caches and prefill logits."""
    tcfg, leaves, token, batch = _inputs(i, arch)
    model = build_model(tcfg, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in weights(arch)[1].items()})
    caches = steps.map_caches(model.init_caches(4, cell("decode").seq_len, 0),
                               lambda p, t: torch.from_numpy(leaves[p].copy()))
    logits, caches = model.decode_step(caches, torch.from_numpy(token))
    with torch.inference_mode():
        x = model.hidden_states(torch.from_numpy(batch["tokens"]),
                                positions=(torch.from_numpy(batch["positions"])
                                           if "positions" in batch else None))[0]
        pre = model.head_logits(x[:, -1])
    return logits.numpy(), steps.cache_leaves(caches), pre.numpy()


CASES = [(2, i, a, m) for i, (a, m) in enumerate(WORLD2)] + \
    [(4, i, a, m) for i, (a, m) in enumerate(WORLD4)]


@pytest.mark.parametrize("world,case,arch,mesh", CASES,
                         ids=[f"{a}-{m[0]}x{m[1]}" for _, _, a, m in CASES])
def test_ranks_equal_world_size_1(runs, world, case, arch, mesh):
    logits, caches, pre = _world1(case, arch)
    S = cell("decode").seq_len
    n_rows = 4 // mesh[0]
    for r in runs[world]:
        out = r[case]
        d, m = out["coord"]
        rows = slice(d * n_rows, (d + 1) * n_rows)
        dec = out["decode"][0]
        np.testing.assert_allclose(dec["logits"], logits[rows], atol=1e-5, rtol=1e-5)
        np.testing.assert_array_equal(dec["token"], logits[rows].argmax(-1))
        np.testing.assert_allclose(out["prefill"][0]["logits"], pre[rows], atol=1e-5, rtol=1e-5)
        np.testing.assert_array_equal(out["prefill"][0]["token"], pre[rows].argmax(-1))
        s = S // mesh[1]
        for path in ("k", "v"):
            np.testing.assert_allclose(dec["caches"][path],
                                       caches[path][:, rows, m * s:(m + 1) * s].numpy(),
                                       atol=1e-5, rtol=1e-5, err_msg=path)
        np.testing.assert_array_equal(dec["caches"]["length"], caches["length"].numpy())


@pytest.mark.parametrize("case", [1, 2], ids=[a for a, _ in WORLD4[1:]])
def test_resident_bytes_follow_the_spec_table(runs, case):
    arch = WORLD4[case][0]
    cfg = configs(arch)[1]
    from repro_torch.models.convert import jax_leaves

    shape = {"data": 1, "model": 4}
    specs = steps.inference_param_shardings(cfg, shape)
    want = 0
    for path, leaf in jax_leaves(cfg).items():
        split = math.prod(shape[e] for e in specs[path] if e is not None)
        want += math.prod(leaf.shape) // split * 4
    whole = sum(math.prod(leaf.shape) * 4 for leaf in jax_leaves(cfg).values())
    assert want < whole
    for r in runs[4]:
        assert r[case]["param_bytes"] == want


def test_collectives_of_one_serve_step_at_2x2(runs):
    """phi4-mini smoke (d 96, 6 query / 2 KV heads of 16, 2 layers) at (2,
    2), b 2 a data rank: all heads split over m 2."""
    cfg = configs("phi4-mini-3.8b")[1]
    b, d, L, m = 2, cfg.d_model, cfg.n_layers, 2
    h, kh, hd = cfg.effective_n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    f32 = 4
    reduce = 2 * b * d * f32                                  # weighted 2x
    gather_qkv = b * (h + 2 * kh) * hd * f32
    gather_parts = m * b * h * (hd + 2) * f32
    want = {"all-reduce": {"count": 1 + 2 * L, "bytes": reduce * (1 + 2 * L)},
            "all-gather": {"count": 2 * L + 1,
                           "bytes": L * (gather_qkv + gather_parts) + m * b * 2 * 8}}
    for r in runs[4]:
        got = r[0]["decode"][0]["collectives"]
        assert {op: got[op] for op in want} == want
        assert got["total_bytes"] == sum(v["bytes"] for v in want.values())


@pytest.mark.parametrize("world", [2, 4])
def test_vocabulary_ties_across_ranks(runs, world):
    for r in runs[world]:
        np.testing.assert_array_equal(r[-1], TIES.argmax(-1))
    assert list(TIES.argmax(-1)) == [100, 300, 10, 0]
