"""The inference steps' tables and cells, port against the JAX package,
and every cell built and run at world size 1:

  * `models.input_specs` / `cache_specs` / `param_specs` (meta tensors)
    against the reference's `jax.eval_shape` stand-ins, every arch x
    applicable shape at full size;
  * `launch.steps.cache_shardings` and `inference_param_shardings` leaf
    by leaf against the reference's at the (16, 16), (2, 16, 16) and (2,
    4) meshes (bare shapes here, `AbstractMesh`es there);
  * `perf.roofline`: `model_flops` / `attention_flops` equal for every
    arch x shape, `extrapolate` on the same dicts, `CellAnalysis`, and
    the FLOPs counted over the smoke serve step against the matmul
    arithmetic written out;
  * `build_cell` on a one-rank CPU mesh for every arch x shape at smoke
    size: it builds and runs, or refuses with `shape_applicable`'s
    reason; the serve and prefill steps equal the mesh-less program bit
    for bit; a MoE cell over a data axis of 2 built on the meta device
    (its batch rows split over `data`), the refusals of caches that do not
    divide over `model`, and the ssm / hybrid / audio cells on 2 ranks at
    (1, 2)."""
import dataclasses
import functools
import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from _torch_dist import Ranks, dryrun_counts, jobs
from _torch_steps import cell, mesh  # noqa: F401
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import all_archs
from repro.configs import get_config as jax_get_config
from repro.launch import steps as jax_steps
from repro.models import build_model as jax_build_model
from repro.models import cache_specs as jax_cache_specs
from repro.models import input_specs as jax_input_specs
from repro.models import sharding as jax_sh
from repro.perf import roofline as jax_roofline
from repro_torch import spmd
from repro_torch.configs import SHAPES, get_config, shape_applicable
from repro_torch.launch import steps
from repro_torch.models import build_model, cache_specs, input_specs, param_specs
from repro_torch.perf import roofline

MESHES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
          {"data": 2, "model": 4}]
MESH_IDS = ["16x16", "2x16x16", "2x4"]
ARCHS = all_archs()


def _abstract(shape: dict) -> AbstractMesh:
    return AbstractMesh(tuple(shape.values()), tuple(shape))


def _flat(tree, is_leaf=None) -> dict:
    return {jax_sh._path_str(p): v
            for p, v in jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]}


def _sd(t) -> tuple:
    return tuple(t.shape), str(t.dtype).replace("torch.", "")


@functools.lru_cache(maxsize=None)
def _jax_params(arch: str):
    return jax.eval_shape(jax_build_model(jax_get_config(arch)).init, jax.random.key(0))


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_eval_shape(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    got = param_specs(cfg)
    assert all(t.device.type == "meta" for t in got.values())
    assert {p: _sd(t) for p, t in got.items()} == \
        {p: (tuple(v.shape), str(v.dtype)) for p, v in _flat(_jax_params(arch)).items()}
    for name, shape in SHAPES.items():
        if not shape_applicable(cfg, shape)[0]:
            continue
        batch = input_specs(cfg, shape)
        assert all(t.device.type == "meta" for t in batch.values())
        assert {k: _sd(v) for k, v in batch.items()} == \
            {k: (tuple(v.shape), str(v.dtype))
             for k, v in jax_input_specs(jcfg, JAX_SHAPES[name]).items()}
        if shape.kind != "decode":
            with pytest.raises(ValueError, match="decode"):
                cache_specs(cfg, shape)
            continue
        caches = steps.cache_leaves(cache_specs(cfg, shape))
        assert all(t.device.type == "meta" for t in caches.values())
        assert {p: _sd(t) for p, t in caches.items()} == \
            {p: (tuple(v.shape), str(v.dtype))
             for p, v in _flat(jax_cache_specs(jcfg, JAX_SHAPES[name])).items()}


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_placements_match_reference(arch, shape):
    """`cache_shardings` for each decode cell and `inference_param_shardings`
    equal the reference's, leaf by leaf."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    am = _abstract(shape)
    for name in ("decode_32k", "long_500k"):
        if not shape_applicable(cfg, SHAPES[name])[0]:
            continue
        want = jax_steps.cache_shardings(am, jax_cache_specs(jcfg, JAX_SHAPES[name]))
        got = steps.cache_shardings(shape, cache_specs(cfg, SHAPES[name]))
        assert got == {p: tuple(s.spec) for p, s in _flat(want).items()}
    want = jax_steps.inference_param_shardings(jcfg, am, _jax_params(arch))
    got = steps.inference_param_shardings(cfg, shape)
    assert got == {p: tuple(s.spec) for p, s in _flat(want).items()}


@pytest.mark.parametrize("arch,model,fsdp", [
    ("phi4-mini-3.8b", 16, ()), ("phi4-mini-3.8b", 4, ()),
    ("qwen2-vl-72b", 16, ("data",)),          # 145 GB / 16: 9.1 GB, over 8 GiB
    ("mamba2-2.7b", 16, ()),
    ("command-r-plus-104b", 16, ("data",)),   # 208 GB / 16: over 8 GiB a device
    ("granite-34b", 4, ("data",)), ("granite-34b", 16, ()),
    ("arctic-480b", 16, ("data",)),           # MoE, and 960 GB / 16
    ("phi3.5-moe-42b-a6.6b", 16, ("data",)),  # MoE: default rules
    ("zamba2-2.7b", 16, ("data",))])          # hybrid: default rules
def test_inference_rules_keep_fsdp_where_the_reference_does(arch, model, fsdp):
    from repro_torch.models import sharding
    from repro_torch.models.convert import jax_leaves

    cfg = get_config(arch)
    rules = sharding.inference_rules({"data": 2, "model": model}, cfg, jax_leaves(cfg))
    assert rules["fsdp"] == fsdp and rules["tp"] == ("model",)


def test_roofline_matches_reference():
    for arch in ARCHS:
        cfg, jcfg = get_config(arch), jax_get_config(arch)
        for name in SHAPES:
            assert roofline.model_flops(cfg, SHAPES[name]) == \
                jax_roofline.model_flops(jcfg, JAX_SHAPES[name])
            assert roofline.attention_flops(cfg, SHAPES[name]) == \
                jax_roofline.attention_flops(jcfg, JAX_SHAPES[name])
    ops = jax_roofline._COLL_OPS

    def analysis(f, b, c, n):
        colls = {op: {"count": n + i, "bytes": c // (i + 1)} for i, op in enumerate(ops)}
        return {"flops": f, "bytes": b, "collective_bytes": c, "collectives": colls}
    for a1, a2, n in [(analysis(1e9, 5e8, 4096, 2), analysis(1.5e9, 7e8, 6144, 4), 32),
                      (analysis(3e9, 5e8, 4096, 2), analysis(2e9, 9e8, 1024, 1), 7)]:
        assert roofline.extrapolate(a1, a2, n) == jax_roofline.extrapolate(a1, a2, n)
    cell_ = roofline.CellAnalysis(2e12, 6.7e9, 9e8, {})
    assert (cell_.compute_s, cell_.memory_s, cell_.collective_s) == \
        (2e12 / 989e12, 6.7e9 / 3.35e12, 9e8 / 450e9)
    assert cell_.bottleneck == "compute" and cell_.step_time_s == cell_.compute_s
    assert set(cell_.to_dict()) == set(jax_roofline.CellAnalysis(1, 1, 1, {}).to_dict())


def test_flops_counted_over_the_smoke_serve_step(mesh):  # noqa: F811
    """`roofline.analyze` over phi4-mini's smoke serve step (b 4, cache 16,
    2 layers) counts 2 b (every matmul weight: q, k, v, o, gate, up, down,
    the tied head) + the score and P.V products over the whole cache, 4 b
    h S hd a layer; no collective at world size 1."""
    cfg = dataclasses.replace(get_config("phi4-mini-3.8b", smoke=True), compute_dtype="float32")
    shape = cell("decode")
    art = steps.build_cell(cfg, mesh, shape, device="cpu")
    art.model.init(torch.Generator().manual_seed(0))
    caches = art.new_caches(3)
    token = torch.zeros((shape.global_batch, 1), dtype=torch.long)
    _, counted = roofline.analyze(lambda: art.fn(caches, {"token": token}),
                                  roofline.tensor_bytes(art.model, caches))
    b, d, f, L = shape.global_batch, cfg.d_model, cfg.d_ff, cfg.n_layers
    h, kh, hd, S = cfg.effective_n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, shape.seq_len
    weights = L * (d * h * hd + 2 * d * kh * hd + h * hd * d + 3 * d * f) \
        + d * cfg.padded_vocab_size
    assert counted["flops"] == 2 * b * weights + L * 4 * b * h * S * hd
    assert counted["collective_bytes"] == 0 and counted["collectives"]["all-reduce"]["count"] == 0
    per_param = sum(p.numel() * 4 for p in art.model.parameters())
    assert counted["bytes"] == per_param + sum(t.numel() * t.element_size() for t in caches)


def _mesh_less(model, shape: str, inputs):
    """The mesh-less model's greedy tokens: `decode_step`'s, or the
    last-position head's (the whole forward's last position agrees)."""
    with torch.inference_mode():
        if shape == "decode":
            caches, token = inputs
            return torch.argmax(model.decode_step(caches, token)[0], dim=-1).to(torch.int32)
        tok = torch.argmax(steps.last_logits(model, inputs), dim=-1).to(torch.int32)
        out = model(**inputs)
        whole = out[0] if isinstance(out, tuple) else out
        assert torch.equal(torch.argmax(whole[:, -1], dim=-1).to(torch.int32), tok)
        return tok


@pytest.mark.parametrize("arch", ARCHS)
def test_every_cell_builds_and_runs_at_world_size_1(mesh, arch):  # noqa: F811
    """Every shape of `SHAPES` at smoke size: a cell that applies builds
    and runs (serve and prefill bit-equal to the mesh-less program, a
    train step gives a finite loss; `init_weights` streams in the seeded
    init's values); long_500k for a full-attention arch refuses with
    `shape_applicable`'s reason."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), compute_dtype="float32")
    ref = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    state = ref.state_dict()
    g = torch.Generator().manual_seed(4)
    for name, full in SHAPES.items():
        shape = dataclasses.replace(full, seq_len=16, global_batch=min(full.global_batch, 2))
        ok, why = shape_applicable(cfg, shape)
        if not ok:
            with pytest.raises(ValueError, match="long_500k exists to exclude"):
                steps.build_cell(cfg, mesh, shape, device="cpu")
            assert "exclude" in why
            continue
        art = steps.build_cell(cfg, mesh, shape, device="cpu")
        b = shape.global_batch
        batch = {k: (torch.randint(0, cfg.vocab_size, v.shape, generator=g)
                     if v.dtype == torch.int32 else torch.randn(v.shape, generator=g))
                 for k, v in input_specs(cfg, shape).items()}
        if "positions" in batch:
            batch["positions"] = torch.randint(0, 16, batch["positions"].shape, generator=g)
        if shape.kind == "train":
            art.load_state_dict(state)
            opt = steps.init_sharded(dict(art.model.named_parameters()), cfg, mesh)
            _, metrics = art.fn(art.model, opt, batch)
            assert math.isfinite(float(metrics["loss"]))
            continue
        art.load_state_dict(state)
        if shape.kind == "prefill":
            art.init_weights(torch.Generator().manual_seed(3))   # the same init, streamed in
            assert all(torch.equal(p, state[n]) for n, p in art.model.named_parameters())
            tok = art.fn(batch)
            assert tok.dtype == torch.int32 and tok.shape == (b,)
            assert torch.equal(tok, _mesh_less(ref, "prefill", batch))
            continue
        caches = art.new_caches(7)
        whole = ref.init_caches(b, 16, 7)
        with torch.inference_mode():
            for (p, t), w in zip(steps.cache_leaves(caches).items(),
                                 steps.cache_leaves(whole).values()):
                if t.is_floating_point():
                    t.copy_(torch.randn(t.shape, generator=g))
                    w.copy_(t)
        tok, new = art.fn(caches, {"token": batch["token"]})
        assert torch.equal(new.length, torch.full((b,), 8, dtype=torch.int32))
        assert torch.equal(tok, _mesh_less(ref, "decode", (whole, batch["token"])))
        for p, t in steps.cache_leaves(new).items():
            if p != "length":
                assert torch.equal(t, steps.cache_leaves(whole)[p]), p


def test_refusals_name_their_roadmap_items(tmp_path):
    """A MoE cell over a data axis > 1 builds (on the meta device over the
    bare shape {data: 2, model: 2}): its experts cut over `model`, its
    batch rows split over `data`, which are its row axes (MoE routing
    takes the global batch from them). A self-attention cache that does
    not divide over `model` refuses before anything is built (every
    family's K/V leaves). The ssm /
    hybrid / audio cells, refused on `model` > 1 before, build and run on
    2 ranks at (1, 2) (`dryrun.count_cell` on CPU tensors), each issuing
    its all-reduces over `model`."""
    archs = ("mamba2-2.7b", "zamba2-2.7b", "whisper-small")
    kinds = ("decode", "prefill", "train")
    ranks = Ranks(jobs, 2, str(tmp_path / "store"),
                  [(dryrun_counts, (2, get_config(a, smoke=True), [cell(k) for k in kinds]))
                   for a in archs])
    moe = get_config("phi3.5-moe-42b-a6.6b", smoke=True)
    for kind in ("decode", "prefill"):
        art = steps.build_cell(moe, {"data": 2, "model": 2}, cell(kind, batch=4),
                               device="meta")
        E, d, f = moe.moe.n_experts, moe.d_model, moe.d_ff
        # MoE serving keeps FSDP: the experts' d and the router's rows over data
        assert art.param_shapes["blocks.0.moe.w_gate"] == (E // 2, d // 2, f)
        assert art.param_shapes["blocks.0.moe.router"] == (d // 2, E)
        key = "token" if kind == "decode" else "tokens"
        assert art.batch_shapes[key][0] == 2 and art.row_axes == ("data",)
    for arch in ("zamba2-2.7b", "whisper-small"):
        with pytest.raises(ValueError, match="does not divide over model"):
            steps.build_cell(get_config(arch, smoke=True), {"data": 1, "model": 2},
                             cell("decode", seq=15))
    for rank in ranks.results(timeout=150):
        for arch, counts in zip(archs, rank):
            for kind, c in zip(kinds, counts):
                assert c["flops"] > 0 and c["collectives"]["all-reduce"]["count"] > 0, \
                    (arch, kind, c["collectives"])
    assert spmd.read_collectives()["total_bytes"] >= 0
