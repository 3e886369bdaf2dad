"""The port's dry run (`repro_torch.launch.dryrun`): one process acting as
a rank of a `fake` process group runs each cell's step on the meta
device and counts it (`perf.roofline.analyze`).

  1. Its records carry the reference's keys (read from
     `src/repro/launch/dryrun.py` itself), but `fits_hbm` / `hbm_bytes`
     for the reference's v5e `fits_16gib`, and the port's `rank` and
     `attn_chunk`; the statuses follow `shape_applicable`: every cell
     that applies is `ok`, mamba2's serve and prefill cells and
     phi3.5-moe's over a data axis of 16 included. Run as a module with
     JAX blocked.
  2. At (data, model) = (2, 2), a smoke cell's FLOPs, collectives, bytes
     and temp peak counted on meta in the fake world equal what 4 real
     gloo ranks count running the same cell on real tensors, rank by
     rank: the dry run measures the program that runs.
  3. A dense train cell's FLOPs a rank at (2, 2) are the world-size-1
     step's over 4 (tensor-parallel over `model`, the batch over
     `data`), within 1%; the whole-weight step would give 1/2.
  4. Importing the module starts no process group and imports no JAX.
"""
import ast
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from _torch_dist import Ranks, dryrun_counts, jobs
from repro.perf import roofline as jax_roofline
from repro_torch.configs import SHAPES, ShapeConfig, get_config, shape_applicable
from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import input_specs, sharding

ROOT = Path(__file__).resolve().parent.parent
ARCHS = ["phi4-mini-3.8b", "mamba2-2.7b", "phi3.5-moe-42b-a6.6b"]
SMOKE = dataclasses.replace(get_config("phi4-mini-3.8b", smoke=True), compute_dtype="float32")
CELLS = [ShapeConfig("train_4k", 32, 4, "train"), ShapeConfig("prefill_32k", 32, 4, "prefill"),
         ShapeConfig("decode_32k", 32, 4, "decode")]

RUN_ARCHS = f"""
import runpy, sys
sys.modules["jax"] = None                 # any import of JAX now raises
args = sys.argv[1:]
for arch in {ARCHS!r}:
    sys.argv = ["dryrun", "--arch", arch] + args
    runpy.run_module("repro_torch.launch.dryrun", run_name="__main__")
"""


@contextlib.contextmanager
def fake_group(world: int, rank: int):
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """The CLI's records of every shape of ARCHS on the 16 x 16 mesh, and
    its output; 4 gloo ranks counting the smoke cells meanwhile."""
    tmp = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cli = [subprocess.Popen([sys.executable, "-c", RUN_ARCHS, "--mesh", "single", "--out",
                             str(tmp / "out"), "--force"], cwd=tmp, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)]
    ranks = Ranks(jobs, 4, str(tmp / "store"), [(dryrun_counts, (2, SMOKE, CELLS))])
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        real = [r[0] for r in ranks.results(timeout=150)]
    finally:
        torch.set_num_threads(n)
    outs = [p.communicate(timeout=300) for p in cli]
    for p, (out, err) in zip(cli, outs):
        assert p.returncode == 0, err[-3000:]
    recs = {}
    for f in (tmp / "out").glob("*.json"):
        r = json.loads(f.read_text())
        recs[(r["arch"], r["shape"])] = r
    return recs, "".join(o for o, _ in outs), real


def _reference_keys() -> dict:
    """The reference's record keys, by where they sit: "top" (every key
    `run_cell` may set), "memory" and "roofline" (its additions to
    `CellAnalysis.to_dict()`)."""
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    top, memory, roof = set(), set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) and \
                any(isinstance(t, ast.Name) and t.id == "rec" for t in node.targets):
            top |= {k.value for k in node.value.keys}
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "update":
            for kw in node.keywords:
                top.add(kw.arg)
                if kw.arg == "memory":
                    memory |= {k.value for k in kw.value.keys}
        if isinstance(node, ast.Subscript) and isinstance(node.slice, ast.Constant):
            inner = node.value
            if isinstance(inner, ast.Name) and inner.id == "rec":
                top.add(node.slice.value)
            elif isinstance(inner, ast.Subscript) and getattr(inner.slice, "value", "") == \
                    "roofline":
                roof.add(node.slice.value)
    roof |= set(jax_roofline.CellAnalysis(1, 1, 1, {}).to_dict())
    return {"top": top, "memory": memory, "roofline": roof}


def test_record_keys_are_the_reference_s(records):
    recs, _, _ = records
    ref = _reference_keys()
    assert "fits_16gib" in ref["memory"] and "useful_flops_ratio" in ref["roofline"]
    port_only = {"rank", "attn_chunk"}
    for (arch, shape), r in recs.items():
        want = ref["top"] - {"hlo"}
        if r["status"] == "ok":
            want -= {"reason", "error", "traceback"}
            assert set(r["memory"]) == ref["memory"] - {"fits_16gib"} | {"fits_hbm", "hbm_bytes"}
            assert set(r["roofline"]) == ref["roofline"]
            assert r["memory"]["hbm_bytes"] == 80e9
        elif r["status"] == "skipped":
            want = {"arch", "shape", "mesh", "kind", "status", "reason"}
        else:
            want = {"arch", "shape", "mesh", "kind", "status", "error", "traceback"}
        assert set(r) == want | port_only, (arch, shape)
        assert r["rank"] == 0


def test_statuses_follow_applicability_and_refusals(records):
    recs, out, _ = records
    assert len(recs) == len(ARCHS) * len(SHAPES)
    for (arch, shape), r in recs.items():
        cfg = get_config(arch)
        if not shape_applicable(cfg, SHAPES[shape])[0]:
            assert r["status"] == "skipped" and "exclude" in r["reason"]
        else:       # mamba2's serve and prefill cells and phi3.5-moe's on `data` 16 included
            assert r["status"] == "ok", r.get("error")
            assert r["chips"] == 256 and r["memory"]["args_gib"] > 0
            assert r["roofline"]["flops_per_device"] > 0
            assert 0 < r["roofline"]["useful_flops_ratio"] <= 1
    assert recs[("phi4-mini-3.8b", "prefill_32k")]["attn_chunk"] == 32768 // 8
    assert recs[("phi4-mini-3.8b", "train_4k")]["attn_chunk"] == 1024
    # the dense train cell: the TP step's collectives, backward and ZeRO-1 included
    coll = recs[("phi4-mini-3.8b", "train_4k")]["roofline"]["collectives"]
    assert coll["all-reduce"]["count"] > 0 and coll["reduce-scatter"]["count"] > 0
    assert coll["all-gather"]["count"] > 0
    assert "done in" in out and f"{len(ARCHS) * 2 - 1} ok" not in out
    assert out.count(", 0 errors") == len(ARCHS)


@pytest.mark.parametrize("i", range(len(CELLS)), ids=[c.kind for c in CELLS])
def test_fake_world_counts_what_real_ranks_run(records, i):
    _, _, real = records
    for rank in range(4):
        with fake_group(4, rank):
            got = dryrun.count_cell(SMOKE, make_local_mesh(2, device="cpu"), CELLS[i])
        want = real[rank][i]
        keys = ("flops", "bytes", "temp_bytes", "collective_bytes", "output_bytes",
                "collectives")
        assert {k: got[k] for k in keys} == {k: want[k] for k in keys}, rank


def test_tp_train_flops_per_rank():
    cell = CELLS[0]
    with fake_group(1, 0):
        one = dryrun.count_cell(SMOKE, make_local_mesh(1, device="cpu"), cell)["flops"]
    with fake_group(4, 0):
        four = dryrun.count_cell(SMOKE, make_local_mesh(2, device="cpu"), cell)["flops"]
    assert abs(four - one / 4) <= 0.01 * one / 4, (one, four)


def test_recompute_sees_the_mesh_on_autograd_s_thread():
    """On the card autograd runs the backward pass, and with it a
    checkpointed layer's recompute, on a device thread of its own, which
    does not see the forward thread's `sharding_ctx`: the recompute must
    run under the mesh the forward had (`sharding.carry_ctx`). Here the
    backward is called from another thread, on the meta device over a
    fake (1, 2) world, with full remat."""
    cfg = dataclasses.replace(SMOKE, remat="full")
    with fake_group(2, 0):
        mesh = make_local_mesh(2, device="cpu")
        model, plan = steps.train_model(cfg, mesh, "meta")
        model.requires_grad_(True)
        assert sharding.split_dim(model.blocks[0].wq) is not None
        batch = input_specs(cfg, CELLS[0])
        with sharding.sharding_ctx(mesh):
            loss, _ = model.loss(batch)
        errors = []

        def backward():
            try:
                torch.autograd.grad(loss, list(model.parameters()))
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(e)
        t = threading.Thread(target=backward)
        t.start()
        t.join(timeout=60)
        assert not t.is_alive() and not errors, errors


def test_import_starts_nothing():
    code = ("import sys\nsys.modules['jax'] = None\n"
            "import torch.distributed as dist\nimport repro_torch.launch.dryrun\n"
            "import repro_torch.launch\n"
            "assert not dist.is_initialized()\n"
            "assert 'repro' not in sys.modules\n"
            "assert 'repro_torch.launch.dryrun' in sys.modules\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    import repro_torch.launch as launch_pkg

    assert "dryrun" not in (ROOT / "src/repro_torch/launch/__init__.py").read_text()
    assert not hasattr(launch_pkg, "run_cell")


def test_save_hlo_refused():
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--save-hlo"],
                          cwd=ROOT, capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert proc.returncode != 0 and "--save-hlo has no counterpart" in proc.stderr
