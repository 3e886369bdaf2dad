"""Multi-pod dry run: build and count EVERY (arch x shape x mesh) cell —
counterpart of `repro.launch.dryrun`.

The reference lowers and compiles each cell's program for 256 or 512 TPU
devices. PyTorch compiles nothing ahead of time, so here one process
acts as rank 0 of a `fake` process group (no communication: each
collective returns at once) of 256 ranks, the production mesh (16, 16)
over ("data", "model"), or 512 ranks, (2, 16, 16) over ("pod", "data",
"model") (`launch.mesh.make_production_mesh`), and RUNS the cell's step
once on the meta device, where tensors carry shapes and dtypes and
allocate nothing. The group starts inside `run_cell` / `main`, never at
import. For each cell:

  1. `launch.steps.build_cell(cfg, mesh, shape, device="meta")`: the
     rank's weights (its resident shards: over `model` and, where the
     rules cut them, over `data`), optimizer state (ZeRO-1 DTensors),
     caches and batch at their local shapes. A cell that does
     not apply is `skipped` with `shape_applicable`'s reason; one whose
     build or step raises is an `error` with its message.
  2. Memory: `args` is exact, from the full-depth cell's local shapes
     (params, optimizer state, batch, caches); `temp` is the peak of the
     live bytes the step allocates (`perf.roofline.StepCounter`) and
     `output` the bytes of what the step returns; `fits_hbm` judges args
     + temp against `roofline.HBM_BYTES` (80e9, the H100's), recorded as
     `hbm_bytes` beside it. These are bounds of the eager program on an
     H100, not measurements.
  3. The roofline (single pod only, as in the reference):
     `perf.roofline.analyze` counts the step's FLOPs (`FlopCounterMode`),
     its collectives (`spmd`'s counter and DTensor's, backward included:
     the FSDP gathers of each layer, again in a recompute, and their
     reduce-scatters) and its bytes (every op's inputs and outputs,
     views 0).

Which path: the reference extrapolates from unrolled 1- and 2-unit
minis (`_unit_layers`, `n_units`, `_mini_cfg`) because it counts from
compiled HLO. The port counts by running, and running every layer of
the big configs through Python on the meta device takes minutes a cell,
so it takes the same path: it runs the 1- and 2-unit minis and
extrapolates base + n_units x per-unit for the FLOPs, bytes, collective
bytes and counts, and the temp peak (with "full" remat the live bytes
grow by one saved layer input and one layer's gradients a unit). Unlike
the reference's, the minis keep the config's `grad_accum_steps`: the
counts are those of the program that runs (the weights are read once a
microbatch), and the FLOPs are the same either way.

Chunked attention at seq_len >= 32768 runs with `attn_chunk = seq_len //
8` (`_mini_cfg`, the reference's rule): the same FLOPs with 64 chunk
pairs a layer instead of thousands in the port's Python loop. The
bytes and `temp` are then the larger chunk's (a chunk's scores are
(b, kh, g, chunk, chunk) fp32); `attn_chunk` is recorded.

The minis run the whole config's placement (`count_cell(placement=)`):
an inference cell keeps FSDP by the whole model's size (over 8 GiB a
device after the `model` split, `sharding.inference_rules`), which a
depth-cut mini never reaches. The reference's minis place themselves by
their own size, so its counts of such cells (command-r-plus, qwen2-vl)
lack the per-token gathers its own placement pays.

A rank's program can depend on its rank (the decode cache's position
owner, the lengths' data shard): the record carries `rank` (0).

Results land in experiments/dryrun_torch/<arch>__<shape>__<mesh>.json
(never in the reference's experiments/dryrun/).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-34b \\
      --shape train_4k --mesh single --force
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from repro_torch.configs import SHAPES, all_archs, get_config, shape_applicable
from repro_torch.models import cache_specs, input_specs, sharding
from repro_torch.perf import roofline
from .mesh import make_production_mesh, mesh_chips, production_mesh_shape
from .steps import MeshPlan, build_cell, cache_leaves, init_sharded

OUT_DIR = "experiments/dryrun_torch"
RANK = 0
_MESHES: dict = {}     # world size -> the production mesh over the fake group


def _unit_layers(cfg, units: int):
    """Reduced-layer mini config of `units` scaling units (the config's
    `grad_accum_steps` kept, see the module note)."""
    ch = {"n_layers": units}
    if cfg.family == "hybrid":
        ch["n_layers"] = units * cfg.hybrid_attn_every
    if cfg.encoder is not None:
        ch["encoder"] = dataclasses.replace(cfg.encoder, n_layers=units)
    return dataclasses.replace(cfg, **ch)


def n_units(cfg) -> int:
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.hybrid_attn_every
    return cfg.n_layers


def _mini_cfg(cfg, shape, units: int):
    mini = _unit_layers(cfg, units)
    if shape.seq_len >= 32_768 and mini.attn_chunk:
        # fewer, fatter attention chunks: the same FLOPs, 64 chunk pairs
        # a layer instead of thousands
        mini = dataclasses.replace(mini, attn_chunk=shape.seq_len // 8)
    return mini


def fake_world(multi_pod: bool):
    """The production mesh over a `fake` process group in which this
    process is rank 0 of 256 (or 512 with `multi_pod`) ranks; a fake
    group of another size is replaced, a real one refused."""
    import torch.distributed as dist
    # importing it registers the "fake" backend with torch.distributed
    from torch.testing._internal.distributed.fake_pg import FakeStore

    n = math.prod(production_mesh_shape(multi_pod).values())
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry run needs its own fake process group: a real one "
                               "is running")
        if dist.get_world_size() != n:
            dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=RANK, world_size=n)
        _MESHES.clear()
    if n not in _MESHES:
        _MESHES[n] = make_production_mesh(multi_pod=multi_pod, device="cpu")
    return _MESHES[n]


def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * dtype.itemsize


def args_bytes(art, cfg) -> int:
    """Bytes of what a rank holds before the step: its resident weight
    shards, its ZeRO-1 state (train), its batch shard and its cache
    shards (serve), from the cell's local shapes."""
    total = roofline.tensor_bytes(art.model)
    specs = input_specs(cfg, art.shape)
    total += sum(_nbytes(art.batch_shapes[k], v.dtype) for k, v in specs.items())
    if art.shape.kind == "train":
        plan = MeshPlan(cfg, art.mesh)
        state = sum(math.prod(sharding.local_shape(leaf.shape, plan.state_specs[p], art.mesh))
                    for p, leaf in plan.leaves.items())
        total += 3 * 4 * state + 4                      # master, mu, nu; the step
    elif art.cache_specs is not None:
        whole = cache_leaves(cache_specs(cfg, art.shape))
        total += sum(_nbytes(art.cache_shapes[p], t.dtype) for p, t in whole.items())
    return total


def count_cell(cfg, mesh, shape, device="meta", placement=None) -> dict:
    """Build `cfg`'s cell on `device` (meta: the dry run) and run its step
    once under `roofline.analyze`: its counts, plus `output_bytes`. On
    another device (the same program on real ranks) the weights are
    seeded normals and the batch zeros. `placement`: the config whose
    size decides an inference cell's FSDP (a mini passes its whole
    config: it runs the whole model's placement, with its per-layer
    gathers)."""
    art = build_cell(cfg, mesh, shape, device=device, placement=placement)
    specs = input_specs(cfg, shape)                 # the global batch
    if torch.device(device).type != "meta":
        g = torch.Generator(device=device).manual_seed(0)
        with torch.no_grad():
            for p in art.model.parameters():
                p.normal_(0.0, 0.02, generator=g)
        specs = {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
                 for k, v in specs.items()}
    if shape.kind == "train":
        opt = init_sharded(dict(art.model.named_parameters()), cfg, mesh)
        out, counts = roofline.analyze(lambda: art.fn(art.model, opt, specs))
    elif shape.kind == "prefill":
        batch = art.local_batch(specs)
        out, counts = roofline.analyze(lambda: art.fn(batch))
    else:
        caches = art.new_caches()
        batch = art.local_batch({"token": specs["token"]})
        out, counts = roofline.analyze(lambda: art.fn(caches, batch))
    counts["output_bytes"] = roofline.tensor_bytes(out)
    return counts


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str = OUT_DIR,
             force: bool = False) -> dict:
    mesh_name = "multipod" if multi_pod else "pod"
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_name}.json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "kind": shape.kind, "status": "ok", "rank": RANK,
           "attn_chunk": _mini_cfg(cfg, shape, 1).attn_chunk}

    ok, why = shape_applicable(cfg, shape)
    if not ok:
        rec.update(status="skipped", reason=why)
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        return rec

    try:
        mesh = fake_world(multi_pod)
        chips = mesh_chips(mesh)
        t0 = time.time()
        art = build_cell(cfg, mesh, shape, device="meta")
        args = args_bytes(art, cfg)
        del art
        t1 = time.time()
        minis = [count_cell(_mini_cfg(cfg, shape, u), mesh, shape, placement=cfg)
                 for u in (1, 2)]
        t2 = time.time()
        full = roofline.extrapolate(minis[0], minis[1], n_units(cfg))
        temp, out_b = full["temp_bytes"], full["output_bytes"]
        rec.update(
            chips=chips,
            lower_s=round(t1 - t0, 2),      # building the cell
            compile_s=round(t2 - t1, 2),    # running the counted minis
            memory={
                "args_gib": args / 2**30,
                "temp_gib": temp / 2**30,
                "output_gib": out_b / 2**30,
                "fits_hbm": (args + temp) < roofline.HBM_BYTES,
                "hbm_bytes": roofline.HBM_BYTES,
            },
            raw_cost=full,
        )
        if not multi_pod:
            cell = roofline.CellAnalysis(
                flops=full["flops"], hbm_bytes=full["bytes"],
                collective_bytes=full["collective_bytes"], collectives=full["collectives"],
                memory_args_bytes=args, memory_temp_bytes=int(temp),
                memory_output_bytes=int(out_b))
            mf = roofline.model_flops(cfg, shape)
            af = roofline.attention_flops(cfg, shape)
            rec["roofline"] = cell.to_dict()
            rec["roofline"]["model_flops_global"] = mf
            rec["roofline"]["model_flops_per_device"] = mf / chips
            rec["roofline"]["useful_flops_ratio"] = mf / chips / max(cell.flops, 1.0)
            rec["roofline"]["attn_flops_global"] = af
            rec["roofline"]["useful_flops_ratio_attn_adj"] = (
                (mf + af) / chips / max(cell.flops, 1.0))
    except Exception as e:  # noqa: BLE001 — record, don't crash the sweep
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--save-hlo", action="store_true",
                    help="refused: PyTorch lowers no HLO")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    if args.save_hlo:
        ap.error("--save-hlo has no counterpart: the port runs an eager program, not a "
                 "compiled HLO module")

    archs = all_archs() if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    t0 = time.time()
    n_ok = n_skip = n_err = 0
    try:
        for mp in meshes:
            for arch in archs:
                for shape in shapes:
                    rec = run_cell(arch, shape, mp, args.out, force=args.force)
                    tag = f"{arch:22s} {shape:12s} {'2x16x16' if mp else '16x16':8s}"
                    if rec["status"] == "ok":
                        n_ok += 1
                        mem = rec["memory"]
                        rf = rec.get("roofline", {})
                        extra = f" bottleneck={rf['bottleneck']:10s}" if rf else ""
                        print(f"OK   {tag} compile={rec.get('compile_s', 0):6.1f}s"
                              f" args={mem['args_gib']:7.2f}GiB temp={mem['temp_gib']:7.2f}GiB"
                              f" fits={mem['fits_hbm']}{extra}", flush=True)
                    elif rec["status"] == "skipped":
                        n_skip += 1
                        print(f"SKIP {tag} {rec['reason'][:70]}", flush=True)
                    else:
                        n_err += 1
                        print(f"ERR  {tag} {rec['error'][:120]}", flush=True)
    finally:
        import torch.distributed as dist

        if dist.is_initialized() and dist.get_backend() == "fake":
            dist.destroy_process_group()
    print(f"\ndone in {time.time()-t0:.0f}s: {n_ok} ok, {n_skip} skipped, "
          f"{n_err} errors")


if __name__ == "__main__":
    torch.set_num_threads(1)
    main()
