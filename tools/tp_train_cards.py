#!/usr/bin/env python3
"""The tensor-parallel train step (`launch.steps.build_train_step(mesh=)`
over `launch.steps.train_model`'s model) across the cards of one host,
one process a card over NCCL:

    python3 tools/tp_train_cards.py                       # every card of the host
    python3 tools/tp_train_cards.py --arch mamba2-2.7b    # any arch (phi4-mini by default)
    python3 tools/tp_train_cards.py --device cpu --smoke  # 4 gloo ranks, smoke configs
    python3 tools/tp_train_cards.py --arch phi3.5-moe-42b-a6.6b --units 1 --timing-layers 2
    python3 tools/tp_train_cards.py --arch arctic-480b --smoke  # smoke widths on the cards

(a) numerics: the arch at its published widths cut to `--units` units of
    depth (2 by default; `launch.dryrun._unit_layers`), in fp32
    (parameters and compute), on the (1, W) mesh (every head, the MLP,
    the experts, the vocabulary and a Mamba2 layer's heads split W ways),
    on (2, W / 2), whose data axis splits the batch (a MoE layer routes
    the global batch across it) and cuts the weights the rules place
    over `data` (FSDP: each rank holds its slice, gathers it per layer
    and reduce-scatters its gradient), and on (W, 1), data parallel
    alone with every such weight cut W ways, 3 steps at lr 1e-2
    over b 4 x s 512, against the mesh-less step on card 0 from the same
    weights and batches, held by ROADMAP T61's measures: step 0's loss
    within 1e-5, grad norm within 2e-5 and gathered gradients within
    5e-5 of their largest, later losses and grad norms 1e-4 / 1e-3, and
    the parameters after one update within 2e-3 save where the two runs'
    step-0 gradients had opposite signs; T42's 3-step parameter bound
    (2e-3) is printed beside them. Beside T61, a witness that tells a
    fault from rounding (`witness`, printed, not judged): step 0's
    gradients of the mesh-less step in fp64, and how far the TP and the
    mesh-less fp32 gradients each lie from them (rounding puts both at
    one distance), and the TP step's own fp64 gradients against them
    (a fault stays, rounding falls ~1e9-fold). The same with the
    config's bf16 parameters is printed but not judged: their gradients
    come in bf16, which each data rank rounds before the sum;
(b) timing: the arch at full depth (`--timing-layers` cuts it, 0 skips
    (b)) in bf16 on the (1, W) mesh and on the (W, 1) mesh (FSDP), b 4
    x s 512 (phase 9's step): the walls of 4 steps (every rank starting
    together, each step ended by a synchronize), the peak memory of
    every card, the weights a card, the collectives of one step and its
    `perf.roofline` counts (FLOPs, bytes, temp peak) and terms; then,
    the other ranks waiting, the mesh-less step on card 0 in the same
    call.
Rank 0 prints the lines and, last, one JSON object of every number, with
the cards' names and power limits (`nvidia-smi`). For (a) the weights are
seeded on card 0 and broadcast (every rank takes part), and each rank
keeps its shards; for (b) each rank draws the seeded init a part at a
time into its shards (`train_model(generator=)`), so no card holds the
whole model. `--control` runs only the rounding control (`control`) on
one device.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import multiprocessing as mp
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

sys.path.insert(0, str(Path(__file__).resolve().parent))
from tp_steps_cards import (ARCH, ROOT, SEED, _sync, _walls, _whole_model,  # noqa: E402
                            prefill_batch)

LR, B, S, N_STEPS, TIMED, UNITS = 1e-2, 4, 512, 3, 4, 2


def _batches(cfg, n: int, b: int, s: int, dev) -> list:
    """`n` seeded global batches, the same on every rank; the first holds
    invalid labels in its first rows (unequal counts across data ranks)."""
    import torch

    g = torch.Generator().manual_seed(SEED + 5)
    out = []
    for _ in range(n):
        batch = prefill_batch(cfg, b, s, g, dev)
        batch["labels"] = torch.randint(0, cfg.vocab_size, (b, s), generator=g).to(dev)
        out.append(batch)
    out[0]["labels"][: b // 2, : s // 8] = -1
    return out


def _ocfg(steps: int):
    from repro_torch.optim import adamw

    return adamw.AdamWConfig(lr=LR, warmup_steps=2, total_steps=10 * steps)


def _grads0(model, batch: dict, mesh=None, plan=None) -> dict:
    """The first batch's gradients, whole: the mesh-less model's, or the
    TP model's summed over the data axes and gathered over the data axes
    and `model` (`sharding.whole_grads`; every rank takes part)."""
    from repro_torch.launch import steps
    from repro_torch.models import sharding

    model.requires_grad_(True)
    params = dict(model.named_parameters())
    if mesh is None:
        return steps.loss_and_grads(model, batch, params)[1]
    with sharding.sharding_ctx(mesh):
        _, g = steps._grads(model, batch, params, 1, mesh, plan.data_axes)
    return sharding.whole_grads(g, params, mesh, plan.data_axes)


def _grad_err(got: dict, want: dict) -> tuple:
    """(the largest difference of a gradient over its leaf's largest
    magnitude, which T42 holds within 5e-5; the parameter it is in)."""
    return max((_leaf_err(got, want, k), k) for k in want)


def _leaf_err(got: dict, want: dict, k: str) -> float:
    """`_grad_err` at one parameter."""
    return (float((got[k].double() - want[k].double()).abs().max())
            / max(float(want[k].double().abs().max()), 1e-300))


@contextlib.contextmanager
def _fp64_upcasts():
    """The port's fp32 upcasts (`Tensor.float()`: the SSD, the norms, the
    softmax and the loss) go to fp64 instead, so that a model in fp64
    computes in fp64 throughout."""
    import torch

    f32 = torch.Tensor.float
    torch.Tensor.float = torch.Tensor.double
    try:
        yield
    finally:
        torch.Tensor.float = f32


def witness(cfg, whole, batch: dict, mesh, dev) -> tuple:
    """Step 0's gradients in fp64 (parameters, compute and upcasts) from
    `whole`'s weights: (the TP step's on `mesh`, gathered whole on every
    rank; the mesh-less step's on rank 0, None elsewhere)."""
    import torch.distributed as dist

    from repro_torch.launch import steps
    from repro_torch.models import build_model

    c64 = dataclasses.replace(cfg, param_dtype="float64", compute_dtype="float64")
    state = {k: v.double() for k, v in whole.state_dict().items()}
    b64 = {k: v.double() if v.is_floating_point() else v for k, v in batch.items()}
    with _fp64_upcasts():
        model, plan = steps.train_model(c64, mesh, dev, state=state)
        tp = _grads0(model, b64, mesh, plan)
        del model
        bare = None
        if dist.get_rank() == 0:
            model = build_model(c64, device=dev)
            model.load_state_dict(state)
            bare = _grads0(model, b64)
            del model
    return tp, bare


def _after_one(got: dict, want: dict, g_got: dict, g_want: dict, tol: float = 2e-3) -> dict:
    """The parameters after one update against the mesh-less ones: the
    largest difference, the elements beyond `tol`, how many of those had
    step-0 gradients of opposite signs in the two runs (Adam's first
    update is lr·g/(|g| + eps), ±lr wherever |g| >> eps: a sign that
    rounding flips moves the weight 2 lr apart), and the largest |g| among
    them over its leaf's largest."""
    import torch

    err, beyond, flipped, band = 0.0, 0, 0, 0.0
    for k, w in want.items():
        d = (got[k].float() - w.float()).abs()
        err = max(err, float(d.max()))
        out = d > tol
        n = int(out.sum())
        if n:
            gg, gw = g_got[k].float()[out], g_want[k].float()[out]
            beyond += n
            flipped += int((torch.sign(gg) != torch.sign(gw)).sum())
            band = max(band, float(gw.abs().max()) / float(g_want[k].float().abs().max()))
    return {"err": err, "beyond": beyond, "flipped": flipped, "band": band}


def numerics(cfg, dev, model_par: int, b: int, s: int) -> dict:
    """(a) at one mesh: the TP step against the mesh-less step on rank 0
    from the same weights and batches: step 0's gathered gradients, the
    parameters after one update (`_after_one`) and after every step, and
    the per-step metrics."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import steps
    from repro_torch.models import sharding
    from repro_torch.optim import adamw

    mesh = mesh_mod.make_local_mesh(model_par, device=dev.type)
    whole = _whole_model(cfg, dev)
    model, plan = steps.train_model(cfg, mesh, dev, state=whole.state_dict())
    batches = _batches(cfg, N_STEPS, b, s, dev)
    g0 = _grads0(model, batches[0], mesh, plan)
    if cfg.param_dtype == "float32":
        tp64, bare64 = witness(cfg, whole, batches[0], mesh, dev)
    step = steps.build_train_step(cfg, _ocfg(N_STEPS), grad_accum=1, mesh=mesh)
    opt = steps.init_sharded(dict(model.named_parameters()), cfg, mesh)
    tp, p1 = [], None
    for bt in batches:
        opt, m = step(model, opt, bt)
        tp.append({k: float(v) for k, v in m.items()})
        if p1 is None:
            p1 = {k: v.clone() for k, v in sharding.gather_whole(model, mesh).items()}
    got = sharding.gather_whole(model, mesh)
    del model, opt
    out = {"mesh": [mesh.size(0), mesh.size(1)], "param_dtype": cfg.param_dtype, "tp": tp}
    dist.barrier()
    if dist.get_rank() == 0:       # the mesh-less step on card 0, the other ranks waiting
        want0 = _grads0(whole, batches[0])
        out["grad_err"], out["grad_err_at"] = _grad_err(g0, want0)
        if cfg.param_dtype == "float32":
            at = out["grad_err_at"]
            out["witness"] = {
                "tp32": _grad_err(g0, bare64), "bare32": _grad_err(want0, bare64),
                "tp64": _grad_err(tp64, bare64),
                "at": at, "tp32_at": _leaf_err(g0, bare64, at),
                "bare32_at": _leaf_err(want0, bare64, at)}
            del tp64, bare64
        bare_step = steps.build_train_step(cfg, _ocfg(N_STEPS), grad_accum=1)
        bare_opt = adamw.init(dict(whole.named_parameters()))
        bare = []
        for bt in batches:
            bare_opt, m = bare_step(whole, bare_opt, bt)
            bare.append({k: float(v) for k, v in m.items()})
            if p1 is not None:
                out["after_one"] = _after_one(p1, whole.state_dict(), g0, want0)
                p1 = None
        want = whole.state_dict()
        out["bare"] = bare
        out["param_err"] = max(float((got[k].float() - want[k].float()).abs().max())
                               for k in want)
        ok = all(abs(g["loss"] - w["loss"]) <= (1e-5 if i == 0 else 1e-4) * abs(w["loss"])
                 and abs(g["grad_norm"] - w["grad_norm"])
                 <= (2e-5 if i == 0 else 1e-3) * w["grad_norm"]
                 for i, (g, w) in enumerate(zip(tp, bare)))
        a1 = out["after_one"]
        out["held"] = bool(ok and out["grad_err"] <= 5e-5
                           and a1["beyond"] == a1["flipped"])    # T61
        del want0, bare_opt
    del whole, got, g0, p1
    dist.barrier()
    return out


def control(cfg, dev, b: int, s: int) -> dict:
    """The mesh-less step against itself with every batch's rows reversed
    (the same loss and updates in exact arithmetic, another summation
    order for every weight gradient), on one card and no process group:
    how far rounding alone moves T42's measures at these widths."""
    from repro_torch.device import make_generator
    from repro_torch.launch import steps
    from repro_torch.models import build_model
    from repro_torch.optim import adamw

    batches = _batches(cfg, N_STEPS, b, s, dev)
    runs = []
    for flip in (False, True):
        model = build_model(cfg, device=dev).init(make_generator(dev, SEED))
        bs = [{k: v.flip(0) for k, v in bt.items()} if flip else bt for bt in batches]
        g0 = _grads0(model, bs[0])
        step = steps.build_train_step(cfg, _ocfg(N_STEPS), grad_accum=1)
        opt = adamw.init(dict(model.named_parameters()))
        metrics, p1 = [], None
        for bt in bs:
            opt, m = step(model, opt, bt)
            metrics.append({k: float(v) for k, v in m.items()})
            if p1 is None:
                p1 = {k: v.clone() for k, v in model.state_dict().items()}
        runs.append((g0, p1, model.state_dict(), metrics))
        del opt, model
    (g0, p1, p3, m0), (g0r, p1r, p3r, m1) = runs
    err, at = _grad_err(g0r, g0)
    return {"grad_err": err, "grad_err_at": at, "after_one": _after_one(p1r, p1, g0r, g0),
            "param_err": max(float((p3r[k].float() - p3[k].float()).abs().max()) for k in p3),
            "metrics": m0, "reversed_metrics": m1}


def timing(cfg, dev, model_par: int, b: int, s: int, mesh_less: bool = True) -> dict:
    """(b) on the (world / model_par, model_par) mesh, then (with
    `mesh_less`) the mesh-less step on rank 0."""
    import torch
    import torch.distributed as dist

    from repro_torch import spmd
    from repro_torch.device import make_generator
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import steps
    from repro_torch.optim import adamw
    from repro_torch.perf import roofline

    rank = dist.get_rank()
    on_card = dev.type == "cuda"
    mesh = mesh_mod.make_local_mesh(model_par, device=dev.type)
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    # the seeded init a part at a time: no card holds the whole model
    model, _ = steps.train_model(cfg, mesh, dev, generator=make_generator(dev, SEED))
    init_peak = torch.cuda.max_memory_allocated(dev) / 1e9 if on_card else None
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    batches = _batches(cfg, TIMED + 1, b, s, dev)
    step = steps.build_train_step(cfg, _ocfg(TIMED + 1), grad_accum=1, mesh=mesh)
    opt = steps.init_sharded(dict(model.named_parameters()), cfg, mesh)
    state = {"opt": opt, "losses": []}

    def one(i):
        def fn():
            state["opt"], m = step(model, state["opt"], batches[i])
            state["losses"].append(float(m["loss"]))
        return fn
    walls = [_walls(one(i), dev, 1)[0] for i in range(TIMED)]
    peak = torch.cuda.max_memory_allocated(dev) / 1e9 if on_card else None
    spmd.reset_collectives()
    counted = roofline.analyze(one(TIMED))[1]
    cell = roofline.CellAnalysis(counted["flops"], counted["bytes"],
                                 counted["collective_bytes"], counted["collectives"])
    out = {"mesh": [mesh.size(0), mesh.size(1)], "step_ms": walls,
           "losses": state["losses"], "peak_gb": peak,
           "init_peak_gb": init_peak,
           "collectives": counted["collectives"], "flops": counted["flops"],
           "bytes": counted["bytes"], "temp_gb": counted["temp_bytes"] / 1e9,
           "compute_ms": cell.compute_s * 1e3, "memory_ms": cell.memory_s * 1e3,
           "collective_ms": cell.collective_s * 1e3,
           "params_gb": roofline.tensor_bytes(model) / 1e9}
    del model, state, opt
    if on_card:
        torch.cuda.empty_cache()
    dist.barrier()
    if rank == 0 and mesh_less:    # the mesh-less step on card 0, the others waiting
        from repro_torch.models import build_model

        whole = build_model(cfg, device=dev).init(make_generator(dev, SEED))
        whole.requires_grad_(True)
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        bare_step = steps.build_train_step(cfg, _ocfg(TIMED + 1), grad_accum=1)
        bare_opt = adamw.init(dict(whole.named_parameters()))
        bare = []
        for i in range(TIMED):
            _sync(dev)
            t0 = time.perf_counter()
            bare_opt, m = bare_step(whole, bare_opt, batches[i])
            float(m["loss"])
            _sync(dev)
            bare.append((time.perf_counter() - t0) * 1e3)
        out["bare_step_ms"] = bare
        out["bare_peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9 if on_card else None
        del whole, bare_opt
    dist.barrier()
    return out


def _progress(rank: int, dev, what: str) -> None:
    """A line on stderr: what this rank has finished, and its card's
    memory then (a rank that stops shows where)."""
    import gc

    import torch

    gc.collect()
    mem = ""
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        mem = (f", {torch.cuda.memory_allocated(dev) / 1e9:.2f} GB allocated, "
               f"peak {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
    print(f"[rank {rank}] done: {what}{mem}", file=sys.stderr, flush=True)


def rank_main(rank: int, world: int, store: str, device: str, smoke: bool, arch: str,
              q, units: int = UNITS, timing_layers: Optional[int] = None) -> None:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.dryrun import _unit_layers

    torch.set_num_threads(1 if device == "cpu" else 4)
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with mesh_mod.distributed(rank, world, store_path=store,
                                  device=None if device == "cuda" else device) as dev:
            full = get_config(arch, smoke=smoke)
            small = dataclasses.replace(_unit_layers(full, units), compute_dtype="float32",
                                        param_dtype="float32")
            half = dataclasses.replace(small, param_dtype="bfloat16")
            b, s = (4, 32) if smoke else (B, S)
            res = {"numerics": [], "bf16_params": []}
            for key, c in (("numerics", small), ("bf16_params", half)):
                for mp_ in sorted({world, world // 2, 1}, reverse=True):
                    res[key].append(numerics(c, dev, mp_, b, s))
                    _progress(rank, dev, f"{key} at model {mp_}")
            if timing_layers != 0:
                cut = full if timing_layers is None else dataclasses.replace(
                    full, n_layers=timing_layers)
                res["timing"] = timing(cut, dev, world, b, s)
                _progress(rank, dev, "timing")
                res["timing_data"] = timing(cut, dev, 1, b, s, mesh_less=False)
                _progress(rank, dev, "timing at model 1")
        q.put((rank, True, res))
    except BaseException:
        import traceback

        q.put((rank, False, traceback.format_exc()))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--world", type=int, default=None,
                    help="ranks (default: every card; 4 with --device cpu)")
    ap.add_argument("--smoke", action="store_true", help="smoke configs and short sequences")
    ap.add_argument("--arch", default=ARCH, help=f"the model (default {ARCH})")
    ap.add_argument("--control", action="store_true",
                    help="only the rounding control on one device (`control`)")
    ap.add_argument("--units", type=int, default=UNITS,
                    help=f"(a)'s depth in units (default {UNITS})")
    ap.add_argument("--timing-layers", type=int, default=None,
                    help="(b)'s depth (default: the arch's; 0 skips (b))")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("tp_train_cards: no CUDA device", file=sys.stderr)
        return 1
    if args.control:
        from repro_torch.configs import get_config

        torch.backends.cuda.matmul.allow_tf32 = False
        dev = torch.device(args.device, 0) if args.device == "cuda" else torch.device("cpu")
        from repro_torch.launch.dryrun import _unit_layers

        cfg = dataclasses.replace(_unit_layers(get_config(args.arch, smoke=args.smoke),
                                               args.units),
                                  compute_dtype="float32", param_dtype="float32")
        b, s = (4, 32) if args.smoke else (B, S)
        c = control(cfg, dev, b, s)
        a1 = c["after_one"]
        print(f"control (the mesh-less step, batch rows reversed, fp32): losses "
              f"{[m['loss'] for m in c['reversed_metrics']]} against "
              f"{[m['loss'] for m in c['metrics']]}, grad norms "
              f"{[m['grad_norm'] for m in c['reversed_metrics']]} against "
              f"{[m['grad_norm'] for m in c['metrics']]}; step-0 gradients within "
              f"{c['grad_err']:.3e} of their largest (at {c['grad_err_at']}); after one "
              f"update params within "
              f"{a1['err']:.3e}, {a1['beyond']} beyond 2e-3 ({a1['flipped']} with step-0 "
              f"gradients of opposite signs); after {N_STEPS} within {c['param_err']:.3e}")
        print(json.dumps(c))
        return 0
    world = args.world or (torch.cuda.device_count() if args.device == "cuda" else 4)
    if world < 2 or world % 2:
        print(f"tp_train_cards: needs an even number of ranks >= 2, not {world}",
              file=sys.stderr)
        return 1
    card = ""
    if args.device == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip()
        print(card)
    (ROOT / "build").mkdir(exist_ok=True)
    store = tempfile.mktemp(dir=ROOT / "build")
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=rank_main,
                         args=(r, world, store, args.device, args.smoke, args.arch, q,
                               args.units, args.timing_layers))
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    try:
        for _ in range(world):      # the first failure ends every rank: the others
            rank, good, res = q.get(timeout=1500)    # would wait in a collective
            if not good:
                print(f"rank {rank} failed:\n{res}", file=sys.stderr, flush=True)
                return 1
            results[rank] = res
    finally:
        for p in procs:
            p.join(timeout=60 if len(results) == world else 0)
            if p.is_alive():
                p.kill()
    r0 = results[0]
    for tag, runs in (("(a)", r0["numerics"]), ("(a, bf16 params: not judged)",
                                                 r0["bf16_params"])):
        for n in runs:
            a1 = n["after_one"]
            print(f"{tag} mesh {n['mesh']}: TP losses {[m['loss'] for m in n['tp']]} grad "
                  f"norms {[m['grad_norm'] for m in n['tp']]}; mesh-less losses "
                  f"{[m['loss'] for m in n['bare']]} grad norms "
                  f"{[m['grad_norm'] for m in n['bare']]}; step-0 gradients within "
                  f"{n['grad_err']:.3e} of their largest (at {n['grad_err_at']}); after one "
                  f"update params within "
                  f"{a1['err']:.3e}, {a1['beyond']} beyond 2e-3 ({a1['flipped']} with "
                  f"step-0 gradients of opposite signs, the largest |g| among them "
                  f"{a1['band']:.3e} of its leaf's); after {N_STEPS} within "
                  f"{n['param_err']:.3e} (T42's bound 2e-3): T61 held {n['held']}")
            w = n.get("witness")
            if w:
                print(f"{tag} mesh {n['mesh']} witness, against the mesh-less step's fp64 "
                      f"step-0 gradients: TP fp32 within {w['tp32'][0]:.3e} (at "
                      f"{w['tp32'][1]}), mesh-less fp32 within {w['bare32'][0]:.3e} (at "
                      f"{w['bare32'][1]}), TP fp64 within {w['tp64'][0]:.3e} (at "
                      f"{w['tp64'][1]}); at {w['at']}: TP fp32 {w['tp32_at']:.3e}, "
                      f"mesh-less fp32 {w['bare32_at']:.3e}")
    bare = r0.get("timing", {})
    for key in ("timing", "timing_data"):
        t = r0.get(key)
        if not t:
            continue
        print(f"(b) {tuple(t['mesh'])} step walls {[round(x, 1) for x in t['step_ms']]} ms "
              f"(mesh-less on card 0: "
              f"{[round(x, 1) for x in bare.get('bare_step_ms', [])]} ms); peak per card "
              f"{[results[r][key]['peak_gb'] for r in sorted(results)]} GB (mesh-less "
              f"{bare.get('bare_peak_gb')} GB); weights a card {t['params_gb']:.2f} GB, peak "
              f"while drawing the init {t['init_peak_gb']} GB; one step: collectives "
              f"{json.dumps(t['collectives'])}, FLOPs {t['flops']:.4e}, bytes "
              f"{t['bytes']:.4e}, temp peak {t['temp_gb']:.2f} GB; terms (H100 bounds) "
              f"compute {t['compute_ms']:.1f} / memory {t['memory_ms']:.1f} / collective "
              f"{t['collective_ms']:.2f} ms")
    good = all(n["held"] for n in r0["numerics"])
    print(json.dumps({"card": card, "arch": args.arch, "world": world,
                      "numerics": r0["numerics"],
                      "bf16_params": r0["bf16_params"],
                      "timing": {r: results[r].get("timing") for r in results},
                      "timing_data": {r: results[r].get("timing_data") for r in results}}))
    return 0 if good else 2


if __name__ == "__main__":
    sys.exit(main())
