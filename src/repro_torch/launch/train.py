"""The training entry point: --arch <id>, resumable — counterpart of
`repro.launch.train`.

  * deterministic resumable data pipeline (bit-exact restart)
  * atomic rotating checkpoints (+ optional async save)
  * preemption-safe resume (the latest complete checkpoint wins)
  * a checkpoint restores on another device than the one that wrote it
  * straggler watchdog (logs steps > 3x the running median)
  * under a process group (`launch.mesh.init_distributed`, one process a
    rank, each calling `train` with the same arguments) the run is
    sharded over `make_local_mesh(model_par)`: data parallel over the
    world // model_par data ranks, tensor parallel over the model_par
    `model` ranks (each holds its resident shards of the weights: its
    `model` shard and, where the rules cut a weight over `data`, that
    data rank's slice of it, FSDP; `steps.train_model`), ZeRO-1
    optimizer state, the parameters and
    state placed by the reference's tables (`launch.steps`,
    `build_train_step(mesh=)`); without one it runs mesh-less, which is
    world size 1 (and `model_par` > 1 raises). The seeded init is drawn
    whole, as the mesh-less run draws it, then cut
  * elastic reshard: a checkpoint holds each tensor whole (the ranks
    all-gather the weights over the data axes and `model` and the state
    over every mesh dim, rank 0 writes), so one saved under one mesh
    restores under another, or without one

Runs on the card (`device=None`) unless asked for the CPU. The audio
family's stub frames are drawn per step from a `torch.Generator` seeded
with the step on the model's device (not the JAX package's draws).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-34b --smoke \\
      --steps 100 --ckpt-dir <dir>
  PYTHONPATH=src python -m repro_torch.launch.train --arch phi4-mini-3.8b --full \\
      --steps 8 --batch 4 --seq 512 --lr 1e-3
"""
from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist

from repro_torch.checkpointing import CheckpointManager, StepWatchdog
from repro_torch.configs import get_config
from repro_torch.data import DataPipeline
from repro_torch.device import make_generator, resolve_device
from repro_torch.models import build_model, sharding
from repro_torch.optim import adamw
from . import steps as steps_mod
from .mesh import make_local_mesh


def audio_frames(cfg, batch: int, step: int, device: torch.device) -> torch.Tensor:
    """Step `step`'s stub frame embeddings (batch, n_frames, d_enc), bf16."""
    e = cfg.encoder
    g = make_generator(device, step)
    return torch.randn((batch, e.n_frames, e.d_model), generator=g,
                       device=device).to(torch.bfloat16)


def train(arch: str, smoke: bool = True, steps: int = 100, batch: int = 8,
          seq: int = 64, lr: float = 1e-2, ckpt_dir: str | None = None,
          ckpt_every: int = 50, async_ckpt: bool = False, model_par: int = 1,
          log_every: int = 10, seed: int = 0, device=None) -> dict:
    """Train `arch` from a seeded init (or the latest checkpoint in
    `ckpt_dir`) up to step `steps`. Returns {losses, grad_norms, step_ms
    (host wall of each step, synchronised by reading its loss),
    peak_bytes (on the card: `max_memory_allocated` after each step),
    final_loss, stragglers, model, opt} (under a process group `opt` is
    this rank's shards)."""
    dev = resolve_device(device)
    mesh = None
    if dist.is_initialized():
        mesh = make_local_mesh(model_par, device=dev)
    elif model_par > 1:
        raise ValueError(f"model_par {model_par} needs a process group of a world size "
                         "it divides: start one with launch.mesh.init_distributed")
    writer = mesh is None or dist.get_rank() == 0
    cfg = get_config(arch, smoke=smoke)
    if mesh is None:
        model = build_model(cfg, device=dev).init(make_generator(dev, seed))
    else:       # the seeded init cut a part at a time: no rank holds the whole model
        model, plan = steps_mod.train_model(cfg, mesh, dev, generator=make_generator(dev, seed))
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    ocfg = adamw.AdamWConfig(lr=lr, warmup_steps=max(steps // 20, 5), total_steps=steps)
    step_fn = steps_mod.build_train_step(cfg, ocfg, grad_accum=1, mesh=mesh)

    pipe = DataPipeline(cfg.vocab_size, batch=batch, seq=seq, seed=seed)
    mgr = CheckpointManager(ckpt_dir, keep=3, async_save=async_ckpt) \
        if ckpt_dir else None
    watchdog = StepWatchdog()

    opt = adamw.init(params) if mesh is None else steps_mod.init_sharded(params, cfg, mesh)
    start = 0
    if mgr is not None and mgr.latest_step() is not None:
        if mesh is None:
            start, state = mgr.restore({"params": params, "opt": opt}, device=dev)
            opt = state["opt"]
            with torch.no_grad():
                for k, p in params.items():
                    p.copy_(state["params"][k])
        else:   # whole tensors on the host, then this rank's shards
            whole = dict(build_model(cfg, device="meta").named_parameters())
            start, state = mgr.restore({"params": whole,
                                        "opt": steps_mod.state_template(whole)},
                                       device="cpu")
            opt = steps_mod.scatter_state(state["opt"], cfg, mesh, dev)
            sharding.load_whole(model, state["params"], plan.port_specs, mesh)
        del state
        pipe = DataPipeline(cfg.vocab_size, batch=batch, seq=seq, seed=seed,
                            start_step=start)
        if writer:
            print(f"[train] resumed from step {start}")

    losses, grad_norms, step_ms, peak_bytes = [], [], [], []
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    try:
        for step in range(start, steps):
            watchdog.start()
            t0 = time.perf_counter()
            b = {k: torch.from_numpy(v).to(dev, torch.long)
                 for k, v in pipe.batch_at(step).items()}
            if cfg.family == "audio":
                b["frames"] = audio_frames(cfg, batch, step, dev)
            opt, metrics = step_fn(model, opt, b)
            loss = float(metrics["loss"])
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss)
            grad_norms.append(float(metrics["grad_norm"]))
            if on_card:
                peak_bytes.append(torch.cuda.max_memory_allocated(dev))
            if watchdog.stop(step):
                print(f"[watchdog] straggler step {step}: "
                      f"{watchdog.durations[-1]:.2f}s")
            if step % log_every == 0 and writer:
                print(f"step {step:5d} loss {loss:.4f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"gnorm {grad_norms[-1]:.2f}", flush=True)
            if mgr is not None and (step + 1) % ckpt_every == 0:
                if mesh is None:
                    tree = {"params": params, "opt": opt}
                else:   # every rank takes part in the gathers
                    tree = {"params": sharding.gather_whole(model, mesh),
                            "opt": steps_mod.gather_state(opt, cfg)}
                if writer:
                    mgr.save(step + 1, tree, metadata={"arch": arch, "loss": loss})
                del tree
    finally:
        if mgr is not None:   # an async save in flight completes, even on a fault
            mgr.wait()
    if mgr is not None and mesh is not None:
        dist.barrier()   # rank 0's checkpoints are written before any rank returns
    return {"losses": losses, "grad_norms": grad_norms, "step_ms": step_ms,
            "peak_bytes": peak_bytes, "final_loss": losses[-1] if losses else float("nan"),
            "stragglers": watchdog.stragglers, "model": model, "opt": opt}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--async-ckpt", action="store_true")
    ap.add_argument("--model-par", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs on the host)")
    args = ap.parse_args()
    t0 = time.time()
    out = train(args.arch, smoke=args.smoke, steps=args.steps,
                batch=args.batch, seq=args.seq, lr=args.lr,
                ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                async_ckpt=args.async_ckpt, model_par=args.model_par,
                device=args.device)
    print(f"done: final loss {out['final_loss']:.4f} "
          f"({time.time()-t0:.0f}s, {len(out['stragglers'])} stragglers)")


if __name__ == "__main__":
    main()
