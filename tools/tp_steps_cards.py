#!/usr/bin/env python3
"""The production inference steps (`launch.steps.build_cell`) tensor-
parallel across the cards of one host, one process a card over NCCL:

    python3 tools/tp_steps_cards.py                      # every card of the host
    python3 tools/tp_steps_cards.py --device cpu --smoke  # 4 gloo ranks, smoke configs

(a) numerics: phi4-mini-3.8b at its published widths cut to 2 layers, in
    fp32, on the (1, W) mesh (every head, the MLP and the vocabulary
    split W ways) and on (2, W / 2): the serve step at b 8 against caches
    of 4096 positions at mixed lengths (one at capacity) and the prefill
    step at b 2 x s 512, against the mesh-less model on each card
    (tokens, and the logits' largest difference);
(b) timing: phi4-mini at full depth in bf16 on the (1, W) mesh: the serve
    step at decode_32k's share of a data rank (b 8 against caches of
    32768 at length 32767) and the prefill step at prefill_32k's (b 2 x
    s 32768, `attn_chunk` 2048 as `chip_smoke.py` phase 11 runs it), host
    walls ended by a synchronize on every rank, with the collectives one
    serve step issues and its `perf.roofline` terms; then the mesh-less
    model's serve and prefill steps on card 0 in the same call.
Rank 0 prints the lines and, last, one JSON object of every number, with
the cards' names and power limits (`nvidia-smi`). Weights are seeded on
card 0 and broadcast, so every rank holds the same model.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing as mp
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
ARCH, SEED = "phi4-mini-3.8b", 0


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _walls(fn, dev, reps: int) -> list:
    """Host walls (ms) of `reps` calls of `fn`, every rank starting
    together and each call ended by a synchronize."""
    import torch.distributed as dist

    out = []
    for _ in range(reps):
        dist.barrier()
        _sync(dev)
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def _whole_model(cfg, dev):
    """The model whole on this rank's device, seeded on rank 0 and
    broadcast from it."""
    import torch
    import torch.distributed as dist

    from repro_torch.device import make_generator
    from repro_torch.models import build_model

    model = build_model(cfg, device=dev)
    if dist.get_rank() == 0:
        model.init(make_generator(dev, SEED))
    with torch.no_grad():
        for p in model.parameters():
            dist.broadcast(p.data, src=0)
    return model


def _err_max(x: float) -> float:
    import torch
    import torch.distributed as dist

    t = torch.tensor([x], dtype=torch.float64)
    if dist.get_backend() == "nccl":
        t = t.cuda()
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t)


def numerics(cfg, dev, model_par: int, seq: int, prefill_s: int) -> dict:
    """(a) at one mesh: tokens equal on every rank's rows, and the largest
    logit difference over all ranks."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import steps
    from repro_torch.models import layers

    mesh = mesh_mod.make_local_mesh(model_par, device=dev.type)
    data = mesh.get_local_rank("data")
    b = 8
    whole = _whole_model(cfg, dev)
    serve = steps.build_cell(cfg, mesh, ShapeConfig("decode_32k", seq, b, "decode"),
                             device=dev)
    serve.load_state_dict(whole.state_dict())
    g = torch.Generator().manual_seed(SEED + 1)
    lengths = torch.tensor([5, seq // 3, seq - 1, seq, seq // 2 + 1, 1, seq * 3 // 4, 0],
                           dtype=torch.int32)
    token = torch.randint(0, cfg.vocab_size, (b, 1), generator=g)

    def caches():
        c = whole.init_caches(b, seq, 0)
        with torch.inference_mode():
            for t in (c.k, c.v):
                t.copy_(torch.randn(t.shape, generator=torch.Generator().manual_seed(SEED + 2)))
        return c._replace(length=lengths.to(dev))
    want, _ = whole.decode_step(caches(), token.to(dev))
    batch = serve.local_batch({"token": token.to(dev)})
    n = batch["token"].shape[0]
    rows = slice(data * n, (data + 1) * n)
    tok, _ = serve.fn(serve.local_caches(caches()), batch)
    with serve.context():
        local = serve.local_caches(caches())
        local = local._replace(length=local.length[rows])
        got = layers.gather_vocab(cfg, serve.model.decode_step(local, batch["token"])[0])
    same = bool(torch.equal(tok, torch.argmax(want[rows], dim=-1).to(torch.int32)))
    err = float((got - want[rows]).abs().max())
    del serve

    pre = steps.build_cell(cfg, mesh, ShapeConfig("prefill_32k", prefill_s, 2, "prefill"),
                           device=dev)
    pre.load_state_dict(whole.state_dict())
    tokens = torch.randint(0, cfg.vocab_size, (2, prefill_s), generator=g).to(dev)
    with torch.inference_mode():
        want_p = steps.last_logits(whole, {"tokens": tokens})
    pb = pre.local_batch({"tokens": tokens})
    np_ = pb["tokens"].shape[0]
    prow = slice(data * np_, (data + 1) * np_) if np_ < 2 else slice(0, 2)
    ptok = pre.fn(pb)
    with pre.context(), torch.inference_mode():
        got_p = layers.gather_vocab(cfg, steps.last_logits(pre.model, pb))
    same_p = bool(torch.equal(ptok, torch.argmax(want_p[prow], dim=-1).to(torch.int32)))
    err_p = float((got_p - want_p[prow]).abs().max())
    flags = torch.tensor([int(same), int(same_p)], dtype=torch.int32,
                         device=dev if dist.get_backend() == "nccl" else "cpu")
    dist.all_reduce(flags, op=dist.ReduceOp.MIN)
    return {"mesh": [mesh.size(0), mesh.size(1)], "serve_tokens_equal": bool(flags[0]),
            "serve_logit_err": _err_max(err), "prefill_tokens_equal": bool(flags[1]),
            "prefill_logit_err": _err_max(err_p)}


def timing(cfg, dev, world: int, decode, prefill, prefill_chunk: int, reps: int) -> dict:
    """(b) on the (1, world) mesh, then the mesh-less steps on rank 0."""
    import torch
    import torch.distributed as dist

    from repro_torch import spmd
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import steps
    from repro_torch.perf import roofline

    rank = dist.get_rank()
    mesh = mesh_mod.make_local_mesh(world, device=dev.type)
    whole = _whole_model(cfg, dev)
    art = steps.build_cell(cfg, mesh, decode, device=dev)
    art.load_state_dict(whole.state_dict())
    caches = art.new_caches()
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    with torch.inference_mode():
        for i in range(cfg.n_layers):
            caches.k[i].normal_(generator=g)
            caches.v[i].normal_(generator=g)
    batch = {"token": torch.randint(0, cfg.vocab_size, (decode.global_batch, 1), generator=g,
                                    device=dev)}
    art.fn(caches, batch)
    spmd.reset_collectives()
    art.fn(caches, batch)
    coll = spmd.read_collectives()
    walls = _walls(lambda: art.fn(caches, batch), dev, reps)
    local = roofline.tensor_bytes(art.model, caches.k, caches.v)
    cell = roofline.CellAnalysis(0.0, local, coll["total_bytes"], coll)
    out = {"serve_ms": walls, "local_bytes": local, "collectives": coll,
           "memory_ms": cell.memory_s * 1e3, "collective_ms": cell.collective_s * 1e3,
           "peak_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                       if dev.type == "cuda" else None)}
    del caches, art
    cfg_p = dataclasses.replace(cfg, attn_chunk=prefill_chunk)
    art = steps.build_cell(cfg_p, mesh, prefill, device=dev)
    art.load_state_dict(whole.state_dict())
    if rank:
        del whole
    tokens = torch.randint(0, cfg.vocab_size, (prefill.global_batch, prefill.seq_len),
                           generator=g, device=dev)
    out["prefill_ms"] = _walls(lambda: art.fn({"tokens": tokens}), dev, 1)
    del art
    dist.barrier()
    if rank == 0:          # the mesh-less steps on card 0, the other ranks waiting
        c = whole.init_caches(decode.global_batch, decode.seq_len, decode.seq_len - 1)
        t = batch["token"]

        def bare():
            return whole.decode_step(c, t)[0]
        bare()
        out["bare_serve_ms"] = []
        for _ in range(reps):
            _sync(dev)
            t0 = time.perf_counter()
            bare()
            _sync(dev)
            out["bare_serve_ms"].append((time.perf_counter() - t0) * 1e3)
        del c
        whole.cfg = cfg_p
        _sync(dev)
        t0 = time.perf_counter()
        with torch.inference_mode():
            steps.last_logits(whole, {"tokens": tokens})
        _sync(dev)
        out["bare_prefill_ms"] = [(time.perf_counter() - t0) * 1e3]
    dist.barrier()
    return out


def rank_main(rank: int, world: int, store: str, device: str, smoke: bool, q) -> None:
    import torch

    from repro_torch.configs import DECODE_32K, PREFILL_32K, get_config
    from repro_torch.launch import mesh as mesh_mod

    torch.set_num_threads(1 if device == "cpu" else 4)
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with mesh_mod.distributed(rank, world, store_path=store,
                                  device=None if device == "cuda" else device) as dev:
            full = get_config(ARCH, smoke=smoke)
            small = dataclasses.replace(full, n_layers=2, compute_dtype="float32")
            seq, pre_s = (64, 32) if smoke else (4096, 512)
            res = {"numerics": [numerics(small, dev, world, seq, pre_s),
                                numerics(small, dev, world // 2, seq, pre_s)]}
            decode = dataclasses.replace(DECODE_32K, global_batch=8,
                                         seq_len=64 if smoke else DECODE_32K.seq_len)
            prefill = dataclasses.replace(PREFILL_32K, global_batch=2,
                                          seq_len=64 if smoke else PREFILL_32K.seq_len)
            res["timing"] = timing(full, dev, world, decode, prefill, 16 if smoke else 2048,
                                   5)
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
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("tp_steps_cards: no CUDA device", file=sys.stderr)
        return 1
    world = args.world or (torch.cuda.device_count() if args.device == "cuda" else 4)
    if world < 2 or world % 2:
        print(f"tp_steps_cards: needs an even number of ranks >= 2, not {world}", file=sys.stderr)
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
    procs = [ctx.Process(target=rank_main, args=(r, world, store, args.device, args.smoke, q))
             for r in range(world)]
    for p in procs:
        p.start()
    results, ok = {}, True
    try:
        for _ in range(world):
            rank, good, res = q.get(timeout=1500)
            results[rank] = res
            if not good:
                print(f"rank {rank} failed:\n{res}", file=sys.stderr)
                ok = False
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    if not ok:
        return 1
    r0 = results[0]
    for n in r0["numerics"]:
        print(f"(a) mesh {n['mesh']}: serve tokens equal {n['serve_tokens_equal']}, logits "
              f"within {n['serve_logit_err']:.3e}; prefill tokens equal "
              f"{n['prefill_tokens_equal']}, logits within {n['prefill_logit_err']:.3e}")
    t = r0["timing"]
    print(f"(b) (1, {world}) serve step walls {[round(x, 2) for x in t['serve_ms']]} ms "
          f"(mesh-less on card 0: {[round(x, 2) for x in t.get('bare_serve_ms', [])]} ms); "
          f"per rank {t['local_bytes'] / 1e9:.2f} GB read: memory term {t['memory_ms']:.2f} ms, "
          f"collectives {json.dumps(t['collectives'])} -> {t['collective_ms']:.3f} ms at "
          f"450 GB/s; peak {t['peak_gb']} GB; prefill {t['prefill_ms']} ms (mesh-less "
          f"{t.get('bare_prefill_ms')} ms)")
    good = all(n["serve_tokens_equal"] and n["prefill_tokens_equal"] for n in r0["numerics"])
    print(json.dumps({"card": card, "world": world, "numerics": r0["numerics"],
                      "timing": {r: results[r]["timing"] for r in results}}))
    return 0 if good else 2


if __name__ == "__main__":
    sys.exit(main())
