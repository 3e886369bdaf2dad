#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA card; builds the kernels

Phases, each raising on a failed check (the process then exits non-zero
and prints no result):
  1. K1 `dirc_mac` and K2 `score_matmul_int` against their plain PyTorch
     versions on the card, bit-equal int32 outputs, with kernel / plain /
     `torch._int_mm` times; K1 also on random plane words (any bit
     pattern is a code, as sensed flips give), all-ones and sign-only
     planes, at b 3 / 32 / 72, n 8229 / 16384, dim 128 / 512 / 1024, bits
     4 and 8; K2 at every edge of its tiling (b 1 / 3 / 8 / 16 / 17 / 63 /
     64 / 65 / 72 x n 37 / 8192 / 8229 / 16384 x dim 16 / 48 / 128 / 512 /
     1024 / 3072) and on all -128 codes, and timed in turns with
     `_int_mm` (kernel, library, kernel, library), single launches and
     back-to-back, at b 8 and 64 over 8192 docs and b 72 over 16384;
  1b. K3 `paged_attend_fused` against its plain version at phi4-mini's
     attention shapes (decode, chunked prefill, block edges, inactive
     lanes, a poisoned NULL block, new-token pool cells poisoned before
     the call, part-empty row tiles, b 16 with mixed lengths, a table
     width that is not a chunk multiple, a CoW-shared table; bf16 pools
     and fp32 cases), pools bit-equal outside block 0; the combine kernel
     against `combine` on partials with fully masked chunks and a query
     with no visible position; kernel / plain /
     `scaled_dot_product_attention` times at the streaming path's decode
     shape and at a prefill piece, each held against the plain version on
     the timed inputs; every prefill piece of a 287-token prompt at the
     table widths the streaming engine gives it; K3's prefill path at the
     2,048-token pieces of the benchmark's cells (a docqa prompt's first
     two, phi3.5-moe's g 4 piece) held against the plain version and
     timed beside its bound and the split path on the same inputs; the
     device kernels of one K3 call (2 on the split path, 1 on the prefill
     path) and one K1 call (1), each counted in a profiler run of
     its own after a warm-up, and of one K2 and one K5 call (1 each);
  1c. K4 `blockwise_topk` (the cores' local comparator), its fused entry
     `hierarchical_select` (local and global comparator in one launch, what
     every search runs) and K5 `score_matmul_cosine` against their plain
     versions, bit-equal: K4 at the monolithic and the 4-macro search
     shapes, the JAX kernel test's sweep through `ops.local_topk_blocks`,
     all-zero ties, signed zeros and blocks with fewer than k scores above
     -inf; the fused entry at every search shape of phases 2, 4 and 5,
     signed zeros and -inf tails; K5 at K2's edge shapes up to dim
     1024, each with a zero-norm query row, and on all -128 codes; kernel
     / plain / library (`torch.topk`, `torch._int_mm` + the division)
     times, each kernel and its library call in turns, single launches
     and back-to-back (K4 also at k 64); the device kernels of one
     `core.topk.hierarchical_topk` call (1) and its host wall per call;
     K5's entry point `ops.score_matmul_cosine` driven once;
  2. the synchronous path: `RagPipeline.query_many` at the paper's
     operating point (8192-document corpus, dim 512, INT8 cosine, 16
     cores) with phi4-mini-3.8b at full width, once through K1 (path
     `kernel_bitserial`) and once through K2 (path `kernel_mxu`); launch
     counts, self-retrieval, agreement with path `int_exact`, phase times;
  3. the sensing-error channel with Sigma-D detection through K1;
  4. the streaming path: `RagPipeline.query_stream(generate=True,
     paged=True, paged_kernel=True)` over 16 requests with the same model
     (retrieval through K1, decode through K3 on the paged KV pool with
     chunked prefill and CoW prefix sharing); the same prompts again
     through a manual-mode engine for its counters; and greedy token
     parity of the K3, gather and fixed-slot engines at phi4-mini's full
     width cut to 4 layers in fp32;
  5. the sharded path (`launch.serve.serve_rag`, 4 macros of 2048
     documents, 16 cores each) at the same operating point over phase 2's
     embeddings, through paths `int_exact` (K4) and `kernel_bitserial`
     (K1 + K4): self-retrieval, ids equal to the monolithic index's,
     kernel launches equal to the searches; `add_docs` / `delete_docs`
     (the capacity doubles); a drifting error channel whose
     recalibration controller must fire on an injected clock; and
     `serve_rag_open_loop`. The card's searches are held against the same
     macro images searched on the CPU by the plain versions, and K1 / K4
     against their plain versions at every shape the phase gives them
     (the fused entry at every shape it recorded the searches sending);
  6. generation serving over phase 5's 4-macro index (path
     `kernel_bitserial`) with phi4-mini at full width: (a)
     `serve_rag_open_loop_generate` at a backlogging Poisson rate, 2
     replicas of `EngineConfig(n_slots=4, paged=True, paged_kernel=True,
     retain_blocks=8, host_blocks=64)` behind the prefix-affinity router,
     the SLO controller with preemption on and one priority-1 tenant; (b)
     3 waves of the same 8 retrieved contexts through `query_stream` over
     the fleet, each wave after the last drained (retained-tier hits,
     host-tier swap-ins and affinity hits required, no leaked block after
     `clear_prefix_cache`); (c) at full width cut to 4 layers in fp32:
     preempt / resume token-identical with retention and without,
     `preempt_for_waiting` under pool pressure, a host-tier round trip
     bit-equal, the 2-replica router against one engine, and `serve` at
     full width; then K1, the fused K4 and K3 held against their plain
     versions at every shape the phase sent them;
  7. the other DecoderLM families, after phase 6's model is freed: (a)
     phi3.5-moe-42b-a6.6b at its published widths (16 experts top-2,
     d_ff 6400, 32/8 heads of 128; depth cut to 16 of 32 layers: 41.9 GB
     in bf16, all 32 would not fit the card) over phase 5's 4-macro
     `kernel_bitserial` index through `query_many` and `query_stream`
     with K3, then a probe engine with 8 sequences in decode: the step
     wall against its bytes bound, one profiled step (busy share,
     launches, the MoE layers' share of device time) and the dropped
     fraction of a decode step and a prefill piece; (b) 2 layers in fp32:
     the K3 and gather paged engines token-identical, `apply_moe` at C =
     T against a per-token loop; (c) phi3-medium, granite (MQA),
     command-r-plus, qwen2-vl and arctic at their published widths (2
     layers, Arctic 1; bf16) through a 32-token prefill piece and 4
     decode steps with K3, finite logits; then K1, the fused K4 and K3
     held at every shape sent (K3 at g 4 / 8 / 12 / 48), and K3 timed at
     granite's MQA and phi3.5-moe's decode shapes;
  8. the ssm, hybrid and audio families, after phase 7's models are
     freed: (a) mamba2-2.7b at its published widths, its depth cut to 32
     of 64 layers (bf16, ~2.7 GB; every prompt token is a decode step of
     the whole depth, and phase 16 needed the time) over phase 5's
     4-macro `kernel_bitserial`
     index: `query_many` (phase 2's 8 queries, prompts cut to 96 tokens)
     and `query_stream(generate=True, paged=True)` over 4 requests
     through the slot-resident engine (prompts streamed through
     `decode_step` at b 1, `prefill_chunk` tokens a step; no pool, K3
     never launched), then a decode step at b 8 against its bytes bound,
     with one profiled step (busy share, launches); (b) zamba2-2.7b at
     full depth: `GenerationEngine.generate` at b 4, the slot-resident
     engine over 4 requests, the b-8 probe; (c) whisper-small: encode
     1500 frames (b 4) against its FLOP bound -> `precompute_cross` -> 8
     decode steps, and both engines (zero cross K/V, as the reference
     serves it); (d) each at full width cut to 4 layers (whisper 2 + 2)
     in fp32: the whole-sequence forward against the same tokens streamed
     through `decode_step`, and `GenerationEngine`, the fixed-slot and
     the slot-resident engines token-identical; then K1 and the fused K4
     held at every shape the phase sent;
  9. training, after phase 8's models are freed (no TPU kernel lies on the
     training path; it launches none of K1-K5): (a) phi4-mini-3.8b at its
     published widths and full depth through `launch.train.train(...,
     smoke=False)` (bf16 params, remat "full", fp32 AdamW, b 4 x s 512, 8
     steps; per step loss, grad norm, wall, tokens/s, peak memory; the
     last two losses must average below the first), then fwd + bwd and
     the optimizer step timed apart against their FLOP and bytes bounds;
     (b) 2 layers at published widths in fp32: loss and every gradient
     on the card against the CPU, and the fused head loss against the
     explicit logits at the full 200064 vocab; (c) mamba2 at smoke size:
     a preempted run resumed from its checkpoint repeats the straight
     run's losses bit for bit under deterministic algorithms (and whether
     it does without them), a checkpoint crosses card -> CPU -> card bit
     for bit, and the CPU resumes from the card's checkpoint; (d) the
     8-bit-moment AdamW on the card (the reference's quadratic case, the
     state's bytes per parameter);
  10. scale-out on a world-size-1 NCCL group, after phase 9 (every
     serving thread has stopped): (a) the flat-index searcher
     (`make_distributed_searcher` over `shard_index_arrays` on the macro
     mesh) at the 4 MB operating point, cosine and MIPS, bit-equal to the
     single-device flat top-k, its time a batch of 8 beside a
     single-device `kernel_mxu` search; (b) phase 5's 4-macro index with
     `parallelism="shard_map"` against `vmap` on the all-gather route
     (`int_exact`) and the kernel route (`kernel_bitserial`); (c)
     `launch.train.train` under `make_local_mesh(1)` at phi4-mini's
     published widths and full depth (32 layers), 2 steps, losses and grad norms
     bit-equal to the mesh-less driver's (peak memory and step walls of
     both); (d) `compressed_psum` against its CPU arithmetic;
  11. the production inference steps (`launch.steps.build_cell`) on a
     world-size-1 NCCL group of their own, after phase 10, at published
     widths and full depth: (a) phi4-mini-3.8b's serve step at b 8
     against caches of capacity 32768 at length 32767 (decode_32k's share
     of one of 16 data ranks), tokens bit-equal to the mesh-less
     `decode_step`, 5 steps timed against the bytes bound from
     `perf.roofline`, the FLOPs `FlopCounterMode` counts and the
     collective counter; (b) its prefill step at b 2 x s 32768 (prefill_32k's
     share), the head at the last position, token bit-equal to the
     mesh-less forward's, timed against the FLOP bound; (c) mamba2-2.7b's
     long_500k serve step at b 1; peaks after each. No kernel of K1-K5
     lies on these steps (the reference's steps attend with plain jnp);
  12. tensor-parallel training and the dry run, after phase 11: (a) the
     train cell of `launch.steps.build_cell` (its model holds the `model`
     shards of the reference's train table) on a world-size-1 NCCL group
     of its own, phi4-mini-3.8b at published widths and full depth, bf16,
     b 4 x s 512, 2 steps, losses and grad norms bit-equal to the
     mesh-less step's under deterministic algorithms, with walls, peak
     and one step's `perf.roofline` counts; (c) one TP step at 2 layers
     over a fake (1, 4) world on the card, whose backward runs on
     autograd's device thread; (b) after phase 14, last, `python -m
     repro_torch.launch.dryrun --mesh single`, every (arch x shape) cell
     on a fake 256-rank world, in a subprocess on the host's CPU with JAX
     blocked from import: every record `ok` or `skipped`, none an
     `error` (the MoE cells included). No kernel of K1-K5 lies on the
     training path;
  13. tensor-parallel compute for the ssm, hybrid and audio families:
     (a) on a world-size-1 NCCL group at published widths and full depth,
     zamba2-2.7b's and whisper-small's serve steps (b 8 against
     32768-slot caches) and prefill steps (b 2 x s 32768) through
     `build_cell`, tokens bit-equal to the mesh-less model on the same
     caches and inputs, and mamba2-2.7b's train cell, 2 steps bit-equal
     to the mesh-less step; (b) each family cut to one unit of depth on a
     fake (1, 4) world on the card, the serve, prefill and train cells
     run once with the seeded init streamed into their shards. No kernel
     of K1-K5 lies on these steps;
  14. MoE routing over the global batch under a data axis: (a) on a
     world-size-1 NCCL group, phi3.5-moe at published widths, its serve
     step (b 8 against 32768-slot caches, 16 layers) and prefill step (b
     2 x s 32768, 4 layers) through `build_cell`, tokens bit-equal to the
     mesh-less model with no collective, and its train cell at 2 layers,
     2 steps bit-equal to the mesh-less step with no all-gather; (b) fake
     (2, 2) and (4, 1) worlds on the card: phi3.5-moe's serve, prefill
     and train cells (one microbatch) and arctic's serve and prefill cells
     at one unit of published depth, arctic's train cell at smoke widths,
     each run once
     with the seeded init streamed in, their collectives printed (one
     all-gather and one all-reduce a MoE layer forward over `data`, and
     the MoE placement's FSDP gathers). No kernel of K1-K5 lies on these
     steps;
  15. FSDP over `data`: phi4-mini's train cell at published widths and
     full depth on a fake (4, 1) world on the card, 2 steps, each rank
     holding a quarter of every weight the rules cut over `data`: the
     resident weight and state bytes and the peak a card beside phase
     12a's (1, 1) step, and the all-gathers and reduce-scatters a step.
     No kernel of K1-K5 lies on this step;
  16. the twins of the reference's examples (`examples_torch/`), each
     through its `main` on the card as a user runs it: (a) edge_sim (host
     arithmetic) line for line as its CPU run; (b) quickstart (4096 x 512
     INT8, clean `int_exact` and noisy `bitserial` with Sigma-D
     detection): clean P@5 and every query's top-5 ids equal to its CPU
     run's, the fused K4 launched; (c) rag_serve (phi4-mini's smoke model,
     4 shards, both schedulers, the streams, the fixed-slot engine): every
     retrieved id equal to its CPU run's, K4 launched; (d) train_lm: the
     100M config at full width, 300 steps at b 8 x s 256 with async
     checkpoints, the loss falling; median step, peak and the card. Then
     K4 held at every shape the phase sent it.
Phases 2, 4, 5, 6, 7a, 8a, 10a and 16b-16c, and 10b's `shard_map`
searches, are the main paths: each sets the launch counts to 0 just before it and
reads them just after (under the counters' lock: the serving threads
launch concurrently).
The line before the last is a JSON object with one entry per kernel; the
last line is `{"ok": true, "device": {...}}`.

`CHIP_SMOKE_PHASES=8` (or `2,4,7`, ...) runs only the phases it lists,
with those they read (phase 2 for 3, 4 and 6; phase 1 for 5), after the
shared set-up: their lines and walls, no kernel line and no result. It
is for iterating on one phase, and for timing two trees of the package
with one driver (this file copied beside the other tree's `src/`).
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import statistics
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

_SRC = Path(__file__).resolve().parent / "src"
if _SRC.is_dir():
    sys.path.insert(0, str(_SRC))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import DECODE_32K, LONG_500K, PREFILL_32K, get_config  # noqa: E402
from repro_torch.core import bitplane, topk  # noqa: E402
from repro_torch.core.device_physics import DriftConfig  # noqa: E402
from repro_torch.core.error_model import ErrorModelConfig  # noqa: E402
from repro_torch.core.quantization import int_norm, quantize_query  # noqa: E402
from repro_torch.core.recalibration import RecalibrationConfig  # noqa: E402
from repro_torch.core.retrieval import DircRagIndex, RetrievalConfig  # noqa: E402
from repro_torch.core.sharded_index import ShardedDircIndex  # noqa: E402
from repro_torch.device import make_generator  # noqa: E402
from repro_torch.kernels import (_build, counters, dirc_mac, ops,  # noqa: E402
                                 paged_attend, score_matmul, topk_select)
from repro_torch.launch import serve as rag_serve  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.serving import (ContinuousBatchingEngine, EngineConfig,  # noqa: E402
                                 EngineRouter, GenerationEngine, GenerationTicket,
                                 HashEmbedder, RagPipeline, SLOConfig)
from repro_torch.serving.paged_cache import blocks_for, pow2_at_least  # noqa: E402

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, dense int8
# ops/s, dense bf16 FLOP/s, fp32 FLOP/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_FLOP_PER_S = 989e12
FP32_FLOP_PER_S = 67e12

N_DOCS = 8192          # the paper's 4 MB INT8 database at dim 512
DIM = 512
MAIN_B = 8             # queries per main-path batch
K, NEW_TOKENS = 3, 8
SEED = 0


class CheckFailed(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def sync() -> None:
    torch.cuda.synchronize()


def time_ms(fn, iters: int = 50) -> float:
    """Median device time of `fn` over `iters` CUDA-event-timed calls.

    A sleep kernel ahead of each timed call keeps the card busy while the
    host enqueues the call, so the events bracket device work only, not
    the host's launch overhead."""
    fn()
    sync()
    events = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    sync()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def bound_ms(n_bytes: float, n_ops: float,
             ops_per_s: float = INT8_OPS_PER_S) -> tuple[float, str]:
    """Least time for the work on the card: bytes over HBM rate vs
    operations over the peak rate of their type (int8 by default); the
    larger one and which it is."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def int_mm_call(q: torch.Tensor, docs: torch.Tensor):
    """`torch._int_mm` on the same int8 codes (rows padded to >= 17 and
    multiples of 8): the library call for the same function. Returns
    (out (b, n) int32, the call), or (None, None) where this build refuses
    it."""
    b, dim = q.shape
    n = docs.shape[0]
    bp, np_ = max(32, -(-b // 8) * 8), -(-n // 8) * 8
    qp = torch.zeros((bp, dim), dtype=torch.int8, device=q.device)
    qp[:b] = q
    dp = torch.zeros((np_, dim), dtype=torch.int8, device=q.device)
    dp[:n] = docs
    dt_ = dp.t()
    try:
        out = torch._int_mm(qp, dt_)
    except RuntimeError as e:
        print(f"  torch._int_mm refused: {e}")
        return None, None
    return out[:b, :n], lambda: torch._int_mm(qp, dt_)


def int_mm_yardstick(q: torch.Tensor, docs: torch.Tensor):
    """(out, ms) of `int_mm_call`, or (None, None)."""
    out, fn = int_mm_call(q, docs)
    return out, None if fn is None else time_ms(fn)


AMORTISED_REPS = 50


def amortised_ms(fn, reps: int = AMORTISED_REPS) -> float:
    """Device time per call of `fn` over `reps` back-to-back calls between
    one pair of CUDA events. A sleep kernel of ~10 ms ahead of them lets
    the host enqueue every call before the first one runs, so the events
    bracket the calls' device work and the gaps between launches."""
    fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


def time_in_turns(kernel, library, plain, label: str, lib_name: str,
                  bound: tuple[float, str]) -> dict:
    """A kernel and its library yardstick timed in turns (kernel, library,
    kernel, library; single-launch medians of `time_ms`), the plain
    version once, then amortised times of kernel and library on a line of
    their own. `ms` / `library_ms` are the means of the two turns."""
    t_k, t_l = [], []
    for _ in range(2):
        t_k.append(time_ms(kernel))
        if library is not None:
            t_l.append(time_ms(library))
    t_p = time_ms(plain)
    a_k = amortised_ms(kernel)
    a_l = None if library is None else amortised_ms(library)
    ms, lib_ms = statistics.mean(t_k), statistics.mean(t_l) if t_l else None
    turns = " / ".join(f"{t:.4f}" for t in t_k)
    lib_turns = " / ".join(f"{t:.4f}" for t in t_l) or "n/a"
    print(f"{label}: kernel {turns} ms, {lib_name} {lib_turns} ms (in turns), plain "
          f"{t_p:.4f} ms, bound {bound[0]:.5f} ms ({bound[1]})")
    lib_us = "n/a" if a_l is None else f"{a_l * 1e3:.2f}"
    print(f"{label}, amortised over {AMORTISED_REPS} back-to-back launches: kernel "
          f"{a_k * 1e3:.2f} us, {lib_name} {lib_us} us, bound {bound[0] * 1e3:.2f} us")
    return dict(ms=ms, plain_ms=t_p, library_ms=lib_ms, amortised_ms=a_k,
                library_amortised_ms=a_l, bound=bound)


def _fmt(ms) -> str:
    return "n/a" if ms is None else f"{ms:.4f}"


def score_bound(b: int, n: int, dim: int, cosine: bool = False) -> tuple[float, str]:
    """K2 / K5: q and docs read once, the (b, n) output written once (K5
    also reads the norms); 2 b n dim int8 operations."""
    n_bytes = b * dim + n * dim + 4 * b * n + (4 * (b + n) if cosine else 0)
    return bound_ms(n_bytes, 2 * b * n * dim)


# ------------------------------------------------------------------ phase 1
def phase_kernels(dev) -> dict:
    """K1 and K2 against their plain versions; returns per-kernel timings
    at the main path's shapes."""
    g = make_generator(dev, SEED)
    main = {}
    max_err = {"dirc_mac": 0, "score_matmul_int": sweep_scores(g, cosine=False)}
    main["score_matmul_int"] = time_k2(g, MAIN_B, N_DOCS, DIM)
    time_k2(g, 64, N_DOCS, DIM)       # the widest single pass (grid.y 1)
    time_k2(g, 72, 2 * N_DOCS, DIM)   # phase 5's widest shape: two query chunks
    for b in (1, MAIN_B, 16):
        for n in (N_DOCS, N_DOCS + 37):
            for dim in (128, 512, 1024):
                for bits in (4, 8):
                    lo = -(1 << (bits - 1))
                    qv = torch.randint(lo, -lo, (b, dim), generator=g, device=dev,
                                       dtype=torch.int8)
                    dv = torch.randint(lo, -lo, (n, dim), generator=g, device=dev,
                                       dtype=torch.int8)
                    qp = bitplane.pack_words(bitplane.to_bitplanes(qv, bits))
                    dp = bitplane.pack_words(bitplane.to_bitplanes(dv, bits))
                    dp = dp.permute(1, 2, 0).contiguous()       # (bits, nw, n)
                    got = dirc_mac.dirc_mac_packed(qp, dp, bits)
                    want = dirc_mac.dirc_mac_packed_ref(qp, dp, bits)
                    sync()
                    err = int((got.long() - want.long()).abs().max())
                    check(err == 0, f"K1 b={b} n={n} dim={dim} bits={bits}: "
                                    f"max |err| {err}")
                    max_err["dirc_mac"] = max(max_err["dirc_mac"], err)
                    if n != N_DOCS:
                        print(f"K1 dirc_mac b={b} n={n} dim={dim} bits={bits}: bit-equal")
                        continue
                    t_k = time_ms(lambda: dirc_mac.dirc_mac_packed(qp, dp, bits))
                    t_p = time_ms(lambda: dirc_mac.dirc_mac_packed_ref(qp, dp, bits))
                    lib_out, t_l = int_mm_yardstick(qv, dv)
                    if lib_out is not None:
                        check(torch.equal(lib_out, got), f"K1 vs torch._int_mm b={b}")
                    print(f"K1 dirc_mac b={b} n={n} dim={dim} bits={bits}: bit-equal; "
                          f"kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
                          f"_int_mm {_fmt(t_l)} ms")
                    if (b, n, dim, bits) == (MAIN_B, N_DOCS, DIM, 8):
                        nw = dim // 32
                        main["dirc_mac"] = dict(
                            ms=t_k, plain_ms=t_p, library_ms=t_l,
                            bound=bound_ms(4 * (b * bits * nw + bits * nw * n + b * n),
                                           2 * b * n * dim))
    for b in (3, 32, 72):
        for n in (N_DOCS + 37, 2 * N_DOCS):
            for dim in (128, 512, 1024):
                for bits in (4, 8):
                    max_err["dirc_mac"] = max(max_err["dirc_mac"], check_k1_words(
                        g, b, n, dim, bits, "random plane words"))
    for fill in ("all-ones", "sign-only"):
        for bits in (4, 8):
            max_err["dirc_mac"] = max(max_err["dirc_mac"], check_k1_words(
                g, MAIN_B, N_DOCS, DIM, bits, f"{fill} planes", fill))
    # the widest shape phase 5 gives K1: 72 queries over the grown 16384 docs
    qv = torch.randint(-128, 128, (72, DIM), generator=g, device=dev, dtype=torch.int8)
    dv = torch.randint(-128, 128, (2 * N_DOCS, DIM), generator=g, device=dev, dtype=torch.int8)
    qp = bitplane.pack_words(bitplane.to_bitplanes(qv, 8))
    dp = bitplane.pack_words(bitplane.to_bitplanes(dv, 8)).permute(1, 2, 0).contiguous()
    t_k = time_ms(lambda: dirc_mac.dirc_mac_packed(qp, dp, 8))
    _, t_l = int_mm_yardstick(qv, dv)
    print(f"K1 at phase 5's widest shape (b 72, n {2 * N_DOCS}, dim {DIM}, bits 8): kernel "
          f"{t_k:.4f} ms, _int_mm {_fmt(t_l)} ms")
    for name in main:
        main[name]["max_abs_err"] = max_err[name]
    return main


# the edges of K2's and K5's tiling: query tiles of 8 up to 64 a block
# (instances for b <= 8, <= 16 and <= 64; grid.y walks 64-query chunks
# above), 64-doc tiles (n 37 is under one), dim chunks of 128 whose last
# k-step runs over zero fill where dim is not a multiple of 32
EDGE_B = (1, 3, 8, 16, 17, 63, 64, 65, 72)
EDGE_N = (37, N_DOCS, N_DOCS + 37, 2 * N_DOCS)
EDGE_DIM = (16, 48, 128, 512, 1024, 3072)


def hold_scores(q: torch.Tensor, d: torch.Tensor, cosine: bool, label: str) -> torch.Tensor:
    """K2 (or K5, whose last query row is zeroed first where b > 1: a
    zero-norm query must give 0) against its plain version, bit-equal."""
    if cosine:
        if q.shape[0] > 1:
            q[-1] = 0
        qn, dn = int_norm(q, keepdim=True), int_norm(d)[None]
        got = score_matmul.score_matmul_cosine(q, d, qn, dn)
        want = score_matmul.score_matmul_cosine_ref(q, d, qn, dn)
    else:
        got = score_matmul.score_matmul_int(q, d)
        want = score_matmul.score_matmul_int_ref(q, d)
    sync()
    err = float((got.double() - want.double()).abs().max())
    check(torch.equal(got, want), f"{'K5' if cosine else 'K2'} {label}: not bit-equal "
                                  f"(max |err| {err})")
    if cosine and q.shape[0] > 1:
        check(bool((got[-1] == 0).all()), f"K5 {label}: the zero-norm query is not 0")
    return got


def sweep_scores(g: torch.Generator, cosine: bool) -> float:
    """K2 (or K5) against its plain version at every edge shape, and on
    all -128 codes (the largest |ip|); returns the max |err|, 0 (every
    check requires bit-equality)."""
    dev = g.device
    name = "K5 score_matmul_cosine" if cosine else "K2 score_matmul_int"
    dims = [dim for dim in EDGE_DIM if not cosine or dim <= score_matmul.COSINE_MAX_DIM]
    for b in EDGE_B:
        for n in EDGE_N:
            for dim in dims:
                q = torch.randint(-128, 128, (b, dim), generator=g, device=dev,
                                  dtype=torch.int8)
                d = torch.randint(-128, 128, (n, dim), generator=g, device=dev,
                                  dtype=torch.int8)
                hold_scores(q, d, cosine, f"b={b} n={n} dim={dim}")
        print(f"{name} b={b}: bit-equal at n {EDGE_N} x dim {dims}"
              + (", a zero-norm query row giving 0" if cosine and b > 1 else ""))
    dim = dims[-1]
    for b, n in ((MAIN_B, N_DOCS), (72, N_DOCS + 37)):
        q = torch.full((b, dim), -128, dtype=torch.int8, device=dev)
        d = torch.full((n, dim), -128, dtype=torch.int8, device=dev)
        got = hold_scores(q, d, cosine, f"all -128 codes b={b} n={n} dim={dim}")
        # K2: every score is dim * 128^2; K5: 1 where the norms 128 sqrt(dim)
        # are exact (dim 1024: 2^24 / (4096 * 4096))
        expect = 1.0 if cosine else dim * 128 * 128
        exact = not cosine or math.isqrt(dim) ** 2 == dim
        if exact:
            rows = got[:-1] if cosine else got
            check(bool((rows == expect).all()), f"{name} all -128 codes: not {expect}")
        print(f"{name} on all -128 codes (b {b}, n {n}, dim {dim}): bit-equal"
              + (f", every score {expect}" if exact else ""))
    return 0


def time_k2(g: torch.Generator, b: int, n: int, dim: int) -> dict:
    """K2 against `torch._int_mm` on one input: equal outputs, then times
    in turns (`time_in_turns`)."""
    dev = g.device
    q = torch.randint(-128, 128, (b, dim), generator=g, device=dev, dtype=torch.int8)
    d = torch.randint(-128, 128, (n, dim), generator=g, device=dev, dtype=torch.int8)
    got = hold_scores(q, d, False, f"timed input b={b} n={n} dim={dim}")
    lib_out, lib_fn = int_mm_call(q, d)
    if lib_out is not None:
        check(torch.equal(lib_out, got), f"K2 vs torch._int_mm b={b} n={n} dim={dim}")
    return time_in_turns(lambda: score_matmul.score_matmul_int(q, d), lib_fn,
                         lambda: score_matmul.score_matmul_int_ref(q, d),
                         f"K2 score_matmul_int at b {b}, n {n}, dim {dim}", "_int_mm",
                         score_bound(b, n, dim))


def check_k1_words(g: torch.Generator, b: int, n: int, dim: int, bits: int, label: str,
                   fill: str = "") -> int:
    """K1 against its plain version on plane words that no codes built:
    random words, or `fill` "all-ones" (code -1 everywhere) / "sign-only"
    (the most negative code); returns the max |err|."""
    nw = dim // 32
    dev = g.device
    if fill:
        qp = torch.zeros((b, bits, nw), dtype=torch.int32, device=dev)
        dp = torch.zeros((bits, nw, n), dtype=torch.int32, device=dev)
        if fill == "all-ones":
            qp.fill_(-1)
            dp.fill_(-1)
        else:
            qp[:, bits - 1] = -1
            dp[bits - 1] = -1
    else:
        qp = torch.randint(-2**31, 2**31, (b, bits, nw), generator=g, device=dev,
                           dtype=torch.int32)
        dp = torch.randint(-2**31, 2**31, (bits, nw, n), generator=g, device=dev,
                           dtype=torch.int32)
    err = hold_k1(qp, dp, bits, label)
    if fill:   # every code -1, or every code the most negative one
        lo = 1 << (bits - 1)
        expect = dim * (1 if fill == "all-ones" else lo * lo)
        got = dirc_mac.dirc_mac_packed(qp, dp, bits)
        check(bool((got == expect).all()), f"K1 {label}: {got[0, 0].item()} != {expect}")
    return err


# the device kernels of each redesigned kernel's entry point, by name
KERNEL_NAMES = {"paged_attend_fused": ("paged_attend_", "paged_combine_"),
                "paged_attend_prefill": ("paged_attend_prefill_",),
                "dirc_mac": ("dirc_mac_kernel",), "score_matmul_int": ("score_kernel",),
                "score_matmul_cosine": ("score_kernel",),
                "hierarchical_topk": ("hierarchical_select_kernel",),
                "hierarchical_topk_4_macros": ("hierarchical_select_kernel",)}


def profiled_device_kernels(fn) -> list:
    """(kernel name, count) of the device kernels one call of `fn` runs,
    in a profiler run of its own (`fn` is called once before it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    return [(e.key, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]


def device_kernels(calls: dict) -> dict:
    """Device kernels that one call of each entry point in `calls` runs,
    each entry point in a profiler run of its own, by kernel name; "other"
    counts kernels of no entry point (a padding or combine op in PyTorch
    would land there). Warm-up runs come first, until one records the one
    kernel of a PyTorch op: the first profiler run of a process can record
    no device kernel at all (PERF.md §7)."""
    x = torch.ones(1024, device="cuda")
    for tries in range(1, 4):
        warm = profiled_device_kernels(lambda: x.mul_(1.0))
        if sum(n for _, n in warm) == 1:
            break
    check(sum(n for _, n in warm) == 1, f"3 warm-up profiler runs, the last: {warm}")
    print(f"profiler warm-up: the op's kernel recorded in run {tries}")
    counts = dict.fromkeys([*calls, "other"], 0)
    for name, fn in calls.items():
        for key, n in profiled_device_kernels(fn):
            counts[name if any(p in key for p in KERNEL_NAMES[name]) else "other"] += n
    return counts


# ----------------------------------------------------------------- phase 1b
# phi4-mini's attention: 24 query heads over 8 KV heads of 128, 16-token blocks
H, KH, HD, BS = 24, 8, 128, 16
MAX_PROMPT = 512
PROMPT_LEN = 287   # near the augmented prompts of phase 4
# K3 vs its plain version. fp32: the JAX kernel test's TOL (the two differ
# only in summation order and in expf). bf16: outputs are rounded to bf16
# (8 significant bits) and p is rounded to bf16 before P.V in both, so an
# ulp-level difference in exp or in a sum can flip one rounding: compared
# in fp32 at 2e-2, about two bf16 ulps at the outputs' magnitude (< 2).
K3_TOL = {torch.float32: dict(rtol=2e-5, atol=1e-5),
          torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
# the benchmark's 2,048-token pieces (bench/: a docqa prompt of ~4.2k
# tokens in pieces of 2,048, phi3.5-moe's ~1.1k-token prompt in one): the
# prefill path's shapes, each table as wide as the piece needs
K3_PIECES = {
    "docqa piece 1 (from 0)": dict(lengths=[0], n_valid=[2048], t=2048, mb=128),
    "docqa piece 2 (from 2,048)": dict(lengths=[2048], n_valid=[2048], t=2048, mb=256),
    "phi3.5-moe piece (g 4, 1,100 valid)": dict(lengths=[0], n_valid=[1100], t=2048, mb=128,
                                                heads=(32, 8, HD)),
}


def k3_case(dev, g, dtype, lengths, n_valid, t, mb, tables=None, poison=False,
            poison_new=False, heads=(H, KH, HD)):
    """Random q / k_new / v_new / pools for K3 at `heads` = (query heads, KV
    heads, head dim), phi4-mini's by default. Row r owns blocks 1 + r*mb
    .. unless `tables` is given; block 0 (NULL) holds 1e4 when `poison`;
    with `poison_new` the pool cells that the new tokens will take hold
    +-1e4 before the call (the kernel must score them from k_new / v_new,
    as the plain version does after its scatter)."""
    h, kh, hd = heads
    b = len(lengths)
    n_blocks = b * mb + 2
    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)
    kp, vp = rnd(n_blocks, BS, kh, hd), rnd(n_blocks, BS, kh, hd)
    if poison:
        kp[0], vp[0] = 1e4, -1e4
    if tables is None:
        tables = torch.zeros((b, mb), dtype=torch.int32)
        for r in range(b):
            need = blocks_for(int(lengths[r]) + t, BS)
            tables[r, :min(need, mb)] = torch.arange(1 + r * mb, 1 + r * mb + min(need, mb))
    if poison_new:
        for r in range(b):
            for p in range(int(lengths[r]), int(lengths[r]) + int(n_valid[r])):
                blk = int(tables[r][p // BS])
                kp[blk, p % BS], vp[blk, p % BS] = 1e4, -1e4
    return dict(q=rnd(b, t, h, hd), k_new=rnd(b, t, kh, hd), v_new=rnd(b, t, kh, hd),
                k_pool=kp, v_pool=vp, block_table=torch.as_tensor(tables, dtype=torch.int32,
                                                                   device=dev),
                length=torch.as_tensor(lengths, dtype=torch.int32, device=dev),
                n_valid=torch.as_tensor(n_valid, dtype=torch.int32, device=dev))


def k3_args(c, pools=None):
    kp, vp = pools if pools is not None else (c["k_pool"], c["v_pool"])
    return (c["q"], c["k_new"], c["v_new"], kp, vp, c["block_table"], c["length"],
            c["n_valid"])


def k3_work(c) -> tuple[float, float]:
    """(bytes, FLOP) K3 needs on these inputs: each visible K/V row read
    once, q / k_new / v_new read and out and the written pool cells
    written once; 4 FLOP per (valid query, head, visible position, dim)."""
    esz = c["q"].element_size()
    b, t, h, hd = c["q"].shape
    kh = c["k_pool"].shape[2]
    ln = c["length"].long().cpu()
    nv = c["n_valid"].long().cpu()
    kv_rows = int((ln + nv).sum())
    n_bytes = (2 * kv_rows * kh * hd * esz                 # K/V read
               + 2 * b * t * h * hd * esz                  # q read, out written
               + 2 * b * t * kh * hd * esz                 # k_new / v_new read
               + 2 * int(nv.sum()) * kh * hd * esz         # pool cells written
               + c["block_table"].numel() * 4 + 2 * b * 4)
    scores = sum(int(ln[r]) * int(nv[r]) + int(nv[r]) * (int(nv[r]) + 1) // 2
                 for r in range(b))
    return n_bytes, 4.0 * h * hd * scores


def sdpa_yardstick(c):
    """`scaled_dot_product_attention` (GQA, causal + true-length mask) on
    the window K3 reads, already gathered dense: a yardstick that leaves
    out the gather and the scatter. The port never calls it. Returns
    (out (b, t, h, hd), ms)."""
    import torch.nn.functional as F

    b, t, h, hd = c["q"].shape
    _, bs, kh, _ = c["k_pool"].shape
    tbl = c["block_table"].long()
    S = tbl.shape[1] * bs
    k = c["k_pool"][tbl].reshape(b, S, kh, hd).transpose(1, 2).contiguous()
    v = c["v_pool"][tbl].reshape(b, S, kh, hd).transpose(1, 2).contiguous()
    q = c["q"].transpose(1, 2).contiguous()
    qpos = c["length"].long()[:, None] + torch.arange(t, device=q.device)[None]
    mask = (torch.arange(S, device=q.device)[None, None] <= qpos[:, :, None])[:, None]
    try:
        fn = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,  # noqa: E731
                                                    enable_gqa=True)
        out = fn()
    except TypeError:   # a PyTorch without enable_gqa: repeat the KV heads
        kr, vr = (x.repeat_interleave(h // kh, dim=1) for x in (k, v))
        fn = lambda: F.scaled_dot_product_attention(q, kr, vr, attn_mask=mask)  # noqa: E731
        out = fn()
    return out.transpose(1, 2), time_ms(fn)


def phase_k3(dev) -> dict:
    """K3 against its plain version in every case; times at the streaming
    path's decode shape (b 8, contexts near the ~287-token augmented
    prompt, a table as wide as `cache_len = 512 + 8` new tokens)."""
    g = make_generator(dev, SEED)
    mb_main = blocks_for(MAX_PROMPT + NEW_TOKENS, BS)
    ctx = torch.randint(270, 305, (MAIN_B,), generator=g, device=dev).tolist()
    mixed_len = torch.randint(0, 501, (16,), generator=g, device=dev).tolist()
    mixed_len[:2] = [0, 500]
    mixed_nv = torch.randint(0, 33, (16,), generator=g, device=dev).tolist()
    mixed_nv[:3] = [32, 32, 0]
    mb_b16 = blocks_for(500 + 32, BS)                # 34 blocks: a ragged last chunk
    cow = torch.zeros((2, 6), dtype=torch.int32)
    cow[0, :3] = torch.tensor([1, 5, 6])        # row 0: CoW copy 5 of shared block 2
    cow[1, :3] = torch.tensor([1, 2, 7])        # row 1: still on the shared block 2
    bf, f32 = torch.bfloat16, torch.float32
    cases = [
        ("decode b1", bf, dict(lengths=[287], n_valid=[1], t=1, mb=mb_main)),
        ("decode b8 (main)", bf, dict(lengths=ctx, n_valid=[1] * MAIN_B, t=1, mb=mb_main)),
        ("decode b16", bf, dict(lengths=torch.randint(0, 500, (16,), generator=g,
                                                      device=dev).tolist(),
                                n_valid=[1] * 16, t=1, mb=mb_main)),
        ("prefill t32 from 0", bf, dict(lengths=[0], n_valid=[32], t=32, mb=mb_main)),
        ("prefill t32 from 16", bf, dict(lengths=[16], n_valid=[32], t=32, mb=mb_main)),
        ("prefill t32 from 250, 27 valid", bf,
         dict(lengths=[250], n_valid=[27], t=32, mb=mb_main)),
        ("block / chunk edges", bf, dict(lengths=[16, 32, 127, 128], n_valid=[1] * 4,
                                         t=1, mb=mb_main)),
        ("prefill ends on a chunk edge", bf, dict(lengths=[96], n_valid=[32], t=32,
                                                  mb=mb_main)),
        ("inactive lanes", bf, dict(lengths=[40, 0, 300, 0], n_valid=[1, 0, 1, 0], t=1,
                                    mb=mb_main, tables=None)),
        ("poisoned NULL block", bf, dict(lengths=[5, 200], n_valid=[1, 1], t=1, mb=mb_main,
                                         poison=True)),
        ("CoW-shared table", bf, dict(lengths=[BS + 2, 2 * BS], n_valid=[30, 1], t=32,
                                      mb=6, tables=cow)),
        ("decode b8 fp32 pools", f32, dict(lengths=ctx, n_valid=[1] * MAIN_B, t=1,
                                           mb=mb_main)),
        # the redesign's cases: the overlay, part-empty row tiles, many
        # rows, a ragged last chunk
        ("new-token cells poisoned, prefill", bf, dict(lengths=[250], n_valid=[27], t=32,
                                                       mb=mb_main, poison_new=True)),
        ("new-token cells poisoned, decode b8", bf, dict(lengths=ctx, n_valid=[1] * MAIN_B,
                                                         t=1, mb=mb_main, poison_new=True)),
        ("new-token cells poisoned, prefill (fp32)", f32,
         dict(lengths=[250], n_valid=[27], t=32, mb=mb_main, poison_new=True)),
        ("prefill t32 from 100, 1 valid", bf, dict(lengths=[100], n_valid=[1], t=32,
                                                   mb=mb_main)),
        ("prefill t32 from 40, 17 valid", bf, dict(lengths=[40], n_valid=[17], t=32,
                                                   mb=mb_main)),
        ("prefill b16 mixed lengths 0-500", bf, dict(lengths=mixed_len, n_valid=mixed_nv,
                                                     t=32, mb=mb_b16)),
        ("prefill b16 mixed lengths 0-500 (fp32)", f32,
         dict(lengths=mixed_len, n_valid=mixed_nv, t=32, mb=mb_b16)),
        ("table of 33 blocks, prefill t32 from 500", bf,
         dict(lengths=[500], n_valid=[28], t=32, mb=mb_main)),
    ]
    # every prefill piece of a 287-token prompt as the streaming engine
    # sends it: t 32, the table narrowed to pow2_at_least(need) blocks
    # (2, 4, 8, 8, 16, 16, 16, 16, 32: chunks of 32, 64 and 128 tokens,
    # one to four of them)
    for p0 in range(0, PROMPT_LEN, 32):
        n = min(32, PROMPT_LEN - p0)
        w = pow2_at_least(blocks_for(p0 + n, BS))
        cases.append((f"prompt piece from {p0}, {n} valid, table {w}", bf,
                      dict(lengths=[p0], n_valid=[n], t=32, mb=w)))
    max_err = 0.0
    main = None
    for name, dtype, kw in cases:
        c = k3_case(dev, g, dtype, **kw)
        if name == "inactive lanes":   # inactive rows: all-NULL tables
            c["block_table"][c["n_valid"] == 0] = 0
        if name == "CoW-shared table":   # the copy prepare_write would have made
            c["k_pool"][5], c["v_pool"][5] = c["k_pool"][2], c["v_pool"][2]
        pk = (c["k_pool"].clone(), c["v_pool"].clone())
        max_err = max(max_err, hold_k3(c, name, pk))
        if name == "CoW-shared table":
            check(torch.equal(pk[0][[1, 2]], c["k_pool"][[1, 2]]),
                  "K3: a shared block was written")
        if name == "decode b8 (main)":
            main = c
    max_err = max(max_err, check_combine(dev, g))
    qp = bitplane.pack_words(bitplane.to_bitplanes(
        torch.randint(-128, 128, (MAIN_B, DIM), generator=g, device=dev, dtype=torch.int8), 8))
    dp = torch.randint(-2**31, 2**31, (8, DIM // 32, N_DOCS), generator=g, device=dev,
                       dtype=torch.int32)
    q8 = torch.randint(-128, 128, (MAIN_B, DIM), generator=g, device=dev, dtype=torch.int8)
    d8 = torch.randint(-128, 128, (N_DOCS, DIM), generator=g, device=dev, dtype=torch.int8)
    qn, dn = int_norm(q8, keepdim=True), int_norm(d8)[None]
    piece = k3_case(dev, g, bf, **K3_PIECES["docqa piece 2 (from 2,048)"])
    counts = device_kernels({
        "paged_attend_fused": lambda: paged_attend.paged_attend_fused(*k3_args(main)),
        "paged_attend_prefill": lambda: paged_attend.paged_attend_fused(*k3_args(piece)),
        "dirc_mac": lambda: dirc_mac.dirc_mac_packed(qp, dp, 8),
        "score_matmul_int": lambda: score_matmul.score_matmul_int(q8, d8),
        "score_matmul_cosine": lambda: score_matmul.score_matmul_cosine(q8, d8, qn, dn)})
    check(counts == {"paged_attend_fused": 2, "paged_attend_prefill": 1, "dirc_mac": 1,
                     "score_matmul_int": 1, "score_matmul_cosine": 1, "other": 0},
          f"device kernels per call: {counts}, not K3 2 (attention and combine) on the "
          "split path and 1 on the prefill path, K1, K2 and K5 1 each")
    del piece
    print(f"device kernels per call (profiler): K3 {counts['paged_attend_fused']} "
          f"(attention and combine) on the split path, "
          f"{counts['paged_attend_prefill']} on the prefill path, K1 {counts['dirc_mac']}, K2 "
          f"{counts['score_matmul_int']}, K5 {counts['score_matmul_cosine']}, other "
          f"{counts['other']}")
    # the last prefill piece of a ~287-token prompt: 31 new tokens from
    # position 256, the table narrowed to pow2_at_least(18) = 32 blocks
    prefill = k3_case(dev, g, bf, lengths=[256], n_valid=[31], t=32, mb=32)
    out = time_k3(prefill, "last prefill piece (b 1, t 32 from 256, 31 valid, "
                           "table 32 blocks of 16, bf16)")
    out["prefill"] = out.copy()
    out.update(time_k3(main, f"streaming decode shape (b {MAIN_B}, contexts "
                             f"{min(ctx)}-{max(ctx)}, table {mb_main} blocks of {BS}, bf16)"))
    out["pieces"] = {}
    for name, kw in K3_PIECES.items():   # the prefill path at the benchmark's pieces
        c = k3_case(dev, g, bf, **kw)
        out["pieces"][name] = r = time_k3(c, name, split=True)
        out["max_abs_err"] = max(out["max_abs_err"], r["max_abs_err"])
        del c
    out["max_abs_err"] = max(max_err, out["max_abs_err"], out["prefill"]["max_abs_err"])
    return out


def hold_k3(c, name: str, pk=None) -> float:
    """K3 on case `c` against its plain version (each on its own copy of
    the pools; `pk` receives the kernel's writes): outputs at the valid
    queries within K3_TOL, finite, pools bit-equal outside block 0.
    Returns the max |err|."""
    dtype = c["q"].dtype
    pk = pk if pk is not None else (c["k_pool"].clone(), c["v_pool"].clone())
    pr = (c["k_pool"].clone(), c["v_pool"].clone())
    got = paged_attend.paged_attend_fused(*k3_args(c, pk))
    want = paged_attend.paged_attend_fused_ref(*k3_args(c, pr))
    sync()
    valid = (torch.arange(c["q"].shape[1], device=got.device)[None]
             < c["n_valid"][:, None])                           # (b, t) valid queries
    err = float((got.float() - want.float())[valid].abs().max()) if valid.any() else 0.0
    check(torch.isfinite(got[valid].float()).all().item(), f"K3 {name}: non-finite")
    check(torch.allclose(got.float()[valid], want.float()[valid], **K3_TOL[dtype]),
          f"K3 {name}: max |err| {err}")
    check(torch.equal(pk[0][1:], pr[0][1:]) and torch.equal(pk[1][1:], pr[1][1:]),
          f"K3 {name}: pools differ outside block 0")
    print(f"K3 paged_attend_fused {name} ({str(dtype)[6:]}): max |err| {err:.3g}; "
          "pools bit-equal outside block 0")
    return err


def combine_kernel(acc, m, den, dtype):
    """The combine kernel alone on planted partials: (b, t, h, hd) in
    `dtype` (`paged_attend_fused` is its only entry point in the port)."""
    b, _, t, h, hd = acc.shape
    out = torch.empty((b, t, h, hd), dtype=dtype, device=acc.device)
    paged_attend._launch_combine(_build.load_library(), acc, m, den, out)
    return out


def check_combine(dev, g) -> float:
    """The combine kernel against `combine` at the decode shape's partials
    (b 8, 5 chunks, 24 heads of 128): chunks 3 and 4 fully masked (their
    acc NaN for the kernel, which must not read it; 0 for the plain
    version), and one query with no visible position (0 out)."""
    err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        shape = (MAIN_B, 5, 1, H)
        acc = torch.randn(shape + (HD,), generator=g, device=dev)
        m = torch.randn(shape, generator=g, device=dev) * 4
        den = torch.rand(shape, generator=g, device=dev) * 8 + 1
        m[:, 3:], den[:, 3:], acc[:, 3:] = paged_attend.NEG_INF, 0.0, 0.0
        m[2, :, 0, 5], den[2, :, 0, 5], acc[2, :, 0, 5] = paged_attend.NEG_INF, 0.0, 0.0
        want = paged_attend.combine(acc, m, den, dtype)
        acc_k = acc.clone()
        acc_k[:, 3:] = float("nan")
        before = launch_count("paged_combine")
        got = combine_kernel(acc_k, m, den, dtype)
        sync()
        check(launch_count("paged_combine") == before + 1, "combine launch not counted")
        e = float((got.float() - want.float()).abs().max())
        check(bool(torch.isfinite(got).all()), "combine kernel: non-finite output")
        check(torch.allclose(got.float(), want.float(), **K3_TOL[dtype]),
              f"combine kernel ({dtype}): max |err| {e}")
        check(bool((got[2, 0, 5] == 0).all()), "combine kernel: a query with no visible "
                                               "position is not 0")
        err = max(err, e)
        t_k = time_ms(lambda: combine_kernel(acc_k, m, den, dtype))
        t_p = time_ms(lambda: paged_attend.combine(acc, m, den, dtype))
        print(f"K3 combine kernel ({str(dtype)[6:]}, b {MAIN_B}, 5 chunks, 2 masked, one "
              f"query with none visible): max |err| {e:.3g}; kernel {t_k:.4f} ms, plain "
              f"{t_p:.4f} ms")
    return err


def time_k3(c, label: str, split: bool = False) -> dict:
    """K3 against its plain version on case `c` (the timed inputs), then
    kernel / plain / SDPA times and the bound. `split`: the call must take
    the prefill path, and the split path (an explicit chunk_blocks) is
    timed on the same inputs beside it."""
    pk = (c["k_pool"].clone(), c["v_pool"].clone())
    before = launch_count("paged_attend_prefill")
    got = paged_attend.paged_attend_fused(*k3_args(c, pk))
    check(launch_count("paged_attend_prefill") == before + int(split),
          f"K3 at the {label}: {'not ' if split else ''}on the prefill path")
    want = paged_attend.paged_attend_fused_ref(*k3_args(c))
    sync()
    valid = torch.arange(c["q"].shape[1], device=got.device)[None] < c["n_valid"][:, None]
    err = float((got.float() - want.float())[valid].abs().max())
    check(torch.allclose(got.float()[valid], want.float()[valid], **K3_TOL[c["q"].dtype]),
          f"K3 at the {label}: max |err| {err}")
    check(torch.equal(pk[0][1:], c["k_pool"][1:]) and torch.equal(pk[1][1:], c["v_pool"][1:]),
          f"K3 at the {label}: pools differ outside block 0")
    t_k = time_ms(lambda: paged_attend.paged_attend_fused(*k3_args(c)))
    t_p = time_ms(lambda: paged_attend.paged_attend_fused_ref(*k3_args(c)))
    lib_out, t_l = sdpa_yardstick(c)
    ref = paged_attend.paged_attend_fused_ref(*k3_args(c))
    valid = torch.arange(c["q"].shape[1], device=ref.device)[None] < c["n_valid"][:, None]
    lib_err = float((lib_out.float() - ref.float())[valid].abs().max())
    check(lib_err < 5e-2, f"scaled_dot_product_attention disagrees with K3's plain "
                          f"version at the {label}: {lib_err}")
    n_bytes, n_flop = k3_work(c)
    bound = bound_ms(n_bytes, n_flop, BF16_FLOP_PER_S)
    out = dict(ms=t_k, plain_ms=t_p, library_ms=t_l, bound=bound, max_abs_err=err)
    line = ""
    if split:
        cb = paged_attend.CHUNK_TOKENS // c["k_pool"].shape[1]
        out["split_ms"] = time_ms(lambda: paged_attend.paged_attend_fused(*k3_args(c),
                                                                          chunk_blocks=cb))
        line = f", split path {out['split_ms']:.4f} ms, {bound[0] / t_k * 100:.1f}% of the bound"
    print(f"K3 at the {label}: max |err| {err:.3g}; kernel {t_k:.4f} ms{line}, plain "
          f"{t_p:.4f} ms, sdpa on the "
          f"gathered window {t_l:.4f} ms (max |diff| to plain {lib_err:.3g}), bound "
          f"{bound[0]:.5f} ms ({bound[1]}; {n_bytes / 1e6:.2f} MB, {n_flop / 1e9:.3f} GFLOP)")
    return out


# ----------------------------------------------------------------- phase 1c
N_SHARDS = 4                     # phase 5: 4 macros of 2048 documents
N_CORES = 16


def k4_bound(rows: int, n: int, nb: int, k: int) -> tuple[float, str]:
    """K4 reads each score once and writes k (value, index) pairs per
    block; k passes of one comparison per score, at the fp32 rate."""
    return bound_ms(4 * rows * n + 8 * rows * nb * k, k * rows * n, FP32_FLOP_PER_S)


def time_k4(s: torch.Tensor, k: int, block_n: int, label: str) -> dict:
    """K4 and `torch.topk` on the block view in turns (single launches and
    back-to-back), the plain version, and the bound of K4 on `s`."""
    rows, n = s.shape
    nb = n // block_n
    view = s.reshape(rows * nb, block_n)
    lib_v, _ = torch.topk(view, k, dim=-1)   # the yardstick: ties in no set order
    got_v, _ = topk_select.blockwise_topk(s, k, block_n)
    check(torch.equal(lib_v.reshape(rows, nb, k), got_v), f"torch.topk values differ ({label})")
    return time_in_turns(lambda: topk_select.blockwise_topk(s, k, block_n),
                         lambda: torch.topk(view, k, dim=-1),
                         lambda: topk_select.blockwise_topk_ref(s, k, block_n),
                         f"K4 at the {label} (rows {rows}, n {n}, block {block_n}, k {k})",
                         "torch.topk", k4_bound(rows, n, nb, k))


def time_fused(s: torch.Tensor, k: int, label: str) -> dict:
    """`hierarchical_select` (what a search launches) and `torch.topk` over
    the whole row in turns, the plain version, the bound; then the host
    wall of one `core.topk.hierarchical_topk` call, back to back."""
    rows, n = s.shape
    t = time_in_turns(lambda: topk_select.hierarchical_select(s, k, N_CORES),
                      lambda: torch.topk(s, k, dim=-1),
                      lambda: topk_select.hierarchical_select_ref(s, k, N_CORES),
                      f"hierarchical_select at the {label} (rows {rows}, n {n}, "
                      f"{N_CORES} cores, k {k})", "torch.topk",
                      bound_ms(4 * rows * n + 8 * rows * k, k * rows * n, FP32_FLOP_PER_S))
    t["wall_us"] = host_wall_us(lambda: topk.hierarchical_topk(s, k, N_CORES))
    print(f"core.topk.hierarchical_topk at the {label}: {t['wall_us']:.2f} us a call on "
          "the host's clock, back to back")
    return t


def host_wall_us(fn, reps: int = 200) -> float:
    """Host wall per call of `fn` over `reps` back-to-back calls and one
    synchronize: host work and device work together."""
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync()
    return (time.perf_counter() - t0) / reps * 1e6


def value_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want|, 0 where the two are equal (-inf included)."""
    diff = (got.double() - want.double()).abs()
    return float(torch.where(got == want, 0.0, diff).max())


def check_k4(s: torch.Tensor, k: int, block_n: int, label: str) -> float:
    """K4 against its plain version on `s`; returns the values' max |err|."""
    v, i = topk_select.blockwise_topk(s, k, block_n)
    rv, ri = topk_select.blockwise_topk_ref(s, k, block_n)
    sync()
    err = value_err(v, rv)
    check(torch.equal(v.view(torch.int32), rv.view(torch.int32)) and torch.equal(i, ri),
          f"K4 {label}: differs from plain (max |err| {err})")
    print(f"K4 blockwise_topk {label}: bit-equal")
    return err


def check_fused(s: torch.Tensor, k: int, label: str, n_cores: int = N_CORES) -> float:
    """`hierarchical_select` against its plain version on `s` (16 cores
    unless told); returns the values' max |err|."""
    v, i = topk_select.hierarchical_select(s, k, n_cores)
    rv, ri = topk_select.hierarchical_select_ref(s, k, n_cores)
    sync()
    err = value_err(v, rv)
    check(torch.equal(v.view(torch.int32), rv.view(torch.int32)) and torch.equal(i, ri),
          f"hierarchical_select {label}: differs from plain (max |err| {err})")
    print(f"K4 hierarchical_select {label}: bit-equal")
    return err


def check_k1(g: torch.Generator, b: int, n: int, dim: int, bits: int, label: str) -> int:
    """K1 against its plain version on random codes; returns the max |err|."""
    lo = -(1 << (bits - 1))
    qv = torch.randint(lo, -lo, (b, dim), generator=g, device=g.device, dtype=torch.int8)
    dv = torch.randint(lo, -lo, (n, dim), generator=g, device=g.device, dtype=torch.int8)
    qp = bitplane.pack_words(bitplane.to_bitplanes(qv, bits))
    dp = bitplane.pack_words(bitplane.to_bitplanes(dv, bits)).permute(1, 2, 0).contiguous()
    return hold_k1(qp, dp, bits, label)


def hold_k1(qp: torch.Tensor, dp: torch.Tensor, bits: int, label: str) -> int:
    """K1 on planes (b, bits, nw) x (bits, nw, n) against its plain version,
    bit-equal; returns the max |err| (0)."""
    b, _, nw = qp.shape
    got = dirc_mac.dirc_mac_packed(qp, dp, bits)
    want = dirc_mac.dirc_mac_packed_ref(qp, dp, bits)
    sync()
    err = int((got.long() - want.long()).abs().max())
    shape = f"b={b} n={dp.shape[2]} dim={32 * nw} bits={bits}"
    check(err == 0, f"K1 {label} {shape}: max |err| {err}")
    print(f"K1 dirc_mac {label} {shape}: bit-equal")
    return err


def cosine_call(q, docs, qn, dn):
    """`torch._int_mm` on the same codes, then the division: one library
    GEMM plus PyTorch's epilogue for the function K5 computes. Returns
    (out, the call), or (None, None) where this build refuses `_int_mm`."""
    b = q.shape[0]
    n = docs.shape[0]
    _, mm = int_mm_call(q, docs)
    if mm is None:
        return None, None
    denom = torch.clamp_min(qn * dn, 1e-12)

    def fn():
        return mm()[:b, :n].float() / denom
    return fn(), fn


def phase_k4_k5(dev) -> dict:
    """K4 and K5 against their plain versions, bit-equal; their times at
    the main path's shapes; K5's entry point driven once."""
    g = make_generator(dev, SEED)
    out = {}
    # ---- K4
    per_mono = N_DOCS // N_CORES                               # 512 scores per core
    cap = N_DOCS // N_SHARDS
    s_mono = torch.randn((MAIN_B, N_DOCS), generator=g, device=dev)
    s_shard = torch.randn((N_SHARDS * MAIN_B, cap), generator=g, device=dev)
    k4_err = check_k4(s_mono, K, per_mono, f"monolithic search (rows {MAIN_B}, n "
                                           f"{N_DOCS}, block {per_mono}, k {K})")
    k4_err = max(k4_err, check_k4(s_shard, K, cap // N_CORES, f"4-macro search flattened "
                                  f"(rows {N_SHARDS * MAIN_B}, n {cap}, block "
                                  f"{cap // N_CORES}, k {K})"))
    for b, n, k in ((1, 512, 1), (3, 1200, 7), (2, 2048, 64)):   # the JAX test's sweep
        s = torch.randn((b, n), generator=g, device=dev)
        got = ops.local_topk_blocks(s, k)
        want = ops.local_topk_blocks(s.cpu(), k)                  # the plain path
        full = torch.sort(s, dim=-1, descending=True, stable=True)
        sync()
        k4_err = max(k4_err, value_err(got[0].cpu(), want[0]))
        check(torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
              and torch.equal(got[1], full.indices[:, :k].int()),
              f"ops.local_topk_blocks b={b} n={n} k={k}")
        print(f"K4 via ops.local_topk_blocks b={b} n={n} k={k}: bit-equal, equals the "
              "stable sort of the row")
    zeros = torch.zeros((2, 1024), device=dev)
    k4_err = max(k4_err, check_k4(zeros, 4, 512, "all-zero ties"))
    check(torch.equal(ops.local_topk_blocks(zeros, 4)[1].cpu(),
                      torch.arange(4, dtype=torch.int32).expand(2, 4)), "K4 zero ties")
    signed = torch.where(torch.rand((4, 2048), generator=g, device=dev) < 0.5, 0.0, -0.0)
    k4_err = max(k4_err, check_k4(signed, 40, 256, "signed zeros (+0.0 above -0.0)"))
    k4_err = max(k4_err, check_fused(signed, 40, "signed zeros"))
    tail = torch.full((2 * N_SHARDS, cap), float("-inf"), device=dev)
    tail[:, :2] = torch.randn((2 * N_SHARDS, 2), generator=g, device=dev)
    tail[0, 2 * (cap // N_CORES) + 44] = 0.5                  # one live score in block 2
    k4_err = max(k4_err, check_k4(tail, K, cap // N_CORES,
                                  "blocks with fewer than k scores above -inf"))
    k4_err = max(k4_err, check_fused(tail, K, "cores with fewer than k scores above -inf"))
    _, ti = topk_select.blockwise_topk(tail, K, cap // N_CORES)
    check(all(len(set(r)) == K for r in ti.reshape(-1, K).tolist()),
          "K4 returned an index twice")
    # the fused local + global comparator at every shape a search gives it:
    # monolithic; 4 macros of 2048 and, grown, of 4096 (update searches and
    # padded open-loop flushes); cross-checked against the CPU once
    for rows, n in ((MAIN_B, N_DOCS), (N_SHARDS * MAIN_B, cap), (N_SHARDS * MAIN_B, 2 * cap),
                    (N_SHARDS * 16, 2 * cap), (N_SHARDS * 64, 2 * cap),
                    (N_SHARDS * 72, 2 * cap)):
        s = torch.randn((rows, n), generator=g, device=dev)
        k4_err = max(k4_err, check_fused(s, K, f"rows {rows}, n {n}, {N_CORES} cores, k {K}"))
    fv, fi = topk_select.hierarchical_select(s, K, N_CORES)
    cv, ci = topk_select.hierarchical_select_ref(s.cpu(), K, N_CORES)
    check(torch.equal(fv.cpu(), cv) and torch.equal(fi.cpu(), ci),
          "hierarchical_select differs from its plain version on the CPU")
    t4 = time_k4(s_mono, K, per_mono, "monolithic search shape")
    t4["sharded"] = time_k4(s_shard, K, cap // N_CORES, "4-macro search shape")
    time_k4(torch.randn((2, 2048), generator=g, device=dev), 64, 64, "k 64 case")
    fused = time_fused(s_mono, K, "monolithic search shape")
    t4["sharded_fused"] = time_fused(s_shard, K, "4-macro search shape")
    kernels = device_kernels({
        "hierarchical_topk": lambda: topk.hierarchical_topk(s_mono, K, N_CORES),
        "hierarchical_topk_4_macros": lambda: topk.hierarchical_topk(s_shard, K, N_CORES)})
    print(f"device kernels of one core.topk.hierarchical_topk call (monolithic, 4 macros; "
          f"profiler): {kernels}")
    check(kernels["hierarchical_topk"] == kernels["hierarchical_topk_4_macros"] == 1
          and kernels["other"] == 0, f"hierarchical_topk device kernels {kernels}")
    t4.update({f"fused_{key}": fused[key] for key in (
        "ms", "amortised_ms", "plain_ms", "library_ms", "library_amortised_ms", "wall_us")})
    t4.update(max_abs_err=k4_err, fused_device_kernels=kernels["hierarchical_topk"])
    out["topk_select"] = t4
    # ---- K5
    k5_err = sweep_scores(g, cosine=True)
    q = torch.randint(-128, 128, (MAIN_B, DIM), generator=g, device=dev, dtype=torch.int8)
    d = torch.randint(-128, 128, (N_DOCS, DIM), generator=g, device=dev, dtype=torch.int8)
    qn, dn = int_norm(q, keepdim=True), int_norm(d)[None]
    got = score_matmul.score_matmul_cosine(q, d, qn, dn)
    check(torch.equal(got, score_matmul.score_matmul_cosine_ref(q, d, qn, dn)),
          "K5 on the timed input: not bit-equal")
    lib_out, lib_fn = cosine_call(q, d, qn, dn)
    if lib_out is not None:
        check(torch.equal(lib_out, got), "K5 vs torch._int_mm + division")
    b, dim = q.shape
    n = d.shape[0]
    t5 = time_in_turns(lambda: score_matmul.score_matmul_cosine(q, d, qn, dn), lib_fn,
                       lambda: score_matmul.score_matmul_cosine_ref(q, d, qn, dn),
                       f"K5 score_matmul_cosine at b {b}, n {n}, dim {dim}",
                       "_int_mm + division", score_bound(b, n, dim, cosine=True))
    # K5's path: its only caller, the `ops` entry point, over the main shape
    reset_launches()
    via_ops = ops.score_matmul_cosine(q, d, dn[0])
    sync()
    launches = launch_count("score_matmul_cosine")
    check(launches == 1 and torch.equal(via_ops, score_matmul.score_matmul_cosine_ref(
        q, d, qn, dn)), f"ops.score_matmul_cosine: {launches} launches or differs")
    print(f"ops.score_matmul_cosine (b {b}, n {n}, dim {dim}): K5 launches {launches}; "
          "equals the plain version")
    out["score_matmul_cosine"] = dict(t5, max_abs_err=k5_err, launches=launches)
    return out


# ------------------------------------------------------------------ phase 2
def make_corpus(n: int, seed: int) -> list:
    """The synthetic corpus of the JAX serving CLI (`launch/serve.py`)."""
    rng = np.random.default_rng(seed)
    return [f"document {i}: " + " ".join(
        f"w{rng.integers(0, 997)}" for _ in range(12)) for i in range(n)]


def corpus_setup() -> dict:
    """What every phase from 2 on reads (host numpy): the corpus of
    N_DOCS documents, its embeddings, and the MAIN_B queries (corpus
    documents, so each query's own document is its top hit)."""
    corpus = make_corpus(N_DOCS, SEED)
    embedder = HashEmbedder(dim=DIM)
    t0 = time.perf_counter()
    embs = embedder.embed(corpus)
    own = list(range(0, N_DOCS, N_DOCS // MAIN_B))
    return dict(corpus=corpus, embedder=embedder, embs=embs,
                embed_s=time.perf_counter() - t0, queries=[corpus[i] for i in own],
                own=own)


def phase_main_path(dev, setup: dict) -> dict:
    """The synchronous path: phi4-mini at full depth answers the MAIN_B
    queries through `query_many` on both retrieval kernel paths. Returns
    `setup` with the pipeline, the launch counts and the search times."""
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("phi4-mini-3.8b")    # FULL: the published 32 layers
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev).init(make_generator(dev, SEED))
    sync()
    print(f"model {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads, hd {cfg.resolved_head_dim}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.param_dtype}, "
          f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B params; "
          f"init {time.perf_counter() - t0:.2f} s")

    corpus, embedder, embs = setup["corpus"], setup["embedder"], setup["embs"]
    base = RetrievalConfig(bits=8, metric="cosine", n_cores=16)
    t0 = time.perf_counter()
    exact = DircRagIndex.build(embs, dataclasses.replace(base, path="int_exact"),
                               device=dev)
    sync()
    build_s = time.perf_counter() - t0
    print(f"embed {N_DOCS} docs (host numpy): {setup['embed_s']:.3f} s; "
          f"index build: {build_s:.4f} s; {exact.storage_bytes()}")

    pipe = RagPipeline(corpus, dataclasses.replace(base, path="kernel_bitserial"),
                       model=model, embedder=embedder, dim=DIM, device=dev)
    check(torch.equal(pipe.index.planes, exact.planes), "index rebuild differs")
    own, queries = setup["own"], setup["queries"]
    q_emb = embedder.embed(queries)
    want = exact.search(q_emb, K)
    want_ids, want_scores = want.indices.cpu().numpy(), want.scores.cpu().numpy()

    out = dict(setup, launches={}, pipe=pipe)
    for path, kmod in (("kernel_bitserial", dirc_mac), ("kernel_mxu", score_matmul)):
        if pipe.index.config.path != path:
            pipe.index = DircRagIndex.build(
                embs, dataclasses.replace(base, path=path), device=dev)
        reset_launches()
        t0 = time.perf_counter()
        results = pipe.query_many(queries, k=K, max_new_tokens=NEW_TOKENS)
        sync()
        wall = time.perf_counter() - t0
        launches = {"dirc_mac": launch_count("dirc_mac"),
                    "score_matmul_int": launch_count("score_matmul_int"),
                    "topk_select": launch_count("topk_select")}
        name = "dirc_mac" if kmod is dirc_mac else "score_matmul_int"
        out["launches"][name] = launches[name]
        out["launches"]["topk_select"] = (out["launches"].get("topk_select", 0)
                                          + launches["topk_select"])
        check(launches[name] > 0, f"{path}: kernel {name} never launched")
        # one batched search: every core's local comparator in one K4 launch
        check(launches["topk_select"] == launches[name] == 1,
              f"{path}: K4 launches {launches['topk_select']} for one search")
        ids = np.stack([r.doc_ids for r in results])
        scores = np.stack([r.doc_scores for r in results])
        check((ids[:, 0] == np.asarray(own)).all(), f"{path}: self-retrieval {ids[:, 0]}")
        check(np.array_equal(ids, want_ids), f"{path}: ids differ from int_exact")
        check(np.array_equal(scores, want_scores), f"{path}: scores differ from int_exact")
        for r in results:
            toks = r.answer_tokens
            check(toks.shape == (1, NEW_TOKENS), f"answer shape {toks.shape}")
            check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()), "token out of vocab")
        search_ms = time_ms(lambda: pipe.index.search(q_emb, K), iters=20)
        print(f"path {path}: launches {launches}; self-retrieval 1.00; ids and "
              f"scores equal int_exact; search {search_ms:.4f} ms per batch of "
              f"{MAIN_B}; query_many {wall:.3f} s; answer[0] "
              f"{results[0].answer_tokens[0].tolist()}")
        out[f"search_ms_{path}"] = search_ms

    # prefill vs decode split, on the first query's augmented prompt
    prompt = pipe.encode_prompt(queries[0], results[0].retrieved_texts)
    toks = np.asarray(prompt, np.int64)[None]
    pipe.engine.generate(toks, max_new_tokens=2)   # warm-up
    t1 = statistics.median(_wall(lambda: pipe.engine.generate(toks, 1)) for _ in range(5))
    tn = statistics.median(
        _wall(lambda: pipe.engine.generate(toks, NEW_TOKENS)) for _ in range(5))
    decode_ms = (tn - t1) / (NEW_TOKENS - 1) * 1e3
    print(f"generate: prompt {len(prompt)} tokens; prefill (+ first token) "
          f"{t1 * 1e3:.2f} ms; decode {decode_ms:.2f} ms/token "
          f"({1e3 / decode_ms:.1f} tokens/s); {NEW_TOKENS} tokens in "
          f"{tn * 1e3:.2f} ms ({NEW_TOKENS / tn:.1f} tokens/s end to end)")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    # K5's entry point over the real corpus gives the int_exact cosine scores
    qv = quantize_query(torch.as_tensor(q_emb, device=dev)).values
    cos = ops.score_matmul_cosine(qv, exact.docs.values, exact.doc_norms)
    check(torch.equal(cos, exact.scores(q_emb)),
          "ops.score_matmul_cosine differs from the int_exact scores")
    profile_device(f"generate({NEW_TOKENS} tokens)",
                   lambda: pipe.engine.generate(toks, NEW_TOKENS), tn * 1e3)
    return out


def _busy(ev) -> tuple[float, int]:
    """(device busy ms, kernel launches) of a profiler's key averages:
    kernel rows only (an operator row repeats the time of its kernels)."""
    from torch.autograd import DeviceType

    dev_ms = sum(e.self_device_time_total for e in ev
                 if e.device_type == DeviceType.CUDA and not e.is_user_annotation) / 1e3
    launches = sum(e.count for e in ev if e.key in ("cudaLaunchKernel", "cuLaunchKernelEx"))
    return dev_ms, launches


def profile_device(what: str, fn, wall_ms: float):
    """Where the time of `fn` goes: `torch.profiler` over one call —
    device time by kernel, kernel launches, and the device's busy share of
    the unprofiled wall time `wall_ms`. Returns the key averages."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    ev = prof.key_averages()
    dev_ms, launches = _busy(ev)
    print(f"profile of {what}: device busy {dev_ms:.2f} ms of {wall_ms:.2f} ms "
          f"unprofiled wall ({dev_ms / wall_ms:.1%}); {launches} kernel launches")
    print(ev.table(sort_by="self_device_time_total", row_limit=10, max_name_column_width=50))
    return ev


def _wall(fn) -> float:
    t0 = time.perf_counter()
    fn()
    sync()
    return time.perf_counter() - t0


# ------------------------------------------------------------------ phase 3
def phase_error_channel(dev, main: dict) -> None:
    pipe = main["pipe"]
    cfg = RetrievalConfig(
        bits=8, metric="cosine", path="kernel_bitserial", mapping="error_aware",
        error=ErrorModelConfig(enabled=True, p_min=5e-3, p_max=4e-2,
                               jitter_sigma=0.25, seed=SEED),
        detect=True, max_retries=2)
    pipe.index = DircRagIndex.build(main["embs"], cfg, device=dev)
    ids, _ = pipe.search_batch(main["queries"], K, generator=make_generator(dev, SEED))
    self_rate = float(np.mean(ids[:, 0] == np.asarray(main["own"])))
    _, stats = pipe.index.sensed_planes(make_generator(dev, SEED + 1))
    print(f"error channel: detected {stats['detected']} planes, residual "
          f"{stats['residual']}; self-retrieval {self_rate:.2f}")
    check(stats["detected"] > 0, "Sigma-D detection never fired")


# ------------------------------------------------------------------ phase 4
STREAM_CFG = dict(n_slots=8, paged=True, block_size=BS, prefill_chunk=32)


def stream_requests(corpus) -> list:
    """16 requests: 8 distinct corpus documents, each asked by two tenants
    back to back (the order the scheduler's round robin over the two
    tenants hands them to the engine), so each repeated retrieved context
    is in flight with its publisher and attaches its prefix blocks."""
    docs = list(range(0, N_DOCS, N_DOCS // 8))
    return [(tenant, corpus[d]) for d in docs for tenant in ("tenant-a", "tenant-b")]


def reset_launches() -> None:
    """Every kernel's launch count to 0 (under the counters' lock)."""
    counters.reset()


def launch_count(name: str) -> int:
    """One kernel's launch count, read under the counters' lock."""
    return counters.read()[name]


def phase_stream(dev, main: dict) -> dict:
    """The streaming path at full width: query_stream(generate=True,
    paged=True, paged_kernel=True) over 16 requests; then the same
    prompts through a manual-mode engine for exact launch counts; then
    K3 / gather / fixed-slot greedy parity at full width, 4 layers, fp32."""
    pipe = main["pipe"]
    cfg = pipe.engine.model.cfg
    n_layers = cfg.n_layers
    pipe.index = DircRagIndex.build(
        main["embs"], RetrievalConfig(bits=8, metric="cosine", n_cores=16,
                                      path="kernel_bitserial"), device=dev)
    reqs = stream_requests(main["corpus"])
    texts = [r[1] for r in reqs]
    want_ids, _ = pipe.search_batch(texts, K)
    config = EngineConfig(**STREAM_CFG, paged_kernel=True)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    items = list(pipe.query_stream(reqs, k=K, generate=True, max_new_tokens=NEW_TOKENS,
                                   config=config))
    sync()
    wall = time.perf_counter() - t0
    launches = counters.read()
    check(len(items) == len(reqs), f"stream yielded {len(items)} of {len(reqs)}")
    for it in items:
        # anything else is a failed retrieval or a failed engine loop
        check(isinstance(it, GenerationTicket) and it._error is None,
              f"stream item failed: {type(it).__name__} "
              f"{getattr(it, '_error', None)!r}")
        check(len(it.tokens) == NEW_TOKENS, f"{len(it.tokens)} tokens, not {NEW_TOKENS}")
        check(all(0 <= tk < cfg.vocab_size for tk in it.tokens), "token out of vocab")
        row = texts.index(it.text)
        check(np.array_equal(it.retrieval.doc_ids, want_ids[row]),
              f"stream ids {it.retrieval.doc_ids} != query_many's {want_ids[row]}")
    k3 = launches["paged_attend_fused"]
    check(k3 > 0 and k3 % n_layers == 0, f"K3 launches {k3} on the stream")
    check(launches["dirc_mac"] > 0, "K1 never launched on the stream")
    check(launches["topk_select"] == launches["dirc_mac"],
          f"K4 launches {launches['topk_select']} != searches {launches['dirc_mac']}")
    ttft = [it.first_token_s * 1e3 for it in items]
    e2e = [it.wait_s * 1e3 for it in items]
    print(f"query_stream (16 requests, k {K}, {NEW_TOKENS} new tokens, {cfg.name} "
          f"{n_layers} layers bf16, {STREAM_CFG}): wall {wall:.3f} s; TTFT median "
          f"{statistics.median(ttft):.1f} ms, max {max(ttft):.1f} ms; end to end median "
          f"{statistics.median(e2e):.1f} ms, max {max(e2e):.1f} ms; launches {launches}; "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # the same augmented prompts through a manual-mode engine: exact counts
    prompts = []
    for text, ids in zip(texts, want_ids):
        prompts.append(pipe.encode_prompt_with_prefix(
            text, [main["corpus"][i] for i in ids if i >= 0]))
    engine = pipe.decode_engine(config, max_new_tokens=NEW_TOKENS, start=False)
    reset_launches()
    t0 = time.perf_counter()
    tickets = [engine.submit(p, max_new_tokens=NEW_TOKENS, tenant=r[0], prefix_len=pl)
               for (p, pl), r in zip(prompts, reqs)]
    engine.run_until_drained()
    sync()
    manual_s = time.perf_counter() - t0
    st = engine.stats()
    pool = st["pool"]
    steps = st["n_decode_steps"] + st["n_prefill_chunks"]
    check(launch_count("paged_attend_fused") == n_layers * steps,
          f"K3 launches {launch_count('paged_attend_fused')} != {n_layers} x {steps} steps")
    check(launch_count("paged_combine") + launch_count("paged_attend_prefill")
          == launch_count("paged_attend_fused"),
          f"combine {launch_count('paged_combine')} + prefill "
          f"{launch_count('paged_attend_prefill')} launches != K3 launches")
    check(pool["n_prefix_hits"] >= 1, f"prefix sharing never attached: {pool}")
    check(pool["free_blocks"] == pool["n_usable_blocks"], f"blocks leaked: {pool}")
    check(all(len(t.result()) == NEW_TOKENS for t in tickets), "manual engine tokens")
    print(f"manual engine, same prompts: {manual_s:.3f} s; {st['n_decode_steps']} decode "
          f"steps, {st['n_prefill_chunks']} prefill chunks, mean occupancy "
          f"{st['mean_occupancy']:.2f}; K3 launches {launch_count('paged_attend_fused')} = {n_layers} x "
          f"{steps}; prefix hits {pool['n_prefix_hits']}, CoW copies "
          f"{pool['n_cow_copies']}; prompt lengths {min(len(p) for p, _ in prompts)}-"
          f"{max(len(p) for p, _ in prompts)}")
    engine.close()

    # profile a short window: the first tenant pair (a publisher and the
    # duplicate that attaches its prefix); the whole run's ~280k launches
    # would take the profiler minutes to process
    def rerun():
        eng = pipe.decode_engine(config, max_new_tokens=NEW_TOKENS, start=False)
        for (p, pl), r in zip(prompts[:2], reqs[:2]):
            eng.submit(p, max_new_tokens=NEW_TOKENS, tenant=r[0], prefix_len=pl)
        eng.run_until_drained()
        return eng.stats()

    rerun()   # warm
    short_ms = _wall(rerun) * 1e3
    reset_launches()
    ev = profile_device("a 2-request engine run (one prefix pair)", rerun, short_ms)
    k3_dev = sum(e.self_device_time_total for e in ev
                 if any(p in e.key for p in KERNEL_NAMES["paged_attend_fused"])) / 1e3
    print(f"K3 device time in that run: {k3_dev:.2f} ms over {launch_count('paged_attend_fused')} "
          f"launches ({k3_dev / max(launch_count('paged_attend_fused'), 1) * 1e3:.1f} us per launch)")

    # greedy parity at full width, 4 layers, fp32: K3 vs gather vs fixed-slot
    cfg4 = dataclasses.replace(cfg, n_layers=4, param_dtype="float32",
                               compute_dtype="float32")
    model4 = build_model(cfg4, device=dev).init(make_generator(dev, SEED + 4))
    outs = {}
    for name, ecfg in (("k3", EngineConfig(**STREAM_CFG, paged_kernel=True)),
                       ("gather", EngineConfig(**STREAM_CFG, paged_kernel=False)),
                       ("fixed_slot", EngineConfig(n_slots=8))):
        eng = ContinuousBatchingEngine(model4, ecfg.replace(cache_len=MAX_PROMPT + NEW_TOKENS),
                                       device=dev)
        ts = [eng.submit(p, max_new_tokens=NEW_TOKENS, prefix_len=pl) for p, pl in prompts]
        eng.run_until_drained()
        outs[name] = [t.result().tolist() for t in ts]
    check(outs["k3"] == outs["gather"] == outs["fixed_slot"],
          "4-layer fp32 engines disagree: " + str({k: v[:2] for k, v in outs.items()}))
    print(f"greedy parity, {cfg4.name} full width cut to 4 layers, fp32: K3, gather and "
          f"fixed-slot engines token-identical on all {len(prompts)} prompts")
    del model4
    return {"launches": k3, "topk_select": launches["topk_select"]}


# ------------------------------------------------------------------ phase 5
SHARD_QUERIES = 64     # serve_rag traffic: 8 batches of MAIN_B, twice


def _counting(pipe) -> list:
    """Count the pipeline's search batches (one index search each)."""
    n = [0]
    search = pipe.search_batch

    def counted(*a, **kw):
        n[0] += 1
        return search(*a, **kw)

    pipe.search_batch = counted
    return n


class CorpusEmbedder:
    """Phase 2's `HashEmbedder`, which hands back phase 2's embeddings when
    asked for that whole corpus (the embedder is deterministic), so that a
    pipeline built here embeds no corpus again. Queries and new documents
    are embedded as in any pipeline."""

    def __init__(self, embedder: HashEmbedder, corpus: list, embs: np.ndarray):
        self.embedder, self.dim = embedder, embedder.dim
        self.corpus, self.embs = corpus, embs

    def embed(self, texts) -> np.ndarray:
        if list(texts) == self.corpus:
            return self.embs.copy()
        return self.embedder.embed(texts)


def hold_on_cpu(idx: ShardedDircIndex, q: np.ndarray, ids, scores, label: str) -> None:
    """A search's ids and scores on the card against the same macro images
    copied to the CPU and searched there on path `int_exact`: the plain
    integer dot (K1's and K2's function) and the plain stable sort (K4's)."""
    arrays = {f.name: getattr(idx, f.name).cpu() for f in dataclasses.fields(idx)
              if isinstance(getattr(idx, f.name), torch.Tensor)}
    twin = dataclasses.replace(idx, config=dataclasses.replace(idx.config, path="int_exact"),
                               **arrays)
    want = twin.search(q, K)
    check(np.array_equal(np.asarray(ids), want.indices.numpy())
          and np.array_equal(np.asarray(scores), want.scores.numpy()),
          f"{label}: the card's search differs from the plain versions on the CPU")
    print(f"{label}: ids and scores equal the plain versions' on the CPU")


def phase_sharded(dev, main: dict, k4_fused: dict) -> dict:
    """The sharded path at the paper's operating point: 8192 docs over 4
    macros of 2048 (16 cores of 128 each), phase 2's corpus and
    embeddings, through `serve_rag`; then updates, a drifting error
    channel with online recalibration, and open-loop traffic. Returns the
    K4 launches of the run and K1 / K4's max |err| at this phase's shapes."""
    corpus, embs = main["corpus"], main["embs"]
    embedder = CorpusEmbedder(main["embedder"], corpus, embs)
    own = list(range(5, N_DOCS, N_DOCS // 32))               # 32 corpus documents
    q_emb = embs[own]
    mono = DircRagIndex.build(embs, RetrievalConfig(bits=8, metric="cosine",
                                                    n_cores=N_CORES), device=dev)
    want = mono.search(q_emb, K)
    launches_total = 0
    out = {}
    # record the shape of every fused top-k launch the phase makes (each
    # search's `hierarchical_topk` over S x b rows) to hold them all below
    sent, select = set(), topk_select.hierarchical_select

    def recording(scores, k, n_cores):
        sent.add((*scores.shape, k, n_cores))
        return select(scores, k, n_cores)

    topk_select.hierarchical_select = recording
    for path, kmod in (("int_exact", None), ("kernel_bitserial", dirc_mac)):
        t0 = time.perf_counter()
        # what `build_rag_pipeline(path=path)` builds, over phase 2's embeddings
        pipe = RagPipeline(corpus, RetrievalConfig(bits=8, metric="cosine", path=path),
                           embedder=embedder, dim=DIM, n_shards=N_SHARDS, device=dev)
        sync()
        build_s = time.perf_counter() - t0
        idx = pipe.index
        check(idx.capacity == N_DOCS // N_SHARDS and idx.capacity % N_CORES == 0,
              f"capacity {idx.capacity}")
        got = idx.search(q_emb, K)
        check(torch.equal(got.indices, want.indices) and torch.equal(got.scores, want.scores),
              f"{path}: sharded top-k differs from the monolithic index's")
        hold_on_cpu(idx, q_emb, got.indices.cpu(), got.scores.cpu(),
                    f"sharded {path}, {len(own)} queries")
        searches = _counting(pipe)
        reset_launches()
        res = rag_serve.serve_rag(pipe=pipe, batch=MAIN_B, n_queries=SHARD_QUERIES, k=K,
                                  seed=SEED)
        sync()
        n_k1, n_k4 = launch_count("dirc_mac"), launch_count("topk_select")
        check(res["self_retrieval"] == 1.0, f"{path}: self-retrieval {res['self_retrieval']}")
        check(n_k4 == searches[0] > 0, f"{path}: K4 launches {n_k4} != searches {searches[0]}")
        if kmod is dirc_mac:
            check(n_k1 == searches[0], f"K1 launches {n_k1} != searches {searches[0]}")
        launches_total += n_k4
        search_ms = time_ms(lambda: idx.search(q_emb[:MAIN_B], K), iters=20)
        print(f"sharded {path}: build {build_s:.3f} s (no re-embedding); ids and scores "
              f"equal the monolithic index on {len(own)} queries; serve_rag "
              f"{SHARD_QUERIES} queries x 2 in batches of {MAIN_B}: {res['qps']:.0f} q/s, "
              f"self-retrieval {res['self_retrieval']:.2f}; {searches[0]} searches, launches "
              f"K1 {n_k1}, K4 {n_k4}; search {search_ms:.4f} ms per batch of {MAIN_B} (K4's "
              f"fused launch alone {k4_fused['ms']:.4f} ms = "
              f"{k4_fused['ms'] / search_ms:.1%})")
        out[f"search_ms_{path}"] = search_ms
        out[f"qps_{path}"] = res["qps"]

    # incremental updates on the kernel_bitserial pipeline
    new = [f"new document {i}: " + " ".join(f"u{(i * 31 + j) % 997}" for j in range(12))
           for i in range(64)]
    reset_launches()
    ids = pipe.add_docs(new)
    check(ids.tolist() == list(range(N_DOCS, N_DOCS + 64)), f"new ids {ids[:4]}...")
    got_ids, got_scores = pipe.search_batch(new, K)
    check((got_ids[:, 0] == ids).all(), "an added document does not retrieve itself")
    hold_on_cpu(pipe.index, embedder.embed(new), got_ids, got_scores,
                f"grown index, {len(new)} queries")
    check(pipe.delete_docs(ids[:32].tolist()) == 32, "delete_docs count")
    got_ids, got_scores = pipe.search_batch(new + corpus[:8], K)
    check(not np.isin(got_ids, ids[:32]).any(), "a deleted id came back")
    check((got_ids[32:64, 0] == ids[32:]).all(), "a kept new document lost itself")
    hold_on_cpu(pipe.index, embedder.embed(new + corpus[:8]), got_ids, got_scores,
                f"after delete_docs, {len(new) + 8} queries")
    launches_total += launch_count("topk_select")
    print(f"add_docs 64 -> ids {ids[0]}..{ids[-1]} (capacity {pipe.index.capacity}, "
          f"loads {pipe.index.shard_loads().tolist()}); delete_docs 32: deleted ids never "
          f"return, kept ones retrieve themselves; K4 launches {launch_count('topk_select')}")
    # K1 and K4 at every shape this phase gives them that phase 1 and 1c do
    # not hold: the 32-query check (capacity 2048), the update searches
    # (64 and 72 rows) and the open loop's padded batches (16 rows) below
    # (capacity 4096 after the growth)
    g = make_generator(dev, SEED + 4)
    k1_err = k4_err = 0
    for b, cap in ((len(own), N_DOCS // N_SHARDS), (len(new), pipe.index.capacity),
                   (len(new) + 8, pipe.index.capacity), (16, pipe.index.capacity)):
        k1_err = max(k1_err, check_k1(g, b, N_SHARDS * cap, DIM, 8, "phase 5 shape"))
        s_rand = torch.randn((N_SHARDS * b, cap), generator=g, device=dev)
        k4_err = max(k4_err, check_k4(s_rand, K, cap // N_CORES, f"phase 5 shape (rows "
                                      f"{N_SHARDS * b}, n {cap}, block {cap // N_CORES}, "
                                      f"k {K})"))
    out["max_abs_err"] = {"dirc_mac": k1_err, "topk_select": k4_err}

    # a drifting error channel, recalibrated online (the drive of
    # tests/test_recalibration.py on an injected clock)
    clock = [0.0]
    cfg = RetrievalConfig(bits=8, metric="cosine", n_cores=N_CORES, path="kernel_bitserial",
                          mapping="error_aware",
                          error=ErrorModelConfig(enabled=True, p_min=1e-4, p_max=1.5e-2,
                                                 jitter_sigma=2.0, seed=5),
                          detect=True, max_retries=2)
    drift_pipe = RagPipeline(corpus, cfg, embedder=embedder, dim=DIM,
                             n_shards=N_SHARDS, device=dev, clock=lambda: clock[0],
                             drift=DriftConfig(enabled=True, rotate_rate=0.02, seed=11),
                             recal=RecalibrationConfig(window=4, trigger_ratio=1.02,
                                                       min_detected=1))
    g = make_generator(dev, SEED + 5)
    texts = [corpus[i] for i in own[:MAIN_B]]
    hits = []
    reset_launches()
    t0 = time.perf_counter()
    for _ in range(40):
        clock[0] += 1.0
        got_ids, _ = drift_pipe.search_batch(texts, K, generator=g)
        hits.append(float(np.mean(got_ids[:, 0] == np.asarray(own[:MAIN_B]))))
    sync()
    drift_s = time.perf_counter() - t0
    launches_total += launch_count("topk_select")
    st = drift_pipe.retrieval_stats()
    rag_serve._print_retrieval_stats({"retrieval": st})
    print(f"drift run: 40 searches in {drift_s:.3f} s, K1 {launch_count('dirc_mac')} / K4 "
          f"{launch_count('topk_select')} launches, self-retrieval mean {np.mean(hits):.3f}, "
          f"recalibrations {st['total_recals']} (per shard "
          f"{[r['recal_events'] for r in st['shards']]})")
    check(st["total_recals"] >= 1, "the recalibration controller never fired")
    check(launch_count("topk_select") == launch_count("dirc_mac") == 40, "drift run launches")

    # open-loop Poisson traffic against the background flush loop
    reset_launches()
    ol = rag_serve.serve_rag_open_loop(max_batch=16, max_wait_ms=5.0, n_tenants=4,
                                       offered_qps=500.0, n_queries=300, k=K, seed=SEED,
                                       pipe=pipe)
    sync()
    launches_total += launch_count("topk_select")
    check(ol["n_failed"] == 0, f"open loop: {ol['n_failed']} failed")
    check(launch_count("topk_select") == ol["n_flushes"] + 1, "open-loop K4 launches")
    print(f"serve_rag_open_loop (300 queries, offered 500 q/s, 4 tenants, max batch 16, "
          f"max wait 5 ms): achieved {ol['achieved_qps']:.1f} q/s; latency ms p50 "
          f"{ol['p50_ms']:.2f} p95 {ol['p95_ms']:.2f} p99 {ol['p99_ms']:.2f}; "
          f"{ol['n_flushes']} flushes, mean batch {ol['mean_batch']:.2f}; K4 launches "
          f"{launch_count('topk_select')}")
    out["launches"] = launches_total
    topk_select.hierarchical_select = select
    print(f"fused top-k shapes phase 5 sent (rows, n, k, cores): {sorted(sent)}")
    g = make_generator(dev, SEED + 6)
    for rows, n, k, n_cores in sorted(sent):
        check(n_cores == N_CORES, f"a search ran {n_cores} cores")
        s_rand = torch.randn((rows, n), generator=g, device=dev)
        k4_err = max(k4_err, check_fused(s_rand, k, f"phase 5 shape (rows {rows}, n {n}, "
                                                    f"k {k})"))
    out["max_abs_err"]["topk_select"] = k4_err
    return out


# ------------------------------------------------------------------ phase 6
GEN_QUERIES, GEN_TOKENS = 48, 16
GEN_PROMPT = 96        # `launch.serve.build_rag_pipeline`'s max_prompt_len
GEN_QPS = 4.0          # offered: 48 arrivals over ~12 s, about twice what 2 x 4 slots drain
GEN_CFG = EngineConfig(n_slots=4, paged=True, paged_kernel=True, block_size=BS,
                       prefill_chunk=32, prefix_sharing=True, retain_blocks=8,
                       host_blocks=64)
GEN_SLO = dict(ttft_p95_ms=500.0, e2e_p95_ms=2000.0, interval_s=0.25, min_samples=4,
               preempt=True)
WAVE_DOCS = list(range(3, N_DOCS, N_DOCS // 8))   # 8 contexts, repeated each wave
N_WAVES = 3
# (b): a roomy pool, and a retained budget of 2 entries (each ~26 tokens of
# context header, 2 blocks), so 4 contexts a replica push 2 to the host tier
WAVE_CFG = GEN_CFG.replace(n_blocks=64, retain_blocks=4)


def _recording(mod, name: str, key) -> tuple[set, object]:
    """Wrap `mod.name` so that every call records `key(*args)`; returns
    (the recorded set, the original function) to restore it."""
    seen, fn = set(), getattr(mod, name)

    def wrapped(*args, **kw):
        seen.add(key(*args))
        return fn(*args, **kw)

    setattr(mod, name, wrapped)
    return seen, fn


def phase_generate(dev, main: dict) -> dict:
    """Generation serving at full width: (a) `serve_rag_open_loop_generate`
    over a 2-replica fleet with the tiered prefix cache and the SLO
    controller; (b) waves of repeated contexts through `query_stream` and
    the fleet (retained hits, host swap-ins, affinity hits required); (c)
    preempt / resume, `preempt_for_waiting`, a host round trip, the fleet
    against one engine (fp32, 4 layers) and `serve`; then K1, the fused
    K4 and K3 held at every shape the phase gave them. Returns its launch
    counts and max |err|s."""
    corpus = main["corpus"]
    model = main["pipe"].engine.model
    cfg = model.cfg
    embedder = CorpusEmbedder(main["embedder"], corpus, main["embs"])
    t0 = time.perf_counter()
    # phase 5's 4-macro index as `build_rag_pipeline(path="kernel_bitserial")`
    # stands it up, with phi4-mini at full width attached
    pipe = RagPipeline(corpus, RetrievalConfig(bits=8, metric="cosine",
                                               path="kernel_bitserial"),
                       model=model, embedder=embedder, dim=DIM, n_shards=N_SHARDS,
                       max_prompt_len=GEN_PROMPT, device=dev)
    sync()
    check(pipe.index.capacity == N_DOCS // N_SHARDS, f"capacity {pipe.index.capacity}")
    print(f"phase 6 pipeline: {N_SHARDS} macros of {pipe.index.capacity}, path "
          f"kernel_bitserial, {cfg.name} {cfg.n_layers} layers bf16, max prompt "
          f"{GEN_PROMPT}; build {time.perf_counter() - t0:.3f} s")
    k4_sent, k4_fn = _recording(topk_select, "hierarchical_select",
                                lambda s_, k, n_cores: (*s_.shape, k, n_cores))
    k1_sent, k1_fn = _recording(dirc_mac, "dirc_mac_packed",
                                lambda qp, dp, bits=8: (qp.shape[0], dp.shape[2],
                                                        32 * qp.shape[2], bits))
    k3_sent, k3_fn = _recording(
        paged_attend, "paged_attend_fused",
        lambda q, kn, vn, kp, vp, tbl, ln, nv, *a: (q.shape[0], q.shape[1], tbl.shape[1],
                                                    kp.shape[0], q.dtype))
    out = {"launches": {}}
    made = []   # every engine fleet the pipeline builds, to read its counters
    decode_engine = pipe.decode_engine

    def capturing(*a, **kw):
        made.append(decode_engine(*a, **kw))
        return made[-1]

    pipe.decode_engine = capturing
    try:
        # ---- (a) open-loop load
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        rep = rag_serve.serve_rag_open_loop_generate(
            max_batch=16, max_wait_ms=5.0, n_tenants=4, offered_qps=GEN_QPS,
            n_queries=GEN_QUERIES, k=K, max_new_tokens=GEN_TOKENS, config=GEN_CFG,
            n_replicas=2, affinity=True, slo=SLOConfig(**GEN_SLO), hi_pri_tenants=1,
            seed=SEED, pipe=pipe)
        sync()
        wall_a = time.perf_counter() - t0
        la = counters.read()
        check(rep["n_failed"] == 0 and rep["n_chain_failed"] == 0,
              f"open loop: {rep['n_failed']} failed, {rep['n_chain_failed']} chain failures")
        check(rep["n_finished"] == GEN_QUERIES, f"finished {rep['n_finished']}")
        check(rep["n_tokens"] == GEN_QUERIES * GEN_TOKENS, f"tokens {rep['n_tokens']}")
        check(la["dirc_mac"] > 0 and la["topk_select"] == la["dirc_mac"],
              f"K1 / K4 launches {la['dirc_mac']} / {la['topk_select']}")
        check(la["paged_attend_fused"] > 0 and la["paged_attend_fused"] % cfg.n_layers == 0
              and la["paged_combine"] + la["paged_attend_prefill"] == la["paged_attend_fused"],
              f"K3 launches {la['paged_attend_fused']}, combine {la['paged_combine']}, "
              f"prefill {la['paged_attend_prefill']}")
        pool, slo = rep["pool"], rep["slo"]
        fleet_a = made[-1].stats()["fleet"]
        print(f"(a) serve_rag_open_loop_generate: {GEN_QUERIES} queries offered at "
              f"{GEN_QPS:.1f} q/s, 4 tenants (tenant0 priority 1), {GEN_TOKENS} new tokens, "
              f"2 replicas x {GEN_CFG.n_slots} slots (paged, K3, retain "
              f"{GEN_CFG.retain_blocks}, host {GEN_CFG.host_blocks} blocks): wall "
              f"{wall_a:.3f} s; achieved {rep['achieved_qps']:.3f} q/s; TTFT p50 / p95 "
              f"{rep['ttft_p50_ms']:.1f} / {rep['ttft_p95_ms']:.1f} ms; e2e p50 / p95 / "
              f"p99 {rep['p50_ms']:.1f} / {rep['p95_ms']:.1f} / {rep['p99_ms']:.1f} ms; "
              f"per token {rep['per_token_ms_mean']:.2f} ms mean, p95 "
              f"{rep['per_token_ms_p95']:.2f}; decode {rep['decode_tok_per_s']:.1f} tok/s; "
              f"mean occupancy {rep['mean_slot_occupancy']:.2f}")
        print(f"(a) preemptions {fleet_a['n_preemptions']} (SLO controller's "
              f"{slo['n_preemptions']}), resumes {fleet_a['n_resumes']}; swap-ins "
              f"{pool['n_host_hits']}, host bytes parked at end {pool['host_bytes']}, "
              f"evictions {pool['n_evictions']}; prefix hits {pool['n_prefix_hits']} "
              f"(device {pool['n_device_hits']}); affinity hits / misses / spills "
              f"{rep['n_affinity_hits']} / {rep['n_affinity_misses']} / "
              f"{rep['n_affinity_spills']}, per replica {rep['per_replica_submits']}; "
              f"SLO polls {slo['n_polls']}, tightens {slo['n_tightens']}, relaxes "
              f"{slo['n_relaxes']}, weight updates {slo['n_weight_updates']}, worst "
              f"p95/target {slo['worst_ratio']:.2f}, final max_wait {slo['max_wait_ms']} ms, "
              f"lookahead {slo['admit_lookahead']}")
        print(f"(a) launches K1 {la['dirc_mac']}, fused K4 {la['topk_select']}, K3 "
              f"{la['paged_attend_fused']} (combine {la['paged_combine']}, prefill "
              f"{la['paged_attend_prefill']}); peak device "
              f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        out["a"] = {key: rep[key] for key in (
            "ttft_p50_ms", "ttft_p95_ms", "p50_ms", "p95_ms", "p99_ms", "per_token_ms_mean",
            "decode_tok_per_s", "achieved_qps")}

        # ---- (b) repeated contexts through the fleet, wave after wave
        made.clear()
        wave = [(f"tenant-{j % 4}", corpus[d], j % 2) for j, d in enumerate(WAVE_DOCS)]

        def waves():
            for w in range(N_WAVES):
                while w and made[0].stats()["fleet"]["n_finished"] < w * len(wave):
                    time.sleep(0.005)   # the previous wave drains first
                # every other wave in reverse: the contexts retained last come
                # first (device hits) before the swap-ins push them out (a
                # cyclic order would make every repeat a host hit)
                yield from (wave[::-1] if w % 2 else wave)

        reset_launches()
        t0 = time.perf_counter()
        items = list(pipe.query_stream(
            waves(), k=K, max_batch=16, generate=True, max_new_tokens=NEW_TOKENS,
            config=WAVE_CFG, n_replicas=2, affinity=True, slo=SLOConfig(**GEN_SLO)))
        sync()
        wall_b = time.perf_counter() - t0
        lb = counters.read()
        router = made[0]
        st = router.stats()
        fleet = st["fleet"]
        check(len(items) == N_WAVES * len(wave), f"stream yielded {len(items)}")
        for it in items:   # T11: anything else is a failed retrieval or engine loop
            check(isinstance(it, GenerationTicket) and it._error is None,
                  f"stream item failed: {type(it).__name__} {getattr(it, '_error', None)!r}")
            check(len(it.tokens) == NEW_TOKENS
                  and all(0 <= tk < cfg.vocab_size for tk in it.tokens), "stream tokens")
        check(fleet["n_host_hits"] >= 1, f"no host-tier swap-in: {fleet}")
        check(fleet["n_device_hits"] >= 1, f"no retained-tier hit: {fleet}")
        check(st["n_affinity_hits"] >= 1, f"no affinity hit: {st['n_affinity_hits']}")
        check(lb["paged_combine"] + lb["paged_attend_prefill"] == lb["paged_attend_fused"] > 0,
              f"K3 launches {lb['paged_attend_fused']} != combine {lb['paged_combine']} + "
              f"prefill {lb['paged_attend_prefill']}")
        check(lb["dirc_mac"] > 0 and lb["topk_select"] == lb["dirc_mac"],
              f"(b) K1 / K4 launches {lb['dirc_mac']} / {lb['topk_select']}")
        dropped = router.clear_prefix_cache()
        for i, e in enumerate(router.engines):
            p_ = e.stats()["pool"]
            check(p_["free_blocks"] == p_["n_usable_blocks"] and not e._host_kv,
                  f"replica {i} leaked blocks: {p_}")
        print(f"(b) query_stream, {N_WAVES} waves of the same {len(wave)} contexts "
              f"(priorities 0/1), 2 replicas (retain {WAVE_CFG.retain_blocks}, host "
              f"{WAVE_CFG.host_blocks}, pool {WAVE_CFG.n_blocks} blocks): wall {wall_b:.3f} s; "
              f"prefix hits {fleet['n_prefix_hits']} (device {fleet['n_device_hits']}, host "
              f"swap-ins {fleet['n_host_hits']}) / misses {fleet['n_prefix_misses']}; "
              f"affinity hits / misses / spills {st['n_affinity_hits']} / "
              f"{st['n_affinity_misses']} / {st['n_affinity_spills']}; preemptions "
              f"{fleet['n_preemptions']}, resumes {fleet['n_resumes']}; SLO "
              f"{pipe.last_slo_stats['n_polls']} polls; K1 {lb['dirc_mac']}, K4 "
              f"{lb['topk_select']}, K3 {lb['paged_attend_fused']} = combine + prefill; "
              f"clear_prefix_cache dropped {dropped}; no replica leaked a block")
    finally:
        pipe.decode_engine = decode_engine
        topk_select.hierarchical_select = k4_fn
        dirc_mac.dirc_mac_packed = k1_fn
        paged_attend.paged_attend_fused = k3_fn
    for name in ("dirc_mac", "topk_select", "paged_attend_fused"):
        out["launches"][name] = la[name] + lb[name]

    # ---- (c) parity at full width, 4 layers, fp32, manual mode
    t0 = time.perf_counter()
    prompts = []
    for d in WAVE_DOCS:
        ids, _ = pipe.search_batch([corpus[d]], K)
        prompts.append(pipe.encode_prompt_with_prefix(
            corpus[d], [corpus[i] for i in ids[0] if i >= 0]))
    cfg4 = dataclasses.replace(cfg, n_layers=4, param_dtype="float32",
                               compute_dtype="float32")
    model4 = build_model(cfg4, device=dev).init(make_generator(dev, SEED + 6))
    pcfg = EngineConfig(n_slots=2, cache_len=GEN_PROMPT + GEN_TOKENS, paged=True,
                        paged_kernel=True, block_size=BS, prefill_chunk=32,
                        prefix_sharing=True)

    def run(config, reqs, **kw):
        eng = ContinuousBatchingEngine(model4, config, device=dev, **kw)
        ts = [eng.submit(p, max_new_tokens=GEN_TOKENS, prefix_len=pl) for p, pl in reqs]
        eng.run_until_drained()
        return [t.result().tolist() for t in ts], eng

    single, _ = run(pcfg, prompts)
    p0, pl0 = prompts[0]
    for retain in (16, 0):   # resume by re-attach, then by a full re-prefill
        eng = ContinuousBatchingEngine(model4, pcfg.replace(retain_blocks=retain), device=dev)
        t = eng.submit(p0, max_new_tokens=GEN_TOKENS, prefix_len=pl0)
        while len(t.tokens) < 5:
            eng.step()
        check(eng.preempt(), "preempt() found no running sequence")
        eng.run_until_drained()
        st = eng.stats()
        check(t.result().tolist() == single[0],
              f"preempted (retain {retain}) tokens differ from an uninterrupted run")
        check(st["n_preemptions"] == st["n_resumes"] == 1 and t.n_preempted == 1,
              f"preemption counters {st['n_preemptions']} / {st['n_resumes']}")
        if retain:
            check(st["pool"]["n_device_hits"] >= 1, "the resume did not re-attach")
    # preempt_for_waiting under pool pressure: a hog fills the pool, an equal
    # priority waits without effect, a priority-1 request preempts it
    tight = pcfg.replace(n_blocks=blocks_for(GEN_PROMPT + GEN_TOKENS, BS) + 3)
    eng = ContinuousBatchingEngine(model4, tight, device=dev)
    hog = eng.submit(p0, max_new_tokens=GEN_TOKENS, prefix_len=pl0, priority=0)
    while len(hog.tokens) < 3:
        eng.step()
    same = eng.submit(prompts[1][0], max_new_tokens=GEN_TOKENS, priority=0)
    eng.step()
    check(eng.pending() == 1 and eng.preempt_for_waiting() == 0,
          "preempt_for_waiting fired for an equal priority")
    hi = eng.submit(prompts[2][0], max_new_tokens=GEN_TOKENS, priority=1)
    eng.step()
    check(eng.preempt_for_waiting() == 1 and hog.n_preempted == 1,
          "preempt_for_waiting did not preempt the priority-0 hog")
    eng.run_until_drained()
    check(hog.result().tolist() == single[0], "the preempted hog's tokens differ")
    check(all(len(x.result()) == GEN_TOKENS for x in (same, hi)), "waiters' tokens")
    # a host-tier round trip: A's retained blocks, parked by B, swapped back
    host = pcfg.replace(n_slots=1, n_blocks=24, retain_blocks=2, host_blocks=16)
    eng = ContinuousBatchingEngine(model4, host, device=dev)
    (pa, pla), (pb, plb) = prompts[0], prompts[1]
    eng.submit(pa, max_new_tokens=2, prefix_len=pla).result()
    key_a = eng.compute_prefix_key(pa, pla)[0]
    blocks = list(eng._pcm._prefix_index[key_a].blocks)
    before = (eng._pools.k_pool[:, blocks].clone(), eng._pools.v_pool[:, blocks].clone())
    eng.submit(pb, max_new_tokens=2, prefix_len=plb).result()
    check(eng._pcm.host_keys() == [key_a], f"A not parked: {eng._pcm.host_keys()}")
    eng.submit(pa, max_new_tokens=2, prefix_len=pla).result()
    blocks2 = list(eng._pcm._prefix_index[key_a].blocks)
    check(eng.stats()["pool"]["n_host_hits"] == 1, "A was not swapped in")
    check(torch.equal(eng._pools.k_pool[:, blocks2], before[0])
          and torch.equal(eng._pools.v_pool[:, blocks2], before[1]),
          "a host round trip changed the prefix's KV")
    # the fleet against one engine
    router = EngineRouter(model4, pcfg, n_replicas=2, device=dev)
    ts = [router.submit(p, max_new_tokens=GEN_TOKENS, prefix_len=pl) for p, pl in prompts]
    router.run_until_drained()
    check([t.result().tolist() for t in ts] == single,
          "2-replica routed tokens differ from one engine's")
    check(sorted(set(t.replica for t in ts)) == [0, 1], "the router used one replica")
    del model4, eng, router
    par_s = time.perf_counter() - t0
    print(f"(c) {cfg4.name} full width cut to 4 layers, fp32, K3: preempt / resume "
          f"token-identical with retention (re-attach) and without (re-prefill); "
          f"preempt_for_waiting fired for priority 1 and not for an equal priority; host "
          f"round trip of {len(blocks)} blocks bit-equal; 2-replica router == one engine "
          f"on {len(prompts)} prompts; {par_s:.1f} s")
    res = rag_serve.serve("phi4-mini-3.8b", smoke=False, batch=4, prompt_len=16,
                          new_tokens=GEN_TOKENS, seed=SEED, device=dev)
    toks = res["tokens"]
    check(toks.shape == (4, GEN_TOKENS) and bool(((toks >= 0) & (toks < cfg.vocab_size))
                                                 .all()), f"serve tokens {toks.shape}")
    print(f"(c) serve('phi4-mini-3.8b', smoke=False): tokens {toks.shape} in "
          f"{res['wall_s']:.3f} s ({res['tok_per_s']:.1f} tok/s)")
    out["serve_tok_per_s"] = res["tok_per_s"]

    # K1, the fused K4 and K3 at every shape this phase gave them
    g = make_generator(dev, SEED + 7)
    k1_err = k4_err = k3_err = 0.0
    print(f"shapes phase 6 sent: K1 (b, n, dim, bits) {sorted(k1_sent)}; fused K4 "
          f"(rows, n, k, cores) {sorted(k4_sent)}; K3 (b, t, table, pool blocks, dtype) "
          f"{len(k3_sent)}")
    for b, n, dim, bits in sorted(k1_sent):
        k1_err = max(k1_err, check_k1(g, b, n, dim, bits, "phase 6 shape"))
    for rows, n, k, n_cores in sorted(k4_sent):
        check(n_cores == N_CORES, f"a search ran {n_cores} cores")
        s_rand = torch.randn((rows, n), generator=g, device=dev)
        k4_err = max(k4_err, check_fused(s_rand, k, f"phase 6 shape (rows {rows}, n {n}, "
                                                    f"k {k})"))
    for b, t, mb, dtype in sorted({(b, t, mb, dt) for b, t, mb, _, dt in k3_sent}, key=str):
        cap = mb * BS - t
        lengths = torch.randint(0, cap + 1, (b,), generator=g, device=dev).tolist()
        n_valid = [t if t == 1 else int(x) for x in
                   torch.randint(1, t + 1, (b,), generator=g, device=dev).tolist()]
        c = k3_case(dev, g, dtype, lengths=lengths, n_valid=n_valid, t=t, mb=mb)
        k3_err = max(k3_err, hold_k3(c, f"phase 6 shape (b {b}, t {t}, table {mb})"))
    out["max_abs_err"] = {"dirc_mac": k1_err, "topk_select": k4_err,
                          "paged_attend_fused": k3_err}
    return out


# ------------------------------------------------------------------ phase 7
MOE_ARCH = "phi3.5-moe-42b-a6.6b"
MOE_LAYERS = 16    # of 32: 20.9 B parameters, 41.9 GB in bf16 (all 32: 83.5 GB)
# the other DecoderLM configs at their published widths, depth cut to fit
# one card at once (Arctic: one layer is 27.7 GB)
FAMILY_LAYERS = {"phi3-medium-14b": 2, "granite-34b": 2, "command-r-plus-104b": 2,
                 "qwen2-vl-72b": 2, "arctic-480b": 1}
PROBE_TOKENS = 32  # new tokens of the probe engine's sequences: they stay in decode


def param_bytes(model) -> int:
    return sum(p.numel() * p.element_size() for p in model.parameters())


def free_card() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def moe_probe(model, prompts) -> dict:
    """Outside the timed path: a manual-mode engine with its 8 slots in
    decode. The median wall of a decode step (b 8), one profiled step
    (device busy share, launches, the MoE layers' share of device time via
    a `record_function` around `apply_moe`), and the dropped fraction of
    one decode step's and one prefill piece's MoE calls (layer mean)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    eng = ContinuousBatchingEngine(model, EngineConfig(
        **STREAM_CFG, paged_kernel=True, cache_len=MAX_PROMPT + PROBE_TOKENS), device=model.device)
    for p, pl in prompts[:8]:
        eng.submit(p, max_new_tokens=PROBE_TOKENS, prefix_len=pl)
    while eng._prefills or eng.pending():
        eng.step()
    check(sum(s is not None for s in eng._slots) == 8, "probe: not 8 sequences in decode")
    eng.step()
    walls = [_wall(eng.step) * 1e3 for _ in range(5)]
    step_ms = statistics.median(walls)
    plain = moe_mod.apply_moe

    def annotated(*a, **kw):
        with record_function("moe"):
            return plain(*a, **kw)

    moe_mod.apply_moe = annotated
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            eng.step()
            sync()
    finally:
        moe_mod.apply_moe = plain
    ev = prof.key_averages()
    dev_ms, launches = _busy(ev)
    moe_ms = sum(e.device_time_total for e in ev
                 if e.key == "moe" and e.device_type == DeviceType.CPU) / 1e3
    print(ev.table(sort_by="self_device_time_total", row_limit=8, max_name_column_width=50))
    check(0 < moe_ms <= dev_ms * 1.01, f"MoE device time {moe_ms} ms of {dev_ms} ms")
    # dropped fractions: one decode step (8 rows a call) ...
    drops = {}

    def recording(cfg, p, x):
        y, aux = plain(cfg, p, x)
        drops.setdefault(x.shape[0] * x.shape[1], []).append(float(aux.dropped_fraction))
        return y, aux

    moe_mod.apply_moe = recording
    try:
        eng.step()
        # ... and one prefill piece (32 rows) of a fresh sequence
        one = ContinuousBatchingEngine(model, EngineConfig(
            **STREAM_CFG, paged_kernel=True, cache_len=MAX_PROMPT + NEW_TOKENS),
            device=model.device)
        one.submit(prompts[8][0], max_new_tokens=1)
        one.step()
    finally:
        moe_mod.apply_moe = plain
    eng.close()
    one.close()
    check(set(drops) == {8, 32}, f"probe MoE call sizes {sorted(drops)}")
    return dict(step_ms=step_ms, walls=walls, dev_ms=dev_ms, moe_ms=moe_ms,
                launches=launches, drop_decode=statistics.mean(drops[8]),
                drop_prefill=statistics.mean(drops[32]))


def moe_loop_ref(cfg, p, x: torch.Tensor) -> torch.Tensor:
    """The MoE layer as a plain per-token loop: softmax router, top k,
    normalised gates, sum_k gate_k * SwiGLU_k(x) (no capacity)."""
    out = torch.zeros_like(x)
    for i in range(x.shape[0]):
        probs = torch.softmax(x[i] @ p.router, dim=-1)
        g, e = torch.topk(probs, cfg.moe.top_k)
        g = g / g.sum()
        for gk, ek in zip(g.tolist(), e.tolist()):
            h = torch.nn.functional.silu(x[i] @ p.w_gate[ek]) * (x[i] @ p.w_up[ek])
            out[i] += gk * (h @ p.w_down[ek])
    return out


def phase_families(dev, main: dict) -> dict:
    """The DecoderLM families at their published widths. (a) phi3.5-moe,
    16 of 32 layers, bf16, over phase 5's 4-macro `kernel_bitserial` index:
    `query_many` and `query_stream` with K3 (a main path), then the
    decode-step probe; (b) 2 layers fp32: the K3 and gather paged engines
    token-identical, `apply_moe` at C = T against a per-token loop; (c)
    each other config (2 layers, Arctic 1, bf16): a 32-token prefill piece
    and 4 decode steps through K3, finite logits; then K1, the fused K4
    and K3 held at every shape the phase sent, and K3 timed at granite's
    MQA and phi3.5-moe's decode shapes."""
    corpus = main["corpus"]
    full = get_config(MOE_ARCH)
    cfg = dataclasses.replace(full, n_layers=MOE_LAYERS)
    free_card()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev).init(make_generator(dev, SEED + 8))
    sync()
    n_param = sum(p.numel() for p in model.parameters())
    print(f"phase 7 model {cfg.name}: published widths (d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.resolved_head_dim}, "
          f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k} of d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}); reduced: n_layers {full.n_layers} -> {cfg.n_layers}; bf16, "
          f"random weights; {n_param / 1e9:.3f} B params, {param_bytes(model) / 1e9:.2f} GB; "
          f"init {time.perf_counter() - t0:.2f} s; held before it {held / 2**30:.2f} GiB")
    pipe = RagPipeline(corpus, RetrievalConfig(bits=8, metric="cosine",
                                               path="kernel_bitserial"),
                       model=model, embedder=CorpusEmbedder(main["embedder"], corpus,
                                                            main["embs"]),
                       dim=DIM, n_shards=N_SHARDS, device=dev)
    k4_sent, k4_fn = _recording(topk_select, "hierarchical_select",
                                lambda s_, k, n_cores: (*s_.shape, k, n_cores))
    k1_sent, k1_fn = _recording(dirc_mac, "dirc_mac_packed",
                                lambda qp, dp, bits=8: (qp.shape[0], dp.shape[2],
                                                        32 * qp.shape[2], bits))
    k3_sent, k3_fn = _recording(
        paged_attend, "paged_attend_fused",
        lambda q, kn, vn, kp, vp, tbl, ln, nv, *a: (q.shape[0], q.shape[1], tbl.shape[1],
                                                    tuple(q.shape[2:3]) + tuple(kp.shape[2:]),
                                                    q.dtype))
    out = {}
    try:
        # ---- (a) the main path: query_many, then query_stream with K3
        reset_launches()
        t0 = time.perf_counter()
        results = pipe.query_many(main["queries"], k=K, max_new_tokens=NEW_TOKENS)
        sync()
        wall_many = time.perf_counter() - t0
        ids = np.stack([r.doc_ids for r in results])
        check((ids[:, 0] == np.asarray(main["own"])).all(), f"(a) self-retrieval {ids[:, 0]}")
        for r in results:
            check(r.answer_tokens.shape == (1, NEW_TOKENS) and bool(
                ((r.answer_tokens >= 0) & (r.answer_tokens < cfg.vocab_size)).all()),
                "(a) query_many answer")
        reqs = stream_requests(corpus)
        texts = [r[1] for r in reqs]
        want_ids, _ = pipe.search_batch(texts, K)
        config = EngineConfig(**STREAM_CFG, paged_kernel=True)
        t0 = time.perf_counter()
        items = list(pipe.query_stream(reqs, k=K, generate=True, max_new_tokens=NEW_TOKENS,
                                       config=config))
        sync()
        wall_stream = time.perf_counter() - t0
        la = counters.read()
        check(len(items) == len(reqs), f"(a) stream yielded {len(items)}")
        for it in items:
            check(isinstance(it, GenerationTicket) and it._error is None,
                  f"(a) stream item failed: {type(it).__name__} "
                  f"{getattr(it, '_error', None)!r}")
            check(len(it.tokens) == NEW_TOKENS
                  and all(0 <= tk < cfg.vocab_size for tk in it.tokens), "(a) stream tokens")
            check(np.array_equal(it.retrieval.doc_ids, want_ids[texts.index(it.text)]),
                  "(a) stream ids differ from search_batch's")
        check(la["paged_attend_fused"] > 0 and la["paged_attend_fused"] % cfg.n_layers == 0
              and la["paged_combine"] + la["paged_attend_prefill"] == la["paged_attend_fused"],
              f"(a) K3 launches {la['paged_attend_fused']}, combine {la['paged_combine']}, "
              f"prefill {la['paged_attend_prefill']}")
        check(la["dirc_mac"] > 0 and la["topk_select"] == la["dirc_mac"],
              f"(a) K1 / K4 launches {la['dirc_mac']} / {la['topk_select']}")
        out["launches"] = {n: la[n] for n in ("dirc_mac", "topk_select", "paged_attend_fused")}
        ttft = [it.first_token_s * 1e3 for it in items]
        e2e = [it.wait_s * 1e3 for it in items]
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"(a) query_many (8 queries, k {K}, {NEW_TOKENS} new tokens): "
              f"{wall_many:.3f} s; query_stream (16 requests, {STREAM_CFG}, K3): wall "
              f"{wall_stream:.3f} s; TTFT median {statistics.median(ttft):.1f} ms, max "
              f"{max(ttft):.1f} ms; e2e median {statistics.median(e2e):.1f} ms, max "
              f"{max(e2e):.1f} ms; launches K1 {la['dirc_mac']}, fused K4 "
              f"{la['topk_select']}, K3 {la['paged_attend_fused']} (= {cfg.n_layers} x "
              f"{la['paged_attend_fused'] // cfg.n_layers} paged steps); peak device memory "
              f"{peak:.2f} GiB")
    finally:
        topk_select.hierarchical_select = k4_fn
        dirc_mac.dirc_mac_packed = k1_fn
        paged_attend.paged_attend_fused = k3_fn
    prompts = [pipe.encode_prompt_with_prefix(text, [corpus[i] for i in ids_ if i >= 0])
               for text, ids_ in zip(texts, want_ids)]
    probe = moe_probe(model, prompts)
    expert_bytes = 3 * cfg.moe.n_experts * cfg.d_model * cfg.d_ff * 2 * cfg.n_layers
    bound_step = param_bytes(model) / HBM_BYTES_PER_S * 1e3
    print(f"(a) decode step (b 8, paged, K3), median of 5: {probe['step_ms']:.2f} ms "
          f"({' / '.join(f'{w:.2f}' for w in probe['walls'])}); bound {bound_step:.2f} ms "
          f"(every weight read once, {param_bytes(model) / 1e9:.2f} GB at 3.35 TB/s; the "
          f"experts alone {expert_bytes / 1e9:.2f} GB, "
          f"{expert_bytes / HBM_BYTES_PER_S * 1e3:.2f} ms: the dispatch runs all "
          f"{cfg.moe.n_experts} experts on their (C, d) rows)")
    print(f"(a) profiled decode step: device busy {probe['dev_ms']:.2f} ms of "
          f"{probe['step_ms']:.2f} ms ({probe['dev_ms'] / probe['step_ms']:.1%}); "
          f"{probe['launches']} kernel launches; MoE layers {probe['moe_ms']:.2f} ms of "
          f"device time ({probe['moe_ms'] / probe['dev_ms']:.1%}); dropped fraction (layer "
          f"mean) {probe['drop_decode']:.4f} at a decode step (8 rows, C "
          f"{moe_mod.capacity(8, cfg)}), {probe['drop_prefill']:.4f} at a prefill piece "
          f"(32 rows, C {moe_mod.capacity(32, cfg)})")
    out.update(stream_wall_s=wall_stream, many_wall_s=wall_many, peak_gib=peak,
               step_ms=probe["step_ms"], step_bound_ms=bound_step)
    del pipe, model, results, items
    free_card()

    # ---- (b) 2 layers, fp32: K3 engine == gather engine; apply_moe at C = T
    t0 = time.perf_counter()
    cfg2 = dataclasses.replace(full, n_layers=2, param_dtype="float32",
                               compute_dtype="float32")
    model2 = build_model(cfg2, device=dev).init(make_generator(dev, SEED + 9))
    toks = {}
    for name, pk in (("k3", True), ("gather", False)):
        eng = ContinuousBatchingEngine(model2, EngineConfig(
            **STREAM_CFG, paged_kernel=pk, cache_len=MAX_PROMPT + NEW_TOKENS), device=dev)
        ts = [eng.submit(p, max_new_tokens=NEW_TOKENS, prefix_len=pl) for p, pl in prompts[:8]]
        eng.run_until_drained()
        toks[name] = [t_.result().tolist() for t_ in ts]
    check(toks["k3"] == toks["gather"], "(b) K3 and gather engines disagree: "
          f"{toks['k3'][:2]} / {toks['gather'][:2]}")
    E, Kk = cfg2.moe.n_experts, cfg2.moe.top_k
    wide = dataclasses.replace(cfg2, moe=dataclasses.replace(cfg2.moe,
                                                            capacity_factor=E / Kk))
    x = torch.randn((1, 32, cfg2.d_model), generator=make_generator(dev, SEED + 10),
                    device=dev)
    check(moe_mod.capacity(32, wide) == 32, "C != T")
    p0 = model2.blocks[0].moe
    y, aux = moe_mod.apply_moe(wide, p0, x)
    ref = moe_loop_ref(wide, p0, x[0])
    rel = float((y[0] - ref).abs().max() / ref.abs().max())
    check(rel < 1e-4 and float(aux.dropped_fraction) == 0.0,
          f"(b) apply_moe at C = T vs the per-token loop: rel err {rel}, dropped "
          f"{float(aux.dropped_fraction)}")
    print(f"(b) {cfg2.name} at full width, 2 layers, fp32 ({param_bytes(model2) / 1e9:.2f} "
          f"GB): K3 and gather paged engines token-identical on 8 prompts; apply_moe at "
          f"C = T = 32 vs a per-token loop: max rel err {rel:.2e}, none dropped; "
          f"{time.perf_counter() - t0:.1f} s")
    del model2, eng
    free_card()

    # ---- (c) the other configs at published widths through K3
    k3_sent_c, k3_fn = _recording(
        paged_attend, "paged_attend_fused",
        lambda q, kn, vn, kp, vp, tbl, ln, nv, *a: (q.shape[0], q.shape[1], tbl.shape[1],
                                                    tuple(q.shape[2:3]) + tuple(kp.shape[2:]),
                                                    q.dtype))
    try:
        for arch, n_layers in FAMILY_LAYERS.items():
            t0 = time.perf_counter()
            cfg_a = dataclasses.replace(get_config(arch), n_layers=n_layers)
            m = build_model(cfg_a, device=dev).init(make_generator(dev, SEED + 11))
            gb = param_bytes(m) / 1e9
            pools = m.init_paged_caches(4 * 4 + 1, BS)
            tables = np.arange(1, 17, dtype=np.int32).reshape(4, 4)
            g = make_generator(dev, SEED + 12)
            prompt = torch.randint(0, cfg_a.vocab_size, (4, 32), generator=g, device=dev)
            n_valid = np.array([32, 32, 20, 9], np.int32)
            logits, _ = m.paged_step(pools, tables, np.zeros(4, np.int32), prompt,
                                     n_valid, paged_kernel=True)
            lengths = n_valid.copy()
            outs = [logits]
            for _ in range(4):
                nxt = torch.argmax(logits, dim=-1)[:, None]
                logits, _ = m.paged_step(pools, tables, lengths, nxt, np.ones(4, np.int32),
                                         paged_kernel=True)
                lengths += 1
                outs.append(logits)
            sync()
            check(all(bool(torch.isfinite(o[:, :cfg_a.vocab_size]).all()) for o in outs),
                  f"(c) {arch}: non-finite logits")
            h, kh, hd = cfg_a.effective_n_heads, cfg_a.n_kv_heads, cfg_a.resolved_head_dim
            print(f"(c) {arch}: published widths (d_model {cfg_a.d_model}, {h}/{kh} heads of "
                  f"{hd}: g {h // kh}, d_ff {cfg_a.d_ff}), reduced: n_layers "
                  f"{get_config(arch).n_layers} -> {n_layers}; {gb:.2f} GB bf16; a 32-token "
                  f"prefill piece (b 4) and 4 decode steps through K3: logits finite; "
                  f"{time.perf_counter() - t0:.1f} s")
            del m, pools, logits, outs
            free_card()
    finally:
        paged_attend.paged_attend_fused = k3_fn

    # K1, the fused K4 and K3 at every shape this phase sent them
    g = make_generator(dev, SEED + 13)
    k1_err = k4_err = k3_err = 0.0
    k3_shapes = sorted({(b, t, mb, hs, dt) for b, t, mb, hs, dt in k3_sent | k3_sent_c},
                       key=str)
    print(f"shapes phase 7 sent: K1 {sorted(k1_sent)}; fused K4 {sorted(k4_sent)}; K3 "
          f"(b, t, table, (h, kh, hd), dtype) {len(k3_shapes)}")
    for b, n, dim, bits in sorted(k1_sent):
        k1_err = max(k1_err, check_k1(g, b, n, dim, bits, "phase 7 shape"))
    for rows, n, k, n_cores in sorted(k4_sent):
        s_rand = torch.randn((rows, n), generator=g, device=dev)
        k4_err = max(k4_err, check_fused(s_rand, k, f"phase 7 shape (rows {rows}, n {n}, "
                                                    f"k {k})"))
    for b, t, mb, (h, kh, hd), dtype in k3_shapes:
        cap = mb * BS - t
        lengths = torch.randint(0, cap + 1, (b,), generator=g, device=dev).tolist()
        n_valid = [t if t == 1 else int(x) for x in
                   torch.randint(1, t + 1, (b,), generator=g, device=dev).tolist()]
        c = k3_case(dev, g, dtype, lengths=lengths, n_valid=n_valid, t=t, mb=mb,
                    heads=(h, kh, hd))
        k3_err = max(k3_err, hold_k3(c, f"phase 7 shape (b {b}, t {t}, table {mb}, "
                                        f"g {h // kh} = {h}/{kh})"))
    groups = {h // kh for _, _, _, (h, kh, _), _ in k3_shapes}
    check({4, 8, 12, 48} <= groups, f"phase 7 sent K3 head groups {sorted(groups)}")
    # K3 timed at the decode shape of granite's MQA and of phi3.5-moe
    mb_main = blocks_for(MAX_PROMPT + NEW_TOKENS, BS)
    ctx = torch.randint(270, 305, (MAIN_B,), generator=g, device=dev).tolist()
    for key, heads in (("g48_mqa_decode", (48, 1, 128)), ("g4_moe_decode", (32, 8, 128))):
        c = k3_case(dev, g, torch.bfloat16, lengths=ctx, n_valid=[1] * MAIN_B, t=1,
                    mb=mb_main, heads=heads)
        res = time_k3(c, f"{key.replace('_', ' ')} shape (b {MAIN_B}, {heads[0]}/{heads[1]} "
                         f"heads of {heads[2]}, contexts {min(ctx)}-{max(ctx)}, bf16)")
        out[key] = res
        k3_err = max(k3_err, res["max_abs_err"])
    out["max_abs_err"] = {"dirc_mac": k1_err, "topk_select": k4_err,
                          "paged_attend_fused": k3_err}
    return out


# ------------------------------------------------------------------ phase 8
SSM_ARCH, HYBRID_ARCH, AUDIO_ARCH = "mamba2-2.7b", "zamba2-2.7b", "whisper-small"
SSM_DOCS = WAVE_DOCS[:4]      # (a) query_stream: 4 requests, 4 distinct contexts
SLOT_CFG = EngineConfig(n_slots=4, paged=True, prefill_chunk=32)   # slot-resident
SSM_PROBE_B = 8               # sequences of the decode-step probes
SSM_LAYERS = 32               # (a) mamba2's depth, of 64: each prompt token runs all of it
PARITY_LAYERS = {SSM_ARCH: 4, HYBRID_ARCH: 4, AUDIO_ARCH: 2}   # (d), fp32


def decode_probe(model, label: str, bound: tuple[float, float], ctx: int) -> dict:
    """Outside the timed path: `decode_step` at b 8 once the caches hold
    `ctx` tokens — the median wall of 5 steps (after a warm-up), one
    profiled step (device busy share, launches), against `bound` = (bytes,
    FLOPs) of the step. `ctx` 0 for a model whose state has one size at
    any context (a pure SSM): the step costs the same, so nothing is
    filled."""
    from torch.profiler import ProfilerActivity, profile

    g = make_generator(model.device, SEED + 15)
    caches = model.init_caches(SSM_PROBE_B, ctx + 16, 0)
    tok = torch.randint(0, model.cfg.vocab_size, (SSM_PROBE_B, 1), generator=g,
                        device=model.device)
    for _ in range(ctx + 1):   # fill the context, then one warm-up step
        logits, caches = model.decode_step(caches, tok)
    sync()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        logits, caches = model.decode_step(caches, tok)
        sync()
        walls.append((time.perf_counter() - t0) * 1e3)
    step_ms = statistics.median(walls)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        logits, caches = model.decode_step(caches, tok)
        sync()
    dev_ms, launches = _busy(prof.key_averages())
    check(bool(torch.isfinite(logits[:, :model.cfg.vocab_size]).all()),
          f"{label} probe: non-finite logits")
    b_ms, b_by = bound_ms(bound[0], bound[1], BF16_FLOP_PER_S)
    print(f"{label} decode step (b {SSM_PROBE_B}, context {ctx}), median of 5: "
          f"{step_ms:.2f} ms ({' / '.join(f'{w:.2f}' for w in walls)}); bound {b_ms:.3f} "
          f"ms by {b_by} ({bound[0] / 1e9:.2f} GB, {bound[1] / 1e9:.1f} GFLOP); profiled "
          f"step: device busy {dev_ms:.2f} ms ({dev_ms / step_ms:.1%} of the median "
          f"wall), {launches} kernel launches")
    return dict(step_ms=step_ms, bound_ms=b_ms, dev_ms=dev_ms, launches=launches,
                busy=dev_ms / step_ms)


def mamba_state_bytes(cfg, b: int) -> int:
    """One step's SSM and conv state of every Mamba2 layer, read once and
    written once."""
    s = cfg.ssm
    di, h = s.d_inner(cfg.d_model), s.n_heads(cfg.d_model)
    ssm = b * h * s.head_dim * s.state_dim * 4
    conv = b * (s.conv_width - 1) * (di + 2 * s.n_groups * s.state_dim) * 2
    return 2 * cfg.n_layers * (ssm + conv)


def step_flops(model, b: int) -> float:
    """2 x the parameters a decode step multiplies by, per sequence."""
    return 2.0 * b * sum(p.numel() for p in model.parameters())


def hold_forward_decode(model, label: str, frames=None) -> float:
    """fp32: the whole-sequence forward's logits against the same tokens
    streamed through `decode_step` (for the encoder-decoder, with the
    encoded frames' cross K/V); returns the max |err| relative to the
    largest logit, which must stay under 1e-4."""
    cfg, dev = model.cfg, model.device
    g = make_generator(dev, SEED + 16)
    toks = torch.randint(0, cfg.vocab_size, (2, 32), generator=g, device=dev)
    V = cfg.vocab_size
    if frames is None:
        full = model.forward(toks)
        caches = model.init_caches(2, 32, 0)
    else:
        full = model.forward(toks, frames)
        k, v = model.precompute_cross(model.encode(frames))
        caches = model.init_caches(2, 32, 0)._replace(cross_k=k, cross_v=v)
    steps = []
    for t in range(32):
        logits, caches = model.decode_step(caches, toks[:, t:t + 1])
        steps.append(logits)
    got = torch.stack(steps, dim=1)[..., :V]
    want = full[..., :V]
    err = float((got - want).abs().max() / want.abs().max())
    check(err < 1e-4, f"{label}: forward vs streamed decode, rel err {err}")
    return err


def engines_agree(model, label: str) -> None:
    """fp32: greedy tokens identical across `GenerationEngine` (one prompt
    at a time), the fixed-slot engine and the slot-resident paged engine
    (2 slots each, so admission staggers; prompts of 12 / 20 / 7 / 16)."""
    dev = model.device
    g = make_generator(dev, SEED + 17)
    prompts = [torch.randint(0, model.cfg.vocab_size, (n,), generator=g, device=dev)
               for n in (12, 20, 7, 16)]
    gen = GenerationEngine(model, device=dev)
    want = [gen.generate(p[None], NEW_TOKENS, cache_len=32)[0].tolist() for p in prompts]
    for name, ecfg in (("fixed-slot", EngineConfig(n_slots=2, cache_len=32)),
                       ("slot-resident", EngineConfig(n_slots=2, cache_len=32, paged=True,
                                                      prefill_chunk=8))):
        eng = ContinuousBatchingEngine(model, ecfg, device=dev)
        ts = [eng.submit(p.tolist(), max_new_tokens=NEW_TOKENS) for p in prompts]
        eng.run_until_drained()
        got = [t.result().tolist() for t in ts]
        check(got == want, f"{label}: {name} engine tokens {got[:2]} != generate's {want[:2]}")


def phase_ssm(dev, main: dict) -> dict:
    """The ssm, hybrid and audio families at their published widths and
    full depth, mamba2 cut to `SSM_LAYERS`. (a) mamba2-2.7b over phase
    5's 4-macro `kernel_bitserial`
    index: `query_many` and `query_stream` through the slot-resident
    engine (the main path), then the b-8 decode-step probe; (b)
    zamba2-2.7b: `GenerationEngine.generate` at b 4, the slot-resident
    engine over 4 requests, the probe; (c) whisper-small: encode 1500
    frames -> precompute_cross -> 8 decode steps, the encoder against its
    FLOP bound, the engines (zero cross K/V); (d) each cut to 4 layers
    (whisper 2) in fp32: forward against streamed decode, and the three
    engines token-identical. Then K1 and the fused K4 held at every shape
    the phase sent."""
    corpus = main["corpus"]
    free_card()
    out = {}
    cfg = dataclasses.replace(get_config(SSM_ARCH), n_layers=SSM_LAYERS)
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev).init(make_generator(dev, SEED + 14))
    sync()
    print(f"phase 8 model {cfg.name}: published widths, {cfg.n_layers} of "
          f"{get_config(SSM_ARCH).n_layers} layers ("
          f"d_model {cfg.d_model}, d_inner {cfg.ssm.d_inner(cfg.d_model)}, "
          f"{cfg.ssm.n_heads(cfg.d_model)} SSM heads of {cfg.ssm.head_dim}, state "
          f"{cfg.ssm.state_dim}, vocab {cfg.vocab_size}); bf16, random weights; "
          f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B params, "
          f"{param_bytes(model) / 1e9:.2f} GB; init {time.perf_counter() - t0:.2f} s")
    pipe = RagPipeline(corpus, RetrievalConfig(bits=8, metric="cosine",
                                               path="kernel_bitserial"),
                       model=model, embedder=CorpusEmbedder(main["embedder"], corpus,
                                                            main["embs"]),
                       dim=DIM, n_shards=N_SHARDS, max_prompt_len=GEN_PROMPT, device=dev)
    k4_sent, k4_fn = _recording(topk_select, "hierarchical_select",
                                lambda s_, k, n_cores: (*s_.shape, k, n_cores))
    k1_sent, k1_fn = _recording(dirc_mac, "dirc_mac_packed",
                                lambda qp, dp, bits=8: (qp.shape[0], dp.shape[2],
                                                        32 * qp.shape[2], bits))
    made = []
    decode_engine = pipe.decode_engine

    def capturing(*a, **kw):
        made.append(decode_engine(*a, **kw))
        return made[-1]

    pipe.decode_engine = capturing
    try:
        # ---- (a) the main path: query_many, then query_stream, slot-resident
        # the stream's reference ids, searched before the counts are reset
        reqs = [("tenant-a", corpus[d]) for d in SSM_DOCS]
        texts = [r[1] for r in reqs]
        want_ids, _ = pipe.search_batch(texts, K)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        results = pipe.query_many(main["queries"], k=K, max_new_tokens=NEW_TOKENS)
        sync()
        wall_many = time.perf_counter() - t0
        ids = np.stack([r.doc_ids for r in results])
        check((ids[:, 0] == np.asarray(main["own"])).all(), f"(a) self-retrieval {ids[:, 0]}")
        for r in results:
            check(r.answer_tokens.shape == (1, NEW_TOKENS) and bool(
                ((r.answer_tokens >= 0) & (r.answer_tokens < cfg.vocab_size)).all()),
                "(a) query_many answer")
        t0 = time.perf_counter()
        items = list(pipe.query_stream(reqs, k=K, generate=True, max_new_tokens=NEW_TOKENS,
                                       config=SLOT_CFG))
        sync()
        wall_stream = time.perf_counter() - t0
        la = counters.read()
    finally:
        topk_select.hierarchical_select = k4_fn
        dirc_mac.dirc_mac_packed = k1_fn
    check(len(items) == len(reqs), f"(a) stream yielded {len(items)}")
    for it in items:
        check(isinstance(it, GenerationTicket) and it._error is None,
              f"(a) stream item failed: {type(it).__name__} {getattr(it, '_error', None)!r}")
        check(len(it.tokens) == NEW_TOKENS
              and all(0 <= tk < cfg.vocab_size for tk in it.tokens), "(a) stream tokens")
        check(np.array_equal(it.retrieval.doc_ids, want_ids[texts.index(it.text)]),
              "(a) stream ids differ from search_batch's")
    eng = made[-1]
    st = eng.stats()
    prompts = [pipe.encode_prompt_with_prefix(text, [corpus[i] for i in ids_ if i >= 0])[0]
               for text, ids_ in zip(texts, want_ids)]
    chunks = sum(-(-len(p) // SLOT_CFG.prefill_chunk) for p in prompts)
    check(eng._pcm is None and not eng.prefix_sharing and "pool" not in st
          and st["n_prefill_chunks"] == chunks,
          f"(a) not the slot-resident engine: {st}")
    check(la["dirc_mac"] > 0 and la["topk_select"] == la["dirc_mac"]
          and la["paged_attend_fused"] == 0,
          f"(a) K1 / K4 / K3 launches {la['dirc_mac']} / {la['topk_select']} / "
          f"{la['paged_attend_fused']}")
    out["launches"] = {n: la[n] for n in ("dirc_mac", "topk_select")}
    ttft = [it.first_token_s * 1e3 for it in items]
    e2e = [it.wait_s * 1e3 for it in items]
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"(a) query_many (8 queries, k {K}, {NEW_TOKENS} new tokens, prompts <= "
          f"{GEN_PROMPT}): {wall_many:.3f} s; query_stream ({len(reqs)} requests, prompts "
          f"{[len(p) for p in prompts]} tokens, slot-resident {SLOT_CFG.n_slots} slots, "
          f"prefill_chunk {SLOT_CFG.prefill_chunk}): wall {wall_stream:.3f} s; TTFT median "
          f"{statistics.median(ttft):.1f} ms, max {max(ttft):.1f} ms; e2e median "
          f"{statistics.median(e2e):.1f} ms, max {max(e2e):.1f} ms; {st['n_decode_steps']} "
          f"decode steps, {st['n_prefill_chunks']} prefill chunks; launches K1 "
          f"{la['dirc_mac']}, fused K4 {la['topk_select']}, K3 0; peak device memory "
          f"{peak:.2f} GiB")
    probe = decode_probe(model, "(a) mamba2", (param_bytes(model)
                                               + mamba_state_bytes(cfg, SSM_PROBE_B),
                                               step_flops(model, SSM_PROBE_B)), 0)
    out.update(many_wall_s=wall_many, stream_wall_s=wall_stream, ttft_ms=ttft, peak_gib=peak,
               mamba_probe=probe)
    del pipe, model, results, items, eng, made
    free_card()

    # ---- (b) zamba2-2.7b, full depth
    t0 = time.perf_counter()
    cfg_h = get_config(HYBRID_ARCH)
    model = build_model(cfg_h, device=dev).init(make_generator(dev, SEED + 18))
    g = make_generator(dev, SEED + 19)
    prompts_h = torch.randint(0, cfg_h.vocab_size, (4, 16), generator=g, device=dev)
    toks = GenerationEngine(model, device=dev).generate(prompts_h, NEW_TOKENS)
    check(toks.shape == (4, NEW_TOKENS) and bool(((toks >= 0) & (toks < cfg_h.vocab_size))
                                                 .all()), "(b) generate tokens")
    eng = ContinuousBatchingEngine(model, SLOT_CFG.replace(cache_len=64), device=dev)
    ts = [eng.submit(torch.randint(0, cfg_h.vocab_size, (n,), generator=g, device=dev)
                     .tolist(), max_new_tokens=NEW_TOKENS) for n in (12, 20, 7, 16)]
    eng.run_until_drained()
    check(all(len(t_.result()) == NEW_TOKENS for t_ in ts), "(b) slot-resident tokens")
    # the shared block's weights are read at each of its n_apps applications
    shared = sum(p.numel() for p in model.shared.parameters())
    ctx = 32
    kv = (model.n_apps * SSM_PROBE_B * ctx * cfg_h.n_kv_heads * cfg_h.resolved_head_dim
          * 2 * 2)
    probe_h = decode_probe(model, "(b) zamba2", (
        param_bytes(model) + (model.n_apps - 1) * shared * 2
        + mamba_state_bytes(cfg_h, SSM_PROBE_B) + kv,
        step_flops(model, SSM_PROBE_B) + 2.0 * SSM_PROBE_B * (model.n_apps - 1) * shared),
        ctx)
    print(f"(b) {cfg_h.name}: published widths and depth ({cfg_h.n_layers} Mamba2 layers, "
          f"state {cfg_h.ssm.state_dim}, one shared block of {shared * 2 / 1e9:.3f} GB applied "
          f"{model.n_apps} times, {cfg_h.n_heads} heads of {cfg_h.resolved_head_dim}); "
          f"{param_bytes(model) / 1e9:.2f} GB bf16; generate (b 4, prompt 16, "
          f"{NEW_TOKENS} new) and the slot-resident engine over 4 requests: tokens "
          f"well-formed; {time.perf_counter() - t0:.1f} s")
    out["zamba_probe"] = probe_h
    del model, eng, ts
    free_card()

    # ---- (c) whisper-small, full
    t0 = time.perf_counter()
    cfg_a = get_config(AUDIO_ARCH)
    e = cfg_a.encoder
    model = build_model(cfg_a, device=dev).init(make_generator(dev, SEED + 20))
    g = make_generator(dev, SEED + 21)
    frames = torch.randn((4, e.n_frames, e.d_model), generator=g, device=dev)
    model.encode(frames)   # warm
    sync()
    enc_ms = statistics.median(_wall(lambda: model.encode(frames)) * 1e3 for _ in range(3))
    enc_out = model.encode(frames)
    cross_k, cross_v = model.precompute_cross(enc_out)
    caches = model.init_caches(4, 16, 0)._replace(cross_k=cross_k, cross_v=cross_v)
    tok = torch.randint(0, cfg_a.vocab_size, (4, 1), generator=g, device=dev)
    for _ in range(NEW_TOKENS):
        logits, caches = model.decode_step(caches, tok)
        check(bool(torch.isfinite(logits[:, :cfg_a.vocab_size]).all()),
              "(c) whisper decode: non-finite logits")
        tok = torch.argmax(logits, dim=-1)[:, None]
    d, f, F_ = e.d_model, e.d_ff, e.n_frames
    enc_flops = e.n_layers * 4 * (8 * F_ * d * d + 4 * F_ * F_ * d + 4 * F_ * d * f)
    enc_bytes = (sum(p.numel() * p.element_size() for p in model.encoder.parameters())
                 + frames.numel() * 4 + enc_out.numel() * enc_out.element_size())
    enc_bound, enc_by = bound_ms(enc_bytes, enc_flops, BF16_FLOP_PER_S)
    prompts_a = torch.randint(0, cfg_a.vocab_size, (4, 16), generator=g, device=dev)
    toks = GenerationEngine(model, device=dev).generate(prompts_a, NEW_TOKENS)
    eng = ContinuousBatchingEngine(model, SLOT_CFG.replace(cache_len=32), device=dev)
    ts = [eng.submit(p.tolist(), max_new_tokens=NEW_TOKENS) for p in prompts_a]
    eng.run_until_drained()
    check(toks.shape == (4, NEW_TOKENS) and all(len(t_.result()) == NEW_TOKENS for t_ in ts),
          "(c) whisper engines' tokens")
    print(f"(c) {cfg_a.name}: published widths ({e.n_layers} + {cfg_a.n_layers} layers, d "
          f"{cfg_a.d_model}, {e.n_frames} frames); {param_bytes(model) / 1e9:.2f} GB bf16; "
          f"encode (b 4, {F_} frames) median of 3: {enc_ms:.2f} ms, bound {enc_bound:.3f} "
          f"ms by {enc_by} ({enc_flops / 1e12:.2f} TFLOP): {enc_bound / enc_ms:.1%}; "
          f"precompute_cross and {NEW_TOKENS} decode steps (b 4): logits finite; generate "
          f"and the slot-resident engine (zero cross K/V, as the reference serves it): "
          f"tokens well-formed; {time.perf_counter() - t0:.1f} s")
    out.update(encode_ms=enc_ms, encode_bound_ms=enc_bound)
    del model, eng, ts, caches, enc_out, cross_k, cross_v
    free_card()

    # ---- (d) fp32 at full width, cut in depth
    for arch, n_layers in PARITY_LAYERS.items():
        t0 = time.perf_counter()
        full = get_config(arch)
        cfg_d = dataclasses.replace(full, n_layers=n_layers, param_dtype="float32",
                                    compute_dtype="float32")
        if cfg_d.encoder is not None:
            cfg_d = dataclasses.replace(cfg_d, encoder=dataclasses.replace(
                cfg_d.encoder, n_layers=n_layers))
        if cfg_d.hybrid_attn_every:
            cfg_d = dataclasses.replace(cfg_d, hybrid_attn_every=2)
        m = build_model(cfg_d, device=dev).init(make_generator(dev, SEED + 22))
        frames = None
        if cfg_d.encoder is not None:
            frames = torch.randn((2, cfg_d.encoder.n_frames, cfg_d.encoder.d_model),
                                 generator=make_generator(dev, SEED + 23), device=dev)
        err = hold_forward_decode(m, f"(d) {arch}", frames)
        engines_agree(m, f"(d) {arch}")
        print(f"(d) {arch} at full width, {n_layers} layers (hybrid: shared block every 2; "
              f"audio: {n_layers} + {n_layers}), fp32: forward vs streamed "
              f"decode max rel err {err:.2e}; generate, fixed-slot and slot-resident "
              f"engines token-identical on 4 prompts; {time.perf_counter() - t0:.1f} s")
        del m
        free_card()

    # K1 and the fused K4 at every shape this phase sent them
    g = make_generator(dev, SEED + 24)
    k1_err = k4_err = 0.0
    print(f"shapes phase 8 sent: K1 {sorted(k1_sent)}; fused K4 {sorted(k4_sent)}")
    for b, n, dim, bits in sorted(k1_sent):
        k1_err = max(k1_err, check_k1(g, b, n, dim, bits, "phase 8 shape"))
    for rows, n, k, n_cores in sorted(k4_sent):
        s_rand = torch.randn((rows, n), generator=g, device=dev)
        k4_err = max(k4_err, check_fused(s_rand, k, f"phase 8 shape (rows {rows}, n {n}, "
                                                    f"k {k})"))
    out["max_abs_err"] = {"dirc_mac": k1_err, "topk_select": k4_err}
    return out


# ------------------------------------------------------------ phase 9: training
TRAIN_ARCH = "phi4-mini-3.8b"
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_LR = 4, 512, 8, 1e-3
RESUME_ARCH = "mamba2-2.7b"


def train_flops(model, b: int, s: int) -> float:
    """FLOP of one fwd + bwd under full remat: 8 N T for the N weights that
    enter a matmul (the tied head once; forward, its recompute, and the two
    backward products) plus the score and P.V products of attention, 4 b
    s^2 h hd a layer forward, also four times (the reference's chunks
    compute the causal mask's zeros too)."""
    cfg = model.cfg
    n_mm = sum(p.numel() for p in model.parameters() if p.ndim >= 2)
    attn = 4 * b * s * s * cfg.effective_n_heads * cfg.resolved_head_dim * cfg.n_layers
    return 8 * n_mm * b * s + 4 * attn


def event_ms(fn) -> tuple[float, object]:
    """(device ms of one call of `fn` between CUDA events, its result)."""
    sync()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    sync()
    return start.elapsed_time(end), out


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|."""
    return float((got.float().cpu() - want.float().cpu()).abs().max()
                 / max(float(want.float().abs().max()), 1e-30))


class Preempted(Exception):
    pass


def preempted_train(train_mod, at: int, **kw) -> None:
    """A `train` run that a fault stops when it asks for step `at`'s batch."""
    batch_at = train_mod.DataPipeline.batch_at

    def preempting(self, step):
        if step == at:
            raise Preempted
        return batch_at(self, step)
    train_mod.DataPipeline.batch_at = preempting
    try:
        train_mod.train(**kw)
    except Preempted:
        pass
    finally:
        train_mod.DataPipeline.batch_at = batch_at


def resume_run(train_mod, ckpt_dir: str, dev) -> tuple[list, list]:
    """(12 steps straight through, the same run preempted at step 8 with
    checkpoints every 3 and resumed from step 6): their losses."""
    kw = dict(arch=RESUME_ARCH, smoke=True, steps=12, batch=4, seq=32, lr=5e-3,
              log_every=1000, device=dev)
    full = train_mod.train(**kw)["losses"]
    preempted_train(train_mod, 8, ckpt_dir=ckpt_dir, ckpt_every=3, **kw)
    resumed = train_mod.train(ckpt_dir=ckpt_dir, ckpt_every=100, **kw)["losses"]
    return full, resumed


def phase_train(dev) -> dict:
    """Training on the card. (a) phi4-mini-3.8b at its published widths and
    full depth through the public `launch.train.train(..., smoke=False)`
    (bf16 params, remat "full", fp32 AdamW, b 4 x s 512, 8 steps): per
    step loss, grad norm, wall, tokens/s and peak memory; then fwd + bwd
    and the optimizer step timed apart against their FLOP and bytes
    bounds. (b) 2 layers at the published widths in fp32: loss and every
    gradient on the card against the CPU, and the fused head loss against
    the explicit logits at the full vocab (fp32 and bf16). (c) mamba2 at
    smoke size: a run preempted and resumed from its checkpoint repeats
    the straight run's losses bit for bit under deterministic algorithms;
    a checkpoint written on the card restores on the CPU and back, bit
    for bit. (d) the 8-bit-moment AdamW on the card: the reference's
    quadratic trajectory, and its state's bytes per parameter."""
    import shutil
    import tempfile

    from repro_torch.checkpointing import checkpoint as ckpt
    from repro_torch.data import DataPipeline
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import layers
    from repro_torch.models.convert import jax_leaves
    from repro_torch.optim import adamw, quant_state

    free_card()
    print(f"phase 9: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated on entry")
    out = {}
    cpu = torch.device("cpu")

    # (a) phi4-mini at full width and depth through `launch.train.train`
    t0 = time.perf_counter()
    res = train_mod.train(TRAIN_ARCH, smoke=False, steps=TRAIN_STEPS, batch=TRAIN_B,
                          seq=TRAIN_S, lr=TRAIN_LR, log_every=1, seed=SEED)
    model, opt = res["model"], res["opt"]
    cfg = model.cfg
    tokens = TRAIN_B * TRAIN_S
    print(f"9a: {cfg.name} {cfg.n_layers} layers d {cfg.d_model} vocab {cfg.vocab_size} "
          f"{cfg.param_dtype} params, remat {cfg.remat}, fp32 AdamW, b {TRAIN_B} x s "
          f"{TRAIN_S}, {TRAIN_STEPS} steps, {param_bytes(model) / 1e9:.2f} GB of params")
    for i, (loss, gn, ms, peak) in enumerate(zip(res["losses"], res["grad_norms"],
                                                 res["step_ms"], res["peak_bytes"])):
        print(f"  step {i}: loss {loss:.4f} grad norm {gn:.4f} wall {ms:.1f} ms "
              f"{tokens / ms * 1e3:.0f} tokens/s max_memory_allocated {peak / 1e9:.2f} GB")
    losses = res["losses"]
    check(all(math.isfinite(x) for x in losses), f"9a: a loss is not finite: {losses}")
    check((losses[-1] + losses[-2]) / 2 < losses[0],
          f"9a: the last two losses do not average below the first: {losses}")
    batch = {k: torch.from_numpy(v).to(dev, torch.long) for k, v in DataPipeline(
        cfg.vocab_size, TRAIN_B, TRAIN_S, seed=SEED).batch_at(TRAIN_STEPS).items()}
    params = dict(model.named_parameters())
    fb = []
    for _ in range(3):
        ms, _ = event_ms(lambda: loss_and_grads(model, batch, params))
        fb.append(ms)
    _, grads = loss_and_grads(model, batch, params)
    ocfg = adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=5, total_steps=TRAIN_STEPS)
    decay = adamw.decay_mask(jax_leaves(cfg))
    upd = []
    for _ in range(3):
        ms, _ = event_ms(lambda: adamw.update(ocfg, grads, opt, params, decay))
        upd.append(ms)
    n_all = sum(p.numel() for p in model.parameters())
    fb_bound = train_flops(model, TRAIN_B, TRAIN_S) / BF16_FLOP_PER_S * 1e3
    opt_bytes = 28 * n_all   # grad bf16 in, master / mu / nu fp32 in and out, param bf16 out
    opt_bound = opt_bytes / HBM_BYTES_PER_S * 1e3
    step_ms = statistics.median(res["step_ms"][1:])
    out["train"] = dict(
        arch=cfg.name, layers=cfg.n_layers, batch=TRAIN_B, seq=TRAIN_S, steps=TRAIN_STEPS,
        losses=losses, grad_norms=res["grad_norms"], step_ms=res["step_ms"],
        step_ms_median=step_ms, tokens_per_s=tokens / step_ms * 1e3,
        peak_gb=max(res["peak_bytes"], default=0) / 1e9, fwd_bwd_ms=fb, fwd_bwd_bound_ms=fb_bound,
        train_flops=train_flops(model, TRAIN_B, TRAIN_S), opt_ms=upd,
        opt_bound_ms=opt_bound, opt_bytes=opt_bytes, params=n_all)
    print(f"9a: fwd+bwd {[round(x, 1) for x in fb]} ms against its FLOP bound "
          f"{fb_bound:.1f} ms ({train_flops(model, TRAIN_B, TRAIN_S):.3e} FLOP at bf16 "
          f"dense peak; {fb_bound / statistics.median(fb):.1%} of it); optimizer step "
          f"{[round(x, 1) for x in upd]} ms against its bytes bound {opt_bound:.1f} ms "
          f"({opt_bytes / 1e9:.1f} GB, {n_all / 1e9:.3f} B params); step wall median "
          f"{step_ms:.1f} ms, {tokens / step_ms * 1e3:.0f} tokens/s; peak "
          f"{out['train']['peak_gb']:.2f} GB; {time.perf_counter() - t0:.1f} s")
    del model, opt, res, grads, params, batch
    free_card()

    # (b) the card against the CPU at fp32, published widths, 2 layers
    t0 = time.perf_counter()
    cfg2 = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=2, param_dtype="float32",
                               compute_dtype="float32")
    m_cpu = build_model(cfg2, device=cpu).init(make_generator(cpu, SEED))
    m_gpu = build_model(cfg2, device=dev)
    m_gpu.load_state_dict(m_cpu.state_dict())
    b2 = DataPipeline(cfg2.vocab_size, 2, 64, seed=SEED + 1).batch_at(0)
    b2["labels"][0, :5] = -1
    lc, gc_ = loss_and_grads(m_cpu, {k: torch.from_numpy(v).long() for k, v in b2.items()},
                             dict(m_cpu.requires_grad_(True).named_parameters()))
    lg, gg = loss_and_grads(m_gpu, {k: torch.from_numpy(v).to(dev, torch.long)
                                    for k, v in b2.items()},
                            dict(m_gpu.requires_grad_(True).named_parameters()))
    loss_err = abs(float(lg) - float(lc)) / abs(float(lc))
    norm_c = float(adamw.global_norm(gc_.values()))
    norm_g = float(adamw.global_norm(gg.values()))
    grad_err = max(rel_err(gg[k], gc_[k]) for k in gc_)
    print(f"9b: fp32, 2 layers at published widths, b 2 x s 64: loss card {float(lg):.6f} "
          f"cpu {float(lc):.6f} (rel {loss_err:.2e}); grad norm card {norm_g:.6f} cpu "
          f"{norm_c:.6f}; worst gradient err {grad_err:.2e} of its largest magnitude over "
          f"{len(gc_)} tensors")
    check(loss_err <= 1e-5, f"9b: loss on the card differs from the CPU's by {loss_err:.2e}")
    check(abs(norm_g - norm_c) <= 1e-4 * norm_c, "9b: grad norm differs from the CPU's")
    check(grad_err <= 1e-4, f"9b: a gradient differs from the CPU's by {grad_err:.2e}")
    del m_cpu, gc_, gg
    # the fused head loss against the explicit logits at the full vocab
    g = make_generator(dev, SEED + 90)
    head_err = {}
    for dtype, tol in (("float32", 1e-5), ("bfloat16", 2e-2)):
        hc = dataclasses.replace(cfg2, compute_dtype=dtype)
        h0 = torch.randn((2, 64, hc.d_model), generator=g, device=dev)
        lab = torch.randint(0, hc.vocab_size, (2, 64), generator=g, device=dev)
        lab[1, :7] = -1

        def run(fused):
            e = m_gpu.embed.detach().clone().requires_grad_(True)
            h = h0.clone().requires_grad_(True)
            loss = (layers.lm_head_loss(hc, e, h, lab) if fused else
                    layers.cross_entropy_loss(layers.logits_from_hidden(hc, e, h), lab))
            return [loss.detach(), *torch.autograd.grad(loss, [h, e])]
        errs = [rel_err(a, b) for a, b in zip(run(True), run(False))]
        head_err[dtype] = errs
        print(f"9b: fused head loss vs explicit logits at vocab {hc.vocab_size} "
              f"(padded {hc.padded_vocab_size}), {dtype}: loss / dhidden / dembed rel err "
              f"{', '.join(f'{x:.2e}' for x in errs)} (limit {tol})")
        check(max(errs) <= tol, f"9b: fused head loss disagrees at {dtype}: {errs}")
    out["card_vs_cpu"] = dict(loss_err=loss_err, grad_err=grad_err, head_err=head_err)
    del m_gpu
    free_card()
    print(f"9b: {time.perf_counter() - t0:.1f} s")

    # (c) resume bit-exact on the card, and checkpoints across devices
    t0 = time.perf_counter()
    root = Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt"
    root.mkdir(parents=True, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=root)
    try:
        mode = "strict"
        torch.use_deterministic_algorithms(True)
        try:
            full, resumed = resume_run(train_mod, os.path.join(tmp, "det"), dev)
        except RuntimeError as e:   # an op with no deterministic implementation
            print(f"9c: deterministic algorithms refused an op: {e}")
            mode = "warn_only"
            torch.use_deterministic_algorithms(True, warn_only=True)
            shutil.rmtree(os.path.join(tmp, "det"), ignore_errors=True)
            full, resumed = resume_run(train_mod, os.path.join(tmp, "det"), dev)
        finally:
            torch.use_deterministic_algorithms(False)
        det_equal = resumed == full[6:]
        print(f"9c: {RESUME_ARCH} smoke, deterministic algorithms ({mode}): resumed losses "
              f"{'==' if det_equal else '!='} the straight run's steps 6-11: {resumed}")
        check(det_equal, f"9c: resume is not bit-exact under deterministic algorithms: "
                         f"{resumed} vs {full[6:]}")
        full_nd, resumed_nd = resume_run(train_mod, os.path.join(tmp, "nondet"), dev)
        nd_equal = resumed_nd == full_nd[6:]
        nd_diff = max(abs(a - b) for a, b in zip(resumed_nd, full_nd[6:]))
        print(f"9c: without deterministic algorithms the resumed losses are "
              f"{'bit-equal' if nd_equal else 'not bit-equal'} (max diff {nd_diff:.3e}); "
              f"straight runs equal across modes: {full_nd == full}")
        # a checkpoint written on the card, restored on the CPU and back
        path = os.path.join(tmp, "det", "ckpt_0000000006")
        m = build_model(get_config(RESUME_ARCH, smoke=True), device=dev)
        target = {"params": dict(m.named_parameters()),
                  "opt": adamw.init(dict(m.named_parameters()))}
        on_card = ckpt.restore(path, target)
        on_cpu = ckpt.restore(path, target, device="cpu")
        ckpt.save(os.path.join(tmp, "from_cpu"), on_cpu, step=6)
        back = ckpt.restore(os.path.join(tmp, "from_cpu"), target)
        leaves = list(zip(ckpt._items(on_card), ckpt._items(on_cpu), ckpt._items(back)))
        cross_ok = all(a.device.type == c.device.type == dev.type and b.device.type == "cpu"
                       and torch.equal(a.cpu(), b)
                       and torch.equal(a, c) for (_, a), (_, b), (_, c) in leaves)
        cpu_resumed = train_mod.train(RESUME_ARCH, smoke=True, steps=12, batch=4, seq=32,
                                      lr=5e-3, log_every=1000, device="cpu",
                                      ckpt_dir=os.path.join(tmp, "det"), ckpt_every=100)
        cpu_diff = max(abs(a - b) for a, b in zip(cpu_resumed["losses"], full[6:]))
        print(f"9c: checkpoint card -> CPU -> card over {len(leaves)} leaves bit-equal: "
              f"{cross_ok}; the CPU resumed from the card's step-6 checkpoint: losses "
              f"within {cpu_diff:.2e} of the card's (bf16 compute)")
        check(cross_ok, "9c: a checkpoint changed crossing devices")
        check(cpu_diff <= 5e-2, f"9c: the CPU's resumed losses are {cpu_diff} off")
        out["resume"] = dict(deterministic=mode, det_equal=det_equal, nondet_equal=nd_equal,
                             nondet_max_diff=nd_diff, cross_device=cross_ok,
                             cpu_resume_diff=cpu_diff)
        del m, target, on_card, on_cpu, back
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    free_card()
    print(f"9c: {time.perf_counter() - t0:.1f} s")

    # (d) the 8-bit-moment AdamW on the card
    t0 = time.perf_counter()
    target = torch.tensor([1.0, -2.0, 3.0, 0.5] * 64, device=dev)
    ocfg = adamw.AdamWConfig(lr=0.05, warmup_steps=5, total_steps=300, weight_decay=0.0)
    p_ref, p_q = {"w": torch.zeros(256, device=dev)}, {"w": torch.zeros(256, device=dev)}
    s_ref, s_q = adamw.init(p_ref), quant_state.init(p_q)
    for _ in range(200):
        p_ref, s_ref, _ = adamw.update(ocfg, {"w": 2 * (p_ref["w"] - target)}, s_ref, p_ref)
        p_q, s_q, _ = quant_state.update(ocfg, {"w": 2 * (p_q["w"] - target)}, s_q, p_q)
    l_ref = float(((p_ref["w"] - target) ** 2).sum())
    l_q = float(((p_q["w"] - target) ** 2).sum())
    n = 3 * 2**20 + 77
    st = quant_state.init({"w": torch.zeros(n, dtype=torch.bfloat16, device=dev)})
    state_bytes = sum(t.numel() * t.element_size()
                      for _, t in ckpt._items((st.master, st.mu, st.nu)))
    bpp = state_bytes / n
    print(f"9d: Adam8 on the card: quadratic loss {l_q:.3e} (fp32 AdamW {l_ref:.3e}); "
          f"state {bpp:.4f} bytes/param measured over {n} params against "
          f"state_bytes_per_param() = {quant_state.state_bytes_per_param():.4f}; "
          f"{time.perf_counter() - t0:.1f} s")
    check(l_q < 1e-2 and abs(l_q - l_ref) < 5e-3, f"9d: Adam8 trajectory {l_q} vs {l_ref}")
    check(abs(bpp - quant_state.state_bytes_per_param()) < 1e-3, f"9d: {bpp} bytes/param")
    out["adam8"] = dict(loss=l_q, loss_fp32=l_ref, bytes_per_param=bpp)
    print("9 summary: " + json.dumps(out))
    return out


# ----------------------------------------------------------------- phase 10
TRAIN10_LAYERS = 32    # phi4-mini at published widths and full depth
CARD = ""              # nvidia-smi's name and power limit, set by main()


def flat_topk_cpu(q: torch.Tensor, docs: torch.Tensor, norms: torch.Tensor, k: int,
                  metric: str) -> topk.TopK:
    """The single-device flat top-k of the reference's check, on the CPU by
    the plain versions: K2's exact int32 dot, the cosine epilogue with an
    fp32 query norm, a stable sort in `lax.top_k`'s order."""
    q, docs, norms = q.cpu(), docs.cpu(), norms.cpu()
    ip = ops.score_matmul(q, docs).float()
    if metric == "cosine":
        qn = torch.sqrt(torch.sum(q.float() ** 2, dim=-1, keepdim=True))
        ip = ip / torch.clamp_min(qn * norms.float()[None, :], 1e-12)
    return topk.local_topk(ip, k)


def phase_scale_out(dev, main: dict) -> dict:
    """Scale-out on a world-size-1 NCCL group: (a) the flat-index searcher
    (`make_distributed_searcher` over `shard_index_arrays` on the macro
    mesh) at the paper's 4 MB, 8192 docs x dim 512 INT8, over phase 2's 8
    queries, cosine and MIPS, bit-equal to the single-device flat top-k,
    timed beside a single-device `kernel_mxu` search; (b) phase 5's 4-macro
    index with `parallelism="shard_map"` on the macro mesh, paths
    `int_exact` (the all-gather route) and `kernel_bitserial` (the vmap
    route), bit-equal to `parallelism="vmap"`; (c) `launch.train.train`
    under the mesh (`make_local_mesh(1)`, DTensor ZeRO-1 state) at
    phi4-mini's published widths and TRAIN10_LAYERS layers, 2 steps,
    losses and grad norms bit-equal to the mesh-less driver's at the same
    depth, both under deterministic algorithms; (d) `compressed_psum` on
    the card against its arithmetic on the CPU, bit for bit. The main
    paths are (a)'s searches (K2 and K4 counted) and (b)'s `shard_map`
    searches (K1 and K4 counted, each with the counts set to 0 just
    before it; the `vmap` search it is held against runs before that).
    K2 and the fused K4 are held against their plain versions at every
    shape (a) sent them."""
    import tempfile

    from repro_torch.core import quantization
    from repro_torch.core.sharded_index import (make_distributed_searcher,
                                                shard_index_arrays)
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.optim import grad_compression

    free_card()
    out = {"launches": {}, "max_abs_err": {}}
    embs, own = main["embs"], main["own"]
    q_emb = embs[own]                                    # phase 2's 8 queries
    k10 = 8

    # (c0) the mesh-less driver first: no process group yet
    t0 = time.perf_counter()
    cfg10 = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=TRAIN10_LAYERS)
    get_cfg = train_mod.get_config
    train_mod.get_config = lambda arch, smoke=True: cfg10
    kw = dict(arch=TRAIN_ARCH, smoke=False, steps=2, batch=TRAIN_B, seq=TRAIN_S,
              lr=TRAIN_LR, log_every=100, seed=SEED)

    def run_train() -> dict:
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            res = train_mod.train(**kw)
        finally:
            torch.use_deterministic_algorithms(False)
        n = sum(p.numel() for p in res["model"].parameters())
        del res["model"], res["opt"]
        free_card()
        return dict(res, params=n)
    try:
        bare = run_train()
        store = tempfile.mktemp(dir=Path(__file__).resolve().parent / "build")
        with mesh_mod.distributed(0, 1, store_path=store, device=dev):
            print(f"10: NCCL group of world size {torch.distributed.get_world_size()} on "
                  f"{torch.cuda.get_device_name(0)} ({CARD}); every time and memory "
                  f"figure below is on that card; mesh-less training run "
                  f"{time.perf_counter() - t0:.1f} s")
            macro = mesh_mod.make_macro_mesh(device=dev)

            # (a) the flat-index searcher at 4 MB
            t0 = time.perf_counter()
            docs = quantization.quantize(torch.as_tensor(embs, device=dev), bits=8,
                                         per_row=True)
            codes, norms = docs.values, quantization.doc_int_norms(docs)
            qv = quantize_query(torch.as_tensor(q_emb, device=dev), bits=8).values
            d_sh, n_sh = shard_index_arrays(macro, codes, norms)
            sent, select = set(), topk_select.hierarchical_select

            def recording(scores, k, n_cores):
                sent.add((*scores.shape, k, n_cores))
                return select(scores, k, n_cores)
            topk_select.hierarchical_select = recording
            searchers = {m: make_distributed_searcher(macro, k10, metric=m)
                         for m in ("cosine", "mips")}
            reset_launches()
            got = {m: fn(qv, d_sh, n_sh) for m, fn in searchers.items()}
            sync()
            n_k2, n_k4 = launch_count("score_matmul_int"), launch_count("topk_select")
            topk_select.hierarchical_select = select
            for m, res in got.items():
                want = flat_topk_cpu(qv, codes, norms, k10, m)
                check(torch.equal(res.indices.cpu(), want.indices)
                      and torch.equal(res.scores.cpu(), want.scores),
                      f"10a: the {m} searcher differs from the flat top-k")
            check((got["cosine"].indices[:, 0].cpu().numpy() == np.asarray(own)).all(),
                  "10a: a query does not retrieve its own document")
            check(n_k2 == 2 and n_k4 == 4, f"10a: launches K2 {n_k2}, K4 {n_k4} for 2 searches")
            out["launches"] = {"score_matmul_int": n_k2, "topk_select": n_k4}
            search_ms = time_ms(lambda: searchers["cosine"](qv, d_sh, n_sh), iters=20)
            wall_us = host_wall_us(lambda: searchers["cosine"](qv, d_sh, n_sh), reps=50)
            mxu = DircRagIndex.build(embs, RetrievalConfig(bits=8, metric="cosine",
                                                           path="kernel_mxu"), device=dev)
            mxu_ms = time_ms(lambda: mxu.search(q_emb, K), iters=20)
            mxu_us = host_wall_us(lambda: mxu.search(q_emb, K), reps=50)
            out["searcher"] = dict(ms=search_ms, wall_us=wall_us, mxu_ms=mxu_ms,
                                   mxu_wall_us=mxu_us)
            print(f"10a: flat searcher, {N_DOCS} docs x dim {DIM} INT8 "
                  f"({N_DOCS * DIM / 2**20:.0f} MiB) on a macro mesh of 1, k {k10}: ids and "
                  f"scores (cosine, MIPS) equal the single-device flat top-k; launches K2 "
                  f"{n_k2}, K4 {n_k4} (2 searches); a batch of {MAIN_B} queries "
                  f"{search_ms:.4f} ms device, {wall_us:.1f} us host wall a call; the "
                  f"single-device kernel_mxu DircRagIndex search (k {K}) {mxu_ms:.4f} ms "
                  f"device, {mxu_us:.1f} us host wall; {time.perf_counter() - t0:.1f} s")
            k2_err = 0
            k2 = score_matmul.score_matmul_int(qv, codes)
            check(torch.equal(k2, score_matmul.score_matmul_int_ref(qv.cpu(), codes.cpu())
                              .to(dev)), "10a: K2 differs from its plain version")
            g = make_generator(dev, SEED + 10)
            k4_err = 0
            print(f"10a: fused top-k shapes sent (rows, n, k, cores): {sorted(sent)}")
            for rows, n, k, n_cores in sorted(sent):
                s_rand = torch.randn((rows, n), generator=g, device=dev)
                k4_err = max(k4_err, check_fused(s_rand, k, f"phase 10 shape (rows {rows}, "
                                                            f"n {n}, k {k}, {n_cores} cores)",
                                                 n_cores))
            out["max_abs_err"] = {"score_matmul_int": k2_err, "topk_select": k4_err}
            del d_sh, n_sh, mxu

            # (b) the 4-macro index over the macro mesh
            t0 = time.perf_counter()
            q32 = embs[list(range(5, N_DOCS, N_DOCS // 32))]
            for path in ("int_exact", "kernel_bitserial"):
                cfg = RetrievalConfig(bits=8, metric="cosine", n_cores=N_CORES, path=path)
                vm = ShardedDircIndex.build(embs, cfg, n_shards=N_SHARDS, device=dev)
                sm = ShardedDircIndex.build(embs, cfg, n_shards=N_SHARDS,
                                            parallelism="shard_map", mesh=macro, device=dev)
                a = vm.search(q32, K)          # the comparison's reference: not counted
                sync()
                reset_launches()
                b = sm.search(q32, K)
                sync()
                n_k1, n_k4 = launch_count("dirc_mac"), launch_count("topk_select")
                route = "all-gather" if sm._macro_block() is not None else "vmap"
                check(route == ("vmap" if path == "kernel_bitserial" else "all-gather"),
                      f"10b: {path} took the {route} route")
                check(torch.equal(a.indices, b.indices) and torch.equal(a.scores, b.scores)
                      and torch.equal(vm.scores(q32), sm.scores(q32)),
                      f"10b: {path}: shard_map differs from vmap")
                check(n_k4 == 1, f"10b: K4 launches {n_k4} for 1 search")
                check(n_k1 == int(path == "kernel_bitserial"),
                      f"10b: K1 launches {n_k1} for 1 {path} search")
                for name, n in (("dirc_mac", n_k1), ("topk_select", n_k4)):
                    out["launches"][name] = out["launches"].get(name, 0) + n
                print(f"10b: {N_SHARDS} macros of {N_DOCS // N_SHARDS}, path {path}: "
                      f"shard_map ({route} route) == vmap over {len(q32)} queries, scores "
                      f"and ids bit-equal; the shard_map search's launches K1 {n_k1}, "
                      f"K4 {n_k4}")
            del vm, sm
            print(f"10b: {time.perf_counter() - t0:.1f} s")

            # (c) the training driver under the mesh
            t0 = time.perf_counter()
            meshed = run_train()
            same = (meshed["losses"] == bare["losses"]
                    and meshed["grad_norms"] == bare["grad_norms"])
            tokens = TRAIN_B * TRAIN_S
            for name, r in (("mesh-less", bare), ("mesh (1, 1)", meshed)):
                print(f"10c: {name}: losses {r['losses']} grad norms {r['grad_norms']} "
                      f"step walls {[round(x, 1) for x in r['step_ms']]} ms "
                      f"({tokens / r['step_ms'][-1] * 1e3:.0f} tokens/s at the last) "
                      f"peak {max(r['peak_bytes'], default=0) / 1e9:.2f} GB")
            print(f"10c: {TRAIN_ARCH} at published widths, {TRAIN10_LAYERS} of "
                  f"{get_cfg(TRAIN_ARCH, smoke=False).n_layers} layers ({bare['params'] / 1e9:.3f} "
                  f"B params), b {TRAIN_B} x s {TRAIN_S}, 2 steps, deterministic algorithms: "
                  f"the mesh run's losses and grad norms "
                  f"{'==' if same else '!='} the mesh-less run's; "
                  f"{time.perf_counter() - t0:.1f} s")
            check(same, "10c: train under the mesh differs from the mesh-less driver")
            out["train"] = dict(layers=TRAIN10_LAYERS, params=bare["params"],
                                losses=meshed["losses"], grad_norms=meshed["grad_norms"],
                                step_ms=meshed["step_ms"], bare_step_ms=bare["step_ms"],
                                peak_gb=max(meshed["peak_bytes"], default=0) / 1e9,
                                bare_peak_gb=max(bare["peak_bytes"], default=0) / 1e9)

            # (d) compressed_psum on the card against its CPU arithmetic
            g = make_generator(dev, SEED + 11)
            grads = {"w": torch.randn((3072, 8192), generator=g, device=dev).bfloat16(),
                     "b": torch.randn((8192,), generator=g, device=dev) * 1e-3}
            err = {k: torch.randn(v.shape, generator=g, device=dev) * 1e-4
                   for k, v in grads.items()}
            mean, new_err = grad_compression.compressed_psum(
                grads, err, mesh_mod.make_local_mesh(1, device=dev))
            ok = True
            for k in grads:
                g32 = grads[k].cpu().float() + err[k].cpu()
                q, scale = grad_compression._q(g32)
                local = q.float() * scale
                ok &= torch.equal(mean[k].cpu(), local / 1) and \
                    torch.equal(new_err[k].cpu(), g32 - local)
            print(f"10d: compressed_psum over a mesh of 1 on the card == its arithmetic on "
                  f"the CPU, bit for bit: {ok}")
            check(ok, "10d: compressed_psum on the card differs from the CPU")
    finally:
        train_mod.get_config = get_cfg
    print("10 summary: " + json.dumps(out))
    return out


STEPS_ARCH = "phi4-mini-3.8b"
# each cell's share of one of 16 data ranks (the production mesh's data
# axis): decode_32k's 128 sequences -> 8, prefill_32k's 32 -> 2
STEPS_DECODE = dataclasses.replace(DECODE_32K, global_batch=DECODE_32K.global_batch // 16)
STEPS_PREFILL = dataclasses.replace(PREFILL_32K, global_batch=PREFILL_32K.global_batch // 16)
# the prefill's attention tiling: phi4-mini's attn_chunk of 1024 is (32768 /
# 1024)^2 = 1024 chunk pairs a layer in the port's chunk loop; 2048 is 256
STEPS_PREFILL_CHUNK = 2048
STEPS_SSM_ARCH = "mamba2-2.7b"
STEPS_REPS = 5


def peak_gb() -> float:
    return torch.cuda.max_memory_allocated() / 1e9


def step_walls(fn, reps: int) -> list:
    """Host walls (ms) of `reps` calls of `fn`, each ended by a sync."""
    out = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def phase_steps(dev) -> dict:
    """The production inference steps (`launch.steps.build_cell`) on a
    world-size-1 NCCL group's (1, 1) mesh, seeded weights at published
    widths and full depth: (a) decode_32k's share of one data rank,
    phi4-mini-3.8b's serve step at b 8 against caches of capacity 32768
    at length 32767 (`cache_specs`; K/V filled with seeded normals), its
    token bit-equal to the mesh-less `decode_step` on the same caches, 5
    steps timed against the bytes bound (weights and KV read once, from
    `perf.roofline`), FLOPs counted by `FlopCounterMode` and the
    collective counter read over one step; (b) prefill_32k's share, the
    prefill step at b 2 x s 32768 (last-position head), its token
    bit-equal to the mesh-less forward's last-position argmax, timed
    against the FLOP bound `model_flops + attention_flops`; (c)
    long_500k for mamba2-2.7b at b 1 through the same `build_cell`, its
    token bit-equal to the mesh-less `decode_step`. Peaks after each. No
    kernel of K1-K5 lies on these steps (the reference's steps attend
    with plain jnp)."""
    import tempfile

    from repro_torch import spmd
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.steps import build_cell
    from repro_torch.perf import roofline

    free_card()
    out = {}
    store = tempfile.mktemp(dir=Path(__file__).resolve().parent / "build")
    with mesh_mod.distributed(0, 1, store_path=store, device=dev):
        mesh = mesh_mod.make_local_mesh(1, device=dev)
        print(f"11: NCCL group of world size {torch.distributed.get_world_size()}, mesh "
              f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}, on "
              f"{torch.cuda.get_device_name(0)} ({CARD}); every time and memory figure "
              f"below is on that card")

        # (a) the serve step at decode_32k's share
        t0 = time.perf_counter()
        cfg = get_config(STEPS_ARCH)
        shape = STEPS_DECODE
        torch.cuda.reset_peak_memory_stats()
        art = build_cell(cfg, mesh, shape, device=dev)
        art.model.init(make_generator(dev, SEED))
        caches = art.new_caches()
        g = make_generator(dev, SEED + 1)
        with torch.inference_mode():
            for i in range(cfg.n_layers):
                caches.k[i].normal_(generator=g)
                caches.v[i].normal_(generator=g)
        token = torch.randint(0, cfg.vocab_size, (shape.global_batch, 1), generator=g,
                              device=dev)
        batch = {"token": token}
        w_bytes = roofline.tensor_bytes(art.model)
        kv_bytes = roofline.tensor_bytes(caches.k, caches.v)
        # each call returns the caches it wrote in place: bind no name to
        # them (not even `_`), or the KV stays alive through (b) and (c)
        tok = art.fn(caches, batch)[0]
        bare = torch.argmax(art.model.decode_step(caches, token)[0],   # 32767 rewritten alike
                            dim=-1).to(torch.int32)
        sync()
        check(torch.equal(tok, bare), "11a: the serve step's tokens differ from decode_step")
        walls = step_walls(lambda: art.fn(caches, batch), STEPS_REPS)
        dev_ms = [event_ms(lambda: art.fn(caches, batch))[0] for _ in range(STEPS_REPS)]
        counted = roofline.analyze(lambda: art.fn(caches, batch), w_bytes + kv_bytes)[1]
        cell = roofline.CellAnalysis(counted["flops"], counted["bytes"],
                                     counted["collective_bytes"], counted["collectives"])
        analytic = (roofline.model_flops(cfg, shape) + roofline.attention_flops(cfg, shape))
        check(math.isfinite(cell.memory_s) and counted["flops"] > 0, "11a: no roofline terms")
        out["decode"] = dict(b=shape.global_batch, cache=shape.seq_len, step_ms=walls,
                             device_ms=dev_ms, bound_ms=cell.memory_s * 1e3,
                             weights_gb=w_bytes / 1e9, kv_gb=kv_bytes / 1e9,
                             flops=counted["flops"], analytic_flops=analytic,
                             compute_ms=cell.compute_s * 1e3, bottleneck=cell.bottleneck,
                             collectives=counted["collectives"], peak_gb=peak_gb())
        print(f"11a: {STEPS_ARCH} ({cfg.n_layers} layers, d {cfg.d_model}, bf16) serve step, "
              f"b {shape.global_batch} against caches of {shape.seq_len} at length "
              f"{shape.seq_len - 1}: tokens == decode_step's bit for bit; step walls "
              f"{[round(x, 2) for x in walls]} ms, device {[round(x, 2) for x in dev_ms]} "
              f"ms, against the bytes bound {cell.memory_s * 1e3:.2f} ms (weights "
              f"{w_bytes / 1e9:.2f} GB + KV {kv_bytes / 1e9:.2f} GB read once at "
              f"{roofline.HBM_BW / 1e12:.2f} TB/s; compute term {cell.compute_s * 1e3:.3f} "
              f"ms, bound by {cell.bottleneck}); FlopCounterMode {counted['flops']:.4e} "
              f"FLOP a step (model_flops + attention_flops {analytic:.4e}); collectives "
              f"{json.dumps(counted['collectives'])}; peak {peak_gb():.2f} GB; "
              f"{time.perf_counter() - t0:.1f} s")
        del caches, art, bare
        free_card()

        # (b) the prefill step at prefill_32k's share
        t0 = time.perf_counter()
        cfg_p = dataclasses.replace(cfg, attn_chunk=STEPS_PREFILL_CHUNK)
        shape = STEPS_PREFILL
        torch.cuda.reset_peak_memory_stats()
        art = build_cell(cfg_p, mesh, shape, device=dev)
        art.model.init(make_generator(dev, SEED))
        tokens = torch.randint(0, cfg.vocab_size, (shape.global_batch, shape.seq_len),
                               generator=g, device=dev)
        ms, tok = event_ms(lambda: art.fn({"tokens": tokens}))
        with torch.inference_mode():
            x = art.model.hidden_states(tokens)[0]
            bare = torch.argmax(art.model.head_logits(x[:, -1]), dim=-1).to(torch.int32)
        del x
        check(torch.equal(tok, bare), "11b: the prefill step's token differs from the "
                                      "mesh-less forward's")
        flops = roofline.model_flops(cfg, shape) + roofline.attention_flops(cfg, shape)
        bound = flops / roofline.PEAK_FLOPS * 1e3
        out["prefill"] = dict(b=shape.global_batch, s=shape.seq_len,
                              attn_chunk=STEPS_PREFILL_CHUNK, ms=ms, bound_ms=bound,
                              flops=flops, peak_gb=peak_gb())
        print(f"11b: {STEPS_ARCH} prefill step, b {shape.global_batch} x s {shape.seq_len} "
              f"(attn_chunk {STEPS_PREFILL_CHUNK}), head at the last position: token == the "
              f"mesh-less forward's bit for bit; {ms:.1f} ms against the FLOP bound "
              f"{bound:.1f} ms ((model_flops {roofline.model_flops(cfg, shape):.3e} + "
              f"attention_flops {roofline.attention_flops(cfg, shape):.3e}) / "
              f"{roofline.PEAK_FLOPS:.3g}); peak {peak_gb():.2f} GB; "
              f"{time.perf_counter() - t0:.1f} s")
        del art
        free_card()

        # (c) long_500k: one serve step of the SSM cell
        t0 = time.perf_counter()
        cfg = get_config(STEPS_SSM_ARCH)
        shape = LONG_500K
        torch.cuda.reset_peak_memory_stats()
        art = build_cell(cfg, mesh, shape, device=dev)
        art.model.init(make_generator(dev, SEED))
        caches = art.new_caches()
        token = torch.randint(0, cfg.vocab_size, (1, 1), generator=g, device=dev)
        with torch.inference_mode():
            state = [t.clone() for t in caches.mamba]
        tok = art.fn(caches, {"token": token})[0]
        with torch.inference_mode():
            for dst, src in zip(caches.mamba, state):
                dst.copy_(src)
        bare = torch.argmax(art.model.decode_step(caches, token)[0], dim=-1).to(torch.int32)
        check(torch.equal(tok, bare), "11c: the SSM serve step's token differs from "
                                      "decode_step's")
        walls = step_walls(lambda: art.fn(caches, {"token": token}), STEPS_REPS)
        st_bytes = roofline.tensor_bytes(art.model, list(caches.mamba))
        out["long"] = dict(arch=STEPS_SSM_ARCH, length=shape.seq_len - 1, step_ms=walls,
                           bound_ms=st_bytes / roofline.HBM_BW * 1e3, peak_gb=peak_gb())
        print(f"11c: {STEPS_SSM_ARCH} serve step at length {shape.seq_len - 1}, b 1: token "
              f"== decode_step's bit for bit; step walls {[round(x, 2) for x in walls]} ms "
              f"against the bytes bound {st_bytes / roofline.HBM_BW * 1e3:.3f} ms (weights and "
              f"state {st_bytes / 1e9:.3f} GB read once); peak {peak_gb():.2f} GB; "
              f"{time.perf_counter() - t0:.1f} s")
        del caches, art, state
        check(spmd.read_collectives()["total_bytes"] == 0, "11: a collective at world size 1")
    free_card()
    print("11 summary: " + json.dumps(out))
    return out


# ------------------------------- phase 12: tensor-parallel training, the dry run
TP_STEPS = 2
DRYRUN = ("import runpy, sys\n"
          "sys.modules['jax'] = None\n"          # the card's machine has no JAX
          "sys.argv = ['dryrun'] + sys.argv[1:]\n"
          "runpy.run_module('repro_torch.launch.dryrun', run_name='__main__')\n")


def run_dryrun() -> tuple:
    """`python -m repro_torch.launch.dryrun --mesh single` over every (arch
    x shape) cell, in a subprocess on the host's CPU (it runs on the meta
    device and needs no card) after the timed phases, with JAX blocked
    from import: (exit code, its lines, its records, its wall in s)."""
    import shutil

    out = Path(__file__).resolve().parent / "build" / "dryrun_torch_smoke"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(_SRC), CUDA_VISIBLE_DEVICES="")
    t0 = time.perf_counter()
    with open(out / "log.txt", "w") as log:
        rc = subprocess.run([sys.executable, "-c", DRYRUN, "--mesh", "single", "--out",
                             str(out / "records"), "--force"], cwd=out, env=env, stdout=log,
                            stderr=subprocess.STDOUT, timeout=600).returncode
    wall = time.perf_counter() - t0
    lines = (out / "log.txt").read_text().splitlines()
    recs = [json.loads(f.read_text()) for f in (out / "records").glob("*.json")]
    return rc, lines, recs, wall


def tp_train_cell(cfg, dev, tag: str) -> dict:
    """The train cell of `launch.steps.build_cell` (`train_model`'s model
    over a `make_local_mesh(1)` of its own world-size-1 NCCL group, ZeRO-1
    DTensor state) at `cfg`'s published widths, b 4 x s 512, `TP_STEPS`
    steps, against the mesh-less step from the same seeded init over the
    same batches, both under deterministic algorithms: losses and grad
    norms bit-equal; step walls, peak memory and the collectives of a
    step; then one more step under `perf.roofline.analyze` (FLOPs, bytes,
    temp peak)."""
    import tempfile

    from repro_torch import spmd
    from repro_torch.configs import ShapeConfig
    from repro_torch.data import DataPipeline
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.steps import build_cell, build_train_step, init_sharded
    from repro_torch.optim import adamw
    from repro_torch.perf import roofline

    free_card()
    ocfg = adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=5, total_steps=TP_STEPS)
    pipe = DataPipeline(cfg.vocab_size, batch=TRAIN_B, seq=TRAIN_S, seed=SEED)
    batches = [{k: torch.from_numpy(v).to(dev, torch.long) for k, v in pipe.batch_at(i).items()}
               for i in range(TP_STEPS)]

    def steps(model, step, opt) -> dict:
        res = {"loss": [], "grad_norm": [], "ms": [], "collectives": [], "gathers": []}
        torch.cuda.reset_peak_memory_stats()
        for b in batches:
            spmd.reset_collectives()
            sync()
            t0 = time.perf_counter()
            opt, m = step(model, opt, b)
            res["loss"].append(float(m["loss"]))
            res["ms"].append((time.perf_counter() - t0) * 1e3)
            res["grad_norm"].append(float(m["grad_norm"]))
            counts = spmd.read_collectives()
            res["collectives"].append(counts["total_bytes"])
            res["gathers"].append(counts["all-gather"]["count"])
        res["peak_gb"] = peak_gb()
        return res, opt

    # the mesh-less step first (no group), then the TP step; deterministic
    t0 = time.perf_counter()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        model = build_model(cfg, device=dev).init(make_generator(dev, SEED))
        model.requires_grad_(True)
        bare, opt = steps(model, build_train_step(cfg, ocfg, grad_accum=1),
                          adamw.init(dict(model.named_parameters())))
        del model, opt
        free_card()
        store = tempfile.mktemp(dir=Path(__file__).resolve().parent / "build")
        with mesh_mod.distributed(0, 1, store_path=store, device=dev):
            mesh = mesh_mod.make_local_mesh(1, device=dev)
            shape = ShapeConfig("train_4k", TRAIN_S, TRAIN_B, "train")
            art = build_cell(cfg, mesh, shape, device=dev)
            whole = build_model(cfg, device=dev).init(make_generator(dev, SEED))
            art.load_state_dict(whole.state_dict())
            del whole
            free_card()
            params = dict(art.model.named_parameters())
            step = build_train_step(cfg, ocfg, grad_accum=1, mesh=mesh)
            tp, opt = steps(art.model, step, init_sharded(params, cfg, mesh))
            counted = roofline.analyze(lambda: step(art.model, opt, batches[0]))[1]
            del art, opt, params
    finally:
        torch.use_deterministic_algorithms(False)
    free_card()
    same = tp["loss"] == bare["loss"] and tp["grad_norm"] == bare["grad_norm"]
    tokens = TRAIN_B * TRAIN_S
    for name, r in (("mesh-less", bare), ("TP (1, 1)", tp)):
        print(f"{tag}: {name}: losses {r['loss']} grad norms {r['grad_norm']} step walls "
              f"{[round(x, 1) for x in r['ms']]} ms ({tokens / r['ms'][-1] * 1e3:.0f} tokens/s "
              f"at the last) peak {r['peak_gb']:.2f} GB; collective bytes a step "
              f"{r['collectives']}")
    cell = roofline.CellAnalysis(counted["flops"], counted["bytes"],
                                 counted["collective_bytes"], counted["collectives"])
    print(f"{tag}: {cfg.name} ({cfg.n_layers} layers, {cfg.compute_dtype}) through "
          f"build_cell's train cell on a world-size-1 NCCL group ({CARD}), b {TRAIN_B} x s "
          f"{TRAIN_S}, {TP_STEPS} steps, deterministic algorithms: the TP step's losses and "
          f"grad norms {'==' if same else '!='} the mesh-less step's; one analysed step: "
          f"{counted['flops']:.4e} FLOP, {counted['bytes']:.4e} bytes (every op's inputs and "
          f"outputs), temp peak {counted['temp_bytes'] / 1e9:.2f} GB, terms compute "
          f"{cell.compute_s * 1e3:.1f} / memory {cell.memory_s * 1e3:.1f} ms (H100 bounds); "
          f"{time.perf_counter() - t0:.1f} s")
    check(same, f"{tag}: the TP train step differs from the mesh-less step")
    return dict(bare=bare, tp=tp, flops=counted["flops"], bytes=counted["bytes"],
                temp_gb=counted["temp_bytes"] / 1e9, compute_ms=cell.compute_s * 1e3,
                memory_ms=cell.memory_s * 1e3)


def phase_tp_train(dev) -> dict:
    """(a) The tensor-parallel train step through `launch.steps.build_cell`
    at phi4-mini-3.8b's published widths and full depth (32 layers, bf16
    params, remat "full", fp32 AdamW) against the mesh-less step
    (`tp_train_cell`). (c) The TP step at 2 layers on a fake 4-rank world
    on this card (collectives return at once): weights cut over `model`,
    and the backward with its recompute runs on autograd's device thread
    under the forward's mesh. (b), the dry run, runs after phase 14
    (`phase_dryrun`)."""
    from repro_torch.data import DataPipeline
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.steps import build_train_step, init_sharded, train_model
    from repro_torch.models import sharding
    from repro_torch.optim import adamw

    cfg = get_config(TRAIN_ARCH)
    out = {"train": tp_train_cell(cfg, dev, "12a")}

    # (c) a `model` axis of 4 on this one card: a fake 4-rank group (its
    # collectives return at once, so the numbers are not the step's) with
    # real tensors, where autograd runs the backward and each checkpointed
    # layer's recompute on its own device thread
    from torch.testing._internal.distributed.fake_pg import FakeStore

    ocfg = adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=5, total_steps=TP_STEPS)
    pipe = DataPipeline(cfg.vocab_size, batch=TRAIN_B, seq=TRAIN_S, seed=SEED)
    batch = {k: torch.from_numpy(v).to(dev, torch.long) for k, v in pipe.batch_at(0).items()}
    cfg_c = dataclasses.replace(cfg, n_layers=2)
    torch.distributed.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        mesh = mesh_mod.make_local_mesh(4, device=dev)
        # the seeded init drawn a part at a time into this rank's shards
        model, plan = train_model(cfg_c, mesh, dev, generator=make_generator(dev, SEED))
        step = build_train_step(cfg_c, ocfg, grad_accum=1, mesh=mesh)
        opt = init_sharded(dict(model.named_parameters()), cfg_c, mesh)
        _, m = step(model, opt, batch)
        loss = float(m["loss"])
        cut = sum(sharding.split_dim(p) is not None for p in model.parameters())
        del model, opt, step
    finally:
        torch.distributed.destroy_process_group()
    free_card()
    print(f"12c: {TRAIN_ARCH} at published widths, 2 layers, remat {cfg_c.remat}, on a fake "
          f"(1, 4) world on the card: {cut} weights cut over `model`, a TP step ran its "
          f"backward on autograd's device thread (loss {loss:.4f}, a fake group's value)")
    check(cut > 0 and math.isfinite(loss), "12c: the TP step on the card's fake world failed")
    print("12 summary: " + json.dumps(out))
    return out


def phase_dryrun() -> dict:
    """(12b) The dry run of every (arch x shape) cell on the 16 x 16 mesh,
    run last, nothing else running on the host (`run_dryrun`): every
    record `ok` or `skipped`, none an `error` (the MoE cells route the
    global batch over `data` 16); a line a cell and its wall."""
    rc, lines, recs, wall = run_dryrun()
    for line in lines:
        if line.startswith(("OK", "SKIP", "ERR", "done")):
            print(f"12b: {line}")
    check(rc == 0, f"12b: the dry run exited {rc}: {lines[-5:]}")
    check(len(recs) == 40, f"12b: {len(recs)} records, not 40")
    status = {}
    for r in recs:
        status[r["status"]] = status.get(r["status"], 0) + 1
        check(r["status"] in ("ok", "skipped"),
              f"12b: {r['arch']} {r['shape']}: {r['status']} {r.get('error', '')}")
    print(f"12b: dry run of {len(recs)} cells on the 16 x 16 fake world: {status}; its wall "
          f"{wall:.1f} s on the host, the card idle")
    return dict(status=status, wall_s=wall)


# ------- phase 13: tensor-parallel compute for the ssm, hybrid and audio families
def phase_tp_families(dev) -> dict:
    """Tensor-parallel compute for the ssm, hybrid and audio families. (a)
    At world size 1 on a one-rank NCCL group's (1, 1) mesh, published
    widths and full depth, seeded weights: zamba2-2.7b's and
    whisper-small's serve steps at decode_32k's share of one data rank (b
    8 against caches of 32768 at length 32767, every cache leaf seeded)
    and prefill steps at prefill_32k's (b 2 x s 32768, `attn_chunk`
    2048), through `build_cell`, tokens bit-equal to the mesh-less model
    on the same caches and inputs, walls and peaks; mamba2-2.7b's train
    cell, 2 steps against the mesh-less step (`tp_train_cell`). (b) Each
    family's cells at published widths, depth cut to one unit, on a fake
    (1, 4) world on this card (its collectives return at once: the values
    are not the model's): the serve, prefill and train cells each built
    with the seeded init streamed into their shards (T59) and run once,
    which proves the local shapes and the launches on the card. Numerics
    across ranks: the CPU tests and `tools/tp_steps_cards.py` /
    `tp_train_cards.py` across cards."""
    import tempfile

    from repro_torch import spmd
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.dryrun import _unit_layers
    from repro_torch.launch.steps import build_cell, init_sharded
    from repro_torch.models import sharding

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))
    from tp_steps_cards import prefill_batch   # the 4-card tool's inputs

    free_card()
    out = {}
    g = make_generator(dev, SEED + 13)
    h = torch.Generator().manual_seed(SEED + 14)     # the batches, drawn on the host
    spmd.reset_collectives()
    store = tempfile.mktemp(dir=Path(__file__).resolve().parent / "build")
    with mesh_mod.distributed(0, 1, store_path=store, device=dev):
        mesh = mesh_mod.make_local_mesh(1, device=dev)
        for arch in (HYBRID_ARCH, AUDIO_ARCH):
            out[arch] = steps_one_rank(dev, mesh, get_config(arch), "13a", g, h)
        check(spmd.read_collectives()["total_bytes"] == 0, "13a: a collective at world size 1")
    out[SSM_ARCH] = dict(train=tp_train_cell(get_config(SSM_ARCH), dev, "13a"))

    # (b) each family cut over `model` 4 on a fake world on this card
    from torch.testing._internal.distributed.fake_pg import FakeStore

    shapes = (STEPS_DECODE, STEPS_PREFILL, ShapeConfig("train_4k", TRAIN_S, TRAIN_B, "train"))
    torch.distributed.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        mesh = mesh_mod.make_local_mesh(4, device=dev)
        for arch in (SSM_ARCH, HYBRID_ARCH, AUDIO_ARCH):
            cfg = _unit_layers(get_config(arch), 1)
            t0 = time.perf_counter()
            torch.cuda.reset_peak_memory_stats()
            ran = {}
            for shape in shapes:
                c = dataclasses.replace(cfg, attn_chunk=STEPS_PREFILL_CHUNK) \
                    if shape.kind == "prefill" else cfg
                bs = (shape.global_batch, shape.seq_len)
                art = build_cell(c, mesh, shape, device=dev)
                art.init_weights(make_generator(dev, SEED))
                cut = sum(sharding.split_dim(p) is not None for p in art.model.parameters())
                if shape.kind == "decode":
                    res = art.fn(art.new_caches(), art.local_batch(
                        {"token": torch.zeros((shape.global_batch, 1), dtype=torch.long,
                                              device=dev)}))[0]
                elif shape.kind == "prefill":
                    res = art.fn(art.local_batch(prefill_batch(cfg, *bs, h, dev)))
                else:
                    batch = prefill_batch(cfg, *bs, h, dev)
                    batch["labels"] = batch["tokens"]
                    opt = init_sharded(dict(art.model.named_parameters()), cfg, mesh)
                    res = art.fn(art.model, opt, batch)[1]["loss"]
                    del opt
                sync()
                ran[shape.kind] = dict(cut=cut, out=list(res.shape))
                check(cut > 0, f"13b: {arch} {shape.kind}: nothing cut over model")
                del art, res
                free_card()
            enc = f", encoder {cfg.encoder.n_layers}" if cfg.encoder else ""
            print(f"13b: {arch} ({cfg.n_layers} layers{enc}, published widths) on a fake "
                  f"(1, 4) world on the card, init streamed into "
                  f"the shards: {json.dumps(ran)}; peak {peak_gb():.2f} GB; "
                  f"{time.perf_counter() - t0:.1f} s")
            out[arch + " (1, 4) fake"] = ran
    finally:
        torch.distributed.destroy_process_group()
    free_card()
    print("13 summary: " + json.dumps(out))
    return out


# ------------------------- phase 14: MoE routing over the global batch under a data axis
MOE_STEPS_LAYERS = 16   # phase 7's depth: 41.9 GB in bf16 beside 17.2 GB of 32k caches
MOE_PREFILL_LAYERS = 4  # its b 2 x s 32768 prefill takes ~2.3 s a layer (the attention)
MOE_TRAIN_LAYERS = 2    # 2.75B parameters at 16 B each (bf16 weights and grads, fp32 state)
ARCTIC_ARCH = "arctic-480b"
# a prefill cell whose batch divides over data 2 and 4 (every rank routes
# its rows against the global batch)
MOE_FAKE_PREFILL = dataclasses.replace(PREFILL_32K, seq_len=8192, global_batch=4)


def steps_one_rank(dev, mesh, cfg, tag: str, g, h, prefill_layers=None) -> dict:
    """`cfg`'s serve step at decode_32k's share of one data rank (b 8
    against caches of 32768 at length 32767, every cache leaf seeded from
    `g`) and its prefill step at prefill_32k's (b 2 x s 32768, `attn_chunk`
    2048, the batch drawn from `h`; its first `prefill_layers` layers where
    given) through `build_cell` over the one-rank `mesh`, tokens against
    the mesh-less model on the same caches and inputs; walls and peaks."""
    from repro_torch.launch.steps import SELF_KV, build_cell, cache_leaves, last_logits

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))
    from tp_steps_cards import fill_caches, prefill_batch   # the 4-card tool's inputs

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    art = build_cell(cfg, mesh, STEPS_DECODE, device=dev)
    art.model.init(make_generator(dev, SEED))
    caches = art.new_caches()
    fill_caches(caches, g)
    token = torch.randint(0, cfg.vocab_size, (STEPS_DECODE.global_batch, 1), generator=g,
                          device=dev)
    # the step writes the states in place: keep them for the mesh-less step
    # (the K/V at the length are rewritten alike)
    with torch.inference_mode():
        keep = {p: t.clone() for p, t in cache_leaves(caches).items()
                if p.split("/")[-1] not in SELF_KV and p != "length"}
    tok = art.fn(caches, {"token": token})[0]
    with torch.inference_mode():
        for p, t in cache_leaves(caches).items():
            if p in keep:
                t.copy_(keep[p])
    del keep
    bare = torch.argmax(art.model.decode_step(caches, token)[0], dim=-1).to(torch.int32)
    check(torch.equal(tok, bare), f"{tag}: {cfg.name}'s serve step differs from decode_step")
    walls = step_walls(lambda: art.fn(caches, {"token": token}), STEPS_REPS)
    serve = dict(step_ms=walls, peak_gb=peak_gb(),
                 cache_gb=sum(t.numel() * t.element_size()
                              for t in cache_leaves(caches).values()) / 1e9)
    print(f"{tag}: {cfg.name} ({cfg.n_layers} layers, d {cfg.d_model}, {cfg.compute_dtype}) "
          f"serve step through build_cell at (1, 1), b {STEPS_DECODE.global_batch} against "
          f"caches of {STEPS_DECODE.seq_len} ({serve['cache_gb']:.2f} GB): tokens == "
          f"decode_step's bit for bit; step walls {[round(x, 2) for x in walls]} ms; peak "
          f"{serve['peak_gb']:.2f} GB; {time.perf_counter() - t0:.1f} s")
    del caches, art, bare
    free_card()
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg_p = dataclasses.replace(cfg, attn_chunk=STEPS_PREFILL_CHUNK,
                                n_layers=prefill_layers or cfg.n_layers)
    art = build_cell(cfg_p, mesh, STEPS_PREFILL, device=dev)
    art.model.init(make_generator(dev, SEED))
    batch = prefill_batch(cfg, STEPS_PREFILL.global_batch, STEPS_PREFILL.seq_len, h, dev)
    ms, tok = event_ms(lambda: art.fn(batch))
    with torch.inference_mode():
        bare = torch.argmax(last_logits(art.model, batch), dim=-1).to(torch.int32)
    check(torch.equal(tok, bare), f"{tag}: {cfg.name}'s prefill step differs from the "
                                  "mesh-less forward's")
    prefill = dict(ms=ms, peak_gb=peak_gb())
    print(f"{tag}: {cfg.name} prefill step ({cfg_p.n_layers} layers), b "
          f"{STEPS_PREFILL.global_batch} x s {STEPS_PREFILL.seq_len} (attn_chunk "
          f"{STEPS_PREFILL_CHUNK}), head at the last position: token == the mesh-less "
          f"forward's bit for bit; {ms:.1f} ms; peak {prefill['peak_gb']:.2f} GB; "
          f"{time.perf_counter() - t0:.1f} s")
    del art, batch, bare
    free_card()
    return dict(serve=serve, prefill=prefill)


def moe_cell_fake(cfg, mesh, shape, dev, h) -> dict:
    """(14b) One cell of `cfg` on a fake world: built on the card with the
    seeded init streamed into its shards (T59) and run once; the local
    output's shape, the weights cut over `model`, the FSDP gathers of one
    call (`fsdp_reads`) and the `spmd` collectives of the call by op."""
    from repro_torch import spmd
    from repro_torch.launch.steps import build_cell, init_sharded
    from repro_torch.models import sharding

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))
    from tp_steps_cards import prefill_batch

    c = dataclasses.replace(cfg, attn_chunk=STEPS_PREFILL_CHUNK) \
        if shape.kind == "prefill" else cfg
    art = build_cell(c, mesh, shape, device=dev)
    art.init_weights(make_generator(dev, SEED))
    cut = sum(sharding.split_dim(p) is not None for p in art.model.parameters())
    if shape.kind == "decode":
        caches = art.new_caches()
        batch = art.local_batch({"token": torch.zeros((shape.global_batch, 1),
                                                      dtype=torch.long, device=dev)})
        spmd.reset_collectives()
        res = art.fn(caches, batch)[0]
    elif shape.kind == "prefill":
        batch = art.local_batch(prefill_batch(cfg, shape.global_batch, shape.seq_len, h, dev))
        spmd.reset_collectives()
        res = art.fn(batch)
    else:
        batch = prefill_batch(cfg, shape.global_batch, shape.seq_len, h, dev)
        batch["labels"] = batch["tokens"]
        opt = init_sharded(dict(art.model.named_parameters()), cfg, mesh)
        spmd.reset_collectives()
        res = art.fn(art.model, opt, batch)[1]["loss"]
        check(math.isfinite(float(res)), f"14b: {cfg.name} train loss {float(res)}")
        del opt
    sync()
    colls = spmd.read_collectives()
    out = dict(cut=cut, out=list(res.shape), rows=list(art.row_axes),
               fsdp=fsdp_reads(art.model),
               collectives={op: colls[op]["count"] for op in spmd.COLLECTIVE_OPS})
    del art, res
    free_card()
    return out


def phase_moe_data(dev) -> dict:
    """MoE routing over the global batch under a data axis. (a) At world
    size 1 on a one-rank NCCL group's (1, 1) mesh, phi3.5-moe at published
    widths: the serve and prefill steps through `build_cell` at 16 and 4
    layers (`steps_one_rank`: tokens bit-equal to the mesh-less model, and
    no collective), then its train cell at 2 layers, 2 steps bit-equal to
    the mesh-less step (`tp_train_cell`) with no all-gather: the row axes
    of a data axis of 1 add nothing. (b) Fake (2, 2) and (4, 1) worlds on
    this card (their all-gather copies this rank's counts into every slot
    and their all-reduce returns at once: the values are not the
    model's): phi3.5-moe's serve, prefill and train cells and arctic's
    serve and prefill cells at published widths cut to one unit, arctic's
    train cell at its smoke widths (one published layer is 13.4B expert
    parameters, beyond one card with fp32 state), each built with the
    seeded init streamed into its shards and run once, printing each
    call's collectives: one all-gather and one all-reduce a MoE layer
    forward over the data axes, and the MoE placement's FSDP gather of
    each weight a layer reads (`fsdp_reads`). Numerics across ranks: the
    CPU tests and
    `tools/tp_steps_cards.py` / `tp_train_cards.py --arch` across cards."""
    import tempfile

    from repro_torch import spmd
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.dryrun import _unit_layers

    free_card()
    out = {}
    full = get_config(MOE_ARCH)
    spmd.reset_collectives()
    store = tempfile.mktemp(dir=Path(__file__).resolve().parent / "build")
    with mesh_mod.distributed(0, 1, store_path=store, device=dev):
        mesh = mesh_mod.make_local_mesh(1, device=dev)
        out["steps"] = steps_one_rank(
            dev, mesh, dataclasses.replace(full, n_layers=MOE_STEPS_LAYERS), "14a",
            make_generator(dev, SEED + 15), torch.Generator().manual_seed(SEED + 16),
            prefill_layers=MOE_PREFILL_LAYERS)
        check(spmd.read_collectives()["total_bytes"] == 0, "14a: a collective at world size 1")
    train = tp_train_cell(dataclasses.replace(full, n_layers=MOE_TRAIN_LAYERS), dev, "14a")
    check(not any(train["tp"]["gathers"]), f"14a: all-gathers {train['tp']['gathers']} in "
                                           "the world-size-1 MoE train step")
    out["train"] = train

    # (b) data 2 and 4 on a fake world on this card
    from torch.testing._internal.distributed.fake_pg import FakeStore

    h = torch.Generator().manual_seed(SEED + 17)
    train_shape = ShapeConfig("train_4k", TRAIN_S, TRAIN_B, "train")
    # one microbatch (the published 4 would leave 1 row, which splits over no data axis)
    cells = [(dataclasses.replace(_unit_layers(full, 1), grad_accum_steps=1),
              (STEPS_DECODE, MOE_FAKE_PREFILL, train_shape)),
             (_unit_layers(get_config(ARCTIC_ARCH), 1), (STEPS_DECODE, MOE_FAKE_PREFILL)),
             (get_config(ARCTIC_ARCH, smoke=True), (train_shape,))]
    torch.distributed.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        for model_par in (2, 1):
            mesh = mesh_mod.make_local_mesh(model_par, device=dev)
            tag = f"({4 // model_par}, {model_par}) fake"
            for cfg, shapes in cells:
                t0 = time.perf_counter()
                torch.cuda.reset_peak_memory_stats()
                ran = {s.kind: moe_cell_fake(cfg, mesh, s, dev, h) for s in shapes}
                for kind, r in ran.items():
                    check(r["rows"] == ["data"], f"14b: {cfg.name} {kind} rows {r['rows']}")
                    check(r["collectives"]["all-gather"] >= cfg.n_layers,
                          f"14b: {cfg.name} {kind}: {r['collectives']}")
                    if model_par == 1 and kind != "train":   # the MoE's and FSDP's
                        check(r["collectives"] == {"all-reduce": cfg.n_layers,
                                                   "all-gather": cfg.n_layers + r["fsdp"],
                                                   "reduce-scatter": 0},
                              f"14b: {cfg.name} {kind} at {tag}: {r['collectives']}")
                print(f"14b: {cfg.name} ({cfg.n_layers} layer{'s' * (cfg.n_layers > 1)}, "
                      f"d {cfg.d_model}, {cfg.moe.n_experts} experts) on a {tag} world on the "
                      f"card, init streamed into the shards: {json.dumps(ran)}; peak "
                      f"{peak_gb():.2f} GB; {time.perf_counter() - t0:.1f} s")
                out[f"{cfg.name} {tag}"] = ran
    finally:
        torch.distributed.destroy_process_group()
    free_card()
    print("14 summary: " + json.dumps(out))
    return out


def fsdp_reads(model) -> int:
    """The FSDP gathers one forward of `model` makes: one each time a
    layer reads a weight cut over the data axes (a tied table twice, the
    embedding and the head; the hybrid's shared block once an
    application)."""
    from repro_torch.models import sharding

    cfg, n = model.cfg, 0
    for name, p in model.named_parameters():
        if sharding.fsdp_dim(p) is None:
            continue
        if name.startswith("shared."):
            n += cfg.n_layers // cfg.hybrid_attn_every
        else:
            n += 2 if name == "embed" and cfg.tie_embeddings else 1
    return n


def phase_fsdp(dev, tp: dict | None) -> dict:
    """FSDP over `data`: phi4-mini's train cell (`build_cell`) at published
    widths and full depth on a fake (4, 1) world on this card, b 4 x s
    512 (one row a data rank), one microbatch as phase 12a runs it, the
    seeded init streamed into the shards, 2 steps. Each weight the rules
    cut over `data` is held as a quarter, gathered per layer (again in
    the full remat's recompute) and its gradient reduce-scattered: the
    fake group's all-gather tiles this rank's shard and its
    reduce-scatter keeps the first slice, so the values are not the
    model's and the walls are not a (4, 1) step's (the collectives
    return at once). It prints the resident weight and state bytes and
    the peak a card beside phase 12a's (1, 1) step (`tp`), and the
    all-gathers and reduce-scatters a step, which must be one a gathered
    weight a read (the forward's, the recompute's, the head's)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch import spmd
    from repro_torch.configs import ShapeConfig
    from repro_torch.data import DataPipeline
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.steps import build_cell, build_train_step, init_sharded
    from repro_torch.models import sharding
    from repro_torch.optim import adamw
    from repro_torch.perf import roofline

    free_card()
    cfg = get_config(TRAIN_ARCH)
    ocfg = adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=5, total_steps=TP_STEPS)
    pipe = DataPipeline(cfg.vocab_size, batch=TRAIN_B, seq=TRAIN_S, seed=SEED)
    batches = [{k: torch.from_numpy(v).to(dev, torch.long) for k, v in pipe.batch_at(i).items()}
               for i in range(TP_STEPS)]
    whole_gb = sum(p.numel() * p.element_size()
                   for p in build_model(cfg, device="meta").parameters()) / 1e9
    t0 = time.perf_counter()
    torch.distributed.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        mesh = mesh_mod.make_local_mesh(1, device=dev)
        art = build_cell(cfg, mesh, ShapeConfig("train_4k", TRAIN_S, TRAIN_B, "train"),
                         device=dev)
        art.init_weights(make_generator(dev, SEED))
        params = dict(art.model.named_parameters())
        n_fsdp = sum(sharding.fsdp_dim(p) is not None for p in params.values())
        reads = fsdp_reads(art.model)
        step = build_train_step(cfg, ocfg, grad_accum=1, mesh=mesh)
        opt = init_sharded(params, cfg, mesh)
        held_gb = param_bytes(art.model) / 1e9
        state_gb = roofline.tensor_bytes(opt.master, opt.mu, opt.nu) / 1e9
        sync()
        torch.cuda.reset_peak_memory_stats()
        res = {"ms": [], "loss": [], "all-gather": [], "reduce-scatter": [], "all-reduce": [],
               "gathered_gb": []}
        for b in batches:
            spmd.reset_collectives()
            sync()
            t1 = time.perf_counter()
            opt, m = step(art.model, opt, b)
            res["loss"].append(float(m["loss"]))
            res["ms"].append(round((time.perf_counter() - t1) * 1e3, 1))
            c = spmd.read_collectives()
            for op in ("all-gather", "reduce-scatter", "all-reduce"):
                res[op].append(c[op]["count"])
            res["gathered_gb"].append(c["all-gather"]["bytes"] / 1e9)
        peak = peak_gb()
        del art, opt, params, step
    finally:
        torch.distributed.destroy_process_group()
    free_card()
    mine = (f"resident weights {held_gb:.2f} GB of {whole_gb:.2f} GB whole, ZeRO-1 state "
            f"{state_gb:.2f} GB, peak {peak:.2f} GB a card")
    theirs = ("phase 12a did not run" if tp is None else
              f"phase 12a's (1, 1) step: weights {whole_gb:.2f} GB, peak "
              f"{tp['tp']['peak_gb']:.2f} GB, walls {[round(x, 1) for x in tp['tp']['ms']]} ms")
    print(f"15: {cfg.name} ({cfg.n_layers} layers, d {cfg.d_model}, {cfg.param_dtype} params, "
          f"remat {cfg.remat}) train cell on a fake (4, 1) world on the card ({CARD}), b "
          f"{TRAIN_B} x s {TRAIN_S}, {TP_STEPS} steps: {n_fsdp} weights cut over `data`; "
          f"{mine}; beside {theirs}; a step's all-gathers {res['all-gather']}, "
          f"reduce-scatters {res['reduce-scatter']}, all-reduces {res['all-reduce']} "
          f"({reads} FSDP reads a forward), gathered {res['gathered_gb'][0]:.2f} GB a step; "
          f"walls {res['ms']} ms (a fake group's: its collectives return at once); losses "
          f"{res['loss']} (a fake group's values); {time.perf_counter() - t0:.1f} s")
    check(n_fsdp > 0 and held_gb < whole_gb / 2, f"15: resident {held_gb:.2f} GB of "
                                                   f"{whole_gb:.2f} GB")
    check(all(n >= reads for n in res["all-gather"]) and all(
        n >= n_fsdp for n in res["reduce-scatter"]), f"15: collectives {res}")
    check(math.isfinite(res["loss"][0]), f"15: step 0's loss {res['loss'][0]}")
    out = dict(held_gb=held_gb, whole_gb=whole_gb, state_gb=state_gb, peak_gb=peak,
               n_fsdp=n_fsdp, reads=reads, **res)
    print("15 summary: " + json.dumps(out))
    return out


# ------------------------------------------------------- phase 16: the examples
EXAMPLES = Path(__file__).resolve().parent / "examples_torch"


def load_example(name: str):
    """`examples_torch/<name>.py` as a module of its own."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"examples_torch_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def quiet(fn, *args, **kwargs):
    """(fn's return value, the lines it printed), nothing shown."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kwargs)
    return out, buf.getvalue().splitlines()


def on_card(fn, *args) -> tuple:
    """A twin's `main` on the card as a main path: every count set to 0
    just before, read just after. (return value, lines, launches, wall s)."""
    reset_launches()
    t0 = time.perf_counter()
    out, lines = quiet(fn, *args)
    sync()
    wall = time.perf_counter() - t0
    return out, lines, counters.read(), wall


def retrieved(rag: dict) -> dict:
    """What rag_serve retrieved, every id it printed: the wave's ids, the
    update's three ids, the schedulers' and the streams' ids by query."""
    return {"wave": [w["doc_ids"] for w in rag["wave"]], "update": rag["update"],
            "pull": rag["pull"]["ids"],
            "async": {q: a["doc_ids"] for q, a in rag["async"].items()},
            "stream": rag["stream"],
            "generate": {q: g["doc_ids"] for q, g in rag["generate"].items()}}


def phase_examples(dev) -> dict:
    """The twins of the reference's examples (`examples_torch/`), each
    driven through its `main` on the card as a user runs it, and held
    against the same twin with `--device cpu` where the outputs do not
    depend on the device's random stream: (a) edge_sim, host arithmetic,
    its lines equal; (b) quickstart, 4096 x 512 INT8: the clean P@5 and
    every query's top-5 ids equal the CPU run's, the noisy P@5 (drawn
    from a generator on the card) in [0, 1], and the fused K4 launched
    (a search a launch: 4096 docs over 16 cores); (c) rag_serve with
    phi4-mini's smoke model, bf16, over 4 shards of 16 documents: every
    retrieved id equal to the CPU run's (the models differ: each is
    seeded on its own device), K4 launched; (d) train_lm: the 100M
    config at full width through `launch.train.train`, the example's 300
    steps at b 8 x s 256 with its async checkpoints (written under
    `build/` and removed), the loss falling from its start; the median
    step, the peak memory and the card. Then K4 held against its plain
    version at every shape the phase sent it."""
    import shutil

    from repro_torch.checkpointing import CheckpointManager
    from repro_torch.data import DataPipeline

    free_card()
    out = {"launches": {}, "walls": {}}
    k4_sent, k4_fn = _recording(topk_select, "hierarchical_select",
                                lambda s_, k, n_cores: (*s_.shape, k, n_cores))
    try:
        # (a) edge_sim
        es = load_example("edge_sim")
        _, lines, _, out["walls"]["edge_sim"] = on_card(es.main, [])
        _, cpu_lines = quiet(es.main, ["--device", "cpu"])
        check(lines == cpu_lines and len(lines) > 20, "16a: edge_sim's lines differ from "
                                                       "the CPU run's")
        print(f"16a: edge_sim on the card: {len(lines)} lines, equal to the CPU run's")

        # (b) quickstart
        qs = load_example("quickstart")
        card, lines, n, out["walls"]["quickstart"] = on_card(qs.main, [])
        out["launches"]["quickstart"] = n
        cpu, _ = quiet(qs.main, ["--device", "cpu"])
        for line in lines:
            print(f"16b | {line}")
        print(f"16b: quickstart on the card in {out['walls']['quickstart']:.2f} s: P@5 "
              f"{card['p5']:.4f} (CPU {cpu['p5']:.4f}), noisy P@5 {card['p5_noisy']:.4f} "
              f"(CPU's generator {cpu['p5_noisy']:.4f}); launches {n}")
        check(card["p5"] == cpu["p5"] and card["ids"] == cpu["ids"],
              "16b: quickstart's clean P@5 / top-5 ids differ from the CPU run's")
        check(0.0 <= card["p5_noisy"] <= 1.0, f"16b: noisy P@5 {card['p5_noisy']}")
        check(n["topk_select"] > 0, "16b: quickstart launched no K4")

        # (c) rag_serve
        rs = load_example("rag_serve")
        card, lines, n, out["walls"]["rag_serve"] = on_card(rs.main, [])
        out["launches"]["rag_serve"] = n
        cpu, _ = quiet(rs.main, ["--device", "cpu"])
        got, want = retrieved(card), retrieved(cpu)
        print(f"16c: rag_serve on the card in {out['walls']['rag_serve']:.2f} s: shard loads "
              f"{card['shard_loads']}, retrieved {got['wave']}, update {got['update']}, "
              f"token_stream {card['token_stream']}; launches {n}")
        check(got == want, f"16c: rag_serve's retrieved ids differ from the CPU run's: "
                           f"{got} against {want}")
        check(card["shard_loads"] == cpu["shard_loads"], "16c: shard loads differ")
        check(all(len(w["answer_tokens"]) == 12 for w in card["wave"])
              and all(len(g["tokens"]) == 8 for g in card["generate"].values())
              and len(card["token_stream"]) == 8, "16c: answers of the wrong length")
        check(n["topk_select"] > 0, "16c: rag_serve launched no K4")
    finally:
        topk_select.hierarchical_select = k4_fn
    out["topk_select"] = sum(out["launches"][e]["topk_select"]
                             for e in ("quickstart", "rag_serve"))

    # (d) train_lm
    tl = load_example("train_lm")
    ckpt = Path(__file__).resolve().parent / "build" / "chip_smoke_train_lm"
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        torch.cuda.reset_peak_memory_stats()
        res, lines, n, out["walls"]["train_lm"] = on_card(tl.main, ["--ckpt-dir", str(ckpt)])
        saved = CheckpointManager(str(ckpt)).all_steps()
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    for line in lines:
        if not line.startswith("[watchdog]"):
            print(f"16d | {line}")
    losses = res["losses"]
    med = statistics.median(res["step_ms"][1:])
    data = DataPipeline(tl.CFG_100M.vocab_size, batch=8, seq=256, seed=SEED)
    data_ms = statistics.median(_wall(lambda i=i: data.batch_at(i)) for i in range(5)) * 1e3
    peak = max(res["peak_bytes"], default=0) / 1e9
    cfg = tl.CFG_100M
    print(f"16d: train_lm, {cfg.name} ({cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.param_count() / 1e6:.1f}M params, {cfg.param_dtype} params, "
          f"{cfg.compute_dtype} compute) on the card ({CARD}): {len(losses)} steps at b 8 x s "
          f"256, loss {losses[0]:.4f} -> {losses[-1]:.4f} (last 10 mean "
          f"{statistics.fmean(losses[-10:]):.4f}); median step {med:.2f} ms (first "
          f"{res['step_ms'][0]:.1f} ms; the host's batch_at alone {data_ms:.2f} ms), peak "
          f"{peak:.2f} GB, {len(res['stragglers'])} "
          f"stragglers, checkpoints {saved}; {out['walls']['train_lm']:.1f} s; launches {n}")
    check(len(losses) == 300 and all(math.isfinite(x) for x in losses),
          f"16d: {len(losses)} steps")
    check(statistics.fmean(losses[-10:]) < losses[0],
          f"16d: the loss did not fall: {losses[0]:.4f} -> {losses[-10:]}")
    out["train_lm"] = {"median_step_ms": med, "data_ms": data_ms, "peak_gb": peak,
                       "first": losses[0],
                       "last10": statistics.fmean(losses[-10:]), "checkpoints": saved}

    g = make_generator(dev, SEED + 26)
    err = 0.0
    print(f"shapes phase 16 sent: fused K4 {sorted(k4_sent)}")
    for rows, n_, k, n_cores in sorted(k4_sent):
        s_rand = torch.randn((rows, n_), generator=g, device=dev)
        err = max(err, check_fused(s_rand, k, f"phase 16 shape (rows {rows}, n {n_}, k {k})",
                                   n_cores))
    out["max_abs_err"] = {"topk_select": err}
    print("16 summary: " + json.dumps({k: v for k, v in out.items()}))
    return out


PHASES = ("1", "2", "3", "4", "5", "6", "7", "8", "9", "10", "11", "12", "13", "14", "15", "16")
NEEDS = {"3": "2", "4": "2", "6": "2", "5": "1"}   # phase 2's pipeline, phase 1c's times


def selected_phases() -> set:
    """The phases to run: every one, or those that CHIP_SMOKE_PHASES lists
    (comma-separated, "1" being 1, 1b and 1c) with the ones they read."""
    want = os.environ.get("CHIP_SMOKE_PHASES", "")
    sel = {p.strip() for p in want.split(",") if p.strip()} or set(PHASES)
    check(sel <= set(PHASES), f"CHIP_SMOKE_PHASES={want!r}: phases are {PHASES}")
    sel |= {NEEDS[p] for p in sel if p in NEEDS}
    return sel


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # cuBLAS reads its workspace setting when its handle is made: phase 9's
    # resume check runs under deterministic algorithms, which need this one
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    global CARD
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    CARD = smi
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")

    _build.load_library()
    print(f"kernel build: {_build.BUILD_SECONDS:.2f} s")
    for line in _build.BUILD_LOG.splitlines():   # registers / spills per kernel
        if "entry function" in line or "registers" in line or "spill" in line:
            print(line.strip())

    return run_phases(dev, selected_phases(), {})


def run_phases(dev, sel: set, walls: dict) -> int:
    """The selected phases, then (all of them run) the kernel line and the
    result line."""

    def run(name, fn, *args):
        t0 = time.perf_counter()
        res = fn(*args)
        sync()
        walls[name] = round(time.perf_counter() - t0, 1)
        # a phase stops every thread it starts: one left polling would
        # slow every later phase's host
        left = [t.name for t in threading.enumerate() if t is not threading.main_thread()]
        if left:
            print(f"threads still alive after phase {name}: {left}")
        return res

    if "1" in sel:
        timings = run("1 (K1, K2)", phase_kernels, dev)
        timings["paged_attend_fused"] = run("1b (K3)", phase_k3, dev)
        timings.update(run("1c (K4, K5)", phase_k4_k5, dev))
    main_out = corpus_setup()
    if "2" in sel:
        main_out = run("2 (synchronous)", phase_main_path, dev, main_out)
    if "3" in sel:
        run("3 (error channel)", phase_error_channel, dev, main_out)
    if "4" in sel:
        stream = run("4 (streaming)", phase_stream, dev, main_out)
    if "5" in sel:
        sharded = run("5 (sharded)", phase_sharded, dev, main_out,
                      timings["topk_select"]["sharded_fused"])
    if "6" in sel:
        gen = run("6 (generation serving)", phase_generate, dev, main_out)
    main_out.pop("pipe", None)   # phase 2's phi4-mini: phase 7 needs the card
    if "7" in sel:
        fam = run("7 (DecoderLM families)", phase_families, dev, main_out)
    if "8" in sel:
        ssm = run("8 (ssm, hybrid, audio)", phase_ssm, dev, main_out)
    if "9" in sel:
        run("9 (training)", phase_train, dev)
    if "10" in sel:
        scale = run("10 (scale-out)", phase_scale_out, dev, main_out)
    if "11" in sel:
        run("11 (inference steps)", phase_steps, dev)
    tp = None
    if "12" in sel:
        tp = run("12 (TP training)", phase_tp_train, dev)["train"]
    if "13" in sel:
        run("13 (TP ssm, hybrid, audio)", phase_tp_families, dev)
    if "14" in sel:
        run("14 (MoE over a data axis)", phase_moe_data, dev)
    if "15" in sel:
        run("15 (FSDP over data)", phase_fsdp, dev, tp)
    if "16" in sel:
        examples = run("16 (examples)", phase_examples, dev)
    if "12" in sel:       # the dry run last, alone on the host
        run("12b (dry run)", phase_dryrun)
    print(f"phase walls (s): {walls}")
    if sel != set(PHASES):
        print(f"phases {sorted(sel)} only: no kernel line and no result")
        return 0
    launches = main_out["launches"]
    launches["paged_attend_fused"] = (stream["launches"] + gen["launches"]["paged_attend_fused"]
                                      + fam["launches"]["paged_attend_fused"])
    launches["topk_select"] += (stream["topk_select"] + sharded["launches"]
                                + gen["launches"]["topk_select"] + fam["launches"]["topk_select"]
                                + ssm["launches"]["topk_select"] + examples["topk_select"])
    launches["dirc_mac"] += (gen["launches"]["dirc_mac"] + fam["launches"]["dirc_mac"]
                             + ssm["launches"]["dirc_mac"])
    launches["score_matmul_cosine"] = timings["score_matmul_cosine"]["launches"]
    for name, n in scale["launches"].items():
        launches[name] += n
    for errs in (sharded["max_abs_err"], gen["max_abs_err"], fam["max_abs_err"],
                 ssm["max_abs_err"], scale["max_abs_err"], examples["max_abs_err"]):
        for name, err in errs.items():
            timings[name]["max_abs_err"] = max(timings[name]["max_abs_err"], err)

    kernels = []
    for name, src, replaces in (
            ("dirc_mac", "src/repro_torch/csrc/dirc_mac.cu",
             "src/repro/kernels/dirc_mac.py:56"),
            ("score_matmul_int", "src/repro_torch/csrc/score_matmul.cu",
             "src/repro/kernels/score_matmul.py:47"),
            ("paged_attend_fused", "src/repro_torch/csrc/paged_attend.cu",
             "src/repro/kernels/paged_attend.py:126"),
            ("topk_select", "src/repro_torch/csrc/topk_select.cu",
             "src/repro/kernels/topk_select.py:41"),
            ("score_matmul_cosine", "src/repro_torch/csrc/score_matmul.cu",
             "src/repro/kernels/score_matmul.py:69")):
        t = timings[name]
        b_ms, b_by = t["bound"]
        check(launches[name] > 0, f"{name} was never launched on its path")
        entry = {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": t["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": t["library_ms"],
        }
        if "amortised_ms" in t:   # K2, K4, K5: back-to-back launches, one pair of events
            entry.update(amortised_ms=t["amortised_ms"],
                         library_amortised_ms=t["library_amortised_ms"])
        if name == "topk_select":   # the fused entry that every search launches
            entry.update({key: t[key] for key in t if key.startswith("fused_")})
        if name == "paged_attend_fused":   # ms / bound_ms above: the decode step
            pre = t["prefill"]
            entry.update(prefill_ms=pre["ms"], prefill_plain_ms=pre["plain_ms"],
                         prefill_bound_ms=pre["bound"][0],
                         prefill_library_ms=pre["library_ms"])
            entry["prefill_path"] = {   # the 2,048-token pieces, one launch each
                name: {key: r[key] for key in ("ms", "split_ms", "plain_ms", "library_ms")}
                | {"bound_ms": r["bound"][0]} for name, r in t["pieces"].items()}
            for key in ("g48_mqa_decode", "g4_moe_decode"):   # phase 7's head layouts
                r = fam[key]
                entry.update({f"{key}_ms": r["ms"], f"{key}_plain_ms": r["plain_ms"],
                              f"{key}_bound_ms": r["bound"][0],
                              f"{key}_library_ms": r["library_ms"]})
        kernels.append(entry)
    print(CARD)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
