#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA card; builds the kernels

Phases, each raising on a failed check (the process then exits non-zero
and prints no result):
  1. every CUDA kernel of the main path (K1 `dirc_mac`, K2
     `score_matmul_int`) against its plain PyTorch version on the card,
     bit-equal int32 outputs, with kernel / plain / `torch._int_mm` times;
  2. the main path: `RagPipeline.query_many` at the paper's operating point
     (8192-document corpus, dim 512, INT8 cosine, 16 cores) with
     phi4-mini-3.8b at full width, once through K1 (path
     `kernel_bitserial`) and once through K2 (path `kernel_mxu`); launch
     counts, self-retrieval, agreement with path `int_exact`, phase times;
  3. the sensing-error channel with Sigma-D detection through K1.
The line before the last is a JSON object with one entry per kernel; the
last line is `{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

_SRC = Path(__file__).resolve().parent / "src"
if _SRC.is_dir():
    sys.path.insert(0, str(_SRC))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import bitplane  # noqa: E402
from repro_torch.core.error_model import ErrorModelConfig  # noqa: E402
from repro_torch.core.retrieval import DircRagIndex, RetrievalConfig  # noqa: E402
from repro_torch.device import make_generator  # noqa: E402
from repro_torch.kernels import _build, dirc_mac, score_matmul  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import HashEmbedder, RagPipeline  # noqa: E402

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, dense int8 ops/s.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12

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


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """Least time for the work on the card: bytes over HBM rate vs int8
    operations over the int8 peak; the larger one and which it is."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def int_mm_yardstick(q: torch.Tensor, docs: torch.Tensor):
    """`torch._int_mm` on the same int8 codes (rows padded to >= 17 and
    multiples of 8): the library call for the same function. Returns
    (out (b, n) int32, ms), or (None, None) where this build refuses it."""
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
    return out[:b, :n], time_ms(lambda: torch._int_mm(qp, dt_))


def _fmt(ms) -> str:
    return "n/a" if ms is None else f"{ms:.4f}"


# ------------------------------------------------------------------ phase 1
def phase_kernels(dev) -> dict:
    """K1 and K2 against their plain versions; returns per-kernel timings
    at the main path's shapes."""
    g = make_generator(dev, SEED)
    main = {}
    max_err = {"dirc_mac": 0, "score_matmul_int": 0}
    for b in (1, MAIN_B, 16):
        for n in (N_DOCS, N_DOCS + 37):
            for dim in (128, 512, 1024):
                q8 = torch.randint(-128, 128, (b, dim), generator=g, device=dev,
                                   dtype=torch.int8)
                d8 = torch.randint(-128, 128, (n, dim), generator=g, device=dev,
                                   dtype=torch.int8)
                # ---- K2
                got = score_matmul.score_matmul_int(q8, d8)
                want = score_matmul.score_matmul_int_ref(q8, d8)
                sync()
                err = int((got.long() - want.long()).abs().max())
                check(err == 0, f"K2 b={b} n={n} dim={dim}: max |err| {err}")
                max_err["score_matmul_int"] = max(max_err["score_matmul_int"], err)
                t_k = time_ms(lambda: score_matmul.score_matmul_int(q8, d8))
                t_p = time_ms(lambda: score_matmul.score_matmul_int_ref(q8, d8))
                lib_out, t_l = int_mm_yardstick(q8, d8)
                if lib_out is not None:
                    check(torch.equal(lib_out, got), f"K2 vs torch._int_mm b={b} n={n}")
                print(f"K2 score_matmul_int b={b} n={n} dim={dim}: bit-equal; "
                      f"kernel {t_k:.4f} ms, plain {t_p:.4f} ms, _int_mm {_fmt(t_l)} ms")
                if (b, n, dim) == (MAIN_B, N_DOCS, DIM):
                    main["score_matmul_int"] = dict(
                        ms=t_k, plain_ms=t_p, library_ms=t_l,
                        bound=bound_ms(b * dim + n * dim + b * n * 4, 2 * b * n * dim))
                # ---- K1
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
    for name in main:
        main[name]["max_abs_err"] = max_err[name]
    return main


# ------------------------------------------------------------------ phase 2
def make_corpus(n: int, seed: int) -> list:
    """The synthetic corpus of the JAX serving CLI (`launch/serve.py`)."""
    rng = np.random.default_rng(seed)
    return [f"document {i}: " + " ".join(
        f"w{rng.integers(0, 997)}" for _ in range(12)) for i in range(n)]


def phase_main_path(dev) -> dict:
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

    corpus = make_corpus(N_DOCS, SEED)
    embedder = HashEmbedder(dim=DIM)
    t0 = time.perf_counter()
    embs = embedder.embed(corpus)
    embed_s = time.perf_counter() - t0
    base = RetrievalConfig(bits=8, metric="cosine", n_cores=16)
    t0 = time.perf_counter()
    exact = DircRagIndex.build(embs, dataclasses.replace(base, path="int_exact"),
                               device=dev)
    sync()
    build_s = time.perf_counter() - t0
    print(f"embed {N_DOCS} docs (host numpy): {embed_s:.3f} s; "
          f"index build: {build_s:.4f} s; {exact.storage_bytes()}")

    pipe = RagPipeline(corpus, dataclasses.replace(base, path="kernel_bitserial"),
                       model=model, embedder=embedder, dim=DIM, device=dev)
    check(torch.equal(pipe.index.planes, exact.planes), "index rebuild differs")
    own = list(range(0, N_DOCS, N_DOCS // MAIN_B))
    queries = [corpus[i] for i in own]
    q_emb = embedder.embed(queries)
    want = exact.search(q_emb, K)
    want_ids, want_scores = want.indices.cpu().numpy(), want.scores.cpu().numpy()

    out = {"launches": {}}
    for path, kmod in (("kernel_bitserial", dirc_mac), ("kernel_mxu", score_matmul)):
        if pipe.index.config.path != path:
            pipe.index = DircRagIndex.build(
                embs, dataclasses.replace(base, path=path), device=dev)
        dirc_mac.LAUNCHES = score_matmul.LAUNCHES = 0
        t0 = time.perf_counter()
        results = pipe.query_many(queries, k=K, max_new_tokens=NEW_TOKENS)
        sync()
        wall = time.perf_counter() - t0
        launches = {"dirc_mac": dirc_mac.LAUNCHES,
                    "score_matmul_int": score_matmul.LAUNCHES}
        name = "dirc_mac" if kmod is dirc_mac else "score_matmul_int"
        out["launches"][name] = launches[name]
        check(launches[name] > 0, f"{path}: kernel {name} never launched")
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
    profile_generate(pipe, toks, tn * 1e3)
    out.update(embs=embs, pipe=pipe, queries=queries, own=own)
    return out


def profile_generate(pipe, toks, wall_ms: float) -> None:
    """Where the time of one answer goes: `torch.profiler` over one
    `generate` call — device time by kernel, kernel launches, and the
    device's busy share of the unprofiled wall time `wall_ms`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pipe.engine.generate(toks, NEW_TOKENS)
        sync()
    ev = prof.key_averages()
    # kernel rows only: an operator row repeats the time of its kernels
    dev_ms = sum(e.self_device_time_total for e in ev
                 if e.device_type == DeviceType.CUDA and not e.is_user_annotation) / 1e3
    launches = sum(e.count for e in ev if e.key in ("cudaLaunchKernel", "cuLaunchKernelEx"))
    print(f"profile of generate({NEW_TOKENS} tokens): device busy {dev_ms:.2f} ms of "
          f"{wall_ms:.2f} ms unprofiled wall ({dev_ms / wall_ms:.1%}); "
          f"{launches} kernel launches")
    print(ev.table(sort_by="self_device_time_total", row_limit=10, max_name_column_width=50))


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")

    _build.load_library()
    print(f"kernel build: {_build.BUILD_SECONDS:.2f} s")
    for line in _build.BUILD_LOG.splitlines():   # registers / spills per kernel
        if "entry function" in line or "registers" in line or "spill" in line:
            print(line.strip())

    timings = phase_kernels(dev)
    main_out = phase_main_path(dev)
    phase_error_channel(dev, main_out)

    kernels = []
    for name, src, replaces in (
            ("dirc_mac", "src/repro_torch/csrc/dirc_mac.cu",
             "src/repro/kernels/dirc_mac.py:56"),
            ("score_matmul_int", "src/repro_torch/csrc/score_matmul.cu",
             "src/repro/kernels/score_matmul.py:47")):
        t = timings[name]
        b_ms, b_by = t["bound"]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": main_out["launches"][name], "max_abs_err": t["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": t["library_ms"],
        })
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
