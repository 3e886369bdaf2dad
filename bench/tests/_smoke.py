"""Toy cells for the CPU: a copy of the benchmark under a temporary root,
with two cells of its own (an open loop on a dense toy model, a closed
loop on a MoE toy model) added as data files and entries."""
from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

DENSE = {"name": "dense-toy", "family": "dense", "n_layers": 2, "d_model": 96,
         "n_heads": 6, "n_kv_heads": 2, "d_ff": 256, "vocab_size": 512, "head_dim": 16,
         "norm": "rmsnorm", "norm_eps": 1e-5, "mlp": "swiglu", "attn_bias": False,
         "rope_style": "standard", "rope_theta": 10000.0, "tie_embeddings": True,
         "param_dtype": "float32", "compute_dtype": "float32", "paged_kernel": True,
         "index": {"n_docs": 64, "dim": 64, "doc_tokens": 48, "bits": 8, "metric": "cosine",
                   "n_cores": 16, "n_shards": 4, "path": "kernel_bitserial",
                   "mapping": "error_aware", "detect": True},
         "engine": {"n_slots": 4, "paged": True, "paged_kernel": True, "block_size": 4,
                    "prefill_chunk": 32, "prefix_sharing": True},
         "scheduler": {"max_batch": 4, "max_wait_ms": 5.0}}
MOE = dict(DENSE, name="moe-toy", family="moe", d_model=64, n_heads=4, d_ff=96,
           moe={"n_experts": 4, "top_k": 2, "capacity_factor": 2.0})
TINY = {"k": 2, "query_tokens": [8, 16], "answer_tokens": [2, 6], "block": 8}
MIXES = {"tiny-open": dict(TINY, loop="open", rate_qps=4.0, drain_s=30),
         "tiny-closed": dict(TINY, loop="closed", clients=6)}
LIMITS = {"search_gap": 1e-6, "logit_gap": 1e-3}
CELLS = {"toy.open": ("dense-toy", "tiny-open", {"check_tokens": 40, "limits": LIMITS}),
         "toy.closed": ("moe-toy", "tiny-closed", {"check_tokens": 40, "limits": LIMITS})}


def make_root(tmp: Path) -> Path:
    """A checkout of the benchmark under `tmp` with the toy cells added."""
    tmp = Path(tmp)
    shutil.copytree(BENCH, tmp / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    spec = json.loads((tmp / "BENCHMARK.json").read_text())
    for name, cfg in (("dense-toy", DENSE), ("moe-toy", MOE)):
        (tmp / f"bench/configs/{name}.json").write_text(json.dumps(cfg))
        spec["configs"].append({"name": name, "source": "toy", "file": f"bench/configs/{name}.json",
                                "reduced": [], "why": "toy"})
    for mix, params in MIXES.items():
        (tmp / f"bench/traffic/{mix}.json").write_text(json.dumps(params))
    for name, (cfg, mix, load) in CELLS.items():
        (tmp / f"bench/workloads/{name}.json").write_text(json.dumps(load))
        spec["workloads"].append({"name": name, "config": cfg, "traffic": mix, "chips": 1,
                                  "why": "toy"})
        tag = name.split(".")[1]
        moves = "ttft_p90_ms" if tag == "open" else "tok_s"
        for m in spec["end_to_end"] + spec["per_layer"]:
            if "workloads" in m and (m["name"].endswith("." + tag) or m["name"] == moves):
                m["workloads"].append(name)
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return tmp


def run(root: Path, name: str, seed: int = 2**31 + 11, seconds: float = 3.0,
        trace: bool = False) -> dict:
    from bench import run as brun
    from bench import spec

    cell = spec.cell(name, root)
    return brun.run_cell(cell, seed, seconds, trace, torch.device("cpu"), time.monotonic(),
                         root=root)
