"""Quickstart: build a DIRC-RAG index and query it, with and without
device errors — the paper's core loop, on the port. The twin of
`examples/quickstart.py`: the same corpus, configs and lines.

On the card every search ends in the fused top-k kernel (K4,
`kernels.topk_select.hierarchical_select`): 4096 documents split over 16
cores. The noisy search draws its sensing errors from a seeded
`torch.Generator` on the index's device (the reference draws from
`jax.random.key(0)`); `main(flips=...)` replays given flip masks instead.

Run: PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]
"""
import argparse

import torch

from repro_torch.core.error_model import ErrorModelConfig
from repro_torch.core.retrieval import DircRagIndex, RetrievalConfig
from repro_torch.core.simulator import simulate_query
from repro_torch.core.topk import precision_at_k
from repro_torch.data.synthetic import make_ir_dataset
from repro_torch.device import make_generator, resolve_device

CLEAN = RetrievalConfig(bits=8, metric="cosine", path="int_exact")
NOISY = RetrievalConfig(
    bits=8, path="bitserial", mapping="error_aware",
    error=ErrorModelConfig(enabled=True, p_min=5e-3, p_max=8e-2),
    detect=True, max_retries=3)
SEED = 0


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs on the host)")
    return ap.parse_args(argv)


def dataset():
    return make_ir_dataset(n_docs=4096, dim=512, n_queries=64, seed=0)


def p_at_5(res, ds, dev) -> float:
    return float(precision_at_k(res.indices, torch.as_tensor(ds.relevant, device=dev), 5))


def noisy_search(noisy: DircRagIndex, ds, flips=None):
    """The noisy index's top 5: the sensing errors drawn from the seeded
    generator, or replayed from `flips` (one mask per sensing round)."""
    if flips is not None:
        return noisy.search(ds.query_embeddings, k=5, flips=flips)
    return noisy.search(ds.query_embeddings, k=5,
                        generator=make_generator(noisy.device, SEED))


def main(argv=None, flips=None) -> dict:
    """Print the quickstart; return what was printed: `p5`, `ids0`, `p5_noisy`,
    the simulator's `db_mb`, `latency_us`, `energy_uj` and `breakdown`, and
    every query's clean top-5 ids (`ids`)."""
    dev = resolve_device(parse_args(argv).device)
    print("== building synthetic corpus (4096 docs, dim 512) ==")
    ds = dataset()

    print("== clean INT8 retrieval (query-stationary digital CIM) ==")
    idx = DircRagIndex.build(ds.doc_embeddings, CLEAN, device=dev)
    res = idx.search(ds.query_embeddings, k=5)
    p5 = p_at_5(res, ds, dev)
    ids = res.indices.cpu().tolist()
    print(f"   P@5 = {p5:.3f}")
    print(f"   top-5 doc ids for query 0: {ids[0]}")

    print("== same retrieval under ReRAM sensing errors ==")
    noisy = DircRagIndex.build(ds.doc_embeddings, NOISY, device=dev)
    p5n = p_at_5(noisy_search(noisy, ds, flips), ds, dev)
    print(f"   P@5 with errors + remap + Sigma-D detection = {p5n:.3f}")

    print("== what the silicon would do (calibrated model) ==")
    sim = simulate_query(idx.n_docs, idx.dim, bits=8)
    out = {"p5": p5, "ids0": ids[0], "ids": ids, "p5_noisy": p5n,
           "db_mb": sim.plan.db_bytes / 2**20, "latency_us": sim.latency_s * 1e6,
           "energy_uj": sim.energy_j * 1e6, "breakdown": sim.energy_breakdown}
    print(f"   database: {out['db_mb']:.2f} MB INT8")
    print(f"   latency:  {out['latency_us']:.2f} us/query"
          f"   energy: {out['energy_uj']:.3f} uJ/query")
    print(f"   breakdown: {sim.energy_breakdown}")
    return out


if __name__ == "__main__":
    main()
