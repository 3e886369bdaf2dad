"""Walk the calibrated DIRC-RAG silicon model across the paper's design
space: database size, precision, dimension, detection on/off. The port's
twin of `examples/edge_sim.py`: the same lines, from
`repro_torch.core.simulator`.

The simulator is host arithmetic and launches nothing on the card; like
every twin, the script still resolves its device first, so without CUDA
it needs `--device cpu`.

Run: PYTHONPATH=src python examples_torch/edge_sim.py [--device cpu]
"""
import argparse

from repro_torch.core.simulator import simulate_database_mb, table1_spec
from repro_torch.device import resolve_device


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs on the host)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Print the walk; return what was printed: `spec` (Table I),
    `scaling` [(MB, bits, us, uJ)], `folding` [(dim, us, docs)] and
    `detect` {"on" / "off": (us, uJ)}."""
    args = parse_args(argv)
    resolve_device(args.device)
    out = {"spec": table1_spec(), "scaling": [], "folding": [], "detect": {}}
    print("== Table I spec (calibrated model vs paper) ==")
    for k, v in out["spec"].items():
        print(f"   {k:32s} {v}")

    print("\n== latency/energy scaling (dim 512) ==")
    print(f"   {'MB':>5s} {'bits':>5s} {'us/query':>9s} {'uJ/query':>9s}")
    for mb in (0.25, 0.5, 1, 2, 4):
        for bits in (8, 4):
            r = simulate_database_mb(mb, dim=512, bits=bits)
            out["scaling"].append((mb, bits, r.latency_s * 1e6, r.energy_j * 1e6))
            print(f"   {mb:5.2f} {bits:5d} {r.latency_s * 1e6:9.3f} "
                  f"{r.energy_j * 1e6:9.4f}")

    print("\n== dimension folding (4MB INT8) ==")
    for dim in (128, 256, 512, 1024):
        r = simulate_database_mb(4.0, dim=dim, bits=8)
        out["folding"].append((dim, r.latency_s * 1e6, r.plan.docs_per_core * 16))
        print(f"   dim {dim:5d}: {r.latency_s * 1e6:7.3f} us, "
              f"{r.plan.docs_per_core * 16:6d} docs resident")

    print("\n== error-detection cost (4MB INT8) ==")
    on = simulate_database_mb(4.0, detect=True)
    off = simulate_database_mb(4.0, detect=False)
    out["detect"] = {"on": (on.latency_s * 1e6, on.energy_j * 1e6),
                     "off": (off.latency_s * 1e6, off.energy_j * 1e6)}
    print(f"   detect ON : {on.latency_s * 1e6:.3f} us, "
          f"{on.energy_j * 1e6:.4f} uJ")
    print(f"   detect OFF: {off.latency_s * 1e6:.3f} us, "
          f"{off.energy_j * 1e6:.4f} uJ  "
          f"(saves {(1 - off.latency_s / on.latency_s) * 100:.1f}% latency)")
    return out


if __name__ == "__main__":
    main()
