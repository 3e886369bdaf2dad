#!/usr/bin/env python3
"""K4 (`blockwise_topk`) and `core.topk.hierarchical_topk` timed on one
CUDA card, for one tree of the port: run it once per tree (parent,
change, change, parent) in one call to compare two commits.

    python3 tools/topk_ab.py                      # this checkout's src/
    python3 tools/topk_ab.py --src /path/to/other/checkout/src

At each shape the sharded and monolithic searches give K4 (and at k 64):
K4 and `torch.topk` on the block view in turns, single launches
(CUDA-event medians) and 50 back-to-back launches behind a sleep kernel,
then the plain version. At the monolithic and 4-macro search shapes: the
device kernels of one `hierarchical_topk` call (profiler) and its host
wall per call (200 calls back to back, one synchronize). The last line
is one JSON object of every number.

The timing helpers are `chip_smoke.py`'s. The port is imported from
`--src` before `chip_smoke` is, so `chip_smoke`'s own imports resolve to
that tree's package.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

# rows, n, block, k: the searches' K4 shapes (monolithic 8 x 8192 in 16
# cores of 512; 4 macros x 8 queries over 2048 and, grown, 4096 slots;
# open-loop flushes of 16 and update searches of 72 over 4096) and k 64
SHAPES = {"monolithic": (8, 8192, 512, 3), "four_macros": (32, 2048, 128, 3),
          "grown": (32, 4096, 256, 3), "flush_16": (64, 4096, 256, 3),
          "update_72": (288, 4096, 256, 3), "wide_k": (2, 2048, 64, 64)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"), help="the tree's src/ directory")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import repro_torch  # noqa: F401  (from --src; see the module docstring)
    import torch

    if not torch.cuda.is_available():
        print("topk_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core import topk
    from repro_torch.kernels import _build, topk_select

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(f"{smi}; port from {Path(repro_torch.__file__).parent}")
    _build.load_library()
    print(f"kernel build: {_build.BUILD_SECONDS:.2f} s")
    g = torch.Generator(device="cuda").manual_seed(0)
    res = {"device": smi, "src": args.src}
    for name, (rows, n, block, k) in SHAPES.items():
        s = torch.randn((rows, n), generator=g, device="cuda")
        t = cs.time_k4(s, k, block, f"{name} shape")
        res[f"k4_{name}"] = {key: t[key] for key in ("ms", "library_ms", "amortised_ms",
                                                     "library_amortised_ms", "plain_ms")}
    cs.device_kernels({})   # the profiler's warm-up runs
    for name, (rows, n) in (("monolithic", (8, 8192)), ("four_macros", (32, 2048))):
        s = torch.randn((rows, n), generator=g, device="cuda")
        fn = lambda s=s: topk.hierarchical_topk(s, 3, 16)  # noqa: E731
        kernels = cs.profiled_device_kernels(fn)
        wall = cs.host_wall_us(fn)
        launches = topk_select.LAUNCHES
        fn()
        launches = topk_select.LAUNCHES - launches
        print(f"hierarchical_topk at the {name} shape (rows {rows}, n {n}, 16 cores, k 3): "
              f"{sum(c for _, c in kernels)} device kernels {kernels}; {wall:.2f} us a call "
              f"on the host's clock, back to back; K4 launches a call {launches}")
        res[f"hier_{name}"] = {"device_kernels": sum(c for _, c in kernels),
                               "wall_us": wall, "k4_launches": launches}
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
