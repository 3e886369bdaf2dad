#!/usr/bin/env python3
"""Variants of K4 (`src/repro_torch/csrc/topk_select.cu`: the blockwise
top-k and the fused local + global comparator) built side by side and
timed in turns on one CUDA card.

    python3 tools/topk_variants.py      # needs a CUDA card and nvcc

Each variant is the committed source with a few lines edited as text,
compiled by `nvcc` into its own library under `build/variants/` and
loaded with `ctypes`. Every variant is first held bit-equal to the plain
versions on scores with ties, -inf slots and signed zeros ("no redux",
which keeps each lane's own best to show what the two `redux.sync` of a
round cost, and "no merge", which skips the global comparator of the
fused launch, are only timed). Then, shape by shape, each
variant is timed as a single-launch median (CUDA events, a sleep kernel
ahead of each call, as `chip_smoke.time_ms` does) and per call over 50
back-to-back launches (`chip_smoke.amortised_ms`).
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from chip_smoke import amortised_ms, time_ms  # noqa: E402
from repro_torch.kernels import _build, topk_select  # noqa: E402

SOURCE = _build.CSRC / "topk_select.cu"
OUT = ROOT / "build" / "variants"
TREE = "      prev = warp_max(tree_max<R / 2>(m));"
REDUX = """  const unsigned hi = __reduce_max_sync(kFull, (unsigned)(best >> 32));
  const unsigned lo = __reduce_max_sync(kFull, (unsigned)(best >> 32) == hi ? (unsigned)best : 0u);
  return ((u64)hi << 32) | lo;"""
# name -> (text in the committed source, its replacement), applied in order
VARIANTS = {
    "committed": [],
    "chain over the slots": [(TREE, "      for (int r = 1; r < R; ++r) m[0] = max64(m[0], m[r]);\n"
                                    "      prev = warp_max(m[0]);")],
    "shuffle butterfly": [(REDUX, """  for (int off = 16; off > 0; off >>= 1) {
    best = max64(best, __shfl_xor_sync(kFull, best, off));
  }
  return best;""")],
    "no redux": [(REDUX, "  return best;")],
    "2 warps per CTA": [("constexpr int kWarps = 4;", "constexpr int kWarps = 2;")],
    "8 warps per CTA": [("constexpr int kWarps = 4;", "constexpr int kWarps = 8;")],
    "8 core warps": [("constexpr int kCoreWarps = 16;", "constexpr int kCoreWarps = 8;")],
    "4 core warps": [("constexpr int kCoreWarps = 16;", "constexpr int kCoreWarps = 4;")],
    "no merge": [("  if (warp != 0) return;\n", "  return;\n")],
    "merge from shared memory": [("  const bool in_regs = m <= 64;", "  const bool in_regs = false;")],
}
TIMED_ONLY = {"no redux", "no merge"}
# rows, n, block, k: the searches' blockwise shapes and k 64
BLOCKWISE = ((8, 8192, 512, 3), (32, 2048, 128, 3), (64, 4096, 256, 3),
             (288, 4096, 256, 3), (2, 2048, 64, 64))
FUSED = ((8, 8192, 3), (32, 2048, 3), (64, 4096, 3), (288, 4096, 3))   # 16 cores


def build() -> dict:
    """Compile every variant in parallel; return name -> loaded library."""
    OUT.mkdir(parents=True, exist_ok=True)
    text = SOURCE.read_text()
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        src = text
        for old, new in edits:
            if old not in src:
                raise SystemExit(f"variant {name!r}: {old!r} not in {SOURCE.name}")
            src = src.replace(old, new)
        cu, so = OUT / f"topk{i}.cu", OUT / f"libtopk{i}.so"
        cu.write_text(src)
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", str(cu), "-o", str(so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"variant {name!r}: nvcc failed\n{log}")
        regs = [ln.split("Used ")[1] for ln in log.splitlines() if "registers" in ln]
        print(f"{name}: {' ; '.join(regs)}")
        lib = ctypes.CDLL(str(so))
        for fn in ("topk_select_launch", "hierarchical_select_launch"):
            getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def launch(lib, fn: str, s: torch.Tensor, shape: tuple, *args: int):
    vals = torch.empty(shape, dtype=torch.float32, device=s.device)
    idx = torch.empty(shape, dtype=torch.int32, device=s.device)
    status = getattr(lib, fn)(s.data_ptr(), vals.data_ptr(), idx.data_ptr(), s.shape[0],
                              s.shape[1], *args, torch.cuda.current_stream().cuda_stream)
    _build.check(status, fn)
    return vals, idx


def blockwise(lib, s, block, k):
    return launch(lib, "topk_select_launch", s, (s.shape[0], s.shape[1] // block, k), block, k)


def fused(lib, s, k, n_cores=16):
    kk = min(k, s.shape[1] // n_cores)
    return launch(lib, "hierarchical_select_launch", s, (s.shape[0], k), n_cores, kk, k)


def same(a, b) -> bool:
    return torch.equal(a[0].view(torch.int32), b[0].view(torch.int32)) and torch.equal(a[1], b[1])


def main() -> int:
    if not torch.cuda.is_available():
        print("topk_variants: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    libs = build()
    g = torch.Generator(device="cuda").manual_seed(0)
    inputs = []
    for rows, n in ((8, 8192), (32, 2048), (3, 4096)):
        s = torch.randn((rows, n), generator=g, device="cuda").round(decimals=1)
        s[:, 5::11] = float("-inf")
        inputs.append(s)
    inputs.append(torch.where(torch.rand((4, 2048), generator=g, device="cuda") < 0.5,
                              0.0, -0.0))
    for s in inputs:
        for block, k in ((128, 3), (256, 40), (512, 3), (64, 64)):
            want = topk_select.blockwise_topk_ref(s, k, block)
            for name, lib in libs.items():
                if name not in TIMED_ONLY and not same(blockwise(lib, s, block, k), want):
                    raise SystemExit(f"variant {name!r}: blockwise differs at {tuple(s.shape)}, "
                                     f"block {block}, k {k}")
        for k in (3, 40):
            want = topk_select.hierarchical_select_ref(s, k, 16)
            for name, lib in libs.items():
                if name not in TIMED_ONLY and not same(fused(lib, s, k), want):
                    raise SystemExit(f"variant {name!r}: fused differs at {tuple(s.shape)}, "
                                     f"k {k}")
    print("every variant but", sorted(TIMED_ONLY), "bit-equal to the plain versions")
    print("ms = single-launch median, us = per call over 50 back-to-back launches")
    cases = [(f"blockwise rows {r} n {n} block {b} k {k}", (r, n),
              lambda lib, s, b=b, k=k: blockwise(lib, s, b, k)) for r, n, b, k in BLOCKWISE]
    cases += [(f"fused rows {r} n {n} k {k}", (r, n), lambda lib, s, k=k: fused(lib, s, k))
              for r, n, k in FUSED]
    for label, shape, call in cases:
        s = torch.randn(shape, generator=g, device="cuda")
        row = [label]
        for name, lib in libs.items():
            fn = (lambda lib=lib: call(lib, s))
            row.append(f"{name} {time_ms(fn):.4f} ms {amortised_ms(fn) * 1e3:.2f} us")
        print(" | ".join(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
