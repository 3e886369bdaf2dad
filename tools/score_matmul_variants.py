#!/usr/bin/env python3
"""Tiling variants of K2 / K5 (`src/repro_torch/csrc/score_matmul.cu`)
built side by side and timed in turns on one CUDA card.

    python3 tools/score_matmul_variants.py      # needs a CUDA card and nvcc

Each variant is the committed source with a few constants edited as
text, compiled by `nvcc` into its own library under `build/variants/`
and loaded with `ctypes`. Every variant is first held bit-equal to the
plain version at a few edge shapes (the "no products" variant, which
skips the tensor-core products to show what they cost, is only timed).
Then, shape by shape, `torch._int_mm` and each variant are timed as
single-launch medians (CUDA events, a sleep kernel ahead of each call,
as `chip_smoke.time_ms` does) and per call over 50 back-to-back launches
(`chip_smoke.amortised_ms`), with `_int_mm` again at the end of the row.
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

from chip_smoke import amortised_ms, int_mm_call, time_ms  # noqa: E402
from repro_torch.core.quantization import int_norm  # noqa: E402
from repro_torch.kernels import _build, score_matmul  # noqa: E402

SOURCE = _build.CSRC / "score_matmul.cu"
OUT = ROOT / "build" / "variants"
# name -> (text in the committed source, its replacement), applied in order
VARIANTS = {
    "committed": [],
    "32-doc blocks": [("static constexpr int DOCS = 64;", "static constexpr int DOCS = 32;")],
    "3 stages": [("constexpr int kStages = 5;", "constexpr int kStages = 3;")],
    "9 stages": [("constexpr int kStages = 5;", "constexpr int kStages = 9;")],
    "no k-split at b > 16": [("static constexpr int KS = NQ == 2 ? 1 : 2;",
                              "static constexpr int KS = NQ >= 2 ? 1 : 2;")],
    "no products": [("      if (j % 2) mma_frag<NQ>(acc2, f[j], ng, live_nt);\n"
                     "      else mma_frag<NQ>(acc, f[j], ng, live_nt);",
                     "      acc[0][0] += f[j].a[0] ^ f[j].b[0][0];")],
}
TIMED_ONLY = {"no products"}
SHAPES = ((8, 8192, 512), (1, 8192, 512), (16, 8192, 512), (17, 8192, 512),
          (64, 8192, 512), (72, 16384, 512), (8, 8192, 1024), (8, 16384, 512))


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
        cu, so = OUT / f"v{i}.cu", OUT / f"libv{i}.so"
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
        for fn in ("score_matmul_launch", "score_matmul_cosine_launch"):
            getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def k2(lib, q: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    out = torch.empty((q.shape[0], d.shape[0]), dtype=torch.int32, device=q.device)
    status = lib.score_matmul_launch(q.data_ptr(), d.data_ptr(), out.data_ptr(),
                                     q.shape[0], q.shape[1], d.shape[0],
                                     torch.cuda.current_stream().cuda_stream)
    _build.check(status, "score_matmul_launch")
    return out


def k5(lib, q, d, qn, dn) -> torch.Tensor:
    out = torch.empty((q.shape[0], d.shape[0]), dtype=torch.float32, device=q.device)
    status = lib.score_matmul_cosine_launch(q.data_ptr(), d.data_ptr(), qn.data_ptr(),
                                            dn.data_ptr(), out.data_ptr(), q.shape[0],
                                            q.shape[1], d.shape[0],
                                            torch.cuda.current_stream().cuda_stream)
    _build.check(status, "score_matmul_cosine_launch")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("score_matmul_variants: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    libs = build()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def codes(*shape):
        return torch.randint(-128, 128, shape, generator=g, device=dev, dtype=torch.int8)

    for b, n, dim in ((1, 37, 16), (17, 8229, 48), (72, 1000, 512), (65, 37, 1024)):
        q, d = codes(b, dim), codes(n, dim)
        qn, dn = int_norm(q, keepdim=True), int_norm(d)[None]
        want = score_matmul.score_matmul_int_ref(q, d)
        want5 = score_matmul.score_matmul_cosine_ref(q, d, qn, dn)
        for name, lib in libs.items():
            if name not in TIMED_ONLY and not (torch.equal(k2(lib, q, d), want)
                                               and torch.equal(k5(lib, q, d, qn, dn), want5)):
                raise SystemExit(f"variant {name!r} differs at b {b}, n {n}, dim {dim}")
    print("every variant but", sorted(TIMED_ONLY), "bit-equal to the plain versions")
    print("ms = single-launch median, us = per call over 50 back-to-back launches")
    for b, n, dim in SHAPES:
        q, d = codes(b, dim), codes(n, dim)
        _, lib_fn = int_mm_call(q, d)
        row = [f"b {b} n {n} dim {dim}: _int_mm {time_ms(lib_fn):.4f} ms "
               f"{amortised_ms(lib_fn) * 1e3:.2f} us"]
        for name, lib in libs.items():
            fn = (lambda lib=lib: k2(lib, q, d))
            row.append(f"{name} {time_ms(fn):.4f} ms {amortised_ms(fn) * 1e3:.2f} us")
        row.append(f"_int_mm {time_ms(lib_fn):.4f} ms {amortised_ms(lib_fn) * 1e3:.2f} us")
        print(" | ".join(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
