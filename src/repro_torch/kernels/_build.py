"""Build and load the port's CUDA kernels (`csrc/*.cu`).

Each source is compiled by `nvcc` for `sm_90a` into an object file, all
sources at once in parallel, and the objects are linked into one shared
library with a plain C interface under `build/repro_torch/` at the root
of the checkout. The library is named by a hash of the sources and the
flags, so an edited source builds anew and an unchanged one is reused.
Loaded with `ctypes`; nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
BUILD_SECONDS: Optional[float] = None   # wall time of the build in this process
BUILD_LOG = ""                          # nvcc's output (ptxas register report)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # q_planes, d_planes, out, b, bits, nw, n, stream
    "dirc_mac_launch": [_P, _P, _P, _I, _I, _I, _I, _P],
    # q, docs, out, b, dim, n, stream
    "score_matmul_launch": [_P, _P, _P, _I, _I, _I, _P],
    # q, docs, q_norms, doc_norms, out, b, dim, n, stream
    "score_matmul_cosine_launch": [_P] * 5 + [_I] * 3 + [_P],
    # scores, vals, idx, rows, n, block_n, k, stream
    "topk_select_launch": [_P, _P, _P, _I, _I, _I, _I, _P],
    # scores, vals, ids, rows, n, n_cores, kk, k, stream
    "hierarchical_select_launch": [_P] * 3 + [_I] * 5 + [_P],
    # q, k_new, v_new, k_pool, v_pool, table, length, n_valid, acc, m, den,
    # b, t, h, kh, hd, block_size, table width, chunk blocks, bf16, scale, stream
    "paged_attend_launch": [_P] * 11 + [_I] * 9 + [_F, _P],
    # acc, m, den, out, b, chunks, t, h, hd, bf16, stream
    "paged_combine_launch": [_P] * 4 + [_I] * 6 + [_P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libreprotorch_{h.hexdigest()[:16]}.so"


def _build(target: Path) -> str:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        outs = [p.communicate()[0] for p in procs]   # wait for every compile
        logs = []
        for src, p, out in zip(_sources(), procs, outs):
            logs.append(f"== {src.name}\n{out}")
            if p.returncode:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
        tmp_lib = Path(tmp) / target.name
        link = subprocess.run(
            [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
             *map(str, objs), "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, target)   # atomic: concurrent builds agree
    return "\n".join(logs)


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process."""
    global _lib, BUILD_SECONDS, BUILD_LOG
    with _lock:
        if _lib is None:
            target = library_path()
            t0 = time.perf_counter()
            if not target.exists():
                BUILD_LOG = _build(target)
            BUILD_SECONDS = time.perf_counter() - t0
            lib = ctypes.CDLL(str(target))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(status: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")
