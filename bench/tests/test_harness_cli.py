"""The command: no card, or no port beside the benchmark, and it prints
no result and exits with a code other than 0."""
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
ARGS = ["--workload", "phi4-mini-rag.docqa-open", "--seed", str(2**31 + 3),
        "--seconds", "1", "--trace", "0"]


def _run(root: Path, env=None):
    return subprocess.run([sys.executable, "bench/run.py", *ARGS], cwd=root,
                          capture_output=True, text=True, timeout=300, env=env)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here")
    res = _run(ROOT)
    assert res.returncode == 2 and res.stdout == ""
    assert "CUDA" in res.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = _run(tmp_path)
    assert res.returncode != 0 and res.stdout == ""
