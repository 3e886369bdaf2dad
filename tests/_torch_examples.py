"""Shared pieces of the example-twin tests (tests/test_torch_example_*.py):
the reference example and its twin (`examples_torch/`) loaded from their
files, a call of either's `main` with its printed lines captured, and
one torch thread for the twins' small CPU runs (faster alone, and the
tier-1 run's six workers share the host's cores)."""
from __future__ import annotations

import contextlib
import importlib.util
import io
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def load(folder: str, name: str):
    """`<folder>/<name>.py` of the repo as a module of its own."""
    spec = importlib.util.spec_from_file_location(f"{folder}_{name}",
                                                  ROOT / folder / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference(name: str):
    return load("examples", name)


def twin(name: str):
    return load("examples_torch", name)


@contextlib.contextmanager
def one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def printed(fn, *args, **kwargs) -> tuple:
    """(fn's return value, the lines it printed)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kwargs)
    return out, buf.getvalue().splitlines()
