"""The port's package surface: each sub-package's `__init__` binds the
names the reference's binds (read by AST from both sources, so no JAX
module is imported into the port; then looked up on the imported port
package), but for an explicit list of exclusions; and the deprecated
`BatchScheduler` shim behaves as the reference's (manual mode: batches
form only on `flush()`)."""
import ast
import importlib
import warnings
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent / "src"
PACKAGES = ["", "core", "serving", "launch", "models", "configs", "kernels", "optim",
            "data", "checkpointing", "perf"]
# names the port does not carry, and why
EXCLUDED = {
    "core": {"distributed"},   # a DEPRECATED shim forwarding to sharded_index (ROADMAP item 8)
}


def _bound_names(path: Path) -> set:
    """Names an `__init__` binds at module level: imports, and assignments
    such as `__version__`."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return names - {"annotations"}


@pytest.mark.parametrize("pkg", PACKAGES, ids=lambda p: p or "root")
def test_port_exports_what_the_reference_exports(pkg):
    ref = _bound_names(ROOT / "repro" / pkg / "__init__.py")
    port = _bound_names(ROOT / "repro_torch" / pkg / "__init__.py")
    want = ref - EXCLUDED.get(pkg, set())
    assert want <= port, sorted(want - port)
    mod = importlib.import_module("repro_torch" + (f".{pkg}" if pkg else ""))
    assert all(hasattr(mod, n) for n in want)


def test_version_and_deprecated_batch_scheduler():
    import repro_torch
    from repro_torch.serving import AsyncBatchScheduler, BatchScheduler, BatchTicket

    assert repro_torch.__version__ == "1.0.0"
    calls = []

    def search(texts, k):
        calls.append(len(texts))
        ids = np.arange(len(texts) * k).reshape(len(texts), k)
        return ids, ids.astype(np.float32)

    with pytest.warns(DeprecationWarning, match="AsyncBatchScheduler"):
        sched = BatchScheduler(search, max_batch=3)
    assert isinstance(sched, AsyncBatchScheduler)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tickets = [sched.submit(f"q{i}", k=2) for i in range(7)]
    assert isinstance(tickets[0], BatchTicket) and calls == []
    assert sched.flush() == 7 and calls == [3, 3, 1]
    ids, _ = tickets[4].result()
    np.testing.assert_array_equal(ids, [2, 3])
