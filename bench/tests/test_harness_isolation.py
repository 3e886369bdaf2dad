"""Nothing the benchmark runs loads JAX or the JAX package; the reference
loads nothing of the port. Module names are compared by their top-level
name whole (`repro_torch` is not `repro`)."""
import ast
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_no_module_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not _imports(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_port():
    for path in (BENCH / "reference").rglob("*.py"):
        names = _imports(path)
        assert names <= {"__future__", "contextlib", "typing", "numpy", "torch"}, (path, names)


def test_a_run_loads_no_jax(tmp_path):
    """A toy run in a fresh process, then the run's own check."""
    code = f"""
import sys
sys.path[:0] = [{str(BENCH.parent / 'src')!r}, {str(BENCH.parent)!r}]
from bench.tests import _smoke
from bench import run
from pathlib import Path
out = _smoke.run(_smoke.make_root(Path({str(tmp_path)!r})), "toy.open", seconds=2.0)
assert out["correct"]
print(sorted(run.loaded_forbidden()))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "[]"
