"""The port stands alone: `repro_torch` and `chip_smoke.py` import no JAX
and nothing of the JAX package `repro`, and `chip_smoke.py` refuses to
run (exit != 0, no result line) without a card or without the repo."""
import pytest

torch = pytest.importorskip("torch")

import ast  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
SMOKE = ROOT / "chip_smoke.py"

BLOCKED_IMPORT = """
import sys
for name in ("jax", "jaxlib", "repro"):
    sys.modules[name] = None          # any import of them now raises
import importlib, pkgutil
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
assert {"repro_torch.launch.mesh", "repro_torch.models.sharding"} <= set(names)
for name in names:
    importlib.import_module(name)
import chip_smoke
assert not any(m == "jax" or m.startswith(("jax.", "repro.")) for m in sys.modules
               if sys.modules[m] is not None)
print(len(names))
"""


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **extra)
    env.pop("PYTHONSTARTUP", None)
    return env


def test_port_and_smoke_import_without_jax_or_repro():
    proc = subprocess.run([sys.executable, "-c", BLOCKED_IMPORT], cwd=ROOT,
                          env=_env(), capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 20     # every module was imported


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module)
    return roots


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [SMOKE],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_imports_jax_or_repro(path):
    for mod in _imported_roots(path):
        root = mod.split(".")[0]
        assert root not in ("jax", "jaxlib", "repro"), f"{path.name} imports {mod}"


def test_chip_smoke_fails_without_a_card(monkeypatch):
    """Here there is no CUDA device: the script must exit non-zero and
    print no result line. (On a machine with a card this would run the
    whole smoke, so it is skipped there.)"""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py would run for real")
    proc = subprocess.run([sys.executable, str(SMOKE)], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """Copied into a directory that holds nothing else of the repo, the
    script cannot find the port and fails before printing a result."""
    shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
    env = _env()
    env.pop("PYTHONPATH")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
