"""The port stands alone: no JAX and nothing of the JAX package is
imported by ``src/repro_torch`` or ``chip_smoke.py``, and its entry
points never fall back to the CPU on their own."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
#: The port's subpackages; each must be present in PORT_FILES.
SUBPACKAGES = ("core", "kernels", "models", "configs", "launch", "checkpoint", "runtime",
               "sph")


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_is_scanned(sub):
    pkg = ROOT / "src" / "repro_torch" / sub
    assert (pkg / "__init__.py") in PORT_FILES
    assert any(p.parent == pkg and p.name != "__init__.py" for p in PORT_FILES), sub


def _imported_modules(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    mods = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            mods.append(node.module)
    return mods


def _forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_package_imports(path):
    assert path.exists(), path
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
    text = path.read_text()
    assert "importlib" not in text and "__import__" not in text


def test_port_imports_without_jax_loaded():
    """Importing every port module in a fresh interpreter loads no jax."""
    code = (
        "import sys, importlib, pkgutil, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
    )
    env_path = str(ROOT / "src")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   env={"PYTHONPATH": env_path, "PATH": "/usr/bin:/bin"}, timeout=120)


def test_from_case_raises_without_cuda(monkeypatch):
    from repro_torch.core import api, solver

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.Simulation.from_case("taylor_green")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        solver.resolve_device(None)
    with pytest.raises(RuntimeError, match="not available"):
        solver.resolve_device("cuda")
    assert solver.resolve_device("cpu") == torch.device("cpu")
