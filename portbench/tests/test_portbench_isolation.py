"""What a run may load: no module whose top-level name is jax, jaxlib,
flax or repro (the JAX package), compared by the whole name; the port
(repro_torch) only through program.py; and the reference nothing of the
program at all."""
from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

from portbench import run

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
PROGRAM = ("repro_torch", "repro", "jax", "jaxlib", "flax")


def _imports(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            tops.add(node.module.split(".")[0])
    return tops


def test_only_program_py_imports_the_port_and_nothing_imports_jax():
    for path in HERE.rglob("*.py"):
        rel = path.relative_to(HERE).as_posix()
        found = _imports(path) & set(PROGRAM)
        if rel == "program.py" or rel.startswith("tests/"):
            found -= {"repro_torch"}
        assert not found, (rel, found)


def test_importing_the_harness_and_the_port_loads_no_jax():
    code = ("import sys; import portbench.run, portbench.bench, portbench.program, "
            "portbench.control; from portbench import bench; "
            "[bench.reader(m) for m in ('k2_roofline_pct', 'step_mfu_pct')]; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'repro')))")
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_probe.x", object())
    assert run.forbidden_modules() == [m for m in run.forbidden_modules()
                                       if not m.startswith("repro_torch")]
    monkeypatch.setitem(sys.modules, "repro.probe", object())
    assert "repro.probe" in run.forbidden_modules()


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "tg-4m-rebuild",
                          "--seed", "2147483659", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
