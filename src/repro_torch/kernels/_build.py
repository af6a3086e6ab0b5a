"""Build and load the port's CUDA kernels (nvcc + ctypes).

At first use every ``csrc/*.cu`` is compiled for ``sm_90a`` by its own
``nvcc`` process (all started together, in a temporary directory), the
objects are linked into one shared library with a plain C interface under
``<repo>/build/repro_torch/`` and the library is loaded with ``ctypes``.
The file is named by a hash of the sources and flags, so an edit rebuilds
it; the finished library is moved into place atomically, so concurrent
processes never load a half-written file. A failed build raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("cell_pack.cu", "rcll_force.cu")
HEADERS = ("tiling.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when an up-to-date library was found
    log: str  # nvcc/ptxas output of the build ("" when not rebuilt)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _run(*cmds: list[str]) -> tuple[bool, str]:
    """Run the commands at once; (all succeeded, their joined output)."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    log = "\n".join(f"== {Path(c[-1]).name} (rc {p.returncode})\n{out}"
                    for c, p, out in zip(cmds, procs, outs))
    return all(p.returncode == 0 for p in procs), log


def _build(target: Path) -> str:
    nvcc = _nvcc()
    target.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=target.parent) as tmp:
        objs = [str(Path(tmp) / f"{Path(name).stem}.o") for name in SOURCES]
        ok, log = _run(*([nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", obj]
                         for name, obj in zip(SOURCES, objs)))
        if ok:
            ok, link_log = _run([nvcc, "-shared", *objs, "-o", str(Path(tmp) / target.name)])
            log += "\n" + link_log
        if not ok:
            raise RuntimeError("building the kernel library failed:\n" + log)
        os.replace(Path(tmp) / target.name, target)
    target.with_suffix(".log").write_text(log)
    return log


@functools.cache
def library() -> KernelLibrary:
    """The loaded kernel library, built first if it is missing or stale."""
    target = BUILD_DIR / f"repro_torch_kernels_{_digest()}.so"
    seconds, log = 0.0, ""
    if not target.exists():
        t0 = time.perf_counter()
        log = _build(target)
        seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(target))
    return KernelLibrary(lib=lib, path=target, build_seconds=seconds, log=log)


def check_rc(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
