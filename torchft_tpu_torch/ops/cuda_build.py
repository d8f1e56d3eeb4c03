"""Build and load the port's hand-written CUDA kernels.

Each ``torchft_tpu_torch/csrc/<name>.cu`` has a plain C interface and is
compiled by ``nvcc`` for ``sm_90a`` into a shared library under
``build/torchft_tpu_torch/`` at the repository root, keyed on a hash of the
source, then loaded with ``ctypes``.  The build happens at first use, never
at import, so the package imports on hosts without CUDA; sources that need a
build are compiled in parallel, one ``nvcc`` each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

_PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "torchft_tpu_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills into the build log
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if not CUDA_HOME:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME) to build the kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _artifact(name: str) -> Path:
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """nvcc's output (``-Xptxas -v``) from the build of ``name``."""
    return _artifact(name).with_suffix(".log").read_text()


def build(names: Iterable[str]) -> None:
    """Compile every source in ``names`` whose artifact is missing, one
    ``nvcc`` process each, all started together.  Raises with nvcc's output
    if any build fails."""
    pending = [(n, _artifact(n)) for n in names]
    pending = [(n, out) for n, out in pending if not out.exists()]
    if not pending:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name, out in pending:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failures = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    if failures:
        raise RuntimeError("\n".join(failures))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_artifact(name)))
            _libs[name] = lib
        return lib
