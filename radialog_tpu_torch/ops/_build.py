"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled with
``nvcc`` for ``sm_90a`` into ``build/kernels/lib<name>-<hash>.so`` at the
repository root, at first use, and loaded with ``ctypes``. The hash of the
source is part of the file name, so an edited source is rebuilt. Nothing
here runs at import time: the CPU tests import every module of the port and
never build or load a kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNELS = ("q8_matmul", "flash_decode")

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return str(path)


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = open(BUILD_DIR / f"{name}.log", "w")
    proc = subprocess.Popen([nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                             str(CSRC / f"{name}.cu")],
                            stdout=log, stderr=subprocess.STDOUT)
    return proc, log, tmp, out


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, log, tmp, out = started
    try:
        rc = proc.wait()
    finally:
        log.close()
    text = (BUILD_DIR / f"{name}.log").read_text()
    if rc != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (rc {rc}):\n{text}")
    os.replace(tmp, out)


def build(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile the named kernels, one nvcc process each, all started
    together. Returns each kernel's ptxas report (registers, spills)."""
    names = list(names)
    started = {n: _start(n) for n in names}
    for n in names:
        _finish(n, started[n])
    reports = {}
    for n in names:
        log = BUILD_DIR / f"{n}.log"
        reports[n] = log.read_text() if log.exists() else ""
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
