"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled with
``nvcc`` for ``sm_90a`` into ``lib<name>-<hash>.so`` in the build directory
(``build/kernels/`` at the repository root unless ``set_build_dir`` names
another), at first use, and loaded with ``ctypes``. The hash of the source
is part of the file name, so an edited source is rebuilt. The directory is
the port's counterpart of JAX's compilation cache: an empty one makes the
first use of each kernel run nvcc (a cold boot), a populated one is reused
(a warm boot). Nothing here runs at import time: the CPU tests import every
module of the port and never build or load a kernel.
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
DEFAULT_BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNELS = ("q8_matmul", "flash_decode", "flash_attention", "flash_attention_bwd",
           "q4_matmul", "w4_colscale")

_loaded: Dict[str, ctypes.CDLL] = {}
_build_dir = DEFAULT_BUILD_DIR


def set_build_dir(path) -> None:
    """Build into and load from ``path``. Once a library is loaded the
    directory is fixed: ctypes cannot unload a library, so a switch would
    leave the old one in use; naming another directory then raises."""
    global _build_dir
    path = Path(path).resolve()
    if _loaded and path != _build_dir:
        raise RuntimeError(f"kernels already loaded from {_build_dir} "
                           f"({', '.join(sorted(_loaded))}); cannot switch to {path}")
    _build_dir = path


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
    """The library's path: its name carries a hash of the source, the shared
    headers (csrc/*.cuh) and the flags, so any edit rebuilds it."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return _build_dir / f"lib{name}-{digest}.so"


def _start(name: str):
    out = library_path(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = open(out.parent / f"{name}.log", "w")
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
    text = (out.parent / f"{name}.log").read_text()
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
        log = _build_dir / f"{n}.log"
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


NO_DRIVER_ENTRY, ENCODE_FAILED = 990, 1000   # csrc/hopper.cuh


def check(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code, or a tensor map could
    not be encoded (the codes of csrc/hopper.cuh)."""
    if rc == NO_DRIVER_ENTRY:
        raise RuntimeError(f"{what}: libcuda.so.1 has no cuTensorMapEncodeTiled")
    if rc >= ENCODE_FAILED:
        raise RuntimeError(f"{what}: cuTensorMapEncodeTiled failed with CUresult "
                           f"{rc - ENCODE_FAILED}")
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
