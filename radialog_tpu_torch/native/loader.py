"""ctypes bindings of the C++ image loader (src/cxr_loader.cpp), and its
Python route (port of radialog_tpu/native/loader.py).

``build_native`` compiles the library with g++ and libjpeg into
``build/native/`` at the repository root, named by a hash of the source,
the flags and the host CPU (the flags hold ``-march=native``), so an edited
source is rebuilt and a library built for another CPU is never loaded.
Where g++ or libjpeg is missing, the loader takes the Python route (PIL,
ops/image.py), as the JAX package does, and says so: ``CxrLoader.route``
is "native" or "pil". Nothing is built at import time.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Deque, Iterator, Optional, Sequence, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "src" / "cxr_loader.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-ljpeg", "-lpthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def _cpu_tag() -> bytes:
    """The host CPU's model and flags (what -march=native compiles for)."""
    try:
        text = Path("/proc/cpuinfo").read_text()
    except OSError:
        return b""
    keep = [ln for ln in text.splitlines() if ln.startswith(("model name", "flags"))]
    return "\n".join(keep[:2]).encode()


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(FLAGS + LIBS).encode()
                            + _cpu_tag()).hexdigest()[:12]
    return BUILD_DIR / f"libcxr_loader-{digest}.so"


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_int, c_u64 = ctypes.c_int, ctypes.c_uint64
    f32p, u8p, i32p = (ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_ubyte),
                       ctypes.POINTER(ctypes.c_int))
    lib.cxr_loader_create.restype = ctypes.c_void_p
    lib.cxr_loader_create.argtypes = [ctypes.POINTER(ctypes.c_char_p), c_int, c_int, c_int,
                                      c_int, c_int, c_int, c_u64, c_int]
    lib.cxr_loader_next.restype = c_int
    lib.cxr_loader_next.argtypes = [ctypes.c_void_p, f32p, i32p]
    lib.cxr_loader_next_u8.restype = c_int
    lib.cxr_loader_next_u8.argtypes = [ctypes.c_void_p, u8p, i32p]
    lib.cxr_loader_reset.restype = None
    lib.cxr_loader_reset.argtypes = [ctypes.c_void_p, c_u64]
    lib.cxr_loader_destroy.restype = None
    lib.cxr_loader_destroy.argtypes = [ctypes.c_void_p]
    lib.cxr_preprocess_file.restype = c_int
    lib.cxr_preprocess_file.argtypes = [ctypes.c_char_p, c_int, c_int, f32p]
    lib.cxr_preprocess_file_u8.restype = c_int
    lib.cxr_preprocess_file_u8.argtypes = [ctypes.c_char_p, c_int, c_int, u8p]
    return lib


def build_native(force: bool = False) -> Optional[ctypes.CDLL]:
    """Compile (where the library for this source is missing) and load it;
    None where g++ or libjpeg is missing (``build_error`` says why)."""
    global _lib, _build_error
    with _lock:
        if _lib is not None and not force:
            return _lib
        if _build_error is not None and not force:
            return None
        out = library_path()
        if force or not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            try:
                subprocess.run(["g++", *FLAGS, str(SRC), "-o", str(tmp), *LIBS],
                               check=True, capture_output=True, text=True)
            except FileNotFoundError as e:
                _build_error = f"g++ not found ({e})"
                return None
            except subprocess.CalledProcessError as e:
                _build_error = f"g++ failed (rc {e.returncode}): {e.stderr[-2000:]}"
                return None
            os.replace(tmp, out)
        try:
            _lib = _declare(ctypes.CDLL(str(out)))
        except OSError as e:
            _build_error = f"loading {out.name} failed: {e}"
            return None
        _build_error = None
        return _lib


def build_error() -> Optional[str]:
    """Why the last build or load failed, or None."""
    return _build_error


def native_available() -> bool:
    return build_native() is not None


def preprocess_file(path: str, resize: int = 512, crop: int = 448) -> np.ndarray:
    """One image file -> (crop, crop, 3) float32 in [0, 1]: the C++ route
    where the library builds and decodes the file, else PIL."""
    lib = build_native()
    if lib is not None:
        out = np.empty((crop, crop, 3), np.float32)
        if lib.cxr_preprocess_file(str(path).encode(), resize, crop,
                                   out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))) == 0:
            return out
    from ..ops.image import preprocess_file as pil_preprocess_file
    return pil_preprocess_file(path, resize, crop)


class CxrLoader:
    """Batched, multithreaded decode and preprocess of image files.

    >>> with CxrLoader(paths, batch=32, crop=448, emit_u8=True) as ld:
    ...     for images, indices in ld.epoch(seed=0):
    ...         step(images)   # (n, crop, crop) uint8, n <= batch

    ``emit_u8`` yields the single-channel uint8 crops (the PIL intermediate;
    ops/image.py ``expand_cxr_u8`` gives the f32 form on the device,
    bitwise), else (n, crop, crop, 3) float32. A file that fails to decode
    is skipped. ``route`` says which decoder runs: "native" (the C++ pool,
    shuffled by its std::mt19937_64) or "pil" (``threads`` Python threads
    over PIL, shuffled by numpy's default_rng; batches in shuffle order).
    """

    def __init__(self, paths: Sequence[str], batch: int = 32, resize: int = 512,
                 crop: int = 448, threads: int = 4, shuffle: bool = True, seed: int = 0,
                 emit_u8: bool = False):
        self.paths = [str(p) for p in paths]
        self.batch, self.resize, self.crop = batch, resize, crop
        self.threads, self.shuffle, self.emit_u8 = threads, shuffle, emit_u8
        self._lib = build_native()
        self._handle = None
        self.route = "pil" if self._lib is None else "native"
        if self._lib is not None:
            self._paths_buf = (ctypes.c_char_p * len(self.paths))(
                *[p.encode() for p in self.paths])   # kept alive beside the handle
            self._handle = self._lib.cxr_loader_create(
                self._paths_buf, len(self.paths), batch, resize, crop, threads, int(shuffle),
                seed, int(emit_u8))

    def close(self) -> None:
        if getattr(self, "_handle", None) is not None:
            self._lib.cxr_loader_destroy(self._handle)
            self._handle = None

    def __enter__(self) -> "CxrLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        self.close()

    def epoch(self, seed: int = 0) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """(images, indices into ``paths``) batches of one pass, reshuffled
        by ``seed``."""
        if self._handle is not None:
            yield from self._native_epoch(seed)
        else:
            yield from self._pil_epoch(seed)

    def _native_epoch(self, seed: int):
        self._lib.cxr_loader_reset(self._handle, seed)
        while True:
            idx = np.empty((self.batch,), np.int32)
            if self.emit_u8:
                images = np.empty((self.batch, self.crop, self.crop), np.uint8)
                n = self._lib.cxr_loader_next_u8(
                    self._handle, images.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
                    idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
            else:
                images = np.empty((self.batch, self.crop, self.crop, 3), np.float32)
                n = self._lib.cxr_loader_next(
                    self._handle, images.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
            if n <= 0:
                return
            yield images[:n], idx[:n]

    def _load(self, i: int) -> Optional[np.ndarray]:
        from ..ops.image import preprocess_file as pil_preprocess_file
        try:
            return pil_preprocess_file(self.paths[i], self.resize, self.crop)
        except (OSError, ValueError):   # PIL's UnidentifiedImageError is an OSError
            return None

    def _pil_epoch(self, seed: int):
        order = np.arange(len(self.paths))
        if self.shuffle:
            np.random.default_rng(seed).shuffle(order)
        todo = iter(order.tolist())
        with ThreadPoolExecutor(max_workers=max(1, self.threads)) as pool:
            ahead: Deque = collections.deque()

            def fill():             # at most two batches decoded ahead of the consumer
                while len(ahead) < 2 * self.batch:
                    i = next(todo, None)
                    if i is None:
                        return
                    ahead.append((i, pool.submit(self._load, i)))

            fill()
            sel, imgs = [], []
            while ahead:
                i, fut = ahead.popleft()
                img = fut.result()
                fill()
                if img is not None:
                    sel.append(i)
                    imgs.append(img)
                if len(sel) == self.batch or (not ahead and sel):
                    yield self._pil_batch(imgs, sel)
                    sel, imgs = [], []

    def _pil_batch(self, imgs, sel):
        images = np.stack(imgs)
        if self.emit_u8:   # the f32 values are u8/255 by construction: exact
            images = np.round(images[..., 0] * 255.0).astype(np.uint8)
        return images, np.asarray(sel, np.int32)
