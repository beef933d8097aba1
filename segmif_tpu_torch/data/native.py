"""ctypes binding of the native data-loading runtime
(counterpart of ``segmif_tpu/data/native.py``).

``runtime/dataloader.cpp`` decodes PNG (libpng) and JPEG (libjpeg), resizes
bilinearly with half-pixel centres and runs a ``std::thread`` batch
pipeline behind a plain C ABI (``sfl_*``). This module compiles that
source where it lies, with ``g++``, into ``data/build/<hash>/`` (the hash
covers the source and the flags), under a temporary name renamed into
place, so that processes building at once never load a half-written
library. It wraps:

 - ``probe_image(path)`` -> (H, W, C) of the file;
 - ``decode_image(path, size=None, channels=3)`` -> float32 [H, W, C] in
   [0, 255], resized to ``size`` if given;
 - ``NativeLoader``: an endless shuffled batch iterator over per-sample
   path tuples, decoded on native threads.

When the build fails (no compiler, no libpng / libjpeg headers),
``available()`` is False and ``build_error()`` holds the compiler's
message; the functions then raise ``NativeUnavailable`` with it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "runtime" / "dataloader.cpp"
BUILD_ROOT = Path(__file__).resolve().parent / "build"
LIB_NAME = "libsegmif_io.so"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]
LIBS = ["-lpng", "-ljpeg", "-lpthread"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


class NativeUnavailable(RuntimeError):
    """The native library did not build or load."""


def _lib_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS + LIBS).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def _build(path: Path) -> Optional[str]:
    """Compile SOURCE into ``path``; the compiler's message on failure."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{LIB_NAME}.{os.getpid()}.{threading.get_ident()}"
                         ".tmp")
    cmd = ["g++"] + CXX_FLAGS + [str(SOURCE)] + LIBS + ["-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"{' '.join(cmd)}: {e}"
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return f"{' '.join(cmd)}:\n{proc.stderr[-2000:]}"
    os.replace(tmp, path)
    return None


def _declare(lib: ctypes.CDLL) -> None:
    c_int, p_int = ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    p_f32 = ctypes.POINTER(ctypes.c_float)
    lib.sfl_decode.restype = c_int
    lib.sfl_decode.argtypes = [ctypes.c_char_p, p_f32] + [c_int] * 4
    lib.sfl_probe.restype = c_int
    lib.sfl_probe.argtypes = [ctypes.c_char_p, p_int, p_int, p_int]
    lib.sfl_loader_create.restype = ctypes.c_void_p
    lib.sfl_loader_create.argtypes = [ctypes.POINTER(ctypes.c_char_p)] + \
        [c_int] * 9 + [ctypes.c_uint64]
    lib.sfl_loader_next.restype = c_int
    lib.sfl_loader_next.argtypes = [ctypes.c_void_p, p_f32]
    lib.sfl_loader_destroy.restype = None
    lib.sfl_loader_destroy.argtypes = [ctypes.c_void_p]


def _load() -> Optional[ctypes.CDLL]:
    """The library, built on first use; None (and ``_build_error`` set)
    if it cannot be built or loaded. Tried once per process."""
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            path = _lib_path()
            err = None if path.exists() else _build(path)
            if err is None:
                lib = ctypes.CDLL(str(path))
                _declare(lib)
                _lib = lib
            else:
                _build_error = err
        except OSError as e:
            _build_error = f"{type(e).__name__}: {e}"
        return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the library is unavailable (None if it built)."""
    _load()
    return _build_error


def library() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise NativeUnavailable(f"the native data library "
                                f"(runtime/dataloader.cpp) did not build: "
                                f"{_build_error}")
    return lib


def probe_image(path: str | Path) -> Tuple[int, int, int]:
    """(H, W, C) of a PNG or JPEG file; IOError if the decoder refuses
    it."""
    lib = library()
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if lib.sfl_probe(str(path).encode(), ctypes.byref(h), ctypes.byref(w),
                     ctypes.byref(c)) != 0:
        raise IOError(f"native probe failed for {path}")
    return h.value, w.value, c.value


def decode_image(path: str | Path, size: Optional[Tuple[int, int]] = None,
                 channels: int = 3) -> np.ndarray:
    """Decode PNG/JPEG to float32 [H, W, channels] in [0, 255]; with
    ``size``, resized bilinearly (half-pixel centres)."""
    lib = library()
    h, w = probe_image(path)[:2] if size is None else size
    out = np.empty((h, w, channels), np.float32)
    rc = lib.sfl_decode(str(path).encode(),
                        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                        h, w, channels, 0 if size is None else 1)
    if rc != 0:
        raise IOError(f"native decode failed for {path} (rc={rc})")
    return out


class NativeLoader:
    """Endless shuffled batch iterator over per-sample path tuples, decoded
    (and resized, if ``resize``) on ``num_threads`` native threads.

    paths: [n_samples][items] file paths; yields float32 arrays
    [batch, items, H, W, C] in [0, 255]. The shuffle is the C++ runtime's
    (an xorshift permutation per epoch from ``seed``); with more than one
    thread, batches arrive in the order the threads finish them."""

    def __init__(self, paths: Sequence[Sequence[str]], batch_size: int,
                 size: Tuple[int, int], channels: int = 3,
                 num_threads: int = 4, queue_depth: int = 4, seed: int = 1,
                 resize: bool = True):
        lib = library()
        self._lib = lib
        self.n = len(paths)
        self.items = len(paths[0])
        self.batch_size = batch_size
        self.h, self.w = size
        self.c = channels
        flat = [str(p).encode() for sample in paths for p in sample]
        arr = (ctypes.c_char_p * len(flat))(*flat)
        self._handle = lib.sfl_loader_create(
            arr, self.n, self.items, batch_size, self.h, self.w, channels,
            1 if resize else 0, num_threads, queue_depth, seed)
        if not self._handle:
            raise NativeUnavailable("sfl_loader_create returned NULL")

    def __iter__(self) -> Iterator[np.ndarray]:
        while self._handle:
            out = np.empty(
                (self.batch_size, self.items, self.h, self.w, self.c),
                np.float32)
            rc = self._lib.sfl_loader_next(
                self._handle,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
            if rc != 0:
                return
            yield out

    def close(self):
        if self._handle:
            self._lib.sfl_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
