"""ctypes binding for the native libav video decoder.

Port of ``videollamb_tpu/native/video_decoder.py`` over its own copy of the
C++ source (``src/video_decoder.cc``, with the padded-stride repair its
header describes). The library is built at first use with ``make`` into
``build/native/`` at the repository root, under a name that carries the
source's hash, and renamed into place when complete, so concurrent first
uses never load a half-written file. Where it cannot be built (no libav
headers, no compiler) ``available()`` is False and
``data/video_reader.load_video`` reads through OpenCV, as the JAX
package's reader does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def library_path() -> Path:
    digest = hashlib.sha256((SRC_DIR / "src" / "video_decoder.cc").read_bytes()
                            + (SRC_DIR / "Makefile").read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libvideodecoder-{digest}.so"


def _build(path: Path) -> bool:
    tmp = f"{path.name}.{os.getpid()}.tmp"
    try:
        subprocess.run(["make", "-s", "-C", str(SRC_DIR), f"OUT={BUILD_DIR}", f"LIB={tmp}"],
                       check=True, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        os.replace(BUILD_DIR / tmp, path)
        return True
    except (OSError, subprocess.CalledProcessError):
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        path = library_path()
        if not path.exists() and not _build(path):
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            _load_failed = True
            return None
        lib.vd_probe.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.vd_probe.restype = ctypes.c_int
        lib.vd_read_frames.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ]
        lib.vd_read_frames.restype = ctypes.c_int
        lib.vd_last_error.restype = ctypes.c_char_p
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _probe(path: str) -> Tuple[int, float, int, int]:
    lib = _load()
    if lib is None:
        raise RuntimeError("the native video decoder could not be built")
    total, fps = ctypes.c_int64(), ctypes.c_double()
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = lib.vd_probe(path.encode(), ctypes.byref(total), ctypes.byref(fps),
                      ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise ValueError(f"probe failed for {path}: {lib.vd_last_error().decode()}")
    return int(total.value), float(fps.value), int(h.value), int(w.value)


def probe(path: str) -> Tuple[int, float]:
    """(total frames, average fps)."""
    return _probe(path)[:2]


def probe_dims(path: str) -> Tuple[int, int]:
    """(height, width)."""
    return _probe(path)[2:]


def read_frames(path: str, indices: Sequence[int], n_threads: int = 0) -> np.ndarray:
    """Decode the frames at the given indices (sorted) -> (n, H, W, 3) uint8 RGB."""
    lib = _load()
    h, w = probe_dims(path)
    idx = np.asarray(sorted(int(i) for i in indices), dtype=np.int64)
    out = np.empty((len(idx), h, w, 3), dtype=np.uint8)
    if n_threads <= 0:
        n_threads = min(os.cpu_count() or 1, 8)
    rc = lib.vd_read_frames(
        path.encode(), idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(idx),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n_threads)
    if rc != 0:
        raise ValueError(f"decode failed for {path}: {lib.vd_last_error().decode()}")
    return out
