"""Native (C++) host components, bound with ctypes.

Counterpart of `gaussianeditor_tpu/native/__init__.py`, with the port's
own copy of `simple_knn.cpp`: the host-side KNN that initialises
Gaussian scales from a point cloud (the reference's CUDA simple-knn).
It is host code, not a device kernel. At first use `g++` compiles it
into `build/native/libsimple_knn-<digest>.so` beside the package (the
directory is git-ignored; the digest covers the source and the flags, so
an edited source is rebuilt), never next to the source. When no compiler
is found `get_lib()` returns None and the callers take scipy, as in the
JAX package (`ops/knn.py` warns once when that happens).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "simple_knn.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def lib_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libsimple_knn-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    """Compile to a file of this process, then move it into place, so
    that processes building at once never load a half-written library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SRC)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (subprocess.SubprocessError, FileNotFoundError):
        return False
    os.replace(tmp, out)
    return True


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        out = lib_path()
        if not out.exists() and not _build(out):
            return None
        try:
            lib = ctypes.CDLL(str(out))
        except OSError:
            return None
        lib.mean_sq_dist_3nn.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ]
        lib.mean_sq_dist_3nn.restype = None
        lib.knn_sq_dists.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ]
        lib.knn_sq_dists.restype = None
        _lib = lib
        return _lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def mean_sq_dist_3nn_native(points: np.ndarray,
                            window: int = 64) -> Optional[np.ndarray]:
    """Mean squared distance to the 3 nearest neighbours (the reference's
    distCUDA2) through the native library; None if it is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points, np.float32)
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f"points must be [N, 3], got {pts.shape}")
    out = np.empty(pts.shape[0], np.float32)
    lib.mean_sq_dist_3nn(_fptr(pts), pts.shape[0], _fptr(out), window, 0)
    return out


def knn_sq_dists_native(points: np.ndarray, queries: np.ndarray,
                        k: int) -> Optional[np.ndarray]:
    """Squared distances [Q, k] from each query to its k nearest
    `points`, exact; None if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points, np.float32)
    qs = np.ascontiguousarray(queries, np.float32)
    if pts.shape[1:] != (3,) or qs.shape[1:] != (3,):
        raise ValueError(f"points and queries must be [N, 3], got "
                         f"{pts.shape} and {qs.shape}")
    out = np.empty((qs.shape[0], k), np.float32)
    lib.knn_sq_dists(_fptr(pts), pts.shape[0], _fptr(qs), qs.shape[0],
                     k, _fptr(out), 0)
    return out
