"""Host C++ built on demand with g++ and bound with ctypes: the grid-hash
KNN of `knn.cpp` (mean squared distance to the k nearest neighbors, which
sets the initial scales of a point cloud). It is host code, not a GPU
kernel.

The library is built at first use into `log_tpu_torch.BUILD_DIR/native`
under a name that carries a hash of the flags and the source, so an
edited source rebuilds; nothing is built at import. The flags name no
`-march`, so a library built on one machine runs on another.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from .. import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "knn.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib = None
_build_error = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / "native" / f"libknn_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                   check=True, capture_output=True, text=True)
    os.replace(tmp, out)  # atomic: concurrent builders never see a half file


def library():
    """The loaded KNN library, built first if needed; None where g++ or the
    build fails (the reason is kept in `build_error()`)."""
    global _lib, _build_error
    with _lock:
        if _lib is None and _build_error is None:
            out = library_path()
            try:
                if not out.exists():
                    _build(out)
                lib = ctypes.CDLL(str(out))
            except (OSError, subprocess.CalledProcessError) as exc:
                detail = getattr(exc, "stderr", "") or ""
                _build_error = f"{exc} {detail}".strip()
                return None
            lib.knn_mean_sq_dist.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ]
            lib.knn_mean_sq_dist.restype = None
            _lib = lib
        return _lib


def build_error() -> str | None:
    return _build_error


def knn_mean_sq_dist(xyz: np.ndarray, k: int = 3, n_threads: int = 0):
    """Mean squared distance of each point to its k nearest neighbors
    (float32, (N,)), or None when the library is unavailable."""
    lib = library()
    if lib is None:
        return None
    pts = np.ascontiguousarray(xyz, np.float32)
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f"expected (N, 3) points, got {pts.shape}")
    out = np.empty(pts.shape[0], np.float32)
    lib.knn_mean_sq_dist(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), pts.shape[0],
        int(k), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        int(n_threads),
    )
    return out
