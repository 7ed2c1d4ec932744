"""Build, load and count the hand-written CUDA kernels of `csrc/`.

The sources compile with nvcc into ONE shared library with a plain C
interface (no PyTorch headers, so the build takes seconds), loaded with
ctypes. The library is built at first use into `log_tpu_torch.BUILD_DIR`
under a name that carries a hash of the sources and flags, so an edited
source rebuilds. Nothing here runs at import time: importing needs neither
nvcc nor a GPU.

Every kernel wrapper (ops/expand.py, ops/rasterize_tiled.py) adds one to its
entry of `LAUNCHES` where it launches its kernel, and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from .. import BUILD_DIR

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("pack.cu", "expand.cu", "rasterize_fwd.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

# launches per kernel wrapper since the last reset_launches()
LAUNCHES = {"pack_rows": 0, "expand_with_keys": 0, "rasterize_fwd": 0}

_VP = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SIGNATURES = {
    "log_pack_rows": [ctypes.POINTER(_VP), _I, _I, _LL, _LL, _VP, _VP],
    "log_expand_with_keys": [_VP, _VP, _I, _VP, _I, _I, _I, _VP, _VP, _VP,
                             _VP, _VP],
    "log_rasterize_fwd": [_VP, _LL, _VP, _VP, _I, _I, _I, _VP, _I, _VP, _VP,
                          _VP, _VP, _VP, _VP, _VP],
}

_lock = threading.Lock()
_lib = None
# what the last build in this process printed (ptxas register/smem report)
build_log = ""


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _source_tag() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"liblog_tpu_torch_{_source_tag()}.so"


def build(force: bool = False) -> float:
    """Compile the kernels if the library for the current sources is
    missing (or always, with force). Returns the seconds spent in nvcc."""
    global build_log
    out = library_path()
    if out.exists() and not force:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, out)  # atomic: concurrent builders never see a half file
    return seconds


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(str(library_path()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {rc}")


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor."""
    for t in tensors:
        if not (t.is_cuda and t.is_contiguous()):
            raise ValueError(
                f"{name}: expected contiguous CUDA tensors, got "
                f"{t.device} contiguous={t.is_contiguous()}"
            )
