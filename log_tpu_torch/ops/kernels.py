"""Build, load and count the hand-written CUDA kernels of `csrc/`.

The sources compile with nvcc, one process per source, all started
together, and link into ONE shared library with a plain C interface (no
PyTorch headers, so the build takes seconds), loaded with ctypes. The
library is built at first use into `log_tpu_torch.BUILD_DIR` under a name
that carries a hash of the flags and of every source and header under
csrc/, so an edited file rebuilds. Nothing here runs at import time:
importing needs neither nvcc nor a GPU.

Every kernel wrapper (ops/expand.py, ops/rasterize_tiled.py, ops/compact.py,
ops/to_host.py) adds one to its entry of `LAUNCHES` where it launches its kernel, and
nowhere else.
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
SOURCES = ("pack.cu", "expand.cu", "rasterize_fwd.cu", "rasterize_bwd.cu",
           "compact.cu", "to_host.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

# launches per kernel wrapper since the last reset_launches()
LAUNCHES = {"pack_rows": 0, "expand_with_keys": 0, "rasterize_fwd": 0,
            "rasterize_bwd": 0, "expand_packed": 0,
            "rasterize_fwd_packed": 0, "stream_compact": 0, "to_host": 0}

_VP = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SIGNATURES = {
    "log_pack_rows": [ctypes.POINTER(_VP), _I, _I, _LL, _LL, _VP, _VP],
    "log_expand_with_keys": [_VP, _VP, _I, _VP, _I, _I, _I, _VP, _VP, _VP,
                             _VP, _VP],
    "log_rasterize_fwd": [_VP, _LL, _VP, _VP, _I, _I, _I, _VP, _I, _VP, _VP,
                          _VP, _VP, _VP, _VP, _VP],
    "log_rasterize_bwd": [_VP, _LL, _VP, _VP, _VP, _I, _I, _I, _VP, _VP, _VP,
                          _VP, _VP, _VP],
    "log_expand_packed_with_keys": [_VP, _LL, _I, _VP, _I, _I, _I, _VP, _VP,
                                    _VP, _VP],
    "log_rasterize_fwd_packed": [_VP, _LL, _VP, _VP, _I, _I, _I, _VP, _VP,
                                 _VP, _VP],
    "log_stream_compact": [_VP, _LL, _I, ctypes.POINTER(_VP), _I, _VP, _VP,
                           _VP, _VP, _VP],
    "log_to_host": [_I, ctypes.POINTER(_VP), ctypes.POINTER(_I),
                    ctypes.POINTER(_LL), ctypes.POINTER(_VP), _VP, _VP],
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
    """Hash of the flags and of every .cu and .cuh file under csrc/, so
    that an edited shared header rebuilds too."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.rglob("*.cu*")):
        h.update(path.relative_to(CSRC).as_posix().encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"liblog_tpu_torch_{_source_tag()}.so"


def build(force: bool = False) -> float:
    """Compile the kernels if the library for the current sources is
    missing (or always, with force): one nvcc per source in parallel, then
    one link. Returns the seconds spent in nvcc."""
    global build_log
    out = library_path()
    if out.exists() and not force:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{Path(s).stem}.o" for s in SOURCES]
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                          str(CSRC / src)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for src, obj in zip(SOURCES, objs)
    ]
    logs = [p.communicate()[0] for p in procs]
    failed = [src for src, p in zip(SOURCES, procs) if p.returncode != 0]
    if not failed:
        link = subprocess.run(
            [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
             "-o", str(tmp), *(str(o) for o in objs)],
            capture_output=True, text=True,
        )
        logs.append(link.stdout + link.stderr)
        if link.returncode != 0:
            failed.append("link")
    seconds = time.perf_counter() - t0
    for obj in objs:
        obj.unlink(missing_ok=True)
    build_log = "".join(logs)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{build_log}")
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
    """Raise unless every tensor is a contiguous CUDA tensor on the current
    device: the kernels launch on the current device's stream (`stream()`),
    so a tensor on another card would be read across the link, or fault."""
    current = None
    for t in tensors:
        if not (t.is_cuda and t.is_contiguous()):
            raise ValueError(
                f"{name}: expected contiguous CUDA tensors, got "
                f"{t.device} contiguous={t.is_contiguous()}"
            )
        if current is None:
            current = torch.cuda.current_device()
        if t.device.index != current:
            raise ValueError(
                f"{name}: a tensor lies on {t.device} while the current "
                f"device is cuda:{current}; the kernel launches on the "
                f"current device (torch.cuda.set_device, or "
                f"torch.cuda.device(...) around the call)")
