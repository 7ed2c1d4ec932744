"""log_tpu_torch: the PyTorch + CUDA port of log_tpu for NVIDIA Hopper.

Mirrors the module layout of `log_tpu` (ops/, model/, render/, utils/,
dataset/). Plain tensor code is PyTorch; the Pallas kernels of the JAX
package are hand-written CUDA kernels under `csrc/`, compiled with nvcc at
first use into `BUILD_DIR` and bound with ctypes (`ops/kernels.py`).
Importing the package needs neither nvcc nor a GPU.
"""
from __future__ import annotations

from pathlib import Path

__version__ = "0.1.0"

# kernel build directory: <checkout>/build/log_tpu_torch (listed in .gitignore)
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "log_tpu_torch"
