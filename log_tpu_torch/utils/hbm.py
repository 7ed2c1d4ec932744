"""Device memory telemetry on torch.cuda; counterpart of log_tpu/utils/hbm.py.

- `live_bytes`: the bytes of live tensors PyTorch's allocator holds on the
  card (`torch.cuda.memory_allocated`), the scalar the reference logs;
- `device_limit`: the card's total memory (`torch.cuda.mem_get_info`);
- `hbm_usage`: in use, peak since the last reset, and the limit, in GiB;
- `call_stats(fn)`: the peak allocated over one call of fn. It stands for
  the JAX package's `executable_stats`, which reads XLA's buffer
  assignment; eager PyTorch has no executable, so the peak is measured.

Every function needs a CUDA device and raises on any other: a CPU run has
no device memory to report, and zeros would read as a measurement.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

GIB = 2 ** 30


def _cuda(device) -> torch.device:
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        raise ValueError(f"device memory telemetry needs a CUDA device, "
                         f"not {device}")
    if not torch.cuda.is_available():
        raise RuntimeError("device memory telemetry: no CUDA device is "
                           "available")
    return device


def live_bytes(device=None) -> int:
    """Bytes of live tensors on the card (the caching allocator's
    allocated bytes, not its reserved pool)."""
    return int(torch.cuda.memory_allocated(_cuda(device)))


def device_limit(device=None) -> int:
    """The card's total memory in bytes."""
    return int(torch.cuda.mem_get_info(_cuda(device))[1])


def hbm_usage(device=None) -> dict[str, Any]:
    """One report: allocated now, peak allocated since the last
    torch.cuda.reset_peak_memory_stats, reserved by the allocator, and the
    card's total, in GiB."""
    device = _cuda(device)
    stats = torch.cuda.memory_stats(device)
    return {
        "in_use_gb": stats.get("allocated_bytes.all.current", 0) / GIB,
        "peak_gb": stats.get("allocated_bytes.all.peak", 0) / GIB,
        "reserved_gb": stats.get("reserved_bytes.all.current", 0) / GIB,
        "limit_gb": device_limit(device) / GIB,
        "source": "torch.cuda.memory_stats",
    }


def call_stats(fn: Callable, *args, device=None, **kwargs):
    """(fn(*args, **kwargs), stats): the allocated bytes before and after
    the call and their peak during it, between two synchronizes. Resets
    the device's peak statistics."""
    device = _cuda(device)
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    before = torch.cuda.memory_allocated(device)
    out = fn(*args, **kwargs)
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device)
    after = torch.cuda.memory_allocated(device)
    return out, {"before_bytes": int(before), "after_bytes": int(after),
                 "peak_bytes": int(peak),
                 "peak_over_before_bytes": int(peak - before)}
