"""Order-preserving stream compaction of 1-D columns (K6); counterpart of
log_tpu/ops/compact_pallas.py.

The render frame's slice compaction moves the kept rows of a few capacity
columns (f32, and int32 holding u32 bit patterns) to the front, in row
order. `stream_compact_cols` launches the CUDA kernel (csrc/compact.cu:
one cooperative launch that counts, scans the block counts and scatters)
on CUDA tensors and runs `stream_compact_cols_plain` on CPU tensors. Both
have the contract of the sort compaction (model/train_step.py
`_compact_flat_cols_sort`): the first k kept rows, zero-filled lanes past
the kept count, index = cap there. Words move as raw bits, so NaN payloads
and large int32 values stay exact.
"""
from __future__ import annotations

import ctypes

import torch

from . import kernels

MAX_COLS = 16
BLOCK_ROWS = 1024  # rows per tile of the kernel, one per thread
# (device, words) -> the kernel's int32 scratch (its blocks' kept counts).
# Every call writes the words it reads, so calls on one stream may share it.
_SCRATCH = {}


def _check_cols(cols: dict, keep, k: int):
    cap = keep.shape[0]
    bad = [(n, tuple(v.shape), v.dtype) for n, v in cols.items()
           if v.dim() != 1 or v.shape[0] != cap
           or v.dtype not in (torch.float32, torch.int32)]
    if bad or not 1 <= len(cols) <= MAX_COLS or keep.dtype != torch.bool \
            or not 0 <= k <= cap:
        raise ValueError(
            f"stream_compact_cols: need 1..{MAX_COLS} (cap,) f32/int32 "
            f"columns, a bool keep mask and k <= cap; got {bad}, "
            f"{len(cols)} columns, keep {keep.dtype}, k {k}, cap {cap}"
        )


def stream_compact_cols_plain(cols: dict, keep, k: int):
    """Plain torch version of `stream_compact_cols` (same contract): each
    kept row's slot is its rank among the kept rows (an inclusive cumsum
    minus one), then one scatter per column."""
    _check_cols(cols, keep, k)
    cap = keep.shape[0]
    dev = keep.device
    slot = torch.cumsum(keep.to(torch.int64), 0) - 1
    take = keep & (slot < k)
    dst = slot[take]
    index = torch.full((k,), cap, dtype=torch.int32, device=dev)
    index[dst] = torch.arange(cap, dtype=torch.int32, device=dev)[take]
    slices = {}
    for name, col in cols.items():
        out = torch.zeros((k,), dtype=col.dtype, device=dev)
        out[dst] = col[take]
        slices[name] = out
    return slices, index, index < cap


def _scratch(dev, words: int):
    key = (dev, words)
    if key not in _SCRATCH:
        _SCRATCH[key] = torch.empty((words,), dtype=torch.int32, device=dev)
    return _SCRATCH[key]


def stream_compact_cols(cols: dict, keep, k: int):
    """Compact (cap,) columns by the bool mask `keep`: returns (slices,
    index, lane_valid) where slices[name] holds the first k kept rows of
    cols[name] in row order and zeros past the kept count, index (k,)
    int32 their rows (cap past the kept count), lane_valid = index < cap.
    """
    if keep.device.type == "cpu":
        return stream_compact_cols_plain(cols, keep, k)
    _check_cols(cols, keep, k)
    names = list(cols)
    cols = {n: cols[n].contiguous() for n in names}
    kernels.require_cuda("stream_compact_cols", keep, *cols.values())
    cap = keep.shape[0]
    dev = keep.device
    out = torch.empty((len(names), k), dtype=torch.int32, device=dev)
    index = torch.empty((k,), dtype=torch.int32, device=dev)
    valid = torch.empty((k,), dtype=torch.bool, device=dev)
    scratch = _scratch(dev, -(-cap // BLOCK_ROWS))
    ptrs = (ctypes.c_void_p * len(names))(
        *(cols[n].data_ptr() for n in names))
    lib = kernels.library()
    rc = lib.log_stream_compact(
        kernels.ptr(keep), cap, k, ptrs, len(names), kernels.ptr(out),
        kernels.ptr(index), kernels.ptr(valid), kernels.ptr(scratch),
        kernels.stream(),
    )
    kernels.check(rc, "stream_compact_cols")
    kernels.LAUNCHES["stream_compact"] += 1
    slices = {n: out[i].view(cols[n].dtype) for i, n in enumerate(names)}
    return slices, index, valid
