"""The 8-bit handoff to the host (`to_host`, csrc/to_host.cu) and its plain
version.

A served frame leaves `vis` as host float32 arrays on the 256 levels
k / 255 (the frame quantized to 8 bits on the device, as the JAX package
does it), and a training step's output carries its GT the same way. This
module owns that handoff. On a CUDA device `to_host` launches one kernel
that quantizes, dequantizes and writes the float32 planes straight into
pinned host memory; the caller waits (`wait`) before it reads them. On the
CPU it takes the plain version, `to_host_plain`: the quantize, a copy to
the host, numpy's float32 division, written into the caller's arrays. Both
give the same bits.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils.profiler import span
from . import kernels

# the float32 value of each level, as numpy's float32 division gives it
DEQUANT = np.arange(256, dtype=np.float32) / np.float32(255)
MAX_PLANES = 2  # source planes of one launch


def _quantize(x: torch.Tensor) -> torch.Tensor:
    """float32 in [0, 1] -> uint8 levels: the product by 255 truncated."""
    return (torch.clamp(x, 0, 1) * 255).to(torch.uint8)


def _dequantize(q: np.ndarray) -> np.ndarray:
    """uint8 levels -> float32 q / 255 on the host."""
    return q.astype(np.float32) / 255.0


def host_empty(shape, like: torch.Tensor) -> torch.Tensor:
    """A float32 host tensor for `to_host` to write into: pinned, from
    PyTorch's caching host allocator, where `like` lies on a CUDA device,
    plain where it lies on the CPU."""
    return torch.empty(tuple(shape), dtype=torch.float32,
                       pin_memory=like.is_cuda)


def wait(like: torch.Tensor) -> None:
    """Wait until `to_host` on `like`'s device has written its
    destinations: the current stream on a CUDA device; on the CPU they are
    written when `to_host` returns."""
    if like.is_cuda:
        torch.cuda.current_stream().synchronize()


def fetch(src: torch.Tensor, sync: str) -> np.ndarray:
    """src dequantized as a host float32 array of its shape: one `to_host`
    into a fresh `host_empty` tensor, waited for in the span `sync`."""
    out = host_empty(src.shape, src)
    to_host([(src, (out,))])
    with span(sync):
        wait(src)
    return out.numpy()


def _check_dsts(src: torch.Tensor, outs, pinned: bool) -> None:
    if not 1 <= len(outs) <= 2:
        raise ValueError(f"to_host: 1 or 2 destinations a plane, got "
                         f"{len(outs)}")
    for out in outs:
        if (out.device.type != "cpu" or out.dtype != torch.float32
                or not out.is_contiguous() or out.numel() != src.numel()
                or (pinned and not out.is_pinned())):
            raise ValueError(
                f"to_host: a destination must be a contiguous "
                f"{'pinned ' if pinned else ''}float32 CPU tensor of "
                f"{src.numel()} elements, got {out.device} {out.dtype} "
                f"{out.numel()} pinned={out.is_pinned()}")


def to_host_plain(planes) -> None:
    """Plain version of `to_host`, on any device: a float32 source is
    quantized first, a uint8 one taken as it is; the levels are copied to
    the host, divided by 255 in numpy and copied into the destinations."""
    for src, outs in planes:
        _check_dsts(src, outs, pinned=False)
        q = src if src.dtype == torch.uint8 else _quantize(src)
        vals = torch.from_numpy(_dequantize(q.cpu().numpy()))
        for out in outs:
            out.copy_(vals.reshape(out.shape))


def _dims(src: torch.Tensor):
    """(planes, rows, width, plane stride, row stride) of a source whose
    last dimension is contiguous; a contiguous source is one row."""
    if src.is_contiguous():
        return 1, 1, src.numel(), 0, 0
    if src.dim() == 2:
        return 1, src.shape[0], src.shape[1], 0, src.stride(0)
    return (src.shape[0], src.shape[1], src.shape[2], src.stride(0),
            src.stride(1))


def to_host(planes) -> None:
    """Write each source plane, dequantized to float32, into its host
    destinations.

    planes: up to two (src, dsts): src a float32 (quantized as the plain
    version does) or uint8 tensor of 2 or 3 dimensions, all on one device;
    dsts one or two contiguous float32 CPU tensors of src's element count
    (`host_empty`). CPU sources take `to_host_plain`, which has written the
    destinations when it returns. CUDA sources, on the current device, take
    one kernel launch into pinned destinations that returns at once: they
    hold the values once `wait` returns."""
    if not 1 <= len(planes) <= MAX_PLANES:
        raise ValueError(f"to_host: 1 to {MAX_PLANES} planes, got "
                         f"{len(planes)}")
    on_cuda = {src.is_cuda for src, _ in planes}
    if on_cuda == {False}:
        to_host_plain(planes)
        return
    if on_cuda != {True}:
        raise ValueError("to_host: the sources of one call lie on one "
                         "device")
    n = len(planes)
    srcs, u8, dims, dsts = [], [], [], []
    for src, outs in planes:
        if src.dim() in (2, 3) and src.stride(-1) != 1:
            # the oracle's frame is a transposed view; the kernel reads rows
            src = src.contiguous()
        if (src.dtype not in (torch.float32, torch.uint8)
                or src.dim() not in (2, 3)):
            raise ValueError(
                f"to_host: bad source {src.dtype} {tuple(src.shape)} "
                f"strides {src.stride()}")
        if src.device.index != torch.cuda.current_device():
            raise ValueError(
                f"to_host: the source lies on {src.device}; the kernel "
                f"launches on the current device, cuda:"
                f"{torch.cuda.current_device()}")
        _check_dsts(src, outs, pinned=True)
        srcs.append(src.data_ptr())
        u8.append(int(src.dtype == torch.uint8))
        dims.extend(_dims(src))
        dsts.extend([outs[0].data_ptr(),
                     outs[1].data_ptr() if len(outs) > 1 else None])
    rc = kernels.library().log_to_host(
        n, (ctypes.c_void_p * n)(*srcs), (ctypes.c_int * n)(*u8),
        (ctypes.c_longlong * (5 * n))(*dims),
        (ctypes.c_void_p * (2 * n))(*dsts), DEQUANT.ctypes.data,
        kernels.stream())
    kernels.check(rc, "to_host")
    kernels.LAUNCHES["to_host"] += 1
