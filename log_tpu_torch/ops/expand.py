"""Pair expansion with sort keys (K3); counterpart of
log_tpu/ops/expand_pallas.py (expand_pallas_with_keys).

Run i (one gaussian) owns the pair columns [offs[i], offs[i+1]); the last run
ends at `length`. Each column gets a copy of its owner's rows and two sort
keys decoded from the packed rect geometry. The CUDA kernel is
csrc/expand.cu; `expand_with_keys_plain` is the same function in plain
torch, used for CPU tensors and as the kernel's reference on the card.
"""
from __future__ import annotations

import torch

from . import kernels

N_VAL_ROWS = 10  # px py cxx cxy cyy opac r g b depth
N_INT_ROWS = 3  # run offset, rect geometry x0 + 32*(y0 + 512*w), caller id
ROW_DEPTH = 9
DEPTH_SENTINEL = 3.0e38


def expand_with_keys_plain(vals, ints, total, length: int, tiles_x: int,
                           num_tiles: int):
    """Plain torch version of `expand_with_keys` (same contract)."""
    dev = vals.device
    j = torch.arange(length, dtype=torch.int32, device=dev)
    owner = torch.searchsorted(ints[0].contiguous(), j, right=True) - 1
    owner = torch.clamp(owner, min=0)
    out_vals = vals[:, owner]
    out_ints = ints[:, owner]
    off, geo = out_ints[0], out_ints[1]
    x0 = geo & 31
    y0 = (geo >> 5) & 511
    w = torch.clamp(geo >> 14, min=1)
    k = j - off
    tile = (y0 + torch.div(k, w, rounding_mode="floor")) * tiles_x + x0 + k % w
    real = j < total.reshape(())
    tile_key = torch.where(real, tile, num_tiles).to(torch.int32)
    depth_key = torch.where(real, out_vals[ROW_DEPTH], DEPTH_SENTINEL)
    return out_vals, out_ints, tile_key, depth_key


def expand_with_keys(vals, ints, total, length: int, tiles_x: int,
                     num_tiles: int):
    """Expand per-run rows to pair columns and decode the pair sort keys.

    vals: (10, P) f32 (row 9 = depth); ints: (3, P) int32, row 0 the
    ascending run starts (exclusive cumsum of the pair counts, clamped to
    `length`), row 1 the packed rect geometry, row 2 the caller ids;
    total: int32 scalar tensor, the clamped pair total.
    Returns (vals (10, A) f32, ints (3, A) int32, tile_key (A,) int32,
    depth_key (A,) f32): tile_key is num_tiles and depth_key 3e38 for
    columns >= total.
    """
    if vals.device.type == "cpu":
        return expand_with_keys_plain(vals, ints, total, length, tiles_x,
                                      num_tiles)
    total = total.reshape(1)
    kernels.require_cuda("expand_with_keys", vals, ints, total)
    P = vals.shape[1]
    if (vals.dtype != torch.float32 or vals.shape[0] != N_VAL_ROWS
            or ints.dtype != torch.int32 or tuple(ints.shape) != (N_INT_ROWS, P)
            or total.dtype != torch.int32 or P < 1 or length >= 1 << 31):
        raise ValueError(
            f"expand_with_keys: bad inputs vals {vals.dtype} "
            f"{tuple(vals.shape)}, ints {ints.dtype} {tuple(ints.shape)}, "
            f"total {total.dtype}, length {length}"
        )
    A = int(length)
    dev = vals.device
    out_vals = torch.empty((N_VAL_ROWS, A), dtype=torch.float32, device=dev)
    out_ints = torch.empty((N_INT_ROWS, A), dtype=torch.int32, device=dev)
    tile_key = torch.empty((A,), dtype=torch.int32, device=dev)
    depth_key = torch.empty((A,), dtype=torch.float32, device=dev)
    lib = kernels.library()
    rc = lib.log_expand_with_keys(
        kernels.ptr(vals), kernels.ptr(ints), P, kernels.ptr(total), A,
        tiles_x, num_tiles, kernels.ptr(out_vals), kernels.ptr(out_ints),
        kernels.ptr(tile_key), kernels.ptr(depth_key), kernels.stream(),
    )
    kernels.check(rc, "expand_with_keys")
    kernels.LAUNCHES["expand_with_keys"] += 1
    return out_vals, out_ints, tile_key, depth_key
