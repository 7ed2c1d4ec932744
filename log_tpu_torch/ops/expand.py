"""Pair expansion with sort keys (K3, and K3p from a pre-packed buffer);
counterpart of log_tpu/ops/expand_pallas.py (expand_pallas_with_keys,
expand_packed_with_keys).

Run i (one gaussian) owns the pair columns [offs[i], offs[i+1]); the last run
ends at `length`. Each column gets a copy of its owner's rows and two sort
keys decoded from the packed rect geometry. The CUDA kernels are in
csrc/expand.cu; `expand_with_keys_plain` and `expand_packed_with_keys_plain`
are the same functions in plain torch, used for CPU tensors and as the
kernels' references on the card.

`ExpandWithKeys` is the differentiable form: the VJP of the value rows is
the segment sum of each run's columns (the TPU package's `_pek_bwd`). The
JAX package takes it as a difference of an f32 cumsum over all A columns,
which at millions of pairs loses most of the precision of a small run's
sum; here the cumsum runs in float64, so each segment sum keeps full f32
precision, and the result is deterministic.
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
    tile_key, depth_key = _decode_keys(j, out_ints[0], out_ints[1],
                                       out_vals[ROW_DEPTH], total, tiles_x,
                                       num_tiles)
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


# --------------------------------------------------------------------------
# K3p: the same expansion from a pre-packed (16, P + spare) f32 buffer
# --------------------------------------------------------------------------
N_PACKED_ROWS = 13  # 10 values, run offset, rect geometry, caller id (f32)
ROW_OFFS, ROW_NEXT = 13, 14  # run starts and next-run starts, f32
PACKED_SPARE = 768  # spare columns; rows 13/14 hold the sentinel A there


def _decode_keys(j, off, geo, depth, total, tiles_x: int, num_tiles: int):
    """Tile and depth sort keys of pair columns j from their run's offset
    and packed rect geometry x0 + 32*(y0 + 512*w)."""
    x0 = geo & 31
    y0 = (geo >> 5) & 511
    w = torch.clamp(geo >> 14, min=1)
    k = j - off
    tile = (y0 + torch.div(k, w, rounding_mode="floor")) * tiles_x + x0 + k % w
    real = j < total.reshape(())
    return (torch.where(real, tile, num_tiles).to(torch.int32),
            torch.where(real, depth, DEPTH_SENTINEL))


def expand_packed_with_keys_plain(packed, n_runs: int, total, length: int,
                                  tiles_x: int, num_tiles: int):
    """Plain torch version of `expand_packed_with_keys` (same contract)."""
    dev = packed.device
    j = torch.arange(length, dtype=torch.int32, device=dev)
    offs = packed[ROW_OFFS, :n_runs].contiguous()
    owner = torch.searchsorted(offs, j.to(torch.float32), right=True) - 1
    out = packed[:N_PACKED_ROWS, torch.clamp(owner, min=0)]
    tile_key, depth_key = _decode_keys(
        j, out[10].to(torch.int32), out[11].to(torch.int32), out[ROW_DEPTH],
        total, tiles_x, num_tiles)
    return out, tile_key, depth_key


def expand_packed_with_keys(packed, n_runs: int, total, length: int,
                            tiles_x: int, num_tiles: int):
    """Expand per-run rows to pair columns from a pre-packed buffer.

    packed: (16, P + 768) f32 as `pack_rows` writes it from 15 rows: 0-9
    the values, 10-12 the run offset, rect geometry and caller id as exact
    f32, 13 the run starts, 14 the next-run starts (rows 13/14 hold the
    sentinel `length` past P); n_runs = P; total: int32 scalar tensor.
    Returns (rows (13, A) f32, tile_key (A,) int32, depth_key (A,) f32);
    the keys are num_tiles and 3e38 for columns >= total. Inference only.
    """
    if packed.device.type == "cpu":
        return expand_packed_with_keys_plain(packed, n_runs, total, length,
                                             tiles_x, num_tiles)
    total = total.reshape(1)
    kernels.require_cuda("expand_packed_with_keys", packed, total)
    if (packed.dtype != torch.float32 or packed.dim() != 2
            or packed.shape[0] != 16 or packed.shape[1] < n_runs
            or total.dtype != torch.int32 or n_runs < 1
            or length >= 1 << 24):
        raise ValueError(
            f"expand_packed_with_keys: bad inputs packed {packed.dtype} "
            f"{tuple(packed.shape)}, runs {n_runs}, total {total.dtype}, "
            f"length {length}"
        )
    A = int(length)
    dev = packed.device
    out = torch.empty((N_PACKED_ROWS, A), dtype=torch.float32, device=dev)
    tile_key = torch.empty((A,), dtype=torch.int32, device=dev)
    depth_key = torch.empty((A,), dtype=torch.float32, device=dev)
    lib = kernels.library()
    rc = lib.log_expand_packed_with_keys(
        kernels.ptr(packed), packed.shape[1], n_runs, kernels.ptr(total), A,
        tiles_x, num_tiles, kernels.ptr(out), kernels.ptr(tile_key),
        kernels.ptr(depth_key), kernels.stream(),
    )
    kernels.check(rc, "expand_packed_with_keys")
    kernels.LAUNCHES["expand_packed"] += 1
    return out, tile_key, depth_key


class ExpandWithKeys(torch.autograd.Function):
    """`expand_with_keys` with a VJP for the value rows: the gradient of run
    i is the sum of its columns [offs[i], offs[i+1]) (the last run ends at
    `length`). The int rows and the sort keys get no gradient."""

    @staticmethod
    def forward(ctx, vals, ints, total, length, tiles_x, num_tiles):
        out_vals, out_ints, tile_key, depth_key = expand_with_keys(
            vals, ints, total, length, tiles_x, num_tiles
        )
        ctx.save_for_backward(ints[0])
        ctx.length = int(length)
        ctx.mark_non_differentiable(out_ints, tile_key, depth_key)
        return out_vals, out_ints, tile_key, depth_key

    @staticmethod
    def backward(ctx, g_vals, *_):
        (offs,) = ctx.saved_tensors
        length = ctx.length
        offs = torch.clamp(offs.to(torch.int64), max=length)
        nxt = torch.cat([offs[1:], offs.new_full((1,), length)])
        s = torch.cumsum(g_vals.to(torch.float64), dim=1)
        s = torch.cat([s.new_zeros((s.shape[0], 1)), s], dim=1)
        d_vals = (s[:, nxt] - s[:, offs]).to(g_vals.dtype)
        return d_vals, None, None, None, None, None
