"""Tiled rasterizer; counterpart of log_tpu/ops/rasterize_tiled.py.

The production render path, in four stages:

  1. projection (`project_gaussians`, shared with the oracle);
  2. binning: per-gaussian tile rectangles give pair counts, an int64
     exclusive cumsum gives each gaussian's run of pair columns, and the
     expansion kernel K3 (ops/expand.py) copies the gaussian's rows into its
     run and decodes each pair's (tile, depth) sort key;
  3. one stable sort over an int64 key (tile << 32 | order-preserving depth
     bits); pairs are generated in lane order, so ties break by lane, i.e.
     by gaussian id, as the reference's exact (tile, depth, gid) sort does.
     The row-pack kernel K4 (`pack_rows`) then lays the sorted rows out as
     the (16, A + 128) compositing input;
  4. per-tile compositing, kernel K1 (`rasterize_forward`), with optional
     densification statistics.

The inference frame of the flat_slice and block-pruned paths
(`render_pairs_packed`) takes column splats (`SplatCols`): K4 packs the run
rows and K3p expands them, one stable sort orders six payloads (px, py and
bf16 pairs of conic, log-opacity and rgb) under a 32-bit key, K4 packs the
8-row records and K5 composites them, without stats.

Under autograd the chain runs backward through K1's VJP, the per-tile
backward kernel K2 (`rasterize_backward`), and the plain-torch VJPs of K4
(a row slice), the sort (a scatter by the permutation) and K3 (a segment
sum, ops/expand.py).

Every kernel wrapper takes its plain torch version for CPU tensors and
launches the CUDA kernel (csrc/) for CUDA tensors. Integer rows (offsets,
rect geometry, ids) are int32 tensors; the gaussian id rides row 10 of the
packed pair array as raw int32 bits.

Tile geometry is fixed at 8 x 128 pixels, as in the JAX package, so pair
counts, tile keys and the pair demand match it exactly.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..utils.profiler import span
from . import expand as _expand
from . import kernels
from .expand import PACKED_SPARE, ROW_NEXT, ROW_OFFS, ExpandWithKeys
from .projection import (ALPHA_MAX, ALPHA_MIN, T_EPS, SplatCols,
                         project_gaussians)

TILE_H = 8
TILE_W = 128
TILE_PIX = TILE_H * TILE_W  # one CUDA block of 1024 threads per tile
# the compositing walk's chunk; runs are read from floor-aligned offsets in
# these units, and the packed pair array carries one spare chunk
PAIR_CHUNK = 128
# pair record rows of the packed (N_ROWS, A + PAIR_CHUNK) array
ROW_PX, ROW_PY, ROW_CXX, ROW_CXY, ROW_CYY, ROW_OPAC = 0, 1, 2, 3, 4, 5
ROW_R, ROW_G, ROW_B, ROW_DEPTH = 6, 7, 8, 9
ROW_GID = 10  # int32 bits: the caller's gaussian id
N_ROWS = 16
N_VAL_ROWS = 10
# the inference pair record of K5: px, py f32; conic, log-opacity and rgb
# as bf16 pairs in 32-bit words (hi | lo); rows 6-7 zero
P_ROW_PX, P_ROW_PY = 0, 1
P_ROW_CXX_CXY, P_ROW_CYY_OPAC, P_ROW_R_G, P_ROW_B = 2, 3, 4, 5
P_N_ROWS = 8
# pair budgets and slice buckets are multiples of this; the column path
# packs its run rows (K4) and expands them with K3p only when P is one
PACK_CHUNK = 1 << 15
# the packed expansion (K4 into K3p) carries run offsets and ids as f32
# rows, exact below 2^24: a larger budget takes K3 (int32 rows)
PACKED_ID_LIMIT = 1 << 24
_STATS_LEVEL = {False: 0, "weights": 1, True: 2}


# --------------------------------------------------------------------------
# bf16 pairs in 32-bit words
# --------------------------------------------------------------------------
def _wrap_i32(x):
    """int64 values in [0, 2^32) -> int32 tensors with the same bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _bf16_bits(x):
    """Round-to-nearest-even f32 -> bf16 bit patterns (int64 in [0, 2^16)),
    by integer arithmetic so that every device rounds alike; NaN becomes
    the quiet NaN 0x7FC0 with its sign, as XLA converts it."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    rne = (bits + 0x7FFF + ((bits >> 16) & 1)) >> 16
    nan = (bits & 0x7FFFFFFF) > 0x7F800000
    return torch.where(nan, ((bits >> 16) & 0x8000) | 0x7FC0, rne) & 0xFFFF


def pack2_bf16(hi, lo):
    """Round two f32 rows to bf16 and pack them into one word row:
    (int32 tensor holding hi << 16 | lo)."""
    return _wrap_i32((_bf16_bits(hi) << 16) | _bf16_bits(lo))


def unpack2_bf16(u):
    """Inverse of pack2_bf16 on an int32 (or f32-typed) word row: two f32
    rows. A bf16 placed in the top half of an f32 word is its exact value."""
    u = u.contiguous().view(torch.int32).to(torch.int64)
    hi = _wrap_i32(u & 0xFFFF0000).view(torch.float32)
    lo = _wrap_i32((u & 0xFFFF) << 16).view(torch.float32)
    return hi, lo


def pack_shift(num_tiles: int) -> int:
    """Bit shift that puts tile ids into the top bits of a 32-bit key."""
    return 32 - max(int(num_tiles + 1).bit_length(), 1)


def _stats_level(with_stats) -> int:
    if with_stats not in _STATS_LEVEL:
        raise ValueError(f"with_stats must be False, 'weights' or True, "
                         f"got {with_stats!r}")
    return _STATS_LEVEL[with_stats]


# --------------------------------------------------------------------------
# K4: row pack
# --------------------------------------------------------------------------
def pack_rows_plain(rows, n_out: int = N_ROWS, spare: int = PAIR_CHUNK):
    """Plain torch version of `pack_rows` (same contract)."""
    A = rows[0].shape[0]
    out = torch.zeros((n_out, A + spare), dtype=torch.float32,
                      device=rows[0].device)
    for r, row in enumerate(rows):
        out[r, :A] = row.view(torch.float32)
    return out


def pack_rows(rows, n_out: int = N_ROWS, spare: int = PAIR_CHUNK):
    """Stack n <= n_out 1-D 32-bit rows (A,) into an (n_out, A + spare) f32
    array; rows n..n_out-1 and the spare columns are zero. int32 rows are
    copied as raw bits."""
    rows = list(rows)
    if rows[0].device.type == "cpu":
        return pack_rows_plain(rows, n_out, spare)
    kernels.require_cuda("pack_rows", *rows)
    A = rows[0].shape[0]
    if not (1 <= len(rows) <= n_out <= 16) or any(
        r.dim() != 1 or r.shape[0] != A
        or r.dtype not in (torch.float32, torch.int32) for r in rows
    ):
        raise ValueError(
            f"pack_rows: need 1..{n_out} rows of one length, f32 or int32; "
            f"got {[(tuple(r.shape), r.dtype) for r in rows]}"
        )
    out = torch.empty((n_out, A + spare), dtype=torch.float32,
                      device=rows[0].device)
    ptrs = (ctypes.c_void_p * len(rows))(*(r.data_ptr() for r in rows))
    lib = kernels.library()
    rc = lib.log_pack_rows(ptrs, len(rows), n_out, A, spare,
                           kernels.ptr(out), kernels.stream())
    kernels.check(rc, "pack_rows")
    kernels.LAUNCHES["pack_rows"] += 1
    return out


# --------------------------------------------------------------------------
# binning
# --------------------------------------------------------------------------
def splat_extents(cn_xx, cn_xy, cn_yy, opacity, radius):
    """Per-axis pixel extents (ext_x, ext_y): the tight axis-aligned bbox of
    the region where alpha can reach ALPHA_MIN, capped at `radius`, with a
    +1 px margin (see the JAX docstring for the derivation)."""
    det_c = cn_xx * cn_yy - cn_xy * cn_xy
    pos = det_c > 0.0
    inv_det = 1.0 / torch.where(pos, det_c, 1.0)
    d_lim = torch.sqrt(torch.clamp(2.0 * torch.log(255.0 * opacity), 0.0, 9.0))
    ext_x = d_lim * torch.sqrt(torch.clamp(cn_yy * inv_det, min=0.0)) + 1.0
    ext_y = d_lim * torch.sqrt(torch.clamp(cn_xx * inv_det, min=0.0)) + 1.0
    ext_x = torch.minimum(torch.where(pos, ext_x, radius), radius)
    ext_y = torch.minimum(torch.where(pos, ext_y, radius), radius)
    return ext_x, ext_y


def _tile_index(v, n_tiles: int):
    """int32(v) truncated toward zero, clipped to [0, n_tiles]; the float is
    clamped first so that huge or infinite coordinates convert the same
    way on every device."""
    v = torch.clamp(v, -1.0, float(n_tiles + 1))
    return torch.clamp(v.to(torch.int32), 0, n_tiles)


def _depth_order_bits(depth):
    """Order-preserving map of f32 values to uint32 codes (in an int64)."""
    bits = depth.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    neg = bits >= 0x80000000
    return torch.where(neg, bits ^ 0xFFFFFFFF, bits | 0x80000000)


def expand_sort_pairs(splats, colors, image_height: int, image_width: int,
                      max_pairs: int, runs_tail_only: bool = False,
                      active_prefix=None, gid_ids=None,
                      inference_pack: bool = False):
    """Binning up to the sort: rects -> pair expansion (K3, or K3p) -> one
    sort by (tile, depth, lane). Returns a dict with the SORTED pair rows
    (tile_s int32 with `num_tiles` as the tail sentinel, gid_s int32,
    values_s (10, A) f32, perm_s), the pre-sort `real` mask, the grid
    geometry, the splats' radius/valid and `total`, the UNCLAMPED pair
    demand (int32, capped at 2^30) that callers size the next frame's
    budget from.

    splats: `Splats` with colors (P, 3), or `SplatCols` with colors a tuple
    of three (P,) columns. Column input under runs_tail_only with A % 512
    == 0 and P % PACK_CHUNK == 0 packs the 15 run rows with K4 and expands
    them with K3p, as the JAX package's dispatch does; otherwise K3.

    runs_tail_only: the caller promises `active_prefix` is a prefix mask
    (compacted slices). Every prefix lane then emits >= 1 pair (invalid
    lanes a sanitized zero-alpha record on the sentinel tile row), so
    zero-count runs exist only in the tail, as in the JAX package.

    inference_pack: sort only what the packed compositing kernel K5 reads,
    under one 32-bit key (tile << shift | the top depth bits; ties by
    lane): returns tile_s, the six rows `packed6` (px, py f32; then conic,
    log-opacity and rgb as bf16 pairs in int32 words), the grid geometry
    and `total`. No gradient path.
    """
    cols_mode = isinstance(splats, SplatCols)
    if cols_mode:
        px_x, px_y = splats.px, splats.py
        cn_xx, cn_xy, cn_yy = splats.cxx, splats.cxy, splats.cyy
        col_r, col_g, col_b = colors
    else:
        px_x = splats.pix_xy[:, 0]
        px_y = splats.pix_xy[:, 1]
        cn_xx = splats.conic[:, 0]
        cn_xy = splats.conic[:, 1]
        cn_yy = splats.conic[:, 2]
        col_r, col_g, col_b = colors[:, 0], colors[:, 1], colors[:, 2]
    P = splats.opacity.shape[0]
    dev = splats.opacity.device
    tiles_x = -(-image_width // TILE_W)
    tiles_y = -(-image_height // TILE_H)
    num_tiles = tiles_x * tiles_y
    A = int(max_pairs)
    # the rect geometry packs into one int32: x0 + 32*(y0 + 512*w)
    if not (tiles_x <= 32 and tiles_y <= 512):
        raise ValueError(f"image too large for the packed rect geometry: "
                         f"{tiles_x} x {tiles_y} tiles")

    radius = splats.radius
    valid = splats.valid & (radius > 0)
    ext_x, ext_y = splat_extents(cn_xx, cn_xy, cn_yy, splats.opacity, radius)
    x0 = _tile_index((px_x - ext_x) / TILE_W, tiles_x)
    y0 = _tile_index((px_y - ext_y) / TILE_H, tiles_y)
    x1 = _tile_index((px_x + ext_x + TILE_W - 1) / TILE_W, tiles_x)
    y1 = _tile_index((px_y + ext_y + TILE_H - 1) / TILE_H, tiles_y)
    rect_w = torch.clamp(x1 - x0, min=0)
    n_tiles_g = torch.where(valid, rect_w * torch.clamp(y1 - y0, min=0), 0)

    if runs_tail_only:
        ap = active_prefix if active_prefix is not None else torch.ones_like(valid)
        n_tiles_g = torch.where(ap, torch.clamp(n_tiles_g, min=1), 0)
        x0 = torch.where(valid, x0, 0)
        y0 = torch.where(valid, y0, tiles_y)
        rect_w = torch.where(valid, rect_w, 1)
        px_x = torch.where(valid, px_x, -1e4)
        px_y = torch.where(valid, px_y, -1e4)

    # exclusive cumsum in int64: the unclamped demand of coarse cuts can
    # exceed int32; offsets past the budget clamp to A (overflow runs empty)
    csum = torch.cumsum(n_tiles_g.to(torch.int64), 0)
    demand = csum[-1] if P else torch.zeros((), dtype=torch.int64, device=dev)
    offsets = torch.clamp(csum - n_tiles_g, max=A).to(torch.int32)
    total_c = torch.clamp(demand, 0, A).to(torch.int32)
    total_unclamped = torch.clamp(demand, max=1 << 30).to(torch.int32)

    geo = (x0 + 32 * (y0 + 512 * torch.clamp(rect_w, min=1))).to(torch.int32)
    id_row = (torch.arange(P, dtype=torch.int32, device=dev)
              if gid_ids is None else gid_ids.to(torch.int32))
    val_rows = [px_x, px_y, cn_xx, cn_xy, cn_yy, splats.opacity,
                col_r, col_g, col_b, splats.depth]
    if (cols_mode and runs_tail_only and A % 512 == 0
            and A < PACKED_ID_LIMIT and P % PACK_CHUNK == 0):
        # K4 packs the 15 run rows (ints as exact f32, ids < 2^24 on a
        # slice), the window sentinel goes into rows 13/14 past P, and K3p
        # expands them
        if P >= PACKED_ID_LIMIT:
            raise ValueError(f"slice too large for f32 id rows: {P}")
        offs_f = offsets.to(torch.float32)
        next_f = torch.cat([offs_f[1:], offs_f.new_full((1,), float(A))])
        rows15 = [r.to(torch.float32).contiguous() for r in val_rows] + [
            offs_f, geo.to(torch.float32), id_row.to(torch.float32),
            offs_f, next_f.contiguous(),
        ]
        packed15 = pack_rows(rows15, N_ROWS, PACKED_SPARE)
        packed15[ROW_OFFS:ROW_NEXT + 1, P:] = float(A)
        rows13, tile_key, depth_key = _expand.expand_packed_with_keys(
            packed15, P, total_c, A, tiles_x, num_tiles)
        vals_pc = rows13[:N_VAL_ROWS]
        gid_pc = rows13[12].to(torch.int32)
    else:
        vals = torch.stack(val_rows).to(torch.float32).contiguous()
        ints = torch.stack([offsets, geo, id_row]).contiguous()
        vals_pc, ints_pc, tile_key, depth_key = ExpandWithKeys.apply(
            vals, ints, total_c, A, tiles_x, num_tiles
        )
        gid_pc = ints_pc[2]
    real = tile_key < num_tiles

    if inference_pack:
        # the JAX package's 32-bit key on the raw depth bits (positive for
        # every composited pair); a stable sort breaks ties by lane
        shift = pack_shift(num_tiles)
        dbits = depth_key.contiguous().view(torch.int32).to(torch.int64)
        key = (tile_key.to(torch.int64) << shift) | (
            (dbits & 0xFFFFFFFF) >> (32 - shift))
        key_s, perm = torch.sort(key, stable=True)
        words = torch.stack([
            vals_pc[ROW_PX].contiguous().view(torch.int32),
            vals_pc[ROW_PY].contiguous().view(torch.int32),
            pack2_bf16(vals_pc[ROW_CXX], vals_pc[ROW_CXY]),
            pack2_bf16(vals_pc[ROW_CYY],
                       torch.log(torch.clamp(vals_pc[ROW_OPAC], min=1e-38))),
            pack2_bf16(vals_pc[ROW_R], vals_pc[ROW_G]),
            pack2_bf16(vals_pc[ROW_B], torch.zeros_like(vals_pc[ROW_B])),
        ])[:, perm]
        return {
            "tile_s": (key_s >> shift).to(torch.int32),
            "packed6": (words[0].view(torch.float32),
                        words[1].view(torch.float32),
                        words[2], words[3], words[4], words[5]),
            "tiles_x": tiles_x,
            "tiles_y": tiles_y,
            "num_tiles": num_tiles,
            "total": total_unclamped,
        }

    key = (tile_key.to(torch.int64) << 32) | _depth_order_bits(depth_key)
    _, perm = torch.sort(key, stable=True)
    return {
        "tile_s": tile_key[perm],
        "gid_s": gid_pc[perm],
        "values_s": SortPermute.apply(vals_pc, perm),
        "perm_s": perm,
        "real": real,
        "tiles_x": tiles_x,
        "tiles_y": tiles_y,
        "num_tiles": num_tiles,
        "radius": radius,
        "valid": valid,
        "total": total_unclamped,
    }


def pack_sorted_pairs(tile_s, gid_s, values_s, tiles_x: int, tiles_y: int):
    """Per-tile start/count tables and the packed (16, A + 128) kernel input
    (rows 0..9 values, row 10 the gaussian id bits) from sorted pair rows."""
    num_tiles = tiles_x * tiles_y
    bounds = torch.arange(num_tiles + 1, dtype=torch.int32,
                          device=tile_s.device)
    starts = torch.searchsorted(tile_s, bounds, side="left").to(torch.int32)
    tile_start = starts[:-1]
    pair_data = PackRows.apply(
        N_ROWS, PAIR_CHUNK, *(values_s[r] for r in range(N_VAL_ROWS)), gid_s
    )
    return {
        "pair_data": pair_data,
        "pair_gid": gid_s,
        "tile_start": tile_start,
        "tile_count": starts[1:] - tile_start,
        "tiles_x": tiles_x,
        "tiles_y": tiles_y,
    }


def build_pairs(splats, colors, image_height: int, image_width: int,
                max_pairs: int, runs_tail_only: bool = False,
                active_prefix=None, gid_ids=None):
    """Expansion + sort + packing: the full binning stage."""
    es = expand_sort_pairs(
        splats, colors, image_height, image_width, max_pairs,
        runs_tail_only=runs_tail_only, active_prefix=active_prefix,
        gid_ids=gid_ids,
    )
    packed = pack_sorted_pairs(es["tile_s"], es["gid_s"], es["values_s"],
                               es["tiles_x"], es["tiles_y"])
    packed["radius"] = es["radius"]
    packed["valid"] = es["valid"]
    packed["total"] = es["total"]
    return packed


# --------------------------------------------------------------------------
# K1: per-tile compositing
# --------------------------------------------------------------------------
# K1, K2 and K5 give each warp a PATCH_H x PATCH_W pixel patch of the tile
# (patches row-major) and skip the pairs whose footprint box misses it
# (csrc/footprint.cuh)
PATCH_W, PATCH_H = 4, 8
FOOT_NONE = 1 << 30  # "no box": (-FOOT_NONE, FOOT_NONE) on both axes


def footprint_box(px, py, cxx, cxy, cyy, opacity, r, g, b,
                  log_opacity: bool = False):
    """Plain mirror of csrc/footprint.cuh's footprint_box: a conservative
    inclusive pixel box (x0, x1, y0, y1) (int64 tensors) of the pair's
    alpha gate set {power <= 0, min(0.99, op exp(power)) >= f32(1/255)},
    from f32 record rows, computed in float64. log_opacity: `opacity` is
    K5's log-opacity lop and the gate is min(0.99, exp(power + lop)) >=
    f32(1/255).

    tau = ln(op / f32(1/255)) + 1e-5 (lop - ln f32(1/255) + 1e-5), divided
    by (1 - 16 u kappa) (u = 2^-24, kappa = (sqrt(cxx cyy) + |cxy|) /
    (sqrt(cxx cyy) - |cxy|) bounds the f32 power's rounding relative to
    Q = -power); the half extents are sqrt(2 tau cyy / det) and
    sqrt(2 tau cxx / det), padded by a pixel. op < f32(1/255) (lop below
    ln f32(1/255) by more than 1e-5) gives an empty box (x0 > x1); a
    non-finite field, cxx <= 0, det <= 0, 16 u kappa > 1/4 or a centre or
    extent past 2^22 gives no box (every pixel evaluates the pair).
    """
    rows = [px, py, cxx, cxy, cyy, opacity, r, g, b]
    finite = torch.stack([torch.isfinite(t) for t in rows]).all(dim=0)
    a_min = float(torch.tensor(ALPHA_MIN, dtype=torch.float32))
    x, y, dxx, dxy, dyy, op = (t.to(torch.float64) for t in rows[:6])
    det = dxx * dyy - dxy * dxy
    s = torch.sqrt(torch.clamp(dxx * dyy, min=0.0))
    kappa = (s + dxy.abs()) / (s - dxy.abs())
    rel = 16.0 * 2.0 ** -24 * kappa
    if log_opacity:
        tau0 = op - math.log(a_min) + 1e-5
        below = tau0 < 0.0
    else:
        tau0 = torch.log(op / a_min) + 1e-5
        below = op < a_min
    tau = tau0 / (1.0 - rel)
    rx = torch.sqrt(2.0 * tau * dyy / det)
    ry = torch.sqrt(2.0 * tau * dxx / det)
    lim = 2.0 ** 22
    boxed = (finite & ~below & (dxx > 0) & (det > 0) & (rel <= 0.25)
             & (x.abs() <= lim) & (y.abs() <= lim) & (rx <= lim)
             & (ry <= lim))
    empty = finite & below
    out = []
    for lo, hi in ((x - rx, x + rx), (y - ry, y + ry)):
        lo = torch.floor(torch.where(boxed, lo, 0.0)).to(torch.int64) - 1
        hi = torch.ceil(torch.where(boxed, hi, 0.0)).to(torch.int64) + 1
        out.append(torch.where(boxed, lo, torch.where(empty, FOOT_NONE,
                                                      -FOOT_NONE)))
        out.append(torch.where(boxed, hi, torch.where(empty, -FOOT_NONE,
                                                      FOOT_NONE)))
    return tuple(out)


def _tiles_to_image(x, tiles_x: int, tiles_y: int):
    """(num_tiles, C, TILE_PIX) per-tile rows -> (C, Hp, Wp) image."""
    C = x.shape[1]
    x = x.reshape(tiles_y, tiles_x, C, TILE_H, TILE_W)
    return x.permute(2, 0, 3, 1, 4).reshape(C, tiles_y * TILE_H,
                                            tiles_x * TILE_W)


def _decode_packed(d):
    """K5's pair record rows (8, ...) -> the K1 rows px py cxx cxy cyy,
    log-opacity, r g b."""
    cxx, cxy = unpack2_bf16(d[P_ROW_CXX_CXY])
    cyy, logop = unpack2_bf16(d[P_ROW_CYY_OPAC])
    r, g = unpack2_bf16(d[P_ROW_R_G])
    b, _ = unpack2_bf16(d[P_ROW_B])
    return torch.stack([d[P_ROW_PX], d[P_ROW_PY], cxx, cxy, cyy, logop,
                        r, g, b])


def rasterize_forward_plain(pair_data, tile_start, tile_count, background,
                            tiles_x: int, tiles_y: int, with_stats,
                            tile_group: int = 256, packed: bool = False):
    """Plain torch version of `rasterize_forward` (same contract), and with
    packed=True of `rasterize_forward_packed`'s compositing (8-row records;
    row 5 of the decoded record is log-opacity, alpha = exp(power +
    log op)).

    Vectorized over groups of tiles and walks their runs chunk by chunk,
    with the transmittance inside a chunk as a cumprod (rasterize_ref's
    formulation); tiles leave the walk when saturated, like the kernel.
    """
    stats = _stats_level(with_stats)
    if packed and stats:
        raise ValueError("the packed records carry no stats")
    dev = pair_data.device
    num_tiles = tiles_x * tiles_y
    pstride = pair_data.shape[1]
    lane = torch.arange(TILE_PIX, device=dev)
    lane_x = (lane % TILE_W).to(torch.float32)
    lane_y = (lane // TILE_W).to(torch.float32)
    tid = torch.arange(num_tiles, device=dev)
    org_x = ((tid % tiles_x) * TILE_W).to(torch.float32)
    org_y = ((tid // tiles_x) * TILE_H).to(torch.float32)
    start = tile_start.to(torch.int64)
    end = start + tile_count.to(torch.int64)
    off0 = torch.div(start, PAIR_CHUNK, rounding_mode="floor") * PAIR_CHUNK
    n_chunks = torch.div(end - off0 + PAIR_CHUNK - 1, PAIR_CHUNK,
                         rounding_mode="floor")
    gid_row = pair_data[ROW_GID].view(torch.int32) if stats == 2 else None
    k_iota = torch.arange(PAIR_CHUNK, device=dev)

    color = torch.zeros((num_tiles, 3, TILE_PIX), dtype=torch.float32,
                        device=dev)
    trans = torch.ones((num_tiles, TILE_PIX), dtype=torch.float32, device=dev)
    best_w = torch.zeros_like(trans)
    best_id = torch.full((num_tiles, TILE_PIX), -1, dtype=torch.int32,
                         device=dev)
    cend = torch.zeros((num_tiles,), dtype=torch.int32, device=dev)
    pair_w = torch.zeros((pstride,), dtype=torch.float32, device=dev)
    for g0 in range(0, num_tiles, tile_group):
        group = tid[g0:g0 + tile_group]
        active = n_chunks[group] > 0
        c = 0
        while True:
            sub = group[active]
            if sub.numel() == 0:
                break
            cols = off0[sub, None] + c * PAIR_CHUNK + k_iota  # (n, CHUNK)
            in_range = (cols >= start[sub, None]) & (cols < end[sub, None])
            d = pair_data[:, torch.clamp(cols, max=pstride - 1)]
            if packed:
                d = _decode_packed(d)
            dx = d[ROW_PX][:, :, None] - (org_x[sub, None] + lane_x)[:, None]
            dy = d[ROW_PY][:, :, None] - (org_y[sub, None] + lane_y)[:, None]
            power = (
                -0.5 * (d[ROW_CXX][:, :, None] * dx * dx
                        + d[ROW_CYY][:, :, None] * dy * dy)
                - d[ROW_CXY][:, :, None] * dx * dy
            )  # (n, CHUNK, TILE_PIX)
            if packed:
                alpha = torch.clamp(torch.exp(power + d[ROW_OPAC][:, :, None]),
                                    max=ALPHA_MAX)
            else:
                alpha = torch.clamp(d[ROW_OPAC][:, :, None] * torch.exp(power),
                                    max=ALPHA_MAX)
            alpha = torch.where(
                (power <= 0.0) & (alpha >= ALPHA_MIN) & in_range[:, :, None],
                alpha, 0.0,
            )
            cp_incl = torch.cumprod(1.0 - alpha, dim=1)
            cp_excl = torch.cat([torch.ones_like(cp_incl[:, :1]),
                                 cp_incl[:, :-1]], dim=1)
            t_before = trans[sub][:, None, :]
            w = torch.where(t_before * cp_incl >= T_EPS,
                            t_before * cp_excl * alpha, 0.0)
            rgb = d[ROW_R:ROW_B + 1].permute(1, 0, 2)  # (n, 3, CHUNK)
            color[sub] += torch.bmm(rgb, w)
            trans[sub] = t_before[:, 0] * cp_incl[:, -1]
            if stats == 2:
                cw = w.max(dim=1).values
                gid = gid_row[torch.clamp(cols, max=pstride - 1)]
                cid = torch.where((w == cw[:, None]) & (cw[:, None] > 0.0),
                                  gid[:, :, None], -1).max(dim=1).values
                take = cw > best_w[sub]
                best_w[sub] = torch.where(take, cw, best_w[sub])
                best_id[sub] = torch.where(take, cid, best_id[sub])
            if stats > 0:
                pw = w.max(dim=2).values
                pair_w[cols[in_range]] = pw[in_range]
            c += 1
            cend[sub] = c
            still = (c < n_chunks[sub]) & (trans[sub].max(dim=1).values >= T_EPS)
            active[active.clone()] = still
    final = color + trans[:, None] * background.to(torch.float32)[None, :, None]
    img = _tiles_to_image(final, tiles_x, tiles_y)
    tf = _tiles_to_image(trans[:, None], tiles_x, tiles_y)[0]
    pid = _tiles_to_image(best_id[:, None], tiles_x, tiles_y)[0]
    pwp = _tiles_to_image(best_w[:, None], tiles_x, tiles_y)[0]
    return img, tf, pid, pwp, pair_w, cend


def rasterize_forward(pair_data, tile_start, tile_count, background,
                      tiles_x: int, tiles_y: int, with_stats):
    """Composite every 8 x 128 tile's sorted pair run front to back.

    pair_data: (16, A + 128) f32 from `pack_sorted_pairs`; tile_start /
    tile_count: (num_tiles,) int32; background: (3,) f32.
    with_stats: False (image only), "weights" (+ per-pair max weight) or
    True (+ per-pixel max weight and the caller id of its pair).
    Returns (color (3, Hp, Wp), tfinal (Hp, Wp), pid (Hp, Wp) int32 (-1
    without full stats), pwp (Hp, Wp), pair_w (A + 128,) per-pair max
    weight (zeros without stats), cend (num_tiles,) int32 chunks composited
    before the saturation exit).
    """
    if pair_data.device.type == "cpu":
        return rasterize_forward_plain(pair_data, tile_start, tile_count,
                                       background, tiles_x, tiles_y,
                                       with_stats)
    stats = _stats_level(with_stats)
    background = background.to(torch.float32).contiguous()
    kernels.require_cuda("rasterize_forward", pair_data, tile_start,
                         tile_count, background)
    num_tiles = tiles_x * tiles_y
    if (pair_data.dtype != torch.float32 or pair_data.dim() != 2
            or pair_data.shape[0] != N_ROWS
            or tile_start.dtype != torch.int32
            or tile_count.dtype != torch.int32
            or tile_start.shape[0] != num_tiles
            or tile_count.shape[0] != num_tiles or background.numel() != 3):
        raise ValueError(
            f"rasterize_forward: bad inputs pair_data {pair_data.dtype} "
            f"{tuple(pair_data.shape)}, tiles {tile_start.dtype} "
            f"{tuple(tile_start.shape)} / {tile_count.dtype}, "
            f"num_tiles {num_tiles}"
        )
    dev = pair_data.device
    Hp, Wp = tiles_y * TILE_H, tiles_x * TILE_W
    color = torch.empty((3, Hp, Wp), dtype=torch.float32, device=dev)
    tfinal = torch.empty((Hp, Wp), dtype=torch.float32, device=dev)
    pid = torch.empty((Hp, Wp), dtype=torch.int32, device=dev)
    pwp = torch.empty((Hp, Wp), dtype=torch.float32, device=dev)
    pair_w = torch.zeros((pair_data.shape[1],), dtype=torch.float32,
                         device=dev)
    cend = torch.empty((num_tiles,), dtype=torch.int32, device=dev)
    lib = kernels.library()
    rc = lib.log_rasterize_fwd(
        kernels.ptr(pair_data), pair_data.shape[1], kernels.ptr(tile_start),
        kernels.ptr(tile_count), num_tiles, tiles_x, tiles_y,
        kernels.ptr(background), stats, kernels.ptr(color),
        kernels.ptr(tfinal), kernels.ptr(pid), kernels.ptr(pwp),
        kernels.ptr(pair_w), kernels.ptr(cend), kernels.stream(),
    )
    kernels.check(rc, "rasterize_forward")
    kernels.LAUNCHES["rasterize_fwd"] += 1
    return color, tfinal, pid, pwp, pair_w, cend


# --------------------------------------------------------------------------
# K5: per-tile compositing of the packed inference records
# --------------------------------------------------------------------------
def rasterize_forward_packed_plain(pair_data, tile_start, tile_count,
                                   background, tiles_x: int, tiles_y: int):
    """Plain torch version of `rasterize_forward_packed` (same contract)."""
    out = rasterize_forward_plain(pair_data, tile_start, tile_count,
                                  background, tiles_x, tiles_y, False,
                                  packed=True)
    return out[0], out[1]


def rasterize_forward_packed(pair_data, tile_start, tile_count, background,
                             tiles_x: int, tiles_y: int):
    """Composite every 8 x 128 tile's sorted run of packed pair records.

    pair_data: (8, A + 128) f32-typed words (rows per P_ROW_*); tile_start /
    tile_count: (num_tiles,) int32; background: (3,) f32. Returns (color
    (3, Hp, Wp), tfinal (Hp, Wp)).
    """
    if pair_data.device.type == "cpu":
        return rasterize_forward_packed_plain(pair_data, tile_start,
                                              tile_count, background,
                                              tiles_x, tiles_y)
    background = background.to(torch.float32).contiguous()
    kernels.require_cuda("rasterize_forward_packed", pair_data, tile_start,
                         tile_count, background)
    num_tiles = tiles_x * tiles_y
    if (pair_data.dtype != torch.float32 or pair_data.dim() != 2
            or pair_data.shape[0] != P_N_ROWS
            or tile_start.dtype != torch.int32
            or tile_count.dtype != torch.int32
            or tile_start.shape[0] != num_tiles
            or tile_count.shape[0] != num_tiles or background.numel() != 3):
        raise ValueError(
            f"rasterize_forward_packed: bad inputs pair_data "
            f"{pair_data.dtype} {tuple(pair_data.shape)}, tiles "
            f"{tile_start.dtype} {tuple(tile_start.shape)} / "
            f"{tile_count.dtype}, num_tiles {num_tiles}"
        )
    dev = pair_data.device
    Hp, Wp = tiles_y * TILE_H, tiles_x * TILE_W
    color = torch.empty((3, Hp, Wp), dtype=torch.float32, device=dev)
    tfinal = torch.empty((Hp, Wp), dtype=torch.float32, device=dev)
    lib = kernels.library()
    rc = lib.log_rasterize_fwd_packed(
        kernels.ptr(pair_data), pair_data.shape[1], kernels.ptr(tile_start),
        kernels.ptr(tile_count), num_tiles, tiles_x, tiles_y,
        kernels.ptr(background), kernels.ptr(color), kernels.ptr(tfinal),
        kernels.stream(),
    )
    kernels.check(rc, "rasterize_forward_packed")
    kernels.LAUNCHES["rasterize_fwd_packed"] += 1
    return color, tfinal


def packed_pairs(splats, colors, image_height: int, image_width: int,
                 max_pairs: int, active_prefix):
    """The packed frame's binning: expansion -> one sort of six payloads ->
    the (8, A + 128) pack (K4). Returns (pair_data, tile_start, tile_count,
    tiles_x, tiles_y, total), total the unclamped pair demand."""
    es = expand_sort_pairs(
        splats, colors, image_height, image_width, max_pairs,
        runs_tail_only=True, active_prefix=active_prefix, inference_pack=True,
    )
    tile_s = es["tile_s"]
    num_tiles = es["num_tiles"]
    A = tile_s.shape[0]
    bounds = torch.arange(num_tiles + 1, dtype=torch.int32,
                          device=tile_s.device)
    starts = torch.searchsorted(tile_s, bounds, side="left").to(torch.int32)
    if A % PACK_CHUNK == 0:
        pair_data = pack_rows(list(es["packed6"]), P_N_ROWS, PAIR_CHUNK)
    else:  # small or odd buckets: plain stack + pad
        pair_data = torch.zeros((P_N_ROWS, A + PAIR_CHUNK),
                                dtype=torch.float32, device=tile_s.device)
        for r, row in enumerate(es["packed6"]):
            pair_data[r, :A] = row.view(torch.float32)
    return (pair_data, starts[:-1], starts[1:] - starts[:-1], es["tiles_x"],
            es["tiles_y"], es["total"])


def render_pairs_packed(splats, colors, background, image_height: int,
                        image_width: int, max_pairs: int, active_prefix):
    """Inference render on the packed pair pipeline: `packed_pairs`, then
    K5. splats: SplatCols (or Splats) of a compacted slice whose
    `active_prefix` is a prefix mask. Returns (color (3, Hp, Wp), tfinal
    (Hp, Wp), total), total the unclamped pair demand."""
    pair_data, start, count, tiles_x, tiles_y, total = packed_pairs(
        splats, colors, image_height, image_width, max_pairs, active_prefix)
    color, tfinal = rasterize_forward_packed(pair_data, start, count,
                                             background, tiles_x, tiles_y)
    return color, tfinal, total


# --------------------------------------------------------------------------
# K2: per-tile backward
# --------------------------------------------------------------------------
def _image_to_tiles(x, tiles_x: int, tiles_y: int):
    """(C, Hp, Wp) image -> (num_tiles, C, TILE_PIX) per-tile rows."""
    C = x.shape[0]
    x = x.reshape(C, tiles_y, TILE_H, tiles_x, TILE_W)
    return x.permute(1, 3, 0, 2, 4).reshape(tiles_y * tiles_x, C, TILE_PIX)


def rasterize_backward_plain(pair_data, tile_start, tile_count, cend, tfinal,
                             dcolor, dalpha, background, tiles_x: int,
                             tiles_y: int, tile_group: int = 256):
    """Plain torch version of `rasterize_backward` (same contract).

    Vectorized over groups of tiles; each tile's composited chunks are
    walked back to front. Inside a chunk the transmittance before each pair
    is the running value after the chunk divided by the inclusive suffix
    product of (1 - alpha) (a reversed cumprod), and the suffix sum u of
    later contributions a reversed cumsum: the TPU kernel's formulation,
    with cumprod in place of its log-space matrix products.
    """
    dev = pair_data.device
    num_tiles = tiles_x * tiles_y
    pstride = pair_data.shape[1]
    lane = torch.arange(TILE_PIX, device=dev)
    lane_x = (lane % TILE_W).to(torch.float32)
    lane_y = (lane // TILE_W).to(torch.float32)
    tid = torch.arange(num_tiles, device=dev)
    org_x = ((tid % tiles_x) * TILE_W).to(torch.float32)
    org_y = ((tid // tiles_x) * TILE_H).to(torch.float32)
    start = tile_start.to(torch.int64)
    end = start + tile_count.to(torch.int64)
    off0 = torch.div(start, PAIR_CHUNK, rounding_mode="floor") * PAIR_CHUNK
    n_chunks = torch.div(end - off0 + PAIR_CHUNK - 1, PAIR_CHUNK,
                         rounding_mode="floor")
    n_walk = torch.minimum(n_chunks, cend.to(torch.int64))
    k_iota = torch.arange(PAIR_CHUNK, device=dev)
    t_fin = _image_to_tiles(tfinal[None], tiles_x, tiles_y)[:, 0]
    # a final transmittance below the smallest normal f32 went through the
    # denormal range: dividing it back up would amplify its rounding without
    # bound, so the pixel gives its pairs no gradient (as T = 0 does)
    t_fin = torch.where(t_fin < torch.finfo(torch.float32).tiny, 0.0, t_fin)
    dC = _image_to_tiles(dcolor, tiles_x, tiles_y)  # (T, 3, TILE_PIX)
    d_alpha = _image_to_tiles(dalpha[None], tiles_x, tiles_y)[:, 0]
    bg = background.to(torch.float32)
    bg_dot = (bg[:, None] * dC).sum(dim=1)
    t_run_all = t_fin.clone()
    u_run_all = t_fin * bg_dot - d_alpha * t_fin
    grad = torch.zeros((N_ROWS, pstride), dtype=torch.float32, device=dev)
    for g0 in range(0, num_tiles, tile_group):
        group = tid[g0:g0 + tile_group]
        walk = n_walk[group]
        k = 0
        while True:
            sub = group[walk > k]
            if sub.numel() == 0:
                break
            c = n_walk[sub] - 1 - k  # this step's chunk of each tile
            cols = off0[sub, None] + c[:, None] * PAIR_CHUNK + k_iota
            in_range = (cols >= start[sub, None]) & (cols < end[sub, None])
            d = pair_data[:, torch.clamp(cols, max=pstride - 1)]
            dx = d[ROW_PX][:, :, None] - (org_x[sub, None] + lane_x)[:, None]
            dy = d[ROW_PY][:, :, None] - (org_y[sub, None] + lane_y)[:, None]
            cxx = d[ROW_CXX][:, :, None]
            cxy = d[ROW_CXY][:, :, None]
            cyy = d[ROW_CYY][:, :, None]
            power = -0.5 * (cxx * dx * dx + cyy * dy * dy) - cxy * dx * dy
            g_exp = torch.exp(power)
            a_unc = d[ROW_OPAC][:, :, None] * g_exp
            alpha = torch.clamp(a_unc, max=ALPHA_MAX)
            cond = (power <= 0.0) & (alpha >= ALPHA_MIN) & in_range[:, :, None]
            alpha = torch.where(cond, alpha, 0.0)
            one_minus = 1.0 - alpha
            p_suffix = torch.flip(torch.cumprod(torch.flip(one_minus, [1]),
                                                dim=1), [1])
            t_run = t_run_all[sub][:, None, :]
            t_i = torch.where(p_suffix > 0.0, t_run / p_suffix, 0.0)
            w = alpha * t_i
            mask = (t_i * one_minus >= T_EPS).to(torch.float32)
            w_m = w * mask
            dCs = dC[sub]  # (n, 3, TILE_PIX)
            cdot = (d[ROW_R][:, :, None] * dCs[:, None, 0]
                    + d[ROW_G][:, :, None] * dCs[:, None, 1]
                    + d[ROW_B][:, :, None] * dCs[:, None, 2])
            v = w_m * cdot
            v_suffix = torch.flip(torch.cumsum(torch.flip(v, [1]), dim=1), [1])
            u_i = u_run_all[sub][:, None, :] + (v_suffix - v)
            dl_da = mask * t_i * cdot - u_i / one_minus
            dl_da = torch.where(cond & (a_unc < ALPHA_MAX), dl_da, 0.0)
            dl_dpower = dl_da * a_unc
            rows = torch.stack([
                (dl_dpower * -(cxx * dx + cxy * dy)).sum(-1),
                (dl_dpower * -(cyy * dy + cxy * dx)).sum(-1),
                (dl_dpower * (-0.5 * dx * dx)).sum(-1),
                (dl_dpower * (-dx * dy)).sum(-1),
                (dl_dpower * (-0.5 * dy * dy)).sum(-1),
                (dl_da * g_exp).sum(-1),
                torch.bmm(w_m, dCs[:, 0, :, None])[..., 0],
                torch.bmm(w_m, dCs[:, 1, :, None])[..., 0],
                torch.bmm(w_m, dCs[:, 2, :, None])[..., 0],
            ])  # (9, n, CHUNK)
            grad[:ROW_B + 1, cols[in_range]] = rows[:, in_range]
            t_run_all[sub] = torch.where(p_suffix[:, 0] > 0.0,
                                         t_run[:, 0] / p_suffix[:, 0], 0.0)
            u_run_all[sub] = u_run_all[sub] + v.sum(dim=1)
            k += 1
    return grad


def rasterize_backward(pair_data, tile_start, tile_count, cend, tfinal,
                       dcolor, dalpha, background, tiles_x: int,
                       tiles_y: int):
    """Per-pair gradients of the compositing: the VJP of `rasterize_forward`.

    pair_data / tile_start / tile_count / background as for
    `rasterize_forward`; cend and tfinal are its outputs; dcolor (3, Hp, Wp)
    and dalpha (Hp, Wp) the cotangents of the color and of alpha = 1 -
    tfinal. Returns (16, A + 128) f32: rows 0..8 are d[px, py, cxx, cxy, cyy,
    opacity, r, g, b] per pair, everything else zero (pairs past a tile's
    composited chunks included).
    """
    if pair_data.device.type == "cpu":
        return rasterize_backward_plain(pair_data, tile_start, tile_count,
                                        cend, tfinal, dcolor, dalpha,
                                        background, tiles_x, tiles_y)
    background = background.to(torch.float32).contiguous()
    kernels.require_cuda("rasterize_backward", pair_data, tile_start,
                         tile_count, cend, tfinal, dcolor, dalpha, background)
    num_tiles = tiles_x * tiles_y
    Hp, Wp = tiles_y * TILE_H, tiles_x * TILE_W
    if (pair_data.dtype != torch.float32 or pair_data.dim() != 2
            or pair_data.shape[0] != N_ROWS
            or any(t.dtype != torch.int32 or t.shape != (num_tiles,)
                   for t in (tile_start, tile_count, cend))
            or any(t.dtype != torch.float32
                   for t in (tfinal, dcolor, dalpha))
            or tfinal.shape != (Hp, Wp) or dalpha.shape != (Hp, Wp)
            or dcolor.shape != (3, Hp, Wp) or background.numel() != 3):
        raise ValueError(
            f"rasterize_backward: bad inputs pair_data {pair_data.dtype} "
            f"{tuple(pair_data.shape)}, tfinal {tuple(tfinal.shape)}, "
            f"dcolor {tuple(dcolor.shape)}, dalpha {tuple(dalpha.shape)}, "
            f"tiles {tiles_x} x {tiles_y}"
        )
    grad = torch.zeros((N_ROWS, pair_data.shape[1]), dtype=torch.float32,
                       device=pair_data.device)
    lib = kernels.library()
    rc = lib.log_rasterize_bwd(
        kernels.ptr(pair_data), pair_data.shape[1], kernels.ptr(tile_start),
        kernels.ptr(tile_count), kernels.ptr(cend), num_tiles, tiles_x,
        tiles_y, kernels.ptr(tfinal), kernels.ptr(dcolor),
        kernels.ptr(dalpha), kernels.ptr(background), kernels.ptr(grad),
        kernels.stream(),
    )
    kernels.check(rc, "rasterize_backward")
    kernels.LAUNCHES["rasterize_bwd"] += 1
    return grad


# --------------------------------------------------------------------------
# autograd: the VJPs of the sort, K4 and K1 (K3's lives in ops/expand.py)
# --------------------------------------------------------------------------
class SortPermute(torch.autograd.Function):
    """values[:, perm]; the VJP scatters the cotangent back by perm. perm is
    a permutation, so the scatter is an assignment, not an accumulation."""

    @staticmethod
    def forward(ctx, values, perm):
        ctx.save_for_backward(perm)
        return values[:, perm]

    @staticmethod
    def backward(ctx, g):
        (perm,) = ctx.saved_tensors
        out = torch.empty_like(g)
        out[:, perm] = g
        return out, None


def sort_pairs(key_tile, key_depth, key_gid, values, num_tiles: int):
    """Sort pair records by (tile, depth, gid): a stable sort by gid, then a
    stable sort by the int64 key tile << 32 | order-preserving depth bits.
    values: (R, A) payload rows, permuted through `SortPermute` (its VJP
    scatters the cotangent back). num_tiles (the tail sentinel of
    key_tile) is the JAX signature's; the sort needs no bound.
    Returns (tile_sorted, gid_sorted, values_sorted, perm)."""
    del num_tiles
    _, by_gid = torch.sort(key_gid, stable=True)
    key = ((key_tile[by_gid].to(torch.int64) << 32)
           | _depth_order_bits(key_depth[by_gid]))
    _, order = torch.sort(key, stable=True)
    perm = by_gid[order]
    return (key_tile[perm], key_gid[perm], SortPermute.apply(values, perm),
            perm)


class PackRows(torch.autograd.Function):
    """`pack_rows` (K4) with a VJP: row r's cotangent is g[r, :A]."""

    @staticmethod
    def forward(ctx, n_out, spare, *rows):
        ctx.A = rows[0].shape[0]
        return pack_rows(list(rows), n_out, spare)

    @staticmethod
    def backward(ctx, g):
        return (None, None) + tuple(
            g[r, :ctx.A] if need else None
            for r, need in enumerate(ctx.needs_input_grad[2:])
        )


class RasterCore(torch.autograd.Function):
    """`rasterize_forward` (K1) with `rasterize_backward` (K2) as its VJP.

    Saves the pair array, the tile runs, the background, tfinal and cend;
    the public alpha is 1 - tfinal, so K2 gets dalpha = -d_tfinal. The
    background's cotangent is sum(tfinal * d_color) per channel. pid, pwp,
    pair_w and cend are not differentiable.
    """

    @staticmethod
    def forward(ctx, pair_data, tile_start, tile_count, background,
                tiles_x, tiles_y, with_stats):
        out = rasterize_forward(pair_data, tile_start, tile_count, background,
                                tiles_x, tiles_y, with_stats)
        _color, tfinal, pid, pwp, pair_w, cend = out
        ctx.save_for_backward(pair_data, tile_start, tile_count, background,
                              tfinal, cend)
        ctx.tiles = (tiles_x, tiles_y)
        ctx.mark_non_differentiable(pid, pwp, pair_w, cend)
        return out

    @staticmethod
    def backward(ctx, d_color, d_tfinal, *_):
        pair_data, tile_start, tile_count, background, tfinal, cend = (
            ctx.saved_tensors
        )
        pair_grad = rasterize_backward(
            pair_data, tile_start, tile_count, cend, tfinal,
            d_color.contiguous(), (-d_tfinal).contiguous(), background,
            *ctx.tiles,
        )
        d_bg = None
        if ctx.needs_input_grad[3]:
            d_bg = (tfinal[None] * d_color).sum(dim=(1, 2))
            d_bg = d_bg.to(background.dtype)
        return pair_grad, None, None, d_bg, None, None, None


# --------------------------------------------------------------------------
# public API
# --------------------------------------------------------------------------
def rasterize_tiled(
    xyz, colors, opacity, scaling, rotation, means2d_offset, world_view,
    full_proj, focal_x, focal_y, tan_fovx, tan_fovy, background,
    image_height: int, image_width: int, active_mask=None,
    mode: str = "antialias", use_filter: bool = True,
    max_pairs: int = 1 << 20, with_stats=True, tight_radius: bool = False,
    runs_tail_only: bool = False, prefix_mask=None, gid_ids=None,
):
    """Same output contract as rasterize_ref.rasterize, plus the binning's
    unclamped pair demand under "pair_total". Differentiable (under
    autograd) w.r.t. the float inputs through the projection, the K3
    expansion, the sort, K4 and K1, whose VJPs are plain torch and K2.

    gid_ids: optional (P,) int32 caller ids for the per-gaussian stat rows
    (ids >= P drop), so stats land directly in the caller's index space.
    runs_tail_only / prefix_mask: see expand_sort_pairs.
    """
    splats = project_gaussians(
        xyz, scaling, rotation, opacity, world_view, full_proj, focal_x,
        focal_y, tan_fovx, tan_fovy, image_height, image_width, mode=mode,
        use_filter=use_filter, means2d_offset=means2d_offset,
        active_mask=active_mask, tight_radius=tight_radius,
    )
    with span("raster.bin"):
        pairs = build_pairs(
            splats, colors, image_height, image_width, max_pairs,
            runs_tail_only=runs_tail_only,
            active_prefix=(prefix_mask if prefix_mask is not None
                           else active_mask),
            gid_ids=gid_ids,
        )
    with span("raster.composite"):
        color, tfinal, pid_pair, pwp, pair_w, _cend = RasterCore.apply(
            pairs["pair_data"], pairs["tile_start"], pairs["tile_count"],
            background, pairs["tiles_x"], pairs["tiles_y"], with_stats,
        )
    H, W = image_height, image_width
    A = pairs["pair_gid"].shape[0]
    P = xyz.shape[0]
    dev = xyz.device
    color = color[:, :H, :W]
    tfinal = tfinal[:H, :W]
    pwp = pwp[:H, :W]
    pid_pair = pid_pair[:H, :W]
    if with_stats:
        if with_stats is True:
            pid = torch.where((pid_pair >= 0) & (pid_pair < P), pid_pair, -1)
        else:  # "weights": per-point weights only, no pixel ownership map
            pid = torch.full((H, W), -1, dtype=torch.int32, device=dev)
        # per-gaussian max blend weight: segment max of pair weights by id
        point_weight = torch.zeros((P + 1,), dtype=torch.float32, device=dev)
        point_weight.scatter_reduce_(
            0, torch.clamp(pairs["pair_gid"], 0, P).to(torch.int64),
            pair_w[:A], reduce="amax",
        )
        point_weight = point_weight[:P]
    else:
        pid = torch.full((H, W), -1, dtype=torch.int32, device=dev)
        point_weight = torch.zeros((P,), dtype=torch.float32, device=dev)
    radii = torch.where(pairs["valid"], pairs["radius"], 0.0)
    return {
        "render": color,
        "radii": radii.to(torch.int32),
        "point_id_pixel": pid,
        "point_weight_pixel": pwp,
        "point_weight": point_weight,
        "alpha": 1.0 - tfinal,
        "depth_cam": splats.depth,
        "pair_total": pairs["total"],
    }
