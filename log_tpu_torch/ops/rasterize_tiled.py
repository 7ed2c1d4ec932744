"""Tiled rasterizer, forward half; counterpart of log_tpu/ops/rasterize_tiled.py.

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

Every kernel wrapper takes its plain torch version for CPU tensors and
launches the CUDA kernel (csrc/) for CUDA tensors. Integer rows (offsets,
rect geometry, ids) are int32 tensors; the gaussian id rides row 10 of the
packed pair array as raw int32 bits.

Tile geometry is fixed at 8 x 128 pixels, as in the JAX package, so pair
counts, tile keys and the pair demand match it exactly.
"""
from __future__ import annotations

import ctypes

import torch

from . import kernels
from .expand import expand_with_keys
from .projection import ALPHA_MAX, ALPHA_MIN, T_EPS, project_gaussians

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
_STATS_LEVEL = {False: 0, "weights": 1, True: 2}


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
                      active_prefix=None, gid_ids=None):
    """Binning up to the sort: rects -> pair expansion (K3) -> one sort by
    (tile, depth, lane). Returns a dict with the SORTED pair rows (tile_s
    int32 with `num_tiles` as the tail sentinel, gid_s int32, values_s
    (10, A) f32, perm_s), the pre-sort `real` mask, the grid geometry, the
    splats' radius/valid and `total`, the UNCLAMPED pair demand (int32,
    capped at 2^30) that callers size the next frame's budget from.

    runs_tail_only: the caller promises `active_prefix` is a prefix mask
    (compacted slices). Every prefix lane then emits >= 1 pair (invalid
    lanes a sanitized zero-alpha record on the sentinel tile row), so
    zero-count runs exist only in the tail, as in the JAX package.
    """
    px_x = splats.pix_xy[:, 0]
    px_y = splats.pix_xy[:, 1]
    cn_xx = splats.conic[:, 0]
    cn_xy = splats.conic[:, 1]
    cn_yy = splats.conic[:, 2]
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

    geo = x0 + 32 * (y0 + 512 * torch.clamp(rect_w, min=1))
    id_row = (torch.arange(P, dtype=torch.int32, device=dev)
              if gid_ids is None else gid_ids.to(torch.int32))
    vals = torch.stack([
        px_x, px_y, cn_xx, cn_xy, cn_yy, splats.opacity,
        colors[:, 0], colors[:, 1], colors[:, 2], splats.depth,
    ]).to(torch.float32).contiguous()
    ints = torch.stack([offsets, geo.to(torch.int32), id_row]).contiguous()
    vals_pc, ints_pc, tile_key, depth_key = expand_with_keys(
        vals, ints, total_c, A, tiles_x, num_tiles
    )
    real = tile_key < num_tiles

    key = (tile_key.to(torch.int64) << 32) | _depth_order_bits(depth_key)
    _, perm = torch.sort(key, stable=True)
    return {
        "tile_s": tile_key[perm],
        "gid_s": ints_pc[2][perm],
        "values_s": vals_pc[:, perm],
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
    pair_data = pack_rows([values_s[r] for r in range(N_VAL_ROWS)] + [gid_s])
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
def _tiles_to_image(x, tiles_x: int, tiles_y: int):
    """(num_tiles, C, TILE_PIX) per-tile rows -> (C, Hp, Wp) image."""
    C = x.shape[1]
    x = x.reshape(tiles_y, tiles_x, C, TILE_H, TILE_W)
    return x.permute(2, 0, 3, 1, 4).reshape(C, tiles_y * TILE_H,
                                            tiles_x * TILE_W)


def rasterize_forward_plain(pair_data, tile_start, tile_count, background,
                            tiles_x: int, tiles_y: int, with_stats,
                            tile_group: int = 256):
    """Plain torch version of `rasterize_forward` (same contract).

    Vectorized over groups of tiles and walks their runs chunk by chunk,
    with the transmittance inside a chunk as a cumprod (rasterize_ref's
    formulation); tiles leave the walk when saturated, like the kernel.
    """
    stats = _stats_level(with_stats)
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
    gid_row = pair_data[ROW_GID].view(torch.int32)
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
            dx = d[ROW_PX][:, :, None] - (org_x[sub, None] + lane_x)[:, None]
            dy = d[ROW_PY][:, :, None] - (org_y[sub, None] + lane_y)[:, None]
            power = (
                -0.5 * (d[ROW_CXX][:, :, None] * dx * dx
                        + d[ROW_CYY][:, :, None] * dy * dy)
                - d[ROW_CXY][:, :, None] * dx * dy
            )  # (n, CHUNK, TILE_PIX)
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
# public API
# --------------------------------------------------------------------------
@torch.no_grad()
def rasterize_tiled(
    xyz, colors, opacity, scaling, rotation, means2d_offset, world_view,
    full_proj, focal_x, focal_y, tan_fovx, tan_fovy, background,
    image_height: int, image_width: int, active_mask=None,
    mode: str = "antialias", use_filter: bool = True,
    max_pairs: int = 1 << 20, with_stats=True, tight_radius: bool = False,
    runs_tail_only: bool = False, prefix_mask=None, gid_ids=None,
):
    """Same output contract as rasterize_ref.rasterize, plus the binning's
    unclamped pair demand under "pair_total".

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
    pairs = build_pairs(
        splats, colors, image_height, image_width, max_pairs,
        runs_tail_only=runs_tail_only,
        active_prefix=prefix_mask if prefix_mask is not None else active_mask,
        gid_ids=gid_ids,
    )
    color, tfinal, pid_pair, pwp, pair_w, _cend = rasterize_forward(
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
