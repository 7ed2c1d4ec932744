"""The point-sharded render of one camera; counterpart of
log_tpu/parallel/sharded_render.py.

Every per-point and per-pair stage runs on each rank's 1/n of the capacity
rows, and the compositing kernel K1 on image BANDS, sort-middle:

  1. local cut: the gather-free flat pre-cut (`flat_cut_pre`) over the
     rank's rows; the per-point caches it reads (root centers, parent
     attributes, tree ints) shard with the rows, so no communication;
  2. local compaction to a k_local slice, activation, projection;
  3. local expansion and one sort by (tile, depth, lane) (`expand_sort_pairs`:
     K3, or on the column flow K4 + K3p where k_local is a multiple of
     32,768), each pair carrying the global row of its point as its id,
     then a second sort by the INTERLEAVED band key;
  4. band exchange: one fixed-capacity bucket per (source, band owner),
     sliced at the band boundaries and exchanged by all_to_all; a run
     longer than the bucket is cut and the overflow reported. Band
     ownership is round-robin over tile rows (owner = tile_row mod n), so
     that every screen region spreads 1/n to each owner;
  5. band merge and kernel: the owner re-sorts the pairs it received by
     (tile, depth, global row), the single-device order, depth ties
     included (f32 depths tie often among millions of points), packs
     them (K4) and composites its band's tiles with K1 without stats. Pixel rows are rebased per pair (a pair renders
     exactly one tile, so shifting its splat center to the tile's local
     frame is exact);
  6. image assembly: the bands all_gathered and de-interleaved.

Row layout: `layout="strided"` expects the capacity rows permuted
round-robin (`interleave_shard_rows`), so that each rank holds a spatially
uniform sample of the points; it is a bijection on rows and every
per-point stage is elementwise, so the image does not change.

Correctness contract: the pairs are ordered as the single-device sort
orders them, so the image matches the single-device flat_slice frame
without the root weight cull (`fused_prepare_render(check_cull=False,
pack_pairs=False)`) to float tolerance. The cull is a conservative
occlusion test, left out here to save its collectives.

The functional entry takes the global capacity-padded arrays on every rank
(each rank reads its block of rows) and returns the whole image on every
rank.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..model.tensor_tree import flat_cut_pre
from ..model.train_step import _compact_slices_gather
from ..model.train_step import _normalize_rows as _normalize
from ..ops import gaussian_math as gm
from ..ops.projection import project_gaussians, project_gaussians_cols
from ..ops import rasterize_tiled as rt
from ..ops.rasterize_tiled import (ROW_DEPTH, ROW_PY, TILE_H, TILE_W,
                                   expand_sort_pairs, pack_sorted_pairs,
                                   sort_pairs)
from ..ops.sh import eval_sh, sh_to_rgb
from .comm import Comm
from .mesh import shard_rows

PARAM_KEYS = ("xyz", "colors", "scaling", "opacity", "rotation", "shs")
TREE_KEYS = ("index_parent", "node_index", "depth", "root_xyz", "parent_xyz",
             "parent_scaling", "parent_rotation")


@dataclass(frozen=True)
class ShardedRenderConfig:
    image_height: int
    image_width: int
    n_devices: int
    k_local: int           # per-rank visible-slice budget
    max_pairs_local: int   # per-rank pair budget (a multiple of 512)
    bucket_pairs: int      # per-(source, band owner) exchange capacity
    sh_degree: int = 0
    mode: str = "antialias"
    min_res_pixel: float = 3.0
    layout: str = "contiguous"  # "contiguous", or "strided": rows permuted
    #   by interleave_shard_rows (rank s's local row j holds global row
    #   j * n + s, so it is alive where j * n + s < n_alive)

    @property
    def tiles_x(self) -> int:
        return -(-self.image_width // TILE_W)

    @property
    def band_ty(self) -> int:
        tiles_y = -(-self.image_height // TILE_H)
        return -(-tiles_y // self.n_devices)

    @property
    def tiles_y_pad(self) -> int:
        return self.band_ty * self.n_devices

    @property
    def height_pad(self) -> int:
        # padded so that every band owns as many tile rows
        return self.tiles_y_pad * TILE_H

    @property
    def band_tiles(self) -> int:
        return self.band_ty * self.tiles_x

    @property
    def merge_pairs(self) -> int:
        return self.bucket_pairs * self.n_devices


def interleave_shard_rows(arrays: dict, n: int) -> dict:
    """The capacity rows of every array permuted for layout="strided": rank
    s's local row j holds global row j * n + s. Bijective on rows; the flat
    cut reads only per-point caches, so the render may use it (tree
    traversal, which follows row-index columns, may not)."""
    out = {}
    for k, v in arrays.items():
        cap = v.shape[0]
        if cap % n:
            raise ValueError(f"{k}: {cap} rows do not split over {n} ranks")
        capl = cap // n
        idx = torch.arange(cap, device=v.device)
        out[k] = v[(idx % capl) * n + idx // capl]
    return out


def _local_cut(params_l, tree_l, cam, alive, min_res, current_depth):
    """flat_cut_pre over the local rows: every input per point, no
    communication."""
    rx = tree_l["root_xyz"]
    rpx, rpy, rpz, _ = gm.project_ndc_c(rx[:, 0], rx[:, 1], rx[:, 2],
                                        cam["full_proj"])
    root_frus = gm.frustum_flag_c(rpx, rpy, rpz, padding=0.5) & alive
    cam_args = (cam["world_view"], cam["full_proj"], cam["focal_x"],
                cam["focal_y"], cam["tan_fovx"], cam["tan_fovy"])
    radius2d = gm.compute_radius2d(
        params_l["xyz"], torch.exp(params_l["scaling"]),
        _normalize(params_l["rotation"]), *cam_args)
    radius2d_parent = gm.compute_radius2d(
        tree_l["parent_xyz"], torch.exp(tree_l["parent_scaling"]),
        _normalize(tree_l["parent_rotation"]), *cam_args)
    return flat_cut_pre(tree_l["index_parent"], tree_l["node_index"],
                        tree_l["depth"], root_frus, radius2d, radius2d_parent,
                        alive, min_res, current_depth)


def _local_pairs(params_l, cam, keep, global_row, cfg: ShardedRenderConfig):
    """Compaction, activation, projection and the sorted pairs of the local
    slice (`expand_sort_pairs`), each pair's id the global row of its
    point: the single-device frame breaks depth ties by lane, which is
    global row order, and so does the owner's merge-sort."""
    need = ["xyz", "colors", "scaling", "opacity", "rotation"]
    use_cols = not (cfg.sh_degree > 0 and "shs" in params_l)
    if not use_cols:
        need.append("shs")
    slices, index, lane_valid = _compact_slices_gather(
        {k: params_l[k] for k in need}, keep, cfg.k_local)
    capl = global_row.shape[0]
    ids = torch.where(lane_valid,
                      global_row[torch.clamp(index.long(), max=capl - 1)],
                      capl * cfg.n_devices)
    cam_args = (cam["world_view"], cam["full_proj"], cam["focal_x"],
                cam["focal_y"], cam["tan_fovx"], cam["tan_fovy"])
    if use_cols:
        # the column flow: 1-D payloads through activation, projection and
        # the pair rows (K4 + K3p where the slice allows)
        x, y, z = slices["xyz"].unbind(1)
        sx, sy, sz = torch.exp(slices["scaling"]).unbind(1)
        qw, qx, qy, qz = slices["rotation"].unbind(1)
        splats = project_gaussians_cols(
            x, y, z, sx, sy, sz, qw, qx, qy, qz,
            torch.sigmoid(slices["opacity"][:, 0]), *cam_args,
            cfg.height_pad, cfg.image_width, mode=cfg.mode, use_filter=False,
            active_mask=lane_valid, tight_radius=True)
        colors = tuple(sh_to_rgb(slices["colors"]).unbind(1))
    else:
        colors = sh_to_rgb(slices["colors"])
        dirs = _normalize(slices["xyz"] - cam["camera_center"][None])
        colors = colors + eval_sh(dirs, slices["shs"], degree=cfg.sh_degree)
        splats = project_gaussians(
            slices["xyz"], torch.exp(slices["scaling"]),
            slices["rotation"] / torch.linalg.norm(slices["rotation"], dim=-1,
                                                   keepdim=True),
            torch.sigmoid(slices["opacity"][:, 0]), *cam_args,
            cfg.height_pad, cfg.image_width, mode=cfg.mode, use_filter=False,
            means2d_offset=torch.zeros((cfg.k_local, 2),
                                       device=lane_valid.device),
            active_mask=lane_valid, tight_radius=True)
    return expand_sort_pairs(splats, colors, cfg.height_pad, cfg.image_width,
                             cfg.max_pairs_local, runs_tail_only=True,
                             active_prefix=lane_valid, gid_ids=ids)


def _shard_render(params_l, tree_l, cam, n_alive, min_res, current_depth,
                  background, cfg: ShardedRenderConfig, comm: Comm):
    """One rank's part of the frame: returns its band's color (3, band_ty *
    TILE_H, tiles_x * TILE_W), alpha and the stats vector."""
    n = cfg.n_devices
    me = comm.rank
    capl = params_l["xyz"].shape[0]
    dev = params_l["xyz"].device
    local = torch.arange(capl, device=dev)
    global_row = (local * n + me if cfg.layout == "strided"
                  else local + me * capl)
    alive = global_row < n_alive

    # ---- 1-3: local cut, slice, pairs sorted by (tile, depth, lane) ----
    keep = _local_cut(params_l, tree_l, cam, alive, min_res, current_depth)
    count_local = keep.sum()
    es = _local_pairs(params_l, cam, keep, global_row, cfg)
    tile_s, gid_s, values_s = es["tile_s"], es["gid_s"], es["values_s"]
    num_tiles = es["num_tiles"]
    band_tiles = cfg.band_tiles

    # ---- 3b: the interleaved band key, and a re-sort by it -------------
    # owner(tile) = tile_row mod n; the owner's local grid is row-major
    # over (band_ty, tiles_x) with local row tile_row // n: a bijection on
    # tile ids, so bands are contiguous runs of the re-sorted pairs and the
    # order inside a tile is untouched
    trow = tile_s // cfg.tiles_x
    tcol = tile_s - trow * cfg.tiles_x
    rk = (trow % n) * band_tiles + (trow // n) * cfg.tiles_x + tcol
    rk = torch.where(tile_s >= num_tiles, num_tiles, rk)
    tile_s, gid_s, values_s, _ = sort_pairs(rk, values_s[ROW_DEPTH], gid_s,
                                            values_s, num_tiles)

    # ---- 4: the fixed-bucket band exchange -----------------------------
    Bcap = cfg.bucket_pairs
    bounds = torch.arange(n + 1, dtype=torch.int32, device=dev) * band_tiles
    starts = torch.searchsorted(tile_s, bounds, side="left")
    lens = (starts[1:] - starts[:-1]).to(torch.int32)  # pairs per band
    overflow = torch.clamp(lens - Bcap, min=0).max()
    iota_b = torch.arange(Bcap, device=dev)
    cols = starts[:-1, None] + iota_b[None, :]           # (n, Bcap)

    def buckets(rows, fill):
        pad = rows.new_full(rows.shape[:-1] + (Bcap,), fill)
        return torch.cat([rows, pad], dim=-1)[..., cols]

    in_run = iota_b[None, :] < lens[:, None]
    tile_b = torch.where(in_run, buckets(tile_s, num_tiles), num_tiles)
    ints_b = torch.stack([tile_b, buckets(gid_s, 0)], dim=1)  # (n, 2, Bcap)
    vals_b = buckets(values_s, 0.0).permute(1, 0, 2)          # (n, 10, Bcap)
    ints_r = comm.all_to_all(ints_b.contiguous(), 0, 0)
    vals_r = comm.all_to_all(vals_b.contiguous(), 0, 0)
    tile_r = ints_r[:, 0].reshape(-1)                         # (n * Bcap,)
    gid_r = ints_r[:, 1].reshape(-1)
    vals_r = vals_r.permute(1, 0, 2).reshape(values_s.shape[0], -1).clone()

    # ---- 5: rebase to the band, merge-sort, pack, K1 -------------------
    tl = tile_r - me * band_tiles
    in_band = (tl >= 0) & (tl < band_tiles)
    tl = torch.where(in_band, tl, band_tiles)
    dkey = torch.where(in_band, vals_r[ROW_DEPTH], float("inf"))
    # the owner's local tile row j is global tile row j * n + me: shift each
    # pair's center y into the band's frame (exact: a pair renders one
    # tile, where local y = global y - (j (n - 1) + me) TILE_H)
    jrow = (tl // cfg.tiles_x).to(torch.float32)
    vals_r[ROW_PY] = vals_r[ROW_PY] - (jrow * (n - 1) + me) * float(TILE_H)
    tile_s2, gid_s2, values_s2, _ = sort_pairs(tl, dkey, gid_r, vals_r,
                                               band_tiles)
    packed = pack_sorted_pairs(tile_s2, gid_s2, values_s2, cfg.tiles_x,
                               cfg.band_ty)
    # K1 by module attribute, so that a swapped-in plain version is seen
    color, tfinal, *_ = rt.rasterize_forward(
        packed["pair_data"], packed["tile_start"], packed["tile_count"],
        background, cfg.tiles_x, cfg.band_ty, False)
    # stats[3:]: the (n_src, n_dst) exchange-length matrix, row-major
    lens_all = comm.all_gather(lens, tiled=False).reshape(-1)
    stats = torch.cat([
        torch.stack([comm.psum(count_local.to(torch.int32)),
                     comm.psum(lens.sum().to(torch.int32)),
                     comm.pmax(overflow)]),
        lens_all])
    return color, 1.0 - tfinal, stats


@torch.no_grad()
def sharded_render_frame(params: dict, tree_arrays: dict, cam: dict,
                         n_alive, min_res, current_depth, background,
                         cfg: ShardedRenderConfig, comm: Comm | None = None):
    """One camera, the whole frame, every stage sharded over the ranks.

    params / tree_arrays: the global capacity-padded dicts (capacity a
    multiple of cfg.n_devices; in the strided layout already permuted by
    interleave_shard_rows), the same on every rank; cam: a camera_device
    dict. Returns, on every rank, (render (3, H, W), alpha (H, W), stats
    (3 + n^2,) int32: cut total, pairs exchanged, largest bucket overflow,
    then the (n_src, n_dst) exchange-length matrix, row-major).
    """
    comm = comm if comm is not None else Comm()
    n = cfg.n_devices
    if comm.world != n:
        raise ValueError(f"{n}-rank render on a {comm.world}-rank group")
    r = comm.rank
    params_l = {k: shard_rows(v, r, n) for k, v in params.items()
                if k in PARAM_KEYS}
    tree_l = {k: shard_rows(v, r, n) for k, v in tree_arrays.items()
              if k in TREE_KEYS}
    bg = torch.as_tensor(background, dtype=torch.float32,
                         device=params_l["xyz"].device)
    color, alpha, stats = _shard_render(
        params_l, tree_l, cam, int(n_alive), float(min_res),
        int(current_depth), bg, cfg, comm)
    # de-interleave: owner d's band rows are global tile rows d, d + n, ...
    bty = cfg.band_ty
    Wk = color.shape[-1]
    color = comm.all_gather(color, tiled=False)          # (n, 3, Hb, Wk)
    color = color.reshape(n, 3, bty, TILE_H, Wk).permute(1, 2, 0, 3, 4)
    color = color.reshape(3, cfg.height_pad, Wk)
    alpha = comm.all_gather(alpha, tiled=False)
    alpha = alpha.reshape(n, bty, TILE_H, Wk).permute(1, 0, 2, 3)
    alpha = alpha.reshape(cfg.height_pad, Wk)
    H, W = cfg.image_height, cfg.image_width
    return color[:, :H, :W], alpha[:H, :W], stats
