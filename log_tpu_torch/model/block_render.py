"""Block-pruned inference render; counterpart of log_tpu/model/block_render.py.

Per-frame cost scales with the visible working set instead of the point
capacity. After `LoG.optimize_render_layout` the rows are grouped so that
LoD coarseness and camera frustum map to contiguous row blocks of S rows:

  * `build_block_cache` prepacks the frame inputs once per layout change
    into an (N_COLS, B, S) tensor (xyz f32; cov3d, opacity + rgb, parent
    and root attributes as bf16 pairs in 32-bit words; flags and root ids
    as int32) plus conservative per-block metadata;
  * `block_eligibility` drops a block only when no row in it can pass the
    flat cut for this camera (its padded bbox is outside the frustum, or
    its parents all project below min_resolution_pixel and it holds no
    root);
  * `select_blocks` compacts the eligible block ids, and `render_blocks`
    takes those blocks' columns and runs the flat_slice frame's packed path
    (projection, cut, compaction, K3p, K4, K5) over k_blocks * S rows.

There is no kernel of its own here: the frame's compaction is K6 under
LOG_TPU_COMPACT=pallas, and its render is K3p, K4 and K5.
"""
from __future__ import annotations

import torch

from ..ops import gaussian_math as gm
from ..ops.projection import NEAR_Z, SplatCols, screen_splat
from ..ops.rasterize_tiled import PACKED_ID_LIMIT, pack2_bf16, unpack2_bf16
from ..ops.sh import sh_to_rgb
from .tensor_tree import flat_cut_pre

# column ids of the (N_COLS, B, S) prepack (int32 words; f32 columns as
# raw bits)
C_X, C_Y, C_Z = 0, 1, 2                    # world position, f32
C_SXX_SXY, C_SXZ_SYY, C_SYZ_SZZ = 3, 4, 5  # cov3d, bf16 pairs
C_OP_R, C_G_B = 6, 7                       # activated opacity + rgb, bf16
C_PX_PY, C_PZ_PXX, C_PXY_PXZ, C_PYY_PYZ, C_PZZ = 8, 9, 10, 11, 12  # parent
C_RX_RY, C_RZ = 13, 14                     # root center, bf16 pairs
C_FLAGS = 15                               # depth | leaf<<8 | root<<9 |
#                                            leaf_opt<<10 | alive<<11
C_ROOT_ID = 16                             # root row id
N_COLS = 17

FLAG_LEAF = 1 << 8
FLAG_ROOT = 1 << 9
FLAG_LEAF_OPT = 1 << 10
FLAG_ALIVE = 1 << 11


def block_size_for(cap: int, target: int = 4096) -> int:
    """Largest power of two <= target dividing cap."""
    s = 1
    while s * 2 <= target and cap % (s * 2) == 0:
        s *= 2
    return s


@torch.no_grad()
def build_block_cache(params: dict, tree_arrays: dict, is_leaf_opt, n_alive,
                      S: int):
    """The (N_COLS, B, S) int32 frame-input prepack and the per-block
    metadata. All bf16 rounding happens here, once per layout change."""
    cap = params["xyz"].shape[0]
    B = cap // S
    dev = params["xyz"].device
    alive = torch.arange(cap, device=dev) < n_alive
    xyz = params["xyz"]
    scaling = torch.exp(params["scaling"])
    cov = gm.build_cov3d_c(scaling, params["rotation"])
    op = torch.sigmoid(params["opacity"][:, 0])
    rgb = sh_to_rgb(params["colors"])
    pscal = torch.exp(tree_arrays["parent_scaling"])
    pcov = gm.build_cov3d_c(pscal, tree_arrays["parent_rotation"])
    pxyz = tree_arrays["parent_xyz"]
    rxyz = tree_arrays["root_xyz"]
    is_leaf = tree_arrays["node_index"] == -1
    is_root = tree_arrays["index_parent"] == -1
    zero = torch.zeros_like(op)
    flags = (torch.clamp(tree_arrays["depth"], 0, 255).to(torch.int32)
             | torch.where(is_leaf, FLAG_LEAF, 0)
             | torch.where(is_root, FLAG_ROOT, 0)
             | torch.where(is_leaf_opt, FLAG_LEAF_OPT, 0)
             | torch.where(alive, FLAG_ALIVE, 0)).to(torch.int32)

    def bits(x):
        return x.contiguous().view(torch.int32)

    cols = torch.stack([
        bits(xyz[:, 0]), bits(xyz[:, 1]), bits(xyz[:, 2]),
        pack2_bf16(cov[0], cov[1]), pack2_bf16(cov[2], cov[3]),
        pack2_bf16(cov[4], cov[5]),
        pack2_bf16(op, rgb[:, 0]), pack2_bf16(rgb[:, 1], rgb[:, 2]),
        pack2_bf16(pxyz[:, 0], pxyz[:, 1]), pack2_bf16(pxyz[:, 2], pcov[0]),
        pack2_bf16(pcov[1], pcov[2]), pack2_bf16(pcov[3], pcov[4]),
        pack2_bf16(pcov[5], zero),
        pack2_bf16(rxyz[:, 0], rxyz[:, 1]), pack2_bf16(rxyz[:, 2], zero),
        flags, tree_arrays["root_id"].to(torch.int32),
    ]).reshape(N_COLS, B, S)

    big = 3.4e38
    x3 = xyz.reshape(B, S, 3)
    am = alive.reshape(B, S, 1)
    smax = scaling.max(dim=-1).values
    psmax = pscal.max(dim=-1).values
    meta = {
        "bbox_min": torch.where(am, x3, big).min(dim=1).values,
        "bbox_max": torch.where(am, x3, -big).max(dim=1).values,
        "s3d": 3.0 * torch.where(alive, smax, 0.0).reshape(B, S)
        .max(dim=1).values,
        "parent_s3d": 3.0 * torch.where(alive, psmax, 0.0).reshape(B, S)
        .max(dim=1).values,
        "any_root": (is_root & alive).reshape(B, S).any(dim=1),
        "any_alive": alive.reshape(B, S).any(dim=1),
    }
    return cols, meta


def block_eligibility(meta: dict, cam: dict, min_resolution_pixel,
                      pad: float = 0.5, slack: float = 2.0):
    """Conservative per-block keep test for the flat cut: a block drops
    only when all 8 corners of its bbox (inflated by the block's 3-sigma
    extent) violate the same padded clip plane with w > 0, or when it has
    no root and its parents' projected radius bound (3 sigma * focal *
    slack / z_min, the parent's z shrunk by half its extent) falls below
    min_resolution_pixel. A camera inside the bbox keeps the block."""
    bmin = meta["bbox_min"] - meta["s3d"][:, None]
    bmax = meta["bbox_max"] + meta["s3d"][:, None]
    sel = torch.tensor(
        [[0, 0, 0], [0, 0, 1], [0, 1, 0], [0, 1, 1],
         [1, 0, 0], [1, 0, 1], [1, 1, 0], [1, 1, 1]],
        dtype=torch.float32, device=bmin.device,
    )
    corners = bmin[:, None, :] * (1 - sel)[None] + bmax[:, None, :] * sel[None]
    cx, cy, cz = corners[..., 0], corners[..., 1], corners[..., 2]
    fp = cam["full_proj"]
    px = cx * fp[0, 0] + cy * fp[1, 0] + cz * fp[2, 0] + fp[3, 0]
    py = cx * fp[0, 1] + cy * fp[1, 1] + cz * fp[2, 1] + fp[3, 1]
    pz = cx * fp[0, 2] + cy * fp[1, 2] + cz * fp[2, 2] + fp[3, 2]
    pw = cx * fp[0, 3] + cy * fp[1, 3] + cz * fp[2, 3] + fp[3, 3]
    wpos = pw > 1e-6
    lim = pw * (1.0 + pad)
    out = (((px > lim) & wpos).all(dim=1) | ((px < -lim) & wpos).all(dim=1)
           | ((py > lim) & wpos).all(dim=1) | ((py < -lim) & wpos).all(dim=1)
           | ((pz < 0.0) & wpos).all(dim=1) | ((pz > pw) & wpos).all(dim=1))
    wv = cam["world_view"]
    tz = cx * wv[0, 2] + cy * wv[1, 2] + cz * wv[2, 2] + wv[3, 2]
    z_min = tz.min(dim=1).values - 0.5 * meta["parent_s3d"]
    focal = max(float(cam["focal_x"]), float(cam["focal_y"]))
    proj_parent = torch.where(
        z_min > 1e-6,
        meta["parent_s3d"] * focal * slack / torch.clamp(z_min, min=1e-6)
        + 1.0,
        3.4e38,
    )
    return (meta["any_alive"] & ~out
            & (meta["any_root"] | (proj_parent >= min_resolution_pixel)))


def select_blocks(eligible, k_blocks: int):
    """Eligible block ids to the front, in order. Returns (blk_ids
    (k_blocks,) int64 with B as the pad sentinel, n_eligible)."""
    B = eligible.shape[0]
    pos = torch.arange(B, dtype=torch.int64, device=eligible.device)
    key_s = torch.sort(torch.where(eligible, pos, B + pos)).values[:k_blocks]
    blk_ids = torch.where(key_s < B, key_s, B)
    return blk_ids, eligible.sum()


def _take_blocks(x, blk_ids, B: int):
    """x[..., blk_ids, :] along the block axis (dim -2) with zero rows for
    the sentinel id B."""
    pad = torch.zeros(x.shape[:-2] + (1, x.shape[-1]), dtype=x.dtype,
                      device=x.device)
    return torch.cat([x, pad], dim=-2)[..., blk_ids, :]


def block_stages(cols, meta: dict, cam: dict, min_resolution_pixel,
                 current_depth, background, image_height: int,
                 image_width: int, k_blocks: int, k_visible: int,
                 max_pairs: int, w_full=None, mode: str = "antialias",
                 use_filter: bool = False):
    """The block-pruned frame as named stages over one state dict;
    `run_stages` of them is `render_blocks`, and the frame's dissection
    (scripts/bench_frame_dissect.py) times them one by one:

      select: block eligibility (and the cached cull's any-row test), the
        eligible block ids to the front -> "blk_ids", "counts" (n_elig);
      take: the k_blocks blocks of the prepack -> "g" (N_COLS, rows);
      project: unpack, the own splat and the cut radius from one cov2d,
        the parents' cut radius -> "splats", "rgb", "radius2d", ...;
      cut: the flat cut on the flag columns (and the cached cull's rows)
        -> "keep", "counts" (leaf, node, n_elig);
      compact, check, pairs, kernel: `packed_frame_stages` (no slice cull).
    """
    from .train_step import packed_frame_stages

    S = cols.shape[2]
    B = cols.shape[1]
    n_rows = k_blocks * S

    def select_stage(s):
        eligible = block_eligibility(meta, cam, min_resolution_pixel)
        if w_full is not None:
            # a block whose rows were all weight-culled cannot contribute
            eligible = eligible & w_full.reshape(B, S).any(dim=1)
        s["blk_ids"], n_elig = select_blocks(eligible, k_blocks)
        s["counts"] = n_elig[None]

    def take_stage(s):
        s["g"] = _take_blocks(cols, s["blk_ids"], B).reshape(N_COLS, n_rows)

    def project_stage(s):
        g = s["g"]

        def f32(c):
            return g[c].view(torch.float32)

        x, y, z = f32(C_X), f32(C_Y), f32(C_Z)
        sxx, sxy = unpack2_bf16(g[C_SXX_SXY])
        sxz, syy = unpack2_bf16(g[C_SXZ_SYY])
        syz, szz = unpack2_bf16(g[C_SYZ_SZZ])
        op, col_r = unpack2_bf16(g[C_OP_R])
        col_g, col_b = unpack2_bf16(g[C_G_B])
        pxx_, pyy_ = unpack2_bf16(g[C_PX_PY])
        pz_, pcxx = unpack2_bf16(g[C_PZ_PXX])
        pcxy, pcxz = unpack2_bf16(g[C_PXY_PXZ])
        pcyy, pcyz = unpack2_bf16(g[C_PYY_PYZ])
        pczz, _ = unpack2_bf16(g[C_PZZ])
        alive = (g[C_FLAGS] & FLAG_ALIVE) != 0
        # projection: the own splat and the cut radius from one cov2d
        wv, fx, fy = cam["world_view"], cam["focal_x"], cam["focal_y"]
        tanx, tany = cam["tan_fovx"], cam["tan_fovy"]
        tx, ty, tz = gm.transform_point_c(x, y, z, wv)
        ndc_x, ndc_y, ndc_z, _ = gm.project_ndc_c(x, y, z, cam["full_proj"])
        cxx, cxy, cyy = gm.ewa_cov2d_c((sxx, sxy, sxz, syy, syz, szz), tx, ty,
                                       tz, wv, fx, fy, tanx, tany)
        s["radius2d"] = gm.cut_radius(
            cxx, cxy, cyy,
            gm.frustum_flag_c(ndc_x, ndc_y, ndc_z, padding=0.3))
        icxx, icxy, icyy, det, radius, op_eff = screen_splat(
            cxx, cxy, cyy, op, mode, use_filter, tight_radius=True)
        valid = (tz > NEAR_Z) & (det > 0.0) & alive
        s["splats"] = SplatCols(
            px=gm.ndc_to_pix(ndc_x, image_width),
            py=gm.ndc_to_pix(ndc_y, image_height), cxx=icxx, cxy=icxy,
            cyy=icyy, opacity=torch.where(valid, op_eff, 0.0), depth=tz,
            radius=torch.where(valid, radius, 0.0), valid=valid,
        )
        s["rgb"] = (col_r, col_g, col_b)
        # the parent's cut radius from the cached parent attributes (roots
        # carry themselves)
        s["radius2d_parent"] = gm.compute_radius2d_c(
            pxx_, pyy_, pz_, (pcxx, pcxy, pcxz, pcyy, pcyz, pczz), wv,
            cam["full_proj"], fx, fy, tanx, tany)
        s["alive"] = alive

    def cut_stage(s):
        g, alive = s["g"], s["alive"]
        rx_, ry_ = unpack2_bf16(g[C_RX_RY])
        rz_, _ = unpack2_bf16(g[C_RZ])
        flags = g[C_FLAGS]
        is_leaf = (flags & FLAG_LEAF) != 0
        is_root = (flags & FLAG_ROOT) != 0
        leaf_opt = (flags & FLAG_LEAF_OPT) != 0
        rnx, rny, rnz, _ = gm.project_ndc_c(rx_, ry_, rz_, cam["full_proj"])
        root_frus = gm.frustum_flag_c(rnx, rny, rnz, padding=0.5) & alive
        keep = flat_cut_pre(torch.where(is_root, -1, 0),
                            torch.where(is_leaf, -1, 0), flags & 255,
                            root_frus, s["radius2d"], s["radius2d_parent"],
                            alive, min_resolution_pixel, current_depth)
        if w_full is not None:
            wb = _take_blocks(w_full.reshape(B, S), s["blk_ids"],
                              B).reshape(n_rows)
            keep = keep & wb
        s["keep"] = keep
        n_elig = s["counts"].to(torch.int64)
        s["counts"] = torch.cat([(keep & leaf_opt).sum()[None],
                                 (keep & ~leaf_opt).sum()[None], n_elig])

    return [("select", select_stage), ("take", take_stage),
            ("project", project_stage), ("cut", cut_stage)] + \
        packed_frame_stages(k_visible, background, image_height, image_width,
                            max_pairs)


@torch.no_grad()
def render_blocks(cols, meta: dict, cam: dict, min_resolution_pixel,
                  current_depth, background, image_height: int,
                  image_width: int, k_blocks: int, k_visible: int,
                  max_pairs: int, w_full=None, mode: str = "antialias",
                  use_filter: bool = False):
    """Block-pruned inference frame (the packed pipeline only): the stages
    of `block_stages`. w_full: the cached capacity-axis weight-cull mask
    (`fused_root_cull`) or None. Returns (render (3,H,W), alpha (H,W),
    counts (4,): leaf, node, pair demand, eligible blocks). A budget of
    2^24 pairs or more raises: the block frame is held to the packed
    route, whose f32 run rows are exact below it (the flat_slice frame
    renders such a budget whole)."""
    from .train_step import run_stages

    if max_pairs >= PACKED_ID_LIMIT:
        raise ValueError(
            f"render_blocks: a pair budget of {max_pairs} reaches the packed "
            f"route's limit of {PACKED_ID_LIMIT}; render this frame through "
            f"fused_prepare_render (flat_slice)")
    s = run_stages(block_stages(
        cols, meta, cam, min_resolution_pixel, current_depth, background,
        image_height, image_width, k_blocks, k_visible, max_pairs, w_full,
        mode, use_filter), prefix="block")
    return s["render"], s["alpha"], s["counts"]
