"""The training step and the per-frame visibility, LoD cut and render;
counterpart of log_tpu/model/train_step.py.

Training: `fused_train_step` (and `fused_prepare_train_step`, which runs the
visibility pass first) is slice compaction -> activation + SH -> the tiled
render with densification stats -> 0.8 L1 + 0.2 SSIM (+ with render_depth a
second render of (camera depth, world z, 1) and the depth patch loss of
render/loss.py) -> autograd backward (K2 and the plain-torch VJPs of the
binning) -> non-finite guard -> counter update -> sparse or dense Adam (with
spilled moments, on the rows the host gathered) -> scale clamp -> per-view
gain Adam. The JAX
package runs it as one jitted executable with donated buffers; here it runs
eagerly, and every update builds new tensors after the backward has used
the saved ones. The slice bucket (k_leaf, k_node) and the pair budget are
the JAX package's, so truncation and the counts that size the next step
agree with it.

Serving: `fused_prepare_render` is the inference frame of the demo/val/viewer
path: frustum test -> root weight-cull render -> LoD cut -> compaction of the
cut into a static slice -> activation + SH -> tiled render, under
torch.no_grad(). Its flat_slice branch (`_flat_slice_frame`) projects the
capacity axis once, compacts bf16-packed splat columns (K6 under
LOG_TPU_COMPACT=pallas) and renders through K3p, K4 and K5;
`fused_root_cull` computes its capacity-axis weight-cull mask.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field

import torch

from ..ops import compact
from ..ops import gaussian_math as gm
from ..ops import rasterize_ref
from ..ops import rasterize_tiled as rt
from ..ops.projection import SplatCols, project_gaussians_cols
from ..ops.rasterize_tiled import rasterize_tiled
from ..ops.sh import eval_sh, sh_to_rgb
from ..ops.ssim import ssim_loss, ssim_map
from ..render.loss import depth_patch_loss
from ..utils.profiler import span
from .counter import update_counter
from .sparse_optimizer import dense_adam_step, sparse_adam_step
from .tensor_tree import flat_cut, flat_cut_pre, traverse_cut

UNIT_QUAT = (1.0, 0.0, 0.0, 0.0)


def _compact_slices_gather(params: dict, keep, k: int):
    """Kept rows to the front, in index order: one sort of the position key
    (kept rows first), then k-row gathers. It stands for both compactions of
    the JAX package (its payload sort and its index sort + gather give the
    same slices).

    Returns (slices, index, lane_valid): the first k kept rows of every
    param; lanes past the kept count are zeroed (rotation = unit
    quaternion) and carry index = cap, so scatters by index drop them.
    """
    cap = keep.shape[0]
    pos = torch.arange(cap, dtype=torch.int64, device=keep.device)
    key_s, order = torch.sort(torch.where(keep, pos, cap + pos))
    key_s = key_s[:k]
    order = order[:k]
    lane_valid = key_s < cap
    index = torch.where(lane_valid, key_s, cap).to(torch.int32)
    slices = {}
    for name, v in params.items():
        block = v[order]
        mask = lane_valid.reshape((k,) + (1,) * (block.dim() - 1))
        if name == "rotation":
            with span("sync.compact_fill"):
                fill = torch.tensor(UNIT_QUAT, dtype=block.dtype,
                                    device=block.device)
            block = torch.where(mask, block, fill)
        else:
            block = torch.where(mask, block, torch.zeros((), dtype=block.dtype,
                                                          device=block.device))
        slices[name] = block
    return slices, index, lane_valid


def _normalize_rows(q):
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True),
                           min=1e-12)


def _check_root_weights(xyz, opacity, scaling, rotation, root_candidate, cam,
                        image_height: int, image_width: int, mode: str,
                        backend: str, max_pairs: int, check_scale: int):
    """Weight-render cull of the ROOT rows: a render of the candidate roots
    (at 1/check_scale resolution) keeps those whose max blend weight is
    > 1e-8. Inputs are the activated root prefix rows; returns ((R,) bool,
    the check render's unclamped pair demand: a 0-d tensor, -1 on the
    reference backend)."""
    chk_h = max(image_height // check_scale, 8)
    chk_w = max(image_width // check_scale, 128)
    common = dict(
        world_view=cam["world_view"], full_proj=cam["full_proj"],
        focal_x=cam["focal_x"] / check_scale,
        focal_y=cam["focal_y"] / check_scale,
        tan_fovx=cam["tan_fovx"], tan_fovy=cam["tan_fovy"],
        background=torch.zeros(3, device=xyz.device),
        image_height=chk_h, image_width=chk_w, mode=mode, use_filter=True,
    )
    if backend == "tiled":
        # compact the candidates to a prefix so the binning rides the
        # tail-only expansion; gid_ids carries the original row ids so the
        # point weights land in row space
        R = xyz.shape[0]
        cols = {"xyz": xyz, "opacity": opacity[:, None], "scaling": scaling,
                "rotation": rotation}
        slices, index, lane_valid = _compact_slices_gather(
            cols, root_candidate, R
        )
        check = rasterize_tiled(
            xyz=slices["xyz"], colors=torch.ones_like(slices["xyz"]),
            opacity=slices["opacity"][:, 0], scaling=slices["scaling"],
            rotation=slices["rotation"],
            means2d_offset=torch.zeros((R, 2), device=xyz.device),
            active_mask=lane_valid, max_pairs=max_pairs,
            with_stats="weights", tight_radius=True, runs_tail_only=True,
            prefix_mask=lane_valid, gid_ids=index, **common,
        )
        return check["point_weight"] > 1e-8, check["pair_total"]
    check = rasterize_ref.rasterize(
        xyz=xyz, colors=torch.ones_like(xyz), opacity=opacity,
        scaling=scaling, rotation=rotation,
        means2d_offset=torch.zeros_like(xyz[:, :2]),
        active_mask=root_candidate, chunk=64, **common,
    )
    return (check["point_weight"] > 1e-8,
            torch.full((), -1, dtype=torch.int32, device=xyz.device))


@torch.no_grad()
def prepare_visibility(params: dict, tree_arrays: dict, cam: dict, n_alive,
                       is_leaf_opt, min_resolution_pixel, current_depth,
                       image_height: int, image_width: int,
                       stage_has_tree: bool, num_levels: int,
                       mode: str = "antialias", backend: str = "reference",
                       max_pairs: int = 1 << 18, check_scale: int = 1,
                       cut_method: str = "traverse", n_roots: int = 0):
    """Per-camera visibility + LoD cut. Returns (keep_leaf, keep_node,
    counts (2,)).

    Frustum cull (padding 0.5) -> weight-render cull of roots
    (point_weight > 1e-8) -> tree cut -> leaf/node split. The treeless init
    stage keeps the frustum test only. cut_method='flat' needs
    tree_arrays' root_id and parent_{xyz,scaling,rotation} cache; n_roots > 0
    restricts the cull render to the root prefix rows [0, n_roots).
    """
    cap = params["xyz"].shape[0]
    dev = params["xyz"].device
    alive = torch.arange(cap, device=dev) < n_alive
    xyz = params["xyz"]
    px, py, pz, _ = gm.project_ndc_c(xyz[:, 0], xyz[:, 1], xyz[:, 2],
                                     cam["full_proj"])
    in_frustum = gm.frustum_flag_c(px, py, pz, padding=0.5) & alive
    if not stage_has_tree:
        keep_node = torch.zeros_like(in_frustum)
        counts = torch.stack([in_frustum.sum(), keep_node.sum()])
        return in_frustum, keep_node, counts

    is_root = tree_arrays["index_parent"] == -1
    root_candidate = is_root & in_frustum
    scaling = torch.exp(params["scaling"])
    rotation = params["rotation"] / torch.linalg.norm(
        params["rotation"], dim=-1, keepdim=True
    )
    opacity = torch.sigmoid(params["opacity"][:, 0])
    R = n_roots if 0 < n_roots <= cap else cap
    root_weight_ok, _ = _check_root_weights(
        xyz[:R], opacity[:R], scaling[:R], rotation[:R], root_candidate[:R],
        cam, image_height, image_width, mode, backend, max_pairs, check_scale,
    )
    if R < cap:
        root_weight_ok = torch.cat(
            [root_weight_ok, torch.zeros(cap - R, dtype=torch.bool, device=dev)]
        )
    root_visible = root_candidate & root_weight_ok

    cam_args = (cam["world_view"], cam["full_proj"], cam["focal_x"],
                cam["focal_y"], cam["tan_fovx"], cam["tan_fovy"])
    radius2d = gm.compute_radius2d(xyz, scaling, rotation, *cam_args)
    if cut_method == "flat":
        radius2d_parent = gm.compute_radius2d(
            tree_arrays["parent_xyz"], torch.exp(tree_arrays["parent_scaling"]),
            _normalize_rows(tree_arrays["parent_rotation"]), *cam_args,
        )
        keep = flat_cut(
            tree_arrays["index_parent"], tree_arrays["node_index"],
            tree_arrays["depth"], tree_arrays["root_id"], radius2d,
            radius2d_parent, root_visible, alive, min_resolution_pixel,
            current_depth,
        )
    else:
        keep = traverse_cut(
            tree_arrays["node_index"], tree_arrays["index_parent"],
            tree_arrays["depth"], radius2d, root_visible, alive,
            min_resolution_pixel, current_depth, num_levels,
        )
    keep_leaf = keep & is_leaf_opt
    keep_node = keep & ~is_leaf_opt
    counts = torch.stack([keep_leaf.sum(), keep_node.sum()])
    return keep_leaf, keep_node, counts


def _compact_flat_cols_sort(cols: dict, keep, k: int):
    """Compaction by sort over 1-D columns of mixed dtype (f32, and int32
    holding u32 bit patterns): one sort of the position key (kept rows
    first), then k-row gathers. Lanes past the kept count are zero (a zero
    word unpacks to opacity 0 / radius 0) with index = cap. Returns
    (slices, index, lane_valid)."""
    cap = keep.shape[0]
    pos = torch.arange(cap, dtype=torch.int64, device=keep.device)
    key_s, order = torch.sort(torch.where(keep, pos, cap + pos))
    lane_valid = key_s[:k] < cap
    order = order[:k]
    index = torch.where(lane_valid, key_s[:k], cap).to(torch.int32)
    slices = {n: torch.where(lane_valid, v[order],
                             torch.zeros((), dtype=v.dtype, device=v.device))
              for n, v in cols.items()}
    return slices, index, lane_valid


def _compact_flat_cols(cols: dict, keep, k: int):
    """The render frame's column compaction: LOG_TPU_COMPACT=pallas takes
    the stream-compaction kernel K6 (ops/compact.py) where the capacity
    axis meets the JAX package's contract for it (a multiple of 8192 rows,
    fewer than 2^24); otherwise the sort compaction. Same results."""
    cap = keep.shape[0]
    if (os.environ.get("LOG_TPU_COMPACT") == "pallas" and cap % 8192 == 0
            and cap < 1 << 24):
        return compact.stream_compact_cols(cols, keep, k)
    return _compact_flat_cols_sort(cols, keep, k)


def _use_packed_pairs() -> bool:
    env = os.environ.get("LOG_TPU_PACK_PAIRS")
    if env is not None:
        return env not in ("0", "false", "")
    return True


def _render_tiled_cols(splat_cols, colors_cols, background, image_height: int,
                       image_width: int, max_pairs: int, prefix_mask):
    """Column-native inference render at full precision, no stats: the
    pair rows and K1 (the packed route is `packed_frame_stages`). Returns
    (render, alpha, pair_total)."""
    H, W = image_height, image_width
    pairs = rt.build_pairs(splat_cols, colors_cols, H, W, max_pairs,
                           runs_tail_only=True, active_prefix=prefix_mask)
    color, tfinal, *_ = rt.rasterize_forward(
        pairs["pair_data"], pairs["tile_start"], pairs["tile_count"],
        background, pairs["tiles_x"], pairs["tiles_y"], False)
    return color[:, :H, :W], 1.0 - tfinal[:H, :W], pairs["total"]


def run_stages(stages, state=None, prefix: str | None = None) -> dict:
    """Run named stages [(name, fn(state))] in order on one state dict,
    each in a span `<prefix>.<name>` where a prefix is given."""
    state = {} if state is None else state
    for name, fn in stages:
        if prefix is None:
            fn(state)
        else:
            with span(f"{prefix}.{name}"):
                fn(state)
    return state


def packed_frame_stages(k_visible: int, background, image_height: int,
                        image_width: int, max_pairs: int, root_id=None,
                        cull=None):
    """The packed frame's tail (flat_slice and block-pruned) as named
    stages over a state dict holding the capacity-side splat columns
    ("splats": SplatCols, "rgb": 3 columns), the cut ("keep") and its
    counts ("counts"):

      compact: bf16-pack the columns (the radius inflated by 2^-7 first, so
        that rounding can only grow a tile rect) and compact them by keep
        (`_compact_flat_cols`) -> "cols", "lane_prefix";
      check: with root_id given, cull(state, root ids of the slice, prefix
        mask) gives the valid lanes (the slice-axis weight cull), else
        the prefix -> "lane_valid";
      pairs: unpack; expansion, the pair sort and the record pack
        (`rt.packed_pairs`: K4, K3p, K4) -> "pairs"; the unclamped pair
        demand joins "counts" and is "pair_total";
      kernel: K5 -> "render" (3, H, W), "alpha" (H, W).
    """
    H, W = image_height, image_width

    def compact_stage(s):
        splats, rgb = s["splats"], s["rgb"]
        sort_cols = {
            "px": splats.px, "py": splats.py, "depth": splats.depth,
            "p1": rt.pack2_bf16(splats.cxx, splats.cxy),
            "p2": rt.pack2_bf16(splats.cyy, splats.opacity),
            "p3": rt.pack2_bf16(rgb[0], rgb[1]),
            "p4": rt.pack2_bf16(rgb[2], splats.radius * (1.0 + 2.0 ** -7)),
        }
        if root_id is not None:
            sort_cols["root_id"] = root_id
        s["cols"], _, s["lane_prefix"] = _compact_flat_cols(
            sort_cols, s["keep"], k_visible)

    def check_stage(s):
        s["lane_valid"] = (s["lane_prefix"] if root_id is None
                           else cull(s, s["cols"]["root_id"],
                                     s["lane_prefix"]))

    def pairs_stage(s):
        cols_s, lane_valid = s["cols"], s["lane_valid"]
        cxx, cxy = rt.unpack2_bf16(cols_s["p1"])
        cyy, op_sl = rt.unpack2_bf16(cols_s["p2"])
        r_sl, g_sl = rt.unpack2_bf16(cols_s["p3"])
        b_sl, rad_sl = rt.unpack2_bf16(cols_s["p4"])
        valid = lane_valid & (rad_sl > 0)
        splat_cols = SplatCols(
            px=cols_s["px"], py=cols_s["py"], cxx=cxx, cxy=cxy, cyy=cyy,
            opacity=torch.where(valid, op_sl, 0.0), depth=cols_s["depth"],
            radius=torch.where(valid, rad_sl, 0.0), valid=valid,
        )
        s["pairs"] = rt.packed_pairs(splat_cols, (r_sl, g_sl, b_sl), H, W,
                                     max_pairs, s["lane_prefix"])
        total = s["pairs"][-1]
        # counts[2]: the frame's unclamped pair demand, which sizes the
        # next frames' pair budget
        s["counts"] = torch.cat([s["counts"][:2],
                                 total[None].to(s["counts"].dtype),
                                 s["counts"][2:]])
        s["pair_total"] = total

    def kernel_stage(s):
        pair_data, start, count, tiles_x, tiles_y, _ = s["pairs"]
        color, tfinal = rt.rasterize_forward_packed(
            pair_data, start, count, background, tiles_x, tiles_y)
        s["render"], s["alpha"] = color[:, :H, :W], 1.0 - tfinal[:H, :W]

    return [("compact", compact_stage), ("check", check_stage),
            ("pairs", pairs_stage), ("kernel", kernel_stage)]


def _flat_slice_geometry(params: dict, tree_arrays: dict, cam: dict,
                         n_alive):
    """What every flat_slice route starts from: the alive mask, the cached
    root centers' projection and frustum flag, and the parents' cut
    radius."""
    cap = params["xyz"].shape[0]
    alive = torch.arange(cap, device=params["xyz"].device) < n_alive
    rx = tree_arrays["root_xyz"]
    rpx, rpy, rpz, _ = gm.project_ndc_c(rx[:, 0], rx[:, 1], rx[:, 2],
                                        cam["full_proj"])
    radius2d_parent = gm.compute_radius2d(
        tree_arrays["parent_xyz"], torch.exp(tree_arrays["parent_scaling"]),
        _normalize_rows(tree_arrays["parent_rotation"]), *_cam_args(cam),
    )
    return {"alive": alive, "rpx": rpx, "rpy": rpy, "rpz": rpz,
            "root_frus": gm.frustum_flag_c(rpx, rpy, rpz, padding=0.5) & alive,
            "radius2d_parent": radius2d_parent}


def _cam_args(cam: dict):
    return (cam["world_view"], cam["full_proj"], cam["focal_x"],
            cam["focal_y"], cam["tan_fovx"], cam["tan_fovy"])


def _flat_slice_cut(geo: dict, tree_arrays: dict, radius2d, is_leaf_opt,
                    min_resolution_pixel, current_depth, w_full):
    """The gather-free pre-cut (`flat_cut_pre`), with the capacity-axis
    weight cull w_full folded in where given. Returns (keep, counts (2,):
    kept leaf and node rows)."""
    keep = flat_cut_pre(
        tree_arrays["index_parent"], tree_arrays["node_index"],
        tree_arrays["depth"], geo["root_frus"], radius2d,
        geo["radius2d_parent"], geo["alive"], min_resolution_pixel,
        current_depth,
    )
    if w_full is not None:
        keep = keep & w_full
    counts = torch.stack([(keep & is_leaf_opt).sum(),
                          (keep & ~is_leaf_opt).sum()])
    return keep, counts


def _slice_root_cull(params: dict, tree_arrays: dict, geo: dict, cam: dict,
                     lane_prefix, root_id_sl, opacity_r, scaling_r,
                     rotation_r, R: int, image_height: int, image_width: int,
                     mode: str, prep_backend: str, prep_max_pairs: int,
                     check_scale: int):
    """The slice-axis weight cull: the root weight render over the first R
    rows, then a k-sized gather by each lane's root."""
    cand = (gm.frustum_flag_c(geo["rpx"][:R], geo["rpy"][:R], geo["rpz"][:R],
                              padding=0.5)
            & (tree_arrays["index_parent"][:R] == -1) & geo["alive"][:R])
    weight_ok, _ = _check_root_weights(
        params["xyz"][:R], opacity_r, scaling_r, rotation_r, cand, cam,
        image_height, image_width, mode, prep_backend, prep_max_pairs,
        check_scale,
    )
    rid = torch.clamp(root_id_sl.to(torch.int64), 0, R - 1)
    return lane_prefix & weight_ok[rid]


def flat_slice_stages(params: dict, tree_arrays: dict, cam: dict, n_alive,
                      is_leaf_opt, min_resolution_pixel, current_depth,
                      background, image_height: int, image_width: int,
                      k_visible: int, sh_degree: int, mode: str,
                      max_pairs: int, check_scale: int, n_roots: int,
                      prep_backend: str, prep_max_pairs: int,
                      use_filter: bool, per_frame_cull: bool, w_full):
    """The packed flat_slice frame (the serving default) as named stages
    over one state dict; `run_stages` of them is the frame, and the
    frame's dissection (scripts/bench_frame_dissect.py) times them one by
    one:

      cut: the capacity axis projected once (the cut radius and the render
        splats from one cov2d) and the flat cut -> "splats", "keep",
        "counts";
      act: the colors, SH evaluated on the capacity axis -> "rgb";
      compact, check, pairs, kernel: `packed_frame_stages`, the check the
        per-frame slice-axis weight cull where per_frame_cull.

    The state ends with "render", "alpha", "counts" (kept leaf, node, pair
    demand) and "pair_total".
    """
    cap = params["xyz"].shape[0]
    R = n_roots if 0 < n_roots <= cap else cap
    xyz, q = params["xyz"], params["rotation"]

    def cut_stage(s):
        geo = _flat_slice_geometry(params, tree_arrays, cam, n_alive)
        op_full = torch.sigmoid(params["opacity"][:, 0])
        s_full = torch.exp(params["scaling"])
        splat_full, radius2d = project_gaussians_cols(
            xyz[:, 0], xyz[:, 1], xyz[:, 2], s_full[:, 0], s_full[:, 1],
            s_full[:, 2], q[:, 0], q[:, 1], q[:, 2], q[:, 3], op_full,
            *_cam_args(cam), image_height, image_width, mode=mode,
            use_filter=use_filter, active_mask=geo["alive"],
            tight_radius=True, with_cut_radius=True,
        )
        s["keep"], s["counts"] = _flat_slice_cut(
            geo, tree_arrays, radius2d, is_leaf_opt, min_resolution_pixel,
            current_depth, w_full)
        s.update(geo=geo, op_full=op_full, s_full=s_full, splats=splat_full)

    def act_stage(s):
        col = sh_to_rgb(params["colors"])
        if sh_degree > 0 and "shs" in params:
            dirs = _normalize_rows(xyz - cam["camera_center"][None])
            col = col + eval_sh(dirs, params["shs"], degree=sh_degree)
        s["rgb"] = col.unbind(1)

    def cull(s, root_id_sl, lane_prefix):
        return _slice_root_cull(
            params, tree_arrays, s["geo"], cam, lane_prefix, root_id_sl,
            s["op_full"][:R], s["s_full"][:R], _normalize_rows(q[:R]), R,
            image_height, image_width, mode, prep_backend, prep_max_pairs,
            check_scale)

    return [("cut", cut_stage), ("act", act_stage)] + packed_frame_stages(
        k_visible, background, image_height, image_width, max_pairs,
        root_id=tree_arrays["root_id"] if per_frame_cull else None,
        cull=cull)


def _flat_slice_frame(params: dict, tree_arrays: dict, cam: dict, n_alive,
                      is_leaf_opt, min_resolution_pixel, current_depth,
                      background, image_height: int, image_width: int,
                      k_visible: int, sh_degree: int, need: list, mode: str,
                      backend: str, max_pairs: int, check_scale: int,
                      n_roots: int, prep_backend: str, prep_max_pairs: int,
                      use_filter: bool, check_cull: bool, pack_pairs,
                      w_full):
    """The flat_slice frame: the gather-free pre-cut (`flat_cut_pre` with
    the cached root centers) and the weight cull folded in before the
    compaction (w_full) or applied after it on the slice axis.

    Returns ("frame", (render, alpha, counts, pair_total)) from the packed
    route (`flat_slice_stages`) and the column path, or ("slices", (slices,
    lane_valid, lane_prefix, counts)) for the shared slice render of
    fused_prepare_render.
    """
    cap = params["xyz"].shape[0]
    R = n_roots if 0 < n_roots <= cap else cap
    per_frame_cull = check_cull and w_full is None
    use_cols = backend == "tiled"
    packed = pack_pairs if pack_pairs is not None else _use_packed_pairs()
    if use_cols and packed:
        s = run_stages(flat_slice_stages(
            params, tree_arrays, cam, n_alive, is_leaf_opt,
            min_resolution_pixel, current_depth, background, image_height,
            image_width, k_visible, sh_degree, mode, max_pairs, check_scale,
            n_roots, prep_backend, prep_max_pairs, use_filter,
            per_frame_cull, w_full), prefix="frame")
        return "frame", (s["render"], s["alpha"], s["counts"],
                         s["pair_total"])

    geo = _flat_slice_geometry(params, tree_arrays, cam, n_alive)
    scaling_full = torch.exp(params["scaling"])
    rotation_full = _normalize_rows(params["rotation"])
    radius2d = gm.compute_radius2d(params["xyz"], scaling_full, rotation_full,
                                   *_cam_args(cam))
    keep, counts = _flat_slice_cut(geo, tree_arrays, radius2d, is_leaf_opt,
                                   min_resolution_pixel, current_depth,
                                   w_full)
    cols_in = {kk: params[kk] for kk in need}
    cols_in["root_id"] = tree_arrays["root_id"][:, None]
    slices, _, lane_prefix = _compact_slices_gather(cols_in, keep, k_visible)
    root_id_sl = slices.pop("root_id")[:, 0]
    lane_valid = lane_prefix
    if per_frame_cull:
        lane_valid = _slice_root_cull(
            params, tree_arrays, geo, cam, lane_prefix, root_id_sl,
            torch.sigmoid(params["opacity"][:R, 0]), scaling_full[:R],
            rotation_full[:R], R, image_height, image_width, mode,
            prep_backend, prep_max_pairs, check_scale)
    if not (use_cols and "shs" not in need):
        return "slices", (slices, lane_valid, lane_prefix, counts)
    # the column path at full precision (pack_pairs=False)
    x, y, z = slices["xyz"].unbind(1)
    sx, sy, sz = torch.exp(slices["scaling"]).unbind(1)
    qw, qx, qy, qz = slices["rotation"].unbind(1)
    splat_cols = project_gaussians_cols(
        x, y, z, sx, sy, sz, qw, qx, qy, qz,
        torch.sigmoid(slices["opacity"][:, 0]), *_cam_args(cam),
        image_height, image_width, mode=mode, use_filter=use_filter,
        active_mask=lane_valid, tight_radius=True,
    )
    render, alpha, pair_total = _render_tiled_cols(
        splat_cols, tuple(sh_to_rgb(slices["colors"]).unbind(1)), background,
        image_height, image_width, max_pairs, lane_prefix,
    )
    return "frame", (render, alpha, torch.cat([counts, pair_total[None]]),
                     pair_total)


def alive_rows(params: dict, tree_arrays: dict, is_leaf_opt, cap_sort: int):
    """The rows [:cap_sort] of every capacity-axis array (all rows where
    cap_sort is 0 or the capacity): points past the alive bucket are dead
    by construction, so the frame's capacity-axis passes run over those
    rows only."""
    cap = params["xyz"].shape[0]
    if not 0 < cap_sort < cap:
        return params, tree_arrays, is_leaf_opt
    return ({k: v[:cap_sort] for k, v in params.items()},
            {k: (v[:cap_sort] if v.dim() >= 1 and v.shape[0] == cap else v)
             for k, v in tree_arrays.items()},
            None if is_leaf_opt is None else is_leaf_opt[:cap_sort])


@torch.no_grad()
def fused_prepare_render(params: dict, tree_arrays: dict, cam: dict, n_alive,
                         is_leaf_opt, min_resolution_pixel, current_depth,
                         background, image_height: int, image_width: int,
                         k_visible: int, sh_degree: int, stage_has_tree: bool,
                         num_levels: int, mode: str = "antialias",
                         backend: str = "tiled", max_pairs: int = 1 << 20,
                         check_scale: int = 1, cut_method: str = "flat",
                         n_roots: int = 0, prep_backend: str = "tiled",
                         prep_max_pairs: int = 1 << 20,
                         use_filter: bool = False, check_cull: bool = True,
                         pack_pairs=None, cap_sort: int = 0, w_full=None):
    """Inference frame: LoD cut + slice compaction + activation + render.
    k_visible is the static cut budget; overflow truncates the cut for that
    frame. Returns (render (3,H,W), alpha (H,W), counts (3,), pair_total):
    pair_total is the frame's unclamped pair demand for telemetry (-1 on
    the reference backend). counts holds the kept leaf/node counts and, as
    in the JAX package, -1 from the generic branch and the pair demand from
    the flat_slice column paths (the next frame's pair budget is sized from
    it).

    cut_method='flat_slice': the gather-free pre-cut via the per-point root
    centers (tree_arrays['root_xyz']); the weight cull either comes in as
    w_full, a (cap,) bool mask from `fused_root_cull` folded into the cut
    before the compaction, or (check_cull and no w_full) runs per frame on
    the slice axis after it. Its default path packs the splat columns to
    bf16 pairs before the compaction and renders through K3p, K4 and K5;
    pack_pairs=False (or LOG_TPU_PACK_PAIRS=0) keeps full-precision
    columns and K1, and SH with pack_pairs=False takes the slices path.
    check_cull=False skips the cull (a conservative occlusion test).
    """
    cap = params["xyz"].shape[0]
    if w_full is not None and w_full.shape[0] == cap and 0 < cap_sort < cap:
        w_full = w_full[:cap_sort]
    if 0 < cap_sort < cap and cap_sort < k_visible:
        raise ValueError(f"cap_sort {cap_sort} < k_visible {k_visible}")
    params, tree_arrays, is_leaf_opt = alive_rows(params, tree_arrays,
                                                  is_leaf_opt, cap_sort)
    need = ["xyz", "colors", "scaling", "opacity", "rotation"]
    if sh_degree > 0 and "shs" in params:
        need.append("shs")
    if cut_method == "flat_slice" and stage_has_tree:
        kind, res = _flat_slice_frame(
            params, tree_arrays, cam, n_alive, is_leaf_opt,
            min_resolution_pixel, current_depth, background, image_height,
            image_width, k_visible, sh_degree, need, mode, backend,
            max_pairs, check_scale, n_roots, prep_backend, prep_max_pairs,
            use_filter, check_cull, pack_pairs, w_full,
        )
        if kind == "frame":
            return res
        slices, lane_valid, lane_prefix, counts = res
    else:
        keep_leaf, keep_node, counts = prepare_visibility(
            params, tree_arrays, cam, n_alive, is_leaf_opt,
            min_resolution_pixel, current_depth, image_height, image_width,
            stage_has_tree, num_levels, mode, prep_backend, prep_max_pairs,
            check_scale, cut_method, n_roots,
        )
        slices, _, lane_valid = _compact_slices_gather(
            {kk: params[kk] for kk in need}, keep_leaf | keep_node, k_visible
        )
        lane_prefix = lane_valid
    scaling = torch.exp(slices["scaling"])
    opacity = torch.sigmoid(slices["opacity"][:, 0])
    rotation = slices["rotation"] / torch.linalg.norm(
        slices["rotation"], dim=-1, keepdim=True
    )
    colors = sh_to_rgb(slices["colors"])
    if sh_degree > 0 and "shs" in slices:
        dirs = _normalize_rows(slices["xyz"] - cam["camera_center"][None])
        colors = colors + eval_sh(dirs, slices["shs"], degree=sh_degree)
    kwargs = dict(
        xyz=slices["xyz"], colors=colors, opacity=opacity, scaling=scaling,
        rotation=rotation,
        means2d_offset=torch.zeros((k_visible, 2), device=colors.device),
        world_view=cam["world_view"], full_proj=cam["full_proj"],
        focal_x=cam["focal_x"], focal_y=cam["focal_y"],
        tan_fovx=cam["tan_fovx"], tan_fovy=cam["tan_fovy"],
        background=background, image_height=image_height,
        image_width=image_width, active_mask=lane_valid, mode=mode,
        use_filter=use_filter,
    )
    if backend == "tiled":
        out = rasterize_tiled(
            **kwargs, max_pairs=max_pairs, with_stats=False,
            tight_radius=True, runs_tail_only=True, prefix_mask=lane_prefix,
        )
    else:
        out = rasterize_ref.rasterize(**kwargs)
    minus_one = torch.full((1,), -1, dtype=counts.dtype, device=counts.device)
    counts = torch.cat([counts, minus_one])
    pair_total = out.get("pair_total", minus_one[0])
    return out["render"], out["alpha"], counts, pair_total


def root_cull_stages(params: dict, tree_arrays: dict, cam: dict, n_alive,
                     image_height: int, image_width: int,
                     mode: str = "antialias", prep_backend: str = "tiled",
                     prep_max_pairs: int = 1 << 20, check_scale: int = 1,
                     n_roots: int = 0, cap_sort: int = 0):
    """`fused_root_cull` as named stages over one state dict:

      candidates: the root prefix's frustum test and activations ->
        "cand", "opacity", "scaling", "rotation";
      check: the root weight render (K1 "weights") -> "weight_ok" (R,),
        "cull_pairs" (its unclamped pair demand, 0-d);
      expand: each row takes its root's verdict (`expand_weight_full`) ->
        "w_full" (cap_sort or cap,).
    """
    params, tree_arrays, _ = alive_rows(params, tree_arrays, None, cap_sort)
    cap = params["xyz"].shape[0]
    R = n_roots if 0 < n_roots <= cap else cap
    x = params["xyz"][:R]

    def candidates_stage(s):
        alive = torch.arange(cap, device=x.device) < n_alive
        px, py, pz, _ = gm.project_ndc_c(x[:, 0], x[:, 1], x[:, 2],
                                         cam["full_proj"])
        s["cand"] = (gm.frustum_flag_c(px, py, pz, padding=0.5)
                     & (tree_arrays["index_parent"][:R] == -1) & alive[:R])
        s["opacity"] = torch.sigmoid(params["opacity"][:R, 0])
        s["scaling"] = torch.exp(params["scaling"][:R])
        s["rotation"] = _normalize_rows(params["rotation"][:R])

    def check_stage(s):
        s["weight_ok"], s["cull_pairs"] = _check_root_weights(
            x, s["opacity"], s["scaling"], s["rotation"], s["cand"], cam,
            image_height, image_width, mode, prep_backend, prep_max_pairs,
            check_scale)

    def expand_stage(s):
        s["w_full"] = expand_weight_full(s["weight_ok"], tree_arrays, cap, R)

    return [("candidates", candidates_stage), ("check", check_stage),
            ("expand", expand_stage)]


@torch.no_grad()
def fused_root_cull(params: dict, tree_arrays: dict, cam: dict, n_alive,
                    image_height: int, image_width: int,
                    mode: str = "antialias", prep_backend: str = "tiled",
                    prep_max_pairs: int = 1 << 20, check_scale: int = 1,
                    n_roots: int = 0, cap_sort: int = 0):
    """The capacity-axis weight-cull mask of the flat_slice frame: the root
    check render, then each row takes its root's verdict
    (`expand_weight_full`); the stages of `root_cull_stages`. Returns
    (cap_sort or cap,) bool for fused_prepare_render(w_full=...)."""
    return run_stages(root_cull_stages(
        params, tree_arrays, cam, n_alive, image_height, image_width, mode,
        prep_backend, prep_max_pairs, check_scale, n_roots,
        cap_sort), prefix="cull")["w_full"]


def expand_weight_full(weight_ok, tree_arrays: dict, cap: int, R: int):
    """Expand the per-root weight-cull verdict (R,) to every row (cap,).

    Default: one gather weight_ok[root_id]. With root-contiguous tail
    segments (tree_arrays["cull_seg_starts"], from
    LoG.optimize_render_layout's root_major layout): a scatter-max of
    rank-coded verdicts at the R segment starts and one cummax broadcast
    each segment's code over its rows. Empty segments share a start with
    the next one; the max picks the larger rank, the owner of the rows.
    """
    seg = tree_arrays.get("cull_seg_starts")
    if seg is None:
        rid = torch.clamp(tree_arrays["root_id"].to(torch.int64), 0, R - 1)
        return weight_ok[rid]
    dev = weight_ok.device
    ranks = torch.arange(R, dtype=torch.int32, device=dev)
    code = (ranks << 2) | (weight_ok.to(torch.int32) << 1) | 1
    # starts outside [0, cap) drop into a spare slot, as mode="drop" does
    idx = seg[:R].to(torch.int64)
    idx = torch.where((idx >= 0) & (idx < cap), idx, cap)
    b = torch.zeros((cap + 1,), dtype=torch.int32, device=dev)
    b.scatter_reduce_(0, idx, code, reduce="amax")
    m = torch.cummax(b[:cap], 0).values
    w_tail = ((m >> 1) & 1).to(torch.bool)
    is_root_row = tree_arrays["index_parent"] == -1
    w_prefix = torch.zeros((cap,), dtype=torch.bool, device=dev)
    w_prefix[:min(R, cap)] = weight_ok[:cap]
    row_in_prefix = torch.arange(cap, device=dev) < R
    return torch.where(row_in_prefix & is_root_row, w_prefix, w_tail)


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class StepConfig:
    image_height: int
    image_width: int
    k_leaf: int
    k_node: int
    sh_degree: int  # active SH degree
    mode: str = "antialias"  # 'antialias' | 'original'
    use_correction: bool = False
    has_mask: bool = False
    opt_keys: tuple = ("xyz", "colors", "scaling", "opacity", "rotation", "shs")
    backend: str = "reference"  # 'reference' | 'tiled'
    max_pairs: int = 1 << 18  # tiled backend pair capacity
    chunk: int = 32
    # the depth loss: a second render with (camera depth, world z, 1) as
    # its colors (K1 without stats) and the SSI patch loss against gt_depth
    render_depth: bool = False
    # foreground-mask training: the GT composites over the step background
    # inside the mask and the loss is restricted to the mask's bbox (the L1
    # mean and the SSIM windows inside the bbox, with static shapes)
    crop_loss: bool = False
    # moment kinds in host memory: the step takes their rows as m_slices
    # and returns the updated rows (no identity fast path)
    spilled: tuple = ()
    # identity fast path opt-out (LOG_TPU_IDENTITY_STEP=0), read when the
    # config is built
    identity_ok: bool = field(
        default_factory=lambda: os.environ.get(
            "LOG_TPU_IDENTITY_STEP", "1"
        ) != "0"
    )


def _activate_and_rasterize(slices, offset, cam, background, lane_valid,
                            cfg: StepConfig, colors=None):
    """Param-space slice -> physical -> rasterize. Differentiable. With
    `colors` (per-point, e.g. the depth pass's (camera depth, world z, 1))
    in place of the SH colors, the render carries no stats: K1 without
    stats on the tiled backend, whose VJP is K2."""
    scaling = torch.exp(slices["scaling"])
    opacity = torch.sigmoid(slices["opacity"][:, 0])
    rotation = slices["rotation"] / torch.linalg.norm(
        slices["rotation"], dim=-1, keepdim=True
    )
    with_stats = colors is None
    if with_stats:
        colors = sh_to_rgb(slices["colors"])
        if cfg.sh_degree > 0 and "shs" in slices:
            # view directions carry no gradient to the positions
            dirs = _normalize_rows(slices["xyz"].detach()
                                   - cam["camera_center"][None])
            colors = colors + eval_sh(dirs, slices["shs"],
                                      degree=cfg.sh_degree)
    kwargs = dict(
        xyz=slices["xyz"], colors=colors, opacity=opacity, scaling=scaling,
        rotation=rotation, means2d_offset=offset,
        world_view=cam["world_view"], full_proj=cam["full_proj"],
        focal_x=cam["focal_x"], focal_y=cam["focal_y"],
        tan_fovx=cam["tan_fovx"], tan_fovy=cam["tan_fovy"],
        background=background, image_height=cfg.image_height,
        image_width=cfg.image_width, active_mask=lane_valid, mode=cfg.mode,
        use_filter=True,
    )
    if cfg.backend == "tiled":
        return rasterize_tiled(**kwargs, max_pairs=cfg.max_pairs,
                               with_stats=with_stats)
    return rasterize_ref.rasterize(**kwargs, chunk=cfg.chunk)


def _loss(out, gt, background, correction, mask_ignore, fg_mask, bbox,
          cfg: StepConfig):
    """0.8 L1 + 0.2 SSIM of one render against its GT. Returns
    (loss, l1, ssim)."""
    render = out["render"]
    # GT may arrive as uint8 (exact for 8-bit sources); normalize here
    gt_f = gt.to(torch.float32) * (1.0 / 255.0) if gt.dtype == torch.uint8 \
        else gt
    bg = background[:, None, None]
    render_l1 = render * correction[:, None, None] if cfg.use_correction \
        else render
    if cfg.crop_loss:
        fm = fg_mask.to(torch.float32)
        gt_f = gt_f * fm + (1 - fm) * bg
    if cfg.has_mask:
        m = mask_ignore.to(torch.float32)  # (1, H, W); 1 = ignore
        gt_eff = gt_f * m + (1 - m) * bg
        render_ssim = gt_eff * m + render * (1 - m)
        render_l1 = gt_eff * m + render_l1 * (1 - m)
    else:
        gt_eff = gt_f
        render_ssim = render
    if cfg.crop_loss:
        # the bbox-restricted loss with static shapes: the L1 mean weighted
        # by the bbox indicator, and the mean of the SSIM windows that lie
        # fully inside the bbox (exactly the valid windows of the crop)
        t_, b_, l_, r_ = (int(v) for v in bbox)
        Hh, Ww = render.shape[1], render.shape[2]
        dev = render.device
        ri = torch.arange(Hh, device=dev)[None, :, None]
        ci = torch.arange(Ww, device=dev)[None, None, :]
        inb = ((ri >= t_) & (ri <= b_) & (ci >= l_) & (ci <= r_)).to(
            torch.float32)
        cnt = torch.clamp(inb.sum(), min=1.0)
        l1 = torch.sum(torch.abs(render_l1 - gt_eff) * inb) / (3.0 * cnt)
        win = 11
        smap = ssim_map(render_ssim, gt_eff, win)
        rim = torch.arange(Hh - win + 1, device=dev)[None, :, None]
        cim = torch.arange(Ww - win + 1, device=dev)[None, None, :]
        inw = ((rim >= t_) & (rim + win - 1 <= b_) & (cim >= l_)
               & (cim + win - 1 <= r_)).to(torch.float32)
        cntw = torch.clamp(inw.sum(), min=1.0)
        ssim = 1.0 - torch.sum(smap * inw) / (3.0 * cntw)
    else:
        l1 = torch.mean(torch.abs(render_l1 - gt_eff))
        ssim = ssim_loss(render_ssim, gt_eff)
    return 0.8 * l1 + 0.2 * ssim, l1, ssim


def _padded_rows(arr, fill):
    """arr with one row of `fill` appended at the sentinel index len(arr)."""
    return torch.cat([arr, arr.new_full((1,) + arr.shape[1:], fill)])


def _clamp_log_radius(s, r3min, r3max):
    return torch.clamp(
        s, min=torch.log(torch.clamp(r3min, min=1e-12))[:, None],
        max=torch.log(torch.clamp(r3max, min=1e-12))[:, None],
    )


def _correction_step(corr_state: dict, view_index: int, g_corr):
    """Per-view AMSGrad Adam on the 3-channel gain: log-lerp LR 0.1 ->
    0.001 over 100 per-view steps, eps 1e-15. Returns the new state."""
    f32 = torch.float32
    dev = g_corr.device
    vsteps = corr_state["steps"].clone()
    vsteps[view_index] += 1
    st = vsteps[view_index].to(f32)
    t = torch.clamp(st / 100.0, 0.0, 1.0)
    with span("sync.correction_lr"):
        lr_start = torch.tensor(0.1, dtype=f32, device=dev)
    with span("sync.correction_lr"):
        lr_end = torch.tensor(0.001, dtype=f32, device=dev)
    lr = torch.exp(torch.log(lr_start) * (1 - t) + torch.log(lr_end) * t)
    m1 = 0.9 * corr_state["m1"][view_index] + 0.1 * g_corr
    m2 = 0.999 * corr_state["m2"][view_index] + 0.001 * g_corr * g_corr
    vmax = torch.maximum(corr_state["vmax"][view_index], m2)
    bias1 = 1 - 0.9 ** st
    bias2 = 1 - 0.999 ** st
    denom = torch.sqrt(vmax) / torch.sqrt(bias2) + 1e-15
    new_val = corr_state["values"][view_index] - (lr / bias1) * (m1 / denom)
    out = {"steps": vsteps}
    for key, row in (("values", new_val), ("m1", m1), ("m2", m2),
                     ("vmax", vmax)):
        out[key] = corr_state[key].clone()
        out[key][view_index] = row
    return out


def _step_slices(opt_params: dict, keep_leaf, keep_node, cfg: StepConfig,
                 identity_fast: bool):
    """The rows a step renders and updates: (slices, index, lane_valid),
    the leaf bucket's compaction followed by the node bucket's."""
    if identity_fast:
        dev = keep_leaf.device
        cap = keep_leaf.shape[0]
        slices = dict(opt_params)
        # dead rows may hold zero quaternions; the compacted path gives
        # them the unit quaternion (the normalization divides by the norm)
        unit = torch.tensor(UNIT_QUAT, dtype=torch.float32, device=dev)
        slices["rotation"] = torch.where(keep_leaf[:, None],
                                         slices["rotation"], unit)
        return (slices, torch.arange(cap, dtype=torch.int32, device=dev),
                keep_leaf)
    slices, index, lane_valid = _compact_slices_gather(
        opt_params, keep_leaf, cfg.k_leaf)
    if cfg.k_node > 0:
        sl_n, idx_n, lv_n = _compact_slices_gather(
            opt_params, keep_node, cfg.k_node)
        slices = {k: torch.cat([slices[k], sl_n[k]]) for k in slices}
        index = torch.cat([index, idx_n])
        lane_valid = torch.cat([lane_valid, lv_n])
    return slices, index, lane_valid


def _clamp_scaling(scaling, counter: dict, index, update_mask,
                   identity_fast: bool):
    """The updated rows' log-scales clamped into [log radius3d_min,
    log radius3d_max]; other rows unchanged."""
    if identity_fast:
        s_cl = _clamp_log_radius(scaling, counter["radius3d_min"],
                                 counter["radius3d_max"])
        return torch.where(update_mask[:, None], s_cl, scaling)
    idx = torch.where(update_mask, index.to(torch.int64), scaling.shape[0])
    s_pad = _padded_rows(scaling, 0.0)
    s = _clamp_log_radius(
        s_pad[idx], _padded_rows(counter["radius3d_min"], 1e-6)[idx],
        _padded_rows(counter["radius3d_max"], 1e6)[idx],
    )
    return s_pad.index_copy_(0, idx, s)[:scaling.shape[0]]


def train_step_stages(params: dict, moments: dict, counter: dict, keep_leaf,
                      keep_node, cam: dict, gt, background, lrs: dict,
                      global_step, corr_state: dict, view_index: int,
                      mask_ignore, gt_depth, cfg: StepConfig, fg_mask=None,
                      bbox=None, depth_patches=None, m_slices=None):
    """The training step as named stages over one state dict; `run_stages`
    of them is `_train_step_core` (its arguments), and the step's
    dissection (scripts/bench_trainstep_dissect.py) times their cumulative
    prefixes:

      compact: the rows the step renders and updates (`_step_slices`) ->
        "slices", "index", "lane_valid";
      forward: the differentiable leaves and the render with stats -> "out";
      loss: 0.8 L1 + 0.2 SSIM (+ with render_depth the depth pass and its
        patch loss) -> "loss", "l1", "ssim", "d_loss";
      backward: the gradients, zeroed where the loss is not finite ->
        "grads";
      update: counters, Adam, the scale clamp and the per-view gain ->
        "result" (_train_step_core's return value).
    """
    cap = params["xyz"].shape[0]
    dev = params["xyz"].device
    opt_params = {k: params[k] for k in cfg.opt_keys if k in params}
    # identity fast path: the leaf bucket covers the whole capacity, so the
    # dense rows ARE the slice (no compaction, dense masked Adam); row for
    # row equal to the compacted path
    identity_fast = (cfg.k_node == 0 and cfg.k_leaf == cap
                     and not cfg.spilled and cfg.identity_ok)

    def compact_stage(s):
        s["slices"], s["index"], s["lane_valid"] = _step_slices(
            opt_params, keep_leaf, keep_node, cfg, identity_fast)

    def forward_stage(s):
        K = s["index"].shape[0]
        s["leaves"] = {k: v.detach().requires_grad_(True)
                       for k, v in s["slices"].items()}
        s["offset"] = torch.zeros((K, 2), dtype=torch.float32, device=dev,
                                  requires_grad=True)
        correction = (corr_state["values"][view_index] if cfg.use_correction
                      else torch.ones(3, dtype=torch.float32, device=dev))
        s["correction"] = correction.detach().requires_grad_(True)
        with torch.enable_grad():
            s["out"] = _activate_and_rasterize(s["leaves"], s["offset"], cam,
                                               background, s["lane_valid"],
                                               cfg)

    def loss_stage(s):
        out = s["out"]
        with torch.enable_grad():
            loss, s["l1"], s["ssim"] = _loss(
                out, gt, background, s["correction"], mask_ignore, fg_mask,
                bbox, cfg)
            s["d_loss"] = None
            if cfg.render_depth:
                with span("train_step.depth"):
                    ones = torch.ones_like(out["depth_cam"])
                    depth_cols = torch.stack(
                        [out["depth_cam"], s["leaves"]["xyz"][:, 2], ones],
                        dim=-1)
                    aux_out = _activate_and_rasterize(
                        s["leaves"], s["offset"], cam, background,
                        s["lane_valid"], cfg, colors=depth_cols)
                    s["d_loss"] = depth_patch_loss(
                        aux_out["render"][0], gt_depth, aux_out["render"][2],
                        *depth_patches)
                    loss = loss + 1.0 * s["d_loss"]
        s["loss"] = loss

    def backward_stage(s):
        wrt = [*s["leaves"].values(), s["offset"], s["correction"]]
        # the backward's kernels run on autograd's device thread, outside
        # the stage's span; a trace attributes them by name
        with torch.enable_grad():
            grads = torch.autograd.grad(s["loss"], wrt, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(wrt, grads)]
        s["loss"] = loss = s["loss"].detach()
        # non-finite guard: one bad step must not poison the model through
        # the Adam moments; zero the gradients and mask the update (the loss
        # metric still reports the NaN)
        s["loss_ok"] = torch.isfinite(loss)
        s["grads"] = [torch.where(s["loss_ok"], g,
                                  torch.zeros((), dtype=g.dtype, device=dev))
                      for g in grads]

    def update_stage(s):
        out, index, lane_valid = s["out"], s["index"], s["lane_valid"]
        grads, n_leaves = s["grads"], len(s["leaves"])
        g_slices = dict(zip(s["leaves"], grads[:n_leaves]))
        g_offset, g_corr = grads[n_leaves:]
        K = index.shape[0]
        # the oracle's stats come out of differentiable ops: the counters
        # keep values, not the render's graph
        radii = out["radii"].detach()
        with span("train_step.counter"):
            new_counter = update_counter(counter, index, radii,
                                         out["point_weight"].detach(),
                                         out["point_id_pixel"], g_offset,
                                         identity=identity_fast)
        flag_vis = radii > 0
        update_mask = (lane_valid & flag_vis
                       & (torch.arange(K, device=dev) < cfg.k_leaf)
                       & s["loss_ok"])
        out_slices = None
        with span("train_step.adam"):
            if cfg.spilled:
                # the host-gathered rows go up only now, after the
                # backward, so they are not resident at its peak (pinned:
                # non-blocking)
                m_dev = {mk: {k: v.to(dev, non_blocking=True)
                              for k, v in rows.items()}
                         for mk, rows in m_slices.items()}
                new_params, new_moments, out_slices = sparse_adam_step(
                    params, moments, g_slices, index, update_mask,
                    global_step, lrs, spilled=cfg.spilled, m_slices=m_dev)
            elif identity_fast:
                new_params, new_moments = dense_adam_step(
                    params, moments, g_slices, update_mask, global_step, lrs)
            else:
                new_params, new_moments = sparse_adam_step(
                    params, moments, g_slices, index, update_mask,
                    global_step, lrs)
        new_corr = corr_state
        with span("train_step.clamp_correction"):
            new_params = dict(new_params)
            new_params["scaling"] = _clamp_scaling(
                new_params["scaling"], new_counter, index, update_mask,
                identity_fast)
            if cfg.use_correction:
                new_corr = _correction_step(corr_state, view_index, g_corr)
        metrics = {
            "loss": s["loss"],
            "l1": s["l1"].detach(),
            "ssim": s["ssim"].detach(),
            "num_rendered": torch.sum(flag_vis & lane_valid),
        }
        if s["d_loss"] is not None:
            metrics["depth"] = s["d_loss"].detach()
        if "pair_total" in out:  # the binning's unclamped demand (telemetry)
            metrics["pair_total"] = out["pair_total"]
        aux = {"render": out["render"].detach(), "radii": radii,
               "index": index}
        if cfg.spilled:
            aux["m_slices"] = out_slices
            aux["update_mask"] = update_mask
        s["result"] = (new_params, new_moments, new_counter, new_corr,
                       metrics, aux)

    return [("compact", compact_stage), ("forward", forward_stage),
            ("loss", loss_stage), ("backward", backward_stage),
            ("update", update_stage)]


def _train_step_core(params: dict, moments: dict, counter: dict, keep_leaf,
                     keep_node, cam: dict, gt, background, lrs: dict,
                     global_step, corr_state: dict, view_index: int,
                     mask_ignore, gt_depth, cfg: StepConfig, fg_mask=None,
                     bbox=None, depth_patches=None, m_slices=None):
    """Returns (params, moments, counter, corr_state, metrics, aux); the
    input dicts are left as they were. The stages of `train_step_stages`.

    gt_depth: (Hd, Wd) monocular inverse depth and depth_patches its patch
    corners (rows, cols), both needed with cfg.render_depth. m_slices: the
    host-gathered rows of the spilled moment kinds at the step's index
    (pinned host tensors); aux then holds the updated rows ("m_slices") and
    the lanes to scatter ("update_mask")."""
    if cfg.render_depth and (gt_depth is None or depth_patches is None):
        raise ValueError("render_depth needs gt_depth and depth_patches")
    if cfg.spilled and m_slices is None:
        raise ValueError(f"spilled moments {cfg.spilled} need m_slices")
    stages = train_step_stages(
        params, moments, counter, keep_leaf, keep_node, cam, gt, background,
        lrs, global_step, corr_state, view_index, mask_ignore, gt_depth, cfg,
        fg_mask, bbox, depth_patches, m_slices)
    return run_stages(stages, prefix="train_step")["result"]


def fused_train_step(params, moments, counter, keep_leaf, keep_node, cam, gt,
                     background, lrs, global_step, corr_state, view_index,
                     mask_ignore, gt_depth, cfg: StepConfig, fg_mask=None,
                     bbox=None, depth_patches=None, m_slices=None):
    """One training step on the keep masks of a prepared camera."""
    return _train_step_core(
        params, moments, counter, keep_leaf, keep_node, cam, gt, background,
        lrs, global_step, corr_state, view_index, mask_ignore, gt_depth, cfg,
        fg_mask=fg_mask, bbox=bbox, depth_patches=depth_patches,
        m_slices=m_slices,
    )


def fused_prepare_train_step(params, moments, counter, tree_arrays, n_alive,
                             is_leaf_opt, min_resolution_pixel, current_depth,
                             cam, gt, background, lrs, global_step,
                             corr_state, view_index, mask_ignore, gt_depth,
                             stage_has_tree: bool, num_levels: int,
                             prep_backend: str, prep_max_pairs: int,
                             check_scale: int, cfg: StepConfig, fg_mask=None,
                             bbox=None, cut_method: str = "traverse",
                             n_roots: int = 0, depth_patches=None):
    """Visibility + LoD cut + the training step.

    The (k_leaf, k_node) bucket in `cfg` comes from the PREVIOUS step's
    counts; this step's counts are returned in metrics["counts"] so the
    caller can grow the bucket for the next step. A transient overflow
    truncates the cut for one step.
    """
    with span("train_step.visibility"):
        keep_leaf, keep_node, counts = prepare_visibility(
            params, tree_arrays, cam, n_alive, is_leaf_opt,
            min_resolution_pixel, current_depth, cfg.image_height,
            cfg.image_width, stage_has_tree, num_levels, cfg.mode,
            prep_backend, prep_max_pairs, check_scale, cut_method, n_roots,
        )
    params, moments, counter, corr_state, metrics, aux = _train_step_core(
        params, moments, counter, keep_leaf, keep_node, cam, gt, background,
        lrs, global_step, corr_state, view_index, mask_ignore, gt_depth, cfg,
        fg_mask=fg_mask, bbox=bbox, depth_patches=depth_patches,
    )
    metrics["counts"] = counts
    aux["keep_mask"] = keep_leaf | keep_node
    return params, moments, counter, corr_state, metrics, aux
