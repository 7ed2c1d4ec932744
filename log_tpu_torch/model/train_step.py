"""Per-frame visibility, LoD cut and render; serving half of
log_tpu/model/train_step.py.

`fused_prepare_render` is the inference frame of the demo/val/viewer path:
frustum test -> root weight-cull render -> LoD cut -> compaction of the cut
into a static slice -> activation + SH -> tiled render. The JAX package runs
it as one jitted executable; here it runs eagerly under torch.no_grad(), with
the same static buckets (slice size, pair budget) so truncation and the
`counts` that size the next frame agree with the JAX package.
"""
from __future__ import annotations

import torch

from ..ops import gaussian_math as gm
from ..ops import rasterize_ref
from ..ops.rasterize_tiled import rasterize_tiled
from ..ops.sh import eval_sh, sh_to_rgb
from .tensor_tree import flat_cut, traverse_cut

UNIT_QUAT = (1.0, 0.0, 0.0, 0.0)


def _compact_slices_sort(params: dict, keep, k: int):
    """Kept rows to the front, in index order (order-preserving, stable).

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
    > 1e-8. Inputs are the activated root prefix rows; returns (R,) bool."""
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
        slices, index, lane_valid = _compact_slices_sort(
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
        return check["point_weight"] > 1e-8
    check = rasterize_ref.rasterize(
        xyz=xyz, colors=torch.ones_like(xyz), opacity=opacity,
        scaling=scaling, rotation=rotation,
        means2d_offset=torch.zeros_like(xyz[:, :2]),
        active_mask=root_candidate, chunk=64, **common,
    )
    return check["point_weight"] > 1e-8


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
    root_weight_ok = _check_root_weights(
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
                         use_filter: bool = False, cap_sort: int = 0):
    """Inference frame: LoD cut + slice compaction + activation + render.
    k_visible is the static cut budget; overflow truncates the cut for that
    frame. Returns (render (3,H,W), alpha (H,W), counts (3,), pair_total):
    counts holds the kept leaf/node counts and -1, as in the JAX package,
    whose generic branch feeds no pair demand back into the next frame's
    budget; pair_total is the frame's unclamped pair demand for telemetry
    (-1 on the reference backend).
    """
    if cut_method == "flat_slice" and stage_has_tree:
        raise NotImplementedError(
            "cut_method='flat_slice' (and its packed column render) is the "
            "next render slice: ROADMAP queue 1, item 3"
        )
    cap = params["xyz"].shape[0]
    if 0 < cap_sort < cap:
        # points past the alive bucket are dead by construction, so the
        # capacity-axis passes run over [:cap_sort] only
        if cap_sort < k_visible:
            raise ValueError(f"cap_sort {cap_sort} < k_visible {k_visible}")
        params = {k: v[:cap_sort] for k, v in params.items()}
        tree_arrays = {
            k: (v[:cap_sort] if v.dim() >= 1 and v.shape[0] == cap else v)
            for k, v in tree_arrays.items()
        }
        is_leaf_opt = is_leaf_opt[:cap_sort]
    need = ["xyz", "colors", "scaling", "opacity", "rotation"]
    if sh_degree > 0 and "shs" in params:
        need.append("shs")
    keep_leaf, keep_node, counts = prepare_visibility(
        params, tree_arrays, cam, n_alive, is_leaf_opt, min_resolution_pixel,
        current_depth, image_height, image_width, stage_has_tree, num_levels,
        mode, prep_backend, prep_max_pairs, check_scale, cut_method, n_roots,
    )
    slices, _, lane_valid = _compact_slices_sort(
        {kk: params[kk] for kk in need}, keep_leaf | keep_node, k_visible
    )
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
            tight_radius=True, runs_tail_only=True, prefix_mask=lane_valid,
        )
    else:
        out = rasterize_ref.rasterize(**kwargs)
    minus_one = torch.full((1,), -1, dtype=counts.dtype, device=counts.device)
    counts = torch.cat([counts, minus_one])
    pair_total = out.get("pair_total", minus_one[0])
    return out["render"], out["alpha"], counts, pair_total
