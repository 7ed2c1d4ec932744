"""The training step and the per-frame visibility, LoD cut and render;
counterpart of log_tpu/model/train_step.py.

Training: `fused_train_step` (and `fused_prepare_train_step`, which runs the
visibility pass first) is slice compaction -> activation + SH -> the tiled
render with densification stats -> 0.8 L1 + 0.2 SSIM -> autograd backward
(K2 and the plain-torch VJPs of the binning) -> non-finite guard -> counter
update -> sparse or dense Adam -> scale clamp -> per-view gain Adam. The JAX
package runs it as one jitted executable with donated buffers; here it runs
eagerly, and every update builds new tensors after the backward has used
the saved ones. The slice bucket (k_leaf, k_node) and the pair budget are
the JAX package's, so truncation and the counts that size the next step
agree with it.

Serving: `fused_prepare_render` is the inference frame of the demo/val/viewer
path: frustum test -> root weight-cull render -> LoD cut -> compaction of the
cut into a static slice -> activation + SH -> tiled render, under
torch.no_grad().
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field

import torch
from torch.profiler import record_function

from ..ops import gaussian_math as gm
from ..ops import rasterize_ref
from ..ops.rasterize_tiled import rasterize_tiled
from ..ops.sh import eval_sh, sh_to_rgb
from ..ops.ssim import ssim_loss, ssim_map
from .counter import update_counter
from .sparse_optimizer import dense_adam_step, sparse_adam_step
from .tensor_tree import flat_cut, traverse_cut

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
    slices, _, lane_valid = _compact_slices_gather(
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
    render_depth: bool = False  # the depth loss: ROADMAP queue 1.2b
    # foreground-mask training: the GT composites over the step background
    # inside the mask and the loss is restricted to the mask's bbox (the L1
    # mean and the SSIM windows inside the bbox, with static shapes)
    crop_loss: bool = False
    spilled: tuple = ()  # host-spilled moments: ROADMAP queue 1.2b
    # identity fast path opt-out (LOG_TPU_IDENTITY_STEP=0), read when the
    # config is built
    identity_ok: bool = field(
        default_factory=lambda: os.environ.get(
            "LOG_TPU_IDENTITY_STEP", "1"
        ) != "0"
    )


def _activate_and_rasterize(slices, offset, cam, background, lane_valid,
                            cfg: StepConfig):
    """Param-space slice -> physical -> rasterize. Differentiable."""
    scaling = torch.exp(slices["scaling"])
    opacity = torch.sigmoid(slices["opacity"][:, 0])
    rotation = slices["rotation"] / torch.linalg.norm(
        slices["rotation"], dim=-1, keepdim=True
    )
    colors = sh_to_rgb(slices["colors"])
    if cfg.sh_degree > 0 and "shs" in slices:
        # view directions carry no gradient to the positions
        dirs = _normalize_rows(slices["xyz"].detach()
                               - cam["camera_center"][None])
        colors = colors + eval_sh(dirs, slices["shs"], degree=cfg.sh_degree)
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
                               with_stats=True)
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
    lr = torch.exp(torch.log(torch.tensor(0.1, dtype=f32, device=dev)) * (1 - t)
                   + torch.log(torch.tensor(0.001, dtype=f32, device=dev)) * t)
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


def _train_step_core(params: dict, moments: dict, counter: dict, keep_leaf,
                     keep_node, cam: dict, gt, background, lrs: dict,
                     global_step, corr_state: dict, view_index: int,
                     mask_ignore, gt_depth, cfg: StepConfig, fg_mask=None,
                     bbox=None):
    """Returns (params, moments, counter, corr_state, metrics, aux); the
    input dicts are left as they were."""
    if cfg.render_depth:
        raise NotImplementedError(
            "the monocular depth loss (render/loss.py) is ROADMAP queue 1.2b")
    if cfg.spilled:
        raise NotImplementedError(
            "host-spilled optimizer moments are ROADMAP queue 1.2b")
    cap = params["xyz"].shape[0]
    dev = params["xyz"].device
    opt_params = {k: params[k] for k in cfg.opt_keys if k in params}
    # identity fast path: the leaf bucket covers the whole capacity, so the
    # dense rows ARE the slice (no compaction, dense masked Adam); row for
    # row equal to the compacted path
    identity_fast = (cfg.k_node == 0 and cfg.k_leaf == cap
                     and cfg.identity_ok)
    with record_function("train_step.compact"):
        slices, index, lane_valid = _step_slices(
            opt_params, keep_leaf, keep_node, cfg, identity_fast)
    K = index.shape[0]
    leaves = {k: v.detach().requires_grad_(True) for k, v in slices.items()}
    offset = torch.zeros((K, 2), dtype=torch.float32, device=dev,
                         requires_grad=True)
    correction = (corr_state["values"][view_index] if cfg.use_correction
                  else torch.ones(3, dtype=torch.float32, device=dev))
    correction = correction.detach().requires_grad_(True)

    with torch.enable_grad():
        with record_function("train_step.render"):
            out = _activate_and_rasterize(leaves, offset, cam, background,
                                          lane_valid, cfg)
        with record_function("train_step.loss"):
            loss, l1, ssim = _loss(out, gt, background, correction,
                                   mask_ignore, fg_mask, bbox, cfg)
        wrt = [*leaves.values(), offset, correction]
        # the backward's kernels run on autograd's device thread, outside
        # this range; a trace attributes them by name
        with record_function("train_step.backward"):
            grads = torch.autograd.grad(loss, wrt, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(wrt, grads)]
    loss = loss.detach()
    # non-finite guard: one bad step must not poison the model through the
    # Adam moments; zero the gradients and mask the update (the loss
    # metric still reports the NaN)
    loss_ok = torch.isfinite(loss)
    grads = [torch.where(loss_ok, g, torch.zeros((), dtype=g.dtype,
                                                 device=dev)) for g in grads]
    g_slices = dict(zip(leaves, grads[:len(leaves)]))
    g_offset, g_corr = grads[len(leaves):]

    radii = out["radii"]
    with record_function("train_step.counter"):
        counter = update_counter(counter, index, radii, out["point_weight"],
                                 out["point_id_pixel"], g_offset,
                                 identity=identity_fast)
    flag_vis = radii > 0
    update_mask = (lane_valid & flag_vis
                   & (torch.arange(K, device=dev) < cfg.k_leaf) & loss_ok)
    with record_function("train_step.adam"):
        if identity_fast:
            params, moments = dense_adam_step(params, moments, g_slices,
                                              update_mask, global_step, lrs)
        else:
            params, moments = sparse_adam_step(params, moments, g_slices,
                                               index, update_mask,
                                               global_step, lrs)

    with record_function("train_step.clamp_correction"):
        params = dict(params)
        params["scaling"] = _clamp_scaling(params["scaling"], counter, index,
                                           update_mask, identity_fast)
        if cfg.use_correction:
            corr_state = _correction_step(corr_state, view_index, g_corr)

    metrics = {
        "loss": loss,
        "l1": l1.detach(),
        "ssim": ssim.detach(),
        "num_rendered": torch.sum(flag_vis & lane_valid),
    }
    if "pair_total" in out:  # the binning's unclamped demand (telemetry)
        metrics["pair_total"] = out["pair_total"]
    aux = {"render": out["render"].detach(), "radii": radii, "index": index}
    return params, moments, counter, corr_state, metrics, aux


def fused_train_step(params, moments, counter, keep_leaf, keep_node, cam, gt,
                     background, lrs, global_step, corr_state, view_index,
                     mask_ignore, gt_depth, cfg: StepConfig, fg_mask=None,
                     bbox=None):
    """One training step on the keep masks of a prepared camera."""
    return _train_step_core(
        params, moments, counter, keep_leaf, keep_node, cam, gt, background,
        lrs, global_step, corr_state, view_index, mask_ignore, gt_depth, cfg,
        fg_mask=fg_mask, bbox=bbox,
    )


def fused_prepare_train_step(params, moments, counter, tree_arrays, n_alive,
                             is_leaf_opt, min_resolution_pixel, current_depth,
                             cam, gt, background, lrs, global_step,
                             corr_state, view_index, mask_ignore, gt_depth,
                             stage_has_tree: bool, num_levels: int,
                             prep_backend: str, prep_max_pairs: int,
                             check_scale: int, cfg: StepConfig, fg_mask=None,
                             bbox=None, cut_method: str = "traverse",
                             n_roots: int = 0):
    """Visibility + LoD cut + the training step.

    The (k_leaf, k_node) bucket in `cfg` comes from the PREVIOUS step's
    counts; this step's counts are returned in metrics["counts"] so the
    caller can grow the bucket for the next step. A transient overflow
    truncates the cut for one step.
    """
    with record_function("train_step.visibility"):
        keep_leaf, keep_node, counts = prepare_visibility(
            params, tree_arrays, cam, n_alive, is_leaf_opt,
            min_resolution_pixel, current_depth, cfg.image_height,
            cfg.image_width, stage_has_tree, num_levels, cfg.mode,
            prep_backend, prep_max_pairs, check_scale, cut_method, n_roots,
        )
    params, moments, counter, corr_state, metrics, aux = _train_step_core(
        params, moments, counter, keep_leaf, keep_node, cam, gt, background,
        lrs, global_step, corr_state, view_index, mask_ignore, gt_depth, cfg,
        fg_mask=fg_mask, bbox=bbox,
    )
    metrics["counts"] = counts
    aux["keep_mask"] = keep_leaf | keep_node
    return params, moments, counter, corr_state, metrics, aux
