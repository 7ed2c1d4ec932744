"""The multi-device training step: point-sharded state, the cameras split
over ranks; counterpart of log_tpu/parallel/sharded_step.py.

One axis of n ranks is at once the point axis (Gaussian attributes, Adam
moments and counters split on axis 0: rank r holds rows [r cap/n, (r+1)
cap/n)) and the data axis (each rank renders its own cams_per_device
cameras). JAX runs the step body under shard_map from one process; here
every rank runs `shard_step` on its own shard, and the collectives of
parallel/comm.py join them. Per step, with B = n * cams_per_device cameras:

  1. prepare: every rank computes frustum flags and projected radii of its
     rows for all B cameras (the cameras all_gathered), and one all_to_all
     hands each camera's owner the full (capacity,) vectors; the LoD cut
     (traverse_cut) runs on the owner against the replicated tree arrays,
     after the root weight cull (a render of the all_gathered roots, as
     the single-device step renders them);
  2. slice exchange: the attribute columns are packed into one (cap/n, D)
     matrix; each rank gathers its rows of every camera's cut and one
     psum_scatter hands each owner its (K, D) slice. Its VJP all_gathers
     the cotangent, and the gather's VJP scatter-adds it into the shard:
     the gradient's reduce-scatter falls out of autograd;
  3. render + loss per camera with the single-device step's building
     blocks (`_activate_and_rasterize`, 0.8 L1 + 0.2 SSIM); each rank
     differentiates its LOCAL weighted loss, and the total is psum'd for
     reporting only;
  4. counter statistics: the (B, K) stats all_gathered and scattered into
     each rank's rows;
  5. masked dense Adam on the packed shard (the sparse step's math, eps
     1e-15 after the sqrt) at the rows some camera touched, the scale
     clamp, and the per-view gain with psum'd deltas.

Cameras that only pad the batch carry loss weight 0: they still render
(every rank issues the same collectives in the same order) but contribute
no gradient, counter or gain update.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..model.counter import _scatter_drop
from ..model.sparse_optimizer import adam_slice_update
from ..model.tensor_tree import traverse_cut
from ..model.train_step import (UNIT_QUAT, StepConfig,
                                _activate_and_rasterize, _check_root_weights,
                                _clamp_log_radius)
from ..model.train_step import _normalize_rows as _normalize
from ..ops import gaussian_math as gm
from ..ops.ssim import ssim_loss
from .comm import Comm
from .mesh import shard_rows


@dataclass(frozen=True)
class ShardedStepConfig:
    image_height: int
    image_width: int
    k_leaf: int
    k_node: int
    sh_degree: int
    n_devices: int
    cams_per_device: int = 1
    mode: str = "antialias"
    use_correction: bool = False
    opt_keys: tuple = ("xyz", "colors", "scaling", "opacity", "rotation", "shs")
    backend: str = "tiled"
    max_pairs: int = 1 << 18
    chunk: int = 32
    stage_has_tree: bool = False
    num_levels: int = 1
    # weight cull of the roots: needs a full all_gather of the physical
    # attributes; off trades a larger cut for no gather traffic
    check_cull: bool = True
    check_scale: int = 1
    prep_backend: str = "reference"
    prep_max_pairs: int = 1 << 18

    @property
    def batch(self) -> int:
        return self.n_devices * self.cams_per_device

    @property
    def k_total(self) -> int:
        return self.k_leaf + self.k_node

    def render_cfg(self) -> StepConfig:
        return StepConfig(
            image_height=self.image_height, image_width=self.image_width,
            k_leaf=self.k_leaf, k_node=self.k_node, sh_degree=self.sh_degree,
            mode=self.mode, opt_keys=self.opt_keys, backend=self.backend,
            max_pairs=self.max_pairs, chunk=self.chunk,
        )


# ---------------------------------------------------------------- packing
def pack_columns(params: dict, keys):
    """Per-key trailing dims stacked into one (N, D) f32 matrix. Returns
    (matrix, keys present, their column counts)."""
    keys = [k for k in keys if k in params]
    dims = [int(np.prod(params[k].shape[1:])) for k in keys]
    cat = torch.cat([params[k].reshape(params[k].shape[0], -1) for k in keys],
                    dim=1)
    return cat, keys, dims


def unpack_columns(cat, keys, dims, shapes) -> dict:
    parts = torch.split(cat, list(dims), dim=1)
    return {k: p.reshape((cat.shape[0],) + tuple(shapes[k]))
            for k, p in zip(keys, parts)}


def _meta_for(params: dict, opt_keys) -> dict:
    """keys, column counts, trailing shapes and column ranges of the packed
    matrix."""
    keys = [k for k in opt_keys if k in params]
    dims = [int(np.prod(params[k].shape[1:])) for k in keys]
    shapes = {k: tuple(params[k].shape[1:]) for k in keys}
    col_of, off = {}, 0
    for k, d in zip(keys, dims):
        col_of[k] = (off, off + d)
        off += d
    return {"keys": keys, "dims": dims, "shapes": shapes, "col_of": col_of}


# ------------------------------------------------------------- step body
def _per_camera_prepare_local(params_l, cam_mat, scalars, n_alive,
                              row_offset):
    """Frustum flag and projected radius of the LOCAL rows for one camera
    (cam_mat (2, 4, 4) world_view / full_proj; scalars the host floats
    focal_x, focal_y, tan_fovx, tan_fovy)."""
    xyz = params_l["xyz"]
    capl = xyz.shape[0]
    alive = (torch.arange(capl, device=xyz.device) + row_offset) < n_alive
    px, py, pz, _ = gm.project_ndc_c(xyz[:, 0], xyz[:, 1], xyz[:, 2],
                                     cam_mat[1])
    in_frustum = gm.frustum_flag_c(px, py, pz, padding=0.5) & alive
    radius2d = gm.compute_radius2d(
        xyz, torch.exp(params_l["scaling"]), _normalize(params_l["rotation"]),
        cam_mat[0], cam_mat[1], *scalars)
    return in_frustum, radius2d


def _check_cull_one(full_phys, root_candidate, cam_mat, scalars,
                    cfg: ShardedStepConfig):
    """Low-resolution weight render of the root candidates of the whole
    capacity axis -> visible flag (cap,).

    It is the single-device step's cull (`_check_root_weights`): on the
    tiled backend the candidates are compacted to a prefix and binned with
    the tail-only expansion, as the single-device step bins them, where the
    JAX sharded step renders the capacity axis as it lies. The two differ
    on roots whose tile rect rounds to no tile at the image's edge (the
    tail-only expansion still composites them in its forced first pair),
    and the sharded step must cull as the single-device step does."""
    xyz, scaling, rotation, opacity = full_phys
    focal_x, focal_y, tan_fovx, tan_fovy = scalars
    cam = {"world_view": cam_mat[0], "full_proj": cam_mat[1],
           "focal_x": focal_x, "focal_y": focal_y, "tan_fovx": tan_fovx,
           "tan_fovy": tan_fovy}
    ok, _ = _check_root_weights(xyz, opacity, scaling, rotation,
                                root_candidate, cam, cfg.image_height,
                                cfg.image_width, cfg.mode, cfg.prep_backend,
                                cfg.prep_max_pairs, cfg.check_scale)
    return root_candidate & ok


def _first_rows(mask, k: int, fill: int):
    """jnp.nonzero(mask, size=k, fill_value=fill) per row of a (B, cap)
    mask: the first k set columns ascending, padded with `fill`."""
    B, cap = mask.shape
    dev = mask.device
    pos = torch.cumsum(mask.to(torch.int64), dim=1) - 1
    slot = torch.where(mask & (pos < k), pos, k)
    out = torch.full((B, k + 1), fill, dtype=torch.int64, device=dev)
    cols = torch.arange(cap, device=dev).expand(B, cap)
    # every column past the k-th set one lands in the spare slot k
    out.scatter_(1, slot, cols)
    return out[:, :k]


def shard_step(packed_l, m1_l, m2_l, counter_l: dict, tree_rep: dict,
               is_leaf_opt, n_alive: int, current_depth: int, min_res,
               cam_mats, cam_scalars, cam_center, background, gt, weight,
               wsum: float, lr_cols, global_step: float, corr_state: dict,
               view_idx, meta: dict, cfg: ShardedStepConfig, comm: Comm):
    """One step on this rank's shard.

    packed_l, m1_l, m2_l: (cap/n, D) rows of the packed params and moments;
    counter_l: (cap/n,) counter rows; tree_rep, is_leaf_opt (cap,) and
    corr_state: replicated. Per camera of THIS rank (B_local =
    cams_per_device): min_res (B_local,), cam_mats (B_local, 2, 4, 4),
    cam_scalars (B_local, 4) float64 (focal_x, focal_y, tan_fovx,
    tan_fovy: the host floats of the single-device camera), cam_center
    (B_local, 3), background (B_local, 3), gt (B_local, 3, H, W) f32 or
    uint8, weight (B_local,), view_idx (B_local,). wsum: the batch's total
    weight.
    Returns (packed, m1, m2, counter, corr_state, metrics, counts (B_local,
    2)); the metrics (loss, l1, ssim) are the batch's totals on every rank.
    """
    n = cfg.n_devices
    if comm.world != n:
        raise ValueError(f"{n}-rank step on a {comm.world}-rank group")
    Bl = cfg.cams_per_device
    B = cfg.batch
    capl = packed_l.shape[0]
    cap = capl * n
    dev = packed_l.device
    row_offset = comm.rank * capl
    keys, dims, shapes = meta["keys"], meta["dims"], meta["shapes"]
    col_of = meta["col_of"]

    def local_cols(key):
        lo, hi = col_of[key]
        return packed_l[:, lo:hi]

    params_l = {k: local_cols(k) for k in ("xyz", "scaling", "rotation")}
    mr = min_res.tolist()

    # ---- 1. prepare: every camera over the local rows, then to its owner
    cam_mats_all = comm.all_gather(cam_mats)            # (B, 2, 4, 4)
    cam_scalars_all = comm.all_gather(cam_scalars)      # (B, 4)
    scalars = cam_scalars_all.tolist()
    prep = [_per_camera_prepare_local(params_l, cam_mats_all[b], scalars[b],
                                      n_alive, row_offset) for b in range(B)]
    frus = comm.all_to_all(torch.stack([p[0] for p in prep]), 0, 1)
    rad = comm.all_to_all(torch.stack([p[1] for p in prep]), 0, 1)
    del prep

    alive_full = torch.arange(cap, device=dev) < n_alive
    if cfg.stage_has_tree:
        is_root = tree_rep["index_parent"] == -1
        root_candidate = is_root[None] & frus
        if cfg.check_cull:
            full_phys = tuple(comm.all_gather(a) for a in (
                local_cols("xyz"), torch.exp(local_cols("scaling")),
                _normalize(local_cols("rotation")),
                torch.sigmoid(local_cols("opacity")[:, 0])))
            me = comm.rank * Bl
            root_visible = torch.stack([
                _check_cull_one(full_phys, root_candidate[b],
                                cam_mats_all[me + b], scalars[me + b], cfg)
                for b in range(Bl)])
            del full_phys
        else:
            root_visible = root_candidate
        keep = torch.stack([
            traverse_cut(tree_rep["node_index"], tree_rep["index_parent"],
                         tree_rep["depth"], rad[b], root_visible[b],
                         alive_full, mr[b], current_depth, cfg.num_levels)
            for b in range(Bl)])
        keep_leaf = keep & is_leaf_opt[None]
        keep_node = keep & ~is_leaf_opt[None]
    else:
        keep_leaf = frus
        keep_node = torch.zeros_like(frus)
    counts_my = torch.stack([keep_leaf.sum(1), keep_node.sum(1)], dim=1)

    idx_my = _first_rows(keep_leaf, cfg.k_leaf, cap)
    if cfg.k_node > 0:
        idx_my = torch.cat([idx_my, _first_rows(keep_node, cfg.k_node, cap)],
                           dim=1)                       # (B_local, K)
    K = cfg.k_total
    idx_all = comm.all_gather(idx_my)                   # (B, K)

    # ---- 2+3. differentiable: slice exchange -> render -> loss ---------
    rcfg = cfg.render_cfg()
    packed_v = packed_l.detach().requires_grad_(True)
    offsets = torch.zeros((Bl, K, 2), dtype=torch.float32, device=dev,
                          requires_grad=True)
    corr_v = corr_state["values"].detach().requires_grad_(True)
    unit = torch.tensor(UNIT_QUAT, dtype=torch.float32, device=dev)
    vi = view_idx.tolist()
    w_host = weight.tolist()
    with torch.enable_grad():
        # this rank's rows of every camera's slice, zeros where another
        # rank owns the row. Those lanes read a spread of local rows, not
        # one shared zero row: the gather's VJP adds their zero gradients
        # into the rows they read, and the indexing backward sums the
        # duplicates of one index in turn (at 4 ranks ~1.3M of them x D
        # columns on one row took ~0.4 s a step on an H100)
        lidx = idx_all - row_offset
        mine = (lidx >= 0) & (lidx < capl)
        spread = torch.arange(lidx.numel(), device=dev).reshape(
            lidx.shape) % capl
        rows = packed_v[torch.where(mine, lidx, spread)]
        slice_my = comm.psum_scatter(
            torch.where(mine[..., None], rows, 0.0))    # (B_local, K, D)
        losses, l1s, ssims, radii_b, pw_b, pid_b = [], [], [], [], [], []
        for b in range(Bl):
            lane_valid = idx_my[b] < cap
            slices = unpack_columns(slice_my[b], keys, dims, shapes)
            slices["rotation"] = torch.where(lane_valid[:, None],
                                             slices["rotation"], unit)
            cam = {
                "world_view": cam_mats[b, 0], "full_proj": cam_mats[b, 1],
                "camera_center": cam_center[b],
                "focal_x": scalars[comm.rank * Bl + b][0],
                "focal_y": scalars[comm.rank * Bl + b][1],
                "tan_fovx": scalars[comm.rank * Bl + b][2],
                "tan_fovy": scalars[comm.rank * Bl + b][3],
            }
            out = _activate_and_rasterize(slices, offsets[b], cam,
                                          background[b], lane_valid, rcfg)
            gt_f = (gt[b].to(torch.float32) * (1.0 / 255.0)
                    if gt.dtype == torch.uint8 else gt[b])
            render = out["render"]
            render_l1 = (render * corr_v[vi[b]][:, None, None]
                         if cfg.use_correction else render)
            l1 = torch.mean(torch.abs(render_l1 - gt_f))
            ssim = ssim_loss(render, gt_f)
            losses.append(w_host[b] * (0.8 * l1 + 0.2 * ssim))
            l1s.append(w_host[b] * l1.detach())
            ssims.append(w_host[b] * ssim.detach())
            radii_b.append(out["radii"].detach())
            pw_b.append(out["point_weight"].detach())
            pid_b.append(out["point_id_pixel"])
        # the LOCAL weighted loss: the ranks' gradients meet in the slice
        # exchange's VJP; a psum here would count each n times
        local = torch.stack(losses).sum() / wsum
        g_packed, g_offsets, g_corr = torch.autograd.grad(
            local, [packed_v, offsets, corr_v], allow_unused=True)
    if g_corr is None:
        g_corr = torch.zeros_like(corr_v)
    metrics = {
        "loss": comm.psum(local.detach()),
        "l1": comm.psum(torch.stack(l1s).sum() / wsum),
        "ssim": comm.psum(torch.stack(ssims).sum() / wsum),
    }

    # ---- 4. counter statistics: the (B, K) stats, gathered -------------
    real = weight > 0.0
    radii_my = torch.stack(radii_b)                     # (B_local, K)
    pid = torch.stack(pid_b).reshape(Bl, -1).to(torch.int64)
    pid = torch.where(pid >= 0, pid, K)
    point_count_my = torch.stack([
        torch.bincount(p, minlength=K + 1)[:K] for p in pid]).to(torch.int32)
    gnorm_my = torch.sqrt(torch.sum(g_offsets ** 2, dim=-1))
    # padding cameras contribute nothing: their indices leave the range
    idx_stat_my = torch.where(real[:, None], idx_my, cap)

    def gath(x):
        return comm.all_gather(x).reshape(B * K)

    idx_g = gath(idx_stat_my)
    radii_g = gath(radii_my)
    pw_g = gath(torch.stack(pw_b))
    pc_g = gath(point_count_my)
    gn_g = gath(gnorm_my)

    lidx_g = idx_g - row_offset
    loc_ok = (lidx_g >= 0) & (lidx_g < capl)
    flag_vis = radii_g > 0
    idx_vis = torch.where(loc_ok & flag_vis, lidx_g, capl)
    idx_area = torch.where(loc_ok & (pc_g > 0), lidx_g, capl)
    ones = torch.ones_like(radii_g)
    c = dict(counter_l)
    c["area_sum"] = _scatter_drop(c["area_sum"], idx_area, pc_g, "sum")
    c["grad_sum"] = _scatter_drop(c["grad_sum"], idx_area,
                                  gn_g * pc_g.to(gn_g.dtype), "sum")
    c["radii_max_max"] = _scatter_drop(c["radii_max_max"], idx_area, pc_g,
                                       "amax")
    c["create_steps"] = _scatter_drop(c["create_steps"], idx_vis, ones, "sum")
    c["visible_count"] = _scatter_drop(c["visible_count"], idx_vis, ones,
                                       "sum")
    c["weights_max"] = _scatter_drop(c["weights_max"], idx_vis, pw_g, "amax")
    c["weights_sum"] = _scatter_drop(c["weights_sum"], idx_vis, pw_g, "sum")
    c["radii_max"] = _scatter_drop(c["radii_max"], idx_vis, radii_g, "amax")

    # ---- 5. masked dense Adam on the local shard -----------------------
    # touched rows: visible leaf lanes of real cameras
    leaf_lane = (torch.arange(K, device=dev) < cfg.k_leaf).repeat(B)
    idx_upd = torch.where(loc_ok & flag_vis & leaf_lane, lidx_g, capl)
    touched = torch.zeros((capl + 1,), dtype=torch.bool, device=dev)
    touched[idx_upd] = True
    m = touched[:capl, None]
    p_u, m1_u, m2_u, _ = adam_slice_update(
        packed_l, g_packed, m1_l, m2_l,
        torch.tensor(global_step, dtype=torch.float32, device=dev),
        lr_cols[None, :])
    m1_new = torch.where(m, m1_u, m1_l)
    m2_new = torch.where(m, m2_u, m2_l)
    packed_new = torch.where(m, p_u, packed_l)
    # the scale clamp on touched rows
    lo, hi = col_of["scaling"]
    s = packed_new[:, lo:hi]
    s_cl = _clamp_log_radius(s, counter_l["radius3d_min"],
                             counter_l["radius3d_max"])
    packed_new = torch.cat([packed_new[:, :lo], torch.where(m, s_cl, s),
                            packed_new[:, hi:]], dim=1)

    # ---- the per-view gain: AMSGrad with psum'd deltas -----------------
    if cfg.use_correction:
        new_corr = _corrector_update(corr_state, g_corr, vi, real, comm)
    else:
        new_corr = corr_state
    return packed_new, m1_new, m2_new, c, new_corr, metrics, counts_my


def _corrector_update(corr: dict, g_corr, vi: list, real, comm: Comm):
    """Per-view AMSGrad (log-lerp LR 0.1 -> 0.001 over 100 view steps):
    each rank's camera deltas, summed over the ranks. g_corr is the grad of
    the whole (n_views, 3) table; with at most one camera per view per
    step, the row of a camera's view is its own gradient."""
    nv = corr["values"].shape[0]
    dev = corr["values"].device
    gate = real.tolist()
    vsteps_delta = torch.zeros((nv,), dtype=torch.int32, device=dev)
    for b, v in enumerate(vi):
        if gate[b]:
            vsteps_delta[v] += 1
    vsteps = corr["steps"] + comm.psum(vsteps_delta)
    deltas = {k: torch.zeros_like(corr[k]) for k in ("values", "m1", "m2",
                                                     "vmax")}
    for b, v in enumerate(vi):
        st = vsteps[v].to(torch.float32)
        t = torch.clamp(st / 100.0, 0.0, 1.0)
        lr = torch.exp(torch.log(torch.tensor(0.1, device=dev)) * (1 - t)
                       + torch.log(torch.tensor(0.001, device=dev)) * t)
        g = g_corr[v]
        m1v = 0.9 * corr["m1"][v] + 0.1 * g
        m2v = 0.999 * corr["m2"][v] + 0.001 * g * g
        vmaxv = torch.maximum(corr["vmax"][v], m2v)
        b1 = 1 - 0.9 ** st
        b2 = 1 - 0.999 ** st
        den = torch.sqrt(vmaxv) / torch.sqrt(b2) + 1e-15
        val = corr["values"][v] - (lr / b1) * (m1v / den)
        if gate[b]:
            deltas["values"][v] += val - corr["values"][v]
            deltas["m1"][v] += m1v - corr["m1"][v]
            deltas["m2"][v] += m2v - corr["m2"][v]
            deltas["vmax"][v] += vmaxv - corr["vmax"][v]
    new = {k: corr[k] + comm.psum(d) for k, d in deltas.items()}
    new["steps"] = vsteps
    return new


def sharded_train_step(params: dict, moments: dict, counter: dict,
                       tree_rep: dict, is_leaf_opt, n_alive, current_depth,
                       min_res, cam_mats, cam_scalars, cam_center, background,
                       gt, weight, lrs: dict, global_step, corr_state: dict,
                       view_idx, cfg: ShardedStepConfig, comm: Comm | None = None):
    """Functional entry: dict-of-tensors in and out. Every rank passes the
    same global arrays (capacity rows; B = n * cams_per_device cameras on
    axis 0 of the camera arrays) and gets the global result back: it takes
    its block of rows and of cameras, runs `shard_step`, and all_gathers
    the new state. Returns (params, moments, counter, corr_state, metrics,
    counts (B, 2))."""
    comm = comm if comm is not None else Comm()
    meta = _meta_for(params, cfg.opt_keys)
    keys, dims, shapes = meta["keys"], meta["dims"], meta["shapes"]
    r, n = comm.rank, comm.world
    packed, _, _ = pack_columns(params, keys)
    m1, _, _ = pack_columns(moments["exp_avg"], keys)
    m2, _, _ = pack_columns(moments["exp_avg_sq"], keys)
    dev = packed.device
    lr_cols = torch.cat([
        torch.full((d,), float(np.float32(lrs[k])), dtype=torch.float32,
                   device=dev) for k, d in zip(keys, dims)])
    wsum = max(float(torch.as_tensor(weight).sum()), 1e-8)

    def mine(x):
        return shard_rows(torch.as_tensor(x), r, n)

    out = shard_step(
        mine(packed).clone(), mine(m1).clone(), mine(m2).clone(),
        {k: mine(v).clone() for k, v in counter.items()}, tree_rep,
        is_leaf_opt, int(n_alive), int(current_depth), mine(min_res),
        mine(cam_mats), mine(cam_scalars), mine(cam_center), mine(background),
        mine(gt), mine(weight), wsum, lr_cols, float(global_step), corr_state,
        mine(view_idx), meta, cfg, comm)
    packed, m1, m2, counter_l, corr_state, metrics, counts = out
    new_params = dict(params)
    new_params.update(unpack_columns(comm.all_gather(packed), keys, dims,
                                     shapes))
    new_moments = {"exp_avg": dict(moments["exp_avg"]),
                   "exp_avg_sq": dict(moments["exp_avg_sq"])}
    new_moments["exp_avg"].update(unpack_columns(comm.all_gather(m1), keys,
                                                 dims, shapes))
    new_moments["exp_avg_sq"].update(unpack_columns(comm.all_gather(m2), keys,
                                                    dims, shapes))
    new_counter = {k: comm.all_gather(v) for k, v in counter_l.items()}
    return (new_params, new_moments, new_counter, corr_state, metrics,
            comm.all_gather(counts))
