"""LoG: the level-of-Gaussians model; counterpart of
log_tpu/model/level_of_gaussian.py.

Owns the point store and the LoD tree, the densification counters, the
sparse optimizer and the per-view gain, the device caches the per-frame cut
reads (tree arrays, parent-attribute cache), checkpoint (de)serialization
with the reference's key names, the training step (`train_step`,
`training_iteration`), the inference frame `render_fused` (generic,
flat_slice and block-pruned) and the inference row layout
`optimize_render_layout`, the init pass (`init_view`) and densification
with its schedule (`update_by_iteration`): on the host (numpy, the
Splitter) or on the device (model/densify_device.py), which give equal
arrays from the same random draws. Past the optimizer's spill thresholds
the Adam moments move to pinned host memory and `train_step` gathers and
scatters the visible rows' moments around each step.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import gaussian_math as gm
from ..ops import pick_backend, pick_max_pairs
from ..render.loss import draw_patch_offsets
from ..utils import jax_random
from ..utils.profiler import span
from . import densify_device as dd
from .block_render import block_size_for, build_block_cache, render_blocks
from .corrector import Corrector
from .counter import RESET_KEYS, Counter, init_counter, str_min_mean_max
from .gaussian import GaussianPoint, next_capacity
from .sparse_optimizer import SparseOptimizer
from .splitter import Splitter
from .tensor_tree import TensorTree
from .train_step import (StepConfig, fused_prepare_render,
                         fused_prepare_train_step, fused_root_cull,
                         fused_train_step, prepare_visibility)

# the init pass sizes each point to cover this many pixels in its
# closest view
MIN_PIXEL = 3


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


class LoG:
    def __init__(self, gaussian: dict, tree: dict, optimizer: dict,
                 densify_and_remove: dict, use_view_correction: bool = False,
                 check_render_scale: int = 1, device="cuda", seed: int = 0):
        self.device = torch.device(device)
        self.optimizer_cfg = dict(optimizer)
        self.densify_and_remove = dict(densify_and_remove)
        self.gaussian = GaussianPoint(**gaussian, device=self.device)
        self.tree = TensorTree(**tree)
        self.counter = Counter(self.gaussian.capacity, device=self.device)
        # densify_and_remove.split_method: 'uniform' (the reference's) or
        # 'sample'
        self.splitter = Splitter(
            N=tree.get("max_child", 2),
            split_method=densify_and_remove.get("split_method", "uniform"),
        )
        # the densify's random draws come from one numpy Generator seeded
        # from `seed`: the host path draws from it, the device path draws
        # the key of its jax.random draw from it, as the JAX model does.
        # The CLI passes the JAX model's seed: the first global numpy draw
        # after seed_everything (apps/train.py)
        self._rng = np.random.default_rng(seed)
        self.num_views = 0
        self.use_view_correction = use_view_correction
        self.view_correction = (Corrector(use_view_correction)
                                if use_view_correction else None)
        self.check_render_scale = check_render_scale
        self.current_depth = 0
        self.training = True
        self.stage_name = "init"
        self.base_iter = 1
        self.optimizer: SparseOptimizer | None = None
        self.lr = 0.0
        self.visibility_flag = None
        self._tree_dev = None
        self._leaf_opt_dev = None
        # the lagged (k_leaf, k_node) bucket of training_iteration and the
        # last step's device-side counts it is refreshed from
        self._bucket = None
        self._counts_dev = None
        # per-view gain Adam state, device-resident across steps
        self._corr_dev = None
        # static buckets of the inference frame and the last frame's
        # device-side counts they are sized from (see render_fused)
        self._render_bucket = None
        self._pair_bucket = None
        self._frame = None
        # flat_slice frames: the capacity-axis weight-cull mask, refreshed
        # every check_render_every frames, and the row layout / block cache
        # of optimize_render_layout
        self.check_render_every = 1
        self._cull_mask_dev = None
        self._cull_frame_i = 0
        self._cull_bucket = None
        self._block_cache = None
        self._kb_bucket = None
        self._layout_optimized = False
        self._cull_seg_starts = None

    # ------------------------------------------------------------ basics
    @property
    def num_points(self) -> int:
        return self.gaussian.num_points

    @property
    def capacity(self) -> int:
        return self.gaussian.capacity

    def train(self):
        self.training = True

    def eval(self):
        self.training = False

    def clear(self):
        self.visibility_flag = None

    def __repr__(self):
        n = self.num_points
        scal = self.gaussian.get("scaling")[:n].cpu().numpy()
        radius = np.exp(scal).max(axis=-1)
        opac = _sigmoid(self.gaussian.get("opacity")[:n, 0].cpu().numpy())
        return (
            f"Gaussian {n} points\n"
            f"    radius [{radius.min():.4f}~{radius.mean():.4f}~"
            f"{radius.max():.4f}]\n"
            f"    opacity: {opac.mean():.2f}, {(opac < 0.05).sum()} < 0.05, "
            f"{(opac < 0.1).sum()} < 0.1, "
        )

    def set_stage(self, stage_name: str):
        self.stage_name = stage_name
        self._bucket = None
        self._counts_dev = None

    def set_state(self, active_sh_degree=None, enable_sh=None,
                  min_resolution_pixel=None, current_depth=None,
                  scaling_modifier=1.0, log_query=None,
                  reset_created_steps=False, check_render_every=None):
        # scaling_modifier is accepted (stage model_state YAML sets it) and
        # not used, as in the JAX package
        if active_sh_degree is not None or enable_sh is not None:
            if enable_sh:
                self.gaussian.active_sh_degree = self.gaussian.max_sh_degree
            else:
                self.gaussian.active_sh_degree = min(
                    int(active_sh_degree), self.gaussian.max_sh_degree
                )
            print(f"[{self.__class__.__name__}] active_sh_degree: "
                  f"{self.gaussian.active_sh_degree}")
        if reset_created_steps:
            self.counter.reset_create_steps()
            print(f"[{self.__class__.__name__}] reset created steps")
        if min_resolution_pixel is not None:
            self.tree.min_resolution_pixel = float(min_resolution_pixel)
        if current_depth is not None:
            self.current_depth = int(current_depth)
            print(f"[{self.__class__.__name__}] set current depth -> "
                  f"{self.current_depth}")
        if log_query is not None:
            self.tree.log_query = bool(log_query)
        if check_render_every is not None:
            self.check_render_every = int(check_render_every)
            self._cull_mask_dev = None

    # ------------------------------------------------------- device caches
    @property
    def cut_method(self) -> str:
        """'flat' unless the config opted out or parents are optimized
        (opt_all_levels=False would stale the parent cache)."""
        cm = getattr(self.tree, "cut_method", "flat")
        if cm not in ("flat", "flat_slice"):
            return "traverse"
        if not self.optimizer_cfg.get("opt_all_levels", True):
            return "traverse"
        return cm

    @property
    def cut_method_train(self) -> str:
        cm = self.cut_method
        return "flat" if cm == "flat_slice" else cm

    @property
    def n_roots_bucket(self) -> int:
        """Static row-count bucket covering the root prefix [0, n_roots)."""
        n = int(self.tree.root_index.shape[0]) if self.tree.num_points else 0
        if n == 0:
            return 0
        return min(next_capacity(n, 256), self.capacity)

    def _refresh_device_caches(self):
        self._cull_mask_dev = None  # the state changed: stale cull mask
        cap = self.capacity
        dev = self.device
        if not self.tree.num_points:
            self._tree_dev = None
            self._leaf_opt_dev = torch.zeros(cap, dtype=torch.bool, device=dev)
            return
        self._tree_dev = self.tree.device_arrays(cap, dev)
        if self.optimizer_cfg.get("opt_all_levels", True):
            leaf_opt = (self.tree.node_index == -1) & (self.tree.depth > 0)
        else:
            leaf_opt = self.tree.depth == self.current_depth
        pad = np.zeros((cap,), bool)
        pad[: leaf_opt.shape[0]] = leaf_opt
        self._leaf_opt_dev = torch.from_numpy(pad).to(dev)
        if self.cut_method in ("flat", "flat_slice"):
            self.tree.ensure_root_id()
            rid = np.zeros((cap,), np.int32)
            rid[: self.tree.root_id.shape[0]] = self.tree.root_id
            self._tree_dev["root_id"] = torch.from_numpy(rid).to(dev)
            # parent-attribute cache: parents are frozen between densifies,
            # so their projected radius needs no per-frame parent gathers
            parent = np.arange(cap, dtype=np.int64)
            ip = self.tree.index_parent
            nz = ip >= 0
            parent[: ip.shape[0]][nz] = ip[nz]
            parent_dev = torch.from_numpy(parent).to(dev)
            params = self.gaussian.params()
            for key in ("xyz", "scaling", "rotation"):
                self._tree_dev[f"parent_{key}"] = params[key][parent_dev]
            # per-point root-center cache (flat_slice cut)
            root_rows = torch.clamp(self._tree_dev["root_id"].to(torch.int64),
                                    0, cap - 1)
            self._tree_dev["root_xyz"] = params["xyz"][root_rows]
            if self._cull_seg_starts is not None:
                # static tail-segment starts of the root_major layout; rows
                # past the known roots start at num_points (dead rows)
                seg = np.full(cap, self.num_points, np.int32)
                seg[: self._cull_seg_starts.shape[0]] = self._cull_seg_starts
                self._tree_dev["cull_seg_starts"] = torch.from_numpy(seg).to(dev)
            if self._layout_optimized:
                S = block_size_for(cap)
                cols, meta = build_block_cache(params, self._tree_dev,
                                               self._leaf_opt_dev,
                                               self.num_points, S)
                self._block_cache = {"cols": cols, "meta": meta, "S": S}
                self._kb_bucket = None

    def _drop_row_caches(self):
        """Forget what was sized from or laid out for the old rows: the
        frame buckets, the cull mask and the optimized row layout with its
        block cache (a densify appends children at the end, a load brings
        its own rows)."""
        self._render_bucket = None
        self._pair_bucket = None
        self._kb_bucket = None
        self._frame = None
        self._cull_mask_dev = None
        self._cull_bucket = None
        self._layout_optimized = False
        self._cull_seg_starts = None
        self._block_cache = None

    def tree_device(self):
        if self._tree_dev is None and self.tree.num_points:
            self._refresh_device_caches()
        return self._tree_dev

    def _tree_args(self, stage_has_tree: bool):
        if stage_has_tree:
            return self._tree_dev, int(self.tree.depth.max()) + 1
        cap = self.capacity
        zeros = torch.zeros(cap, dtype=torch.int32, device=self.device)
        return {"node_index": zeros, "index_parent": zeros,
                "depth": zeros}, 1

    # -------------------------------------------------------- preparation
    def prepare_from_camera(self, camera: dict):
        """Visibility + LoD cut for one camera; stores bucketed keep flags."""
        from ..render.renderer import camera_device

        cam = camera_device(camera, self.device)
        stage_has_tree = self.tree.num_nodes > 0
        if stage_has_tree and self._tree_dev is None:
            self._refresh_device_caches()
        tree_arrays, num_levels = self._tree_args(stage_has_tree)
        leaf_opt = (self._leaf_opt_dev if stage_has_tree else
                    torch.zeros(self.capacity, dtype=torch.bool,
                                device=self.device))
        keep_leaf, keep_node, counts = prepare_visibility(
            self.gaussian.params(), tree_arrays, cam, self.num_points,
            leaf_opt, float(self.tree.min_resolution_pixel),
            self.current_depth, cam["image_height"], cam["image_width"],
            stage_has_tree, num_levels,
            backend=pick_backend(self.capacity, device=self.device),
            max_pairs=pick_max_pairs(self.capacity),
            check_scale=int(self.check_render_scale),
            cut_method=self.cut_method_train if stage_has_tree else "traverse",
            n_roots=self.n_roots_bucket if stage_has_tree else 0,
        )
        c = counts.cpu().numpy()
        self.visibility_flag = {
            "keep_leaf": keep_leaf,
            "keep_node": keep_node,
            "keep_mask": keep_leaf | keep_node,
            "counts": (int(c[0]), int(c[1])),
            "k_leaf": next_capacity(int(c[0]), 256),
            "k_node": 0 if int(c[1]) == 0 else next_capacity(int(c[1]), 256),
        }
        return self.visibility_flag

    # ----------------------------------------------------- training setup
    def training_setup(self):
        if self.optimizer is not None:
            print(f"[{self.__class__.__name__}] optimizer is already setup")
            self.counter.reset(self.num_points, self.capacity)
            return 0
        cfg = dict(self.optimizer_cfg)
        lr_dict = dict(cfg["lr_dict"])
        lr_dict["max_steps"] = int(lr_dict["max_steps"]) * self.base_iter
        self.optimizer = SparseOptimizer(cfg["optimize_keys"], lr_dict,
                                         self.gaussian,
                                         xyz_scale=self.gaussian.xyz_scale)
        print(f"[{self.__class__.__name__}] optimizer setup: max steps = "
              f"{lr_dict['max_steps']}")
        self.lr = lr_dict["xyz"]
        self.counter.reset(self.num_points, self.capacity)
        if self.view_correction is not None:
            self.view_correction.training_setup()

    # ------------------------------------------------------- training step
    def _step_config(self, cam: dict, k_leaf: int, k_node: int, mask_ignore,
                     render_depth: bool, fg_mask) -> StepConfig:
        k_total = k_leaf + k_node
        return StepConfig(
            image_height=cam["image_height"], image_width=cam["image_width"],
            k_leaf=k_leaf, k_node=k_node,
            sh_degree=self.gaussian.active_sh_degree, mode="antialias",
            # the per-view gain is applied and stepped only from base_iter
            # on; before that it is 1.0
            use_correction=(
                self.view_correction is not None
                and self.view_correction.values.shape[0] > 0
                and self.optimizer.global_steps >= self.base_iter
            ),
            has_mask=mask_ignore is not None,
            opt_keys=tuple(self.gaussian.keys),
            backend=pick_backend(k_total, device=self.device),
            max_pairs=pick_max_pairs(k_total),
            render_depth=render_depth, crop_loss=fg_mask is not None,
            spilled=self.optimizer.spilled,
        )

    def _step_inputs(self, cam: dict, cfg: StepConfig, gt_image, background,
                     mask_ignore, fg_mask, gt_depth) -> dict:
        """Device inputs of one step; advances the optimizer's step count
        and the LR schedule. With cfg.render_depth the depth map goes to the
        device and the patch corners are the JAX step's: jax.random's draws
        from PRNGKey(global step), made on the device."""
        dev = self.device
        self.optimizer.global_steps += 1
        step = self.optimizer.global_steps
        depth = patches = None
        if cfg.render_depth:
            depth = torch.as_tensor(np.asarray(gt_depth, np.float32),
                                    device=dev)
            patches = draw_patch_offsets(*depth.shape,
                                         jax_random.prng_key(step), dev)
        host_lrs = _host_lrs(self.optimizer, step)
        self.lr = host_lrs.get("xyz", 0.0)
        if cfg.use_correction:
            corr_state = self._corr_device_state()
        else:
            corr_state = {
                "values": torch.ones((1, 3), device=dev),
                "m1": torch.zeros((1, 3), device=dev),
                "m2": torch.zeros((1, 3), device=dev),
                "vmax": torch.zeros((1, 3), device=dev),
                "steps": torch.zeros((1,), dtype=torch.int32, device=dev),
            }
        fg_dev = bbox = None
        if fg_mask is not None:
            fg_dev, bbox = _fg_mask_bbox(fg_mask, cam["image_height"],
                                         cam["image_width"], dev)
        with span("sync.step_background"):
            bg = torch.as_tensor(np.asarray(background, np.float32),
                                 device=dev)
        return dict(
            gt=torch.as_tensor(gt_image, device=dev), background=bg,
            lrs=host_lrs, global_step=float(step), corr_state=corr_state,
            mask_ignore=(torch.as_tensor(mask_ignore, device=dev)[None]
                         if mask_ignore is not None
                         else torch.ones((1, 1, 1), device=dev)),
            gt_depth=depth, depth_patches=patches, fg_mask=fg_dev, bbox=bbox,
        )

    def _apply_step(self, cfg: StepConfig, params, moments, counter,
                    corr_state):
        for key, val in params.items():
            self.gaussian.set(key, val)
        self.optimizer.moments = moments
        self.counter.data = counter
        if cfg.use_correction:
            self._corr_dev = corr_state

    def train_step(self, camera: dict, gt_image, background, mask_ignore=None,
                   view_index: int = 0, gt_depth=None, render_depth=False,
                   fg_mask=None):
        """One optimization step on the cut of the last prepare_from_camera.
        Returns (metrics, aux) of device tensors."""
        from ..render.renderer import camera_device

        if self.visibility_flag is None or "k_leaf" not in self.visibility_flag:
            raise RuntimeError("call prepare_from_camera first")
        if self.optimizer is None:
            raise RuntimeError("call training_setup first")
        vf = self.visibility_flag
        cam = camera_device(camera, self.device)
        cfg = self._step_config(cam, vf["k_leaf"], vf["k_node"], mask_ignore,
                                render_depth and gt_depth is not None,
                                fg_mask)
        m_slices = None
        if cfg.spilled:
            # the rows of the step's slice, in its compaction's order, read
            # from the host moments before the step
            host_index = _host_compact_index(
                vf["keep_leaf"].cpu().numpy(), cfg.k_leaf, self.capacity)
            if cfg.k_node > 0:
                host_index = np.concatenate([host_index, _host_compact_index(
                    vf["keep_node"].cpu().numpy(), cfg.k_node,
                    self.capacity)])
            m_slices = self.optimizer.host_gather(host_index)
        inputs = self._step_inputs(cam, cfg, gt_image, background,
                                   mask_ignore, fg_mask, gt_depth)
        params, moments, counter, corr_state, metrics, aux = fused_train_step(
            self.gaussian.params(), self.optimizer.moments, self.counter.data,
            vf["keep_leaf"], vf["keep_node"], cam, view_index=view_index,
            cfg=cfg, m_slices=m_slices, **inputs,
        )
        self._apply_step(cfg, params, moments, counter, corr_state)
        if cfg.spilled:
            self.optimizer.host_scatter(host_index, aux.pop("m_slices"),
                                        aux.pop("update_mask"))
        return metrics, aux

    def training_iteration(self, camera: dict, gt_image, background,
                           mask_ignore=None, view_index: int = 0,
                           gt_depth=None, render_depth: bool = False,
                           fg_mask=None):
        """One training step with the visibility pass in front of it.

        The slice bucket lags one step behind the visible counts (temporal
        coherence of consecutive training cameras): it grows when the last
        step's count outgrew it and shrinks when that count fell below half.
        The first step of a stage seeds it with a standalone prepare.
        """
        from ..render.renderer import camera_device

        with span("training_iteration"):
            if self.optimizer is not None and self.optimizer.spilled:
                # spilled moments: the host needs the step's rows before
                # the step, so the visibility pass runs on its own first
                self.prepare_from_camera(camera)
                return self.train_step(
                    camera, gt_image, background, mask_ignore=mask_ignore,
                    view_index=view_index, gt_depth=gt_depth,
                    render_depth=render_depth, fg_mask=fg_mask,
                )
            if self._bucket is None:
                vf = self.prepare_from_camera(camera)
                self._bucket = (vf["k_leaf"], vf["k_node"])
                return self.train_step(
                    camera, gt_image, background, mask_ignore=mask_ignore,
                    view_index=view_index, gt_depth=gt_depth,
                    render_depth=render_depth, fg_mask=fg_mask,
                )
            with span("training_iteration.inputs"):
                if self._counts_dev is not None:
                    with span("sync.training_iteration_buckets"):
                        c = self._counts_dev.cpu().numpy()
                    k_leaf = next_capacity(int(c[0]), 256)
                    k_node = (0 if int(c[1]) == 0
                              else next_capacity(int(c[1]), 256))
                    bl, bn = self._bucket
                    if k_leaf > bl or k_leaf * 2 < bl:
                        bl = k_leaf
                    if k_node > bn or k_node * 2 < bn:
                        bn = k_node
                    self._bucket = (bl, bn)
                if self.optimizer is None:
                    raise RuntimeError("call training_setup first")
                cam = camera_device(camera, self.device)
                stage_has_tree = self.tree.num_nodes > 0
                if stage_has_tree and self._tree_dev is None:
                    self._refresh_device_caches()
                tree_arrays, num_levels = self._tree_args(stage_has_tree)
                leaf_opt = (self._leaf_opt_dev if stage_has_tree else
                            torch.zeros(self.capacity, dtype=torch.bool,
                                        device=self.device))
                k_leaf, k_node = self._bucket
                cfg = self._step_config(cam, k_leaf, k_node, mask_ignore,
                                        render_depth and gt_depth is not None,
                                        fg_mask)
                inputs = self._step_inputs(cam, cfg, gt_image, background,
                                           mask_ignore, fg_mask, gt_depth)
            params, moments, counter, corr_state, metrics, aux = (
                fused_prepare_train_step(
                    self.gaussian.params(), self.optimizer.moments,
                    self.counter.data, tree_arrays, self.num_points,
                    leaf_opt, float(self.tree.min_resolution_pixel),
                    self.current_depth, cam, view_index=view_index,
                    stage_has_tree=stage_has_tree, num_levels=num_levels,
                    prep_backend=pick_backend(self.capacity,
                                              device=self.device),
                    prep_max_pairs=pick_max_pairs(self.capacity),
                    check_scale=int(self.check_render_scale), cfg=cfg,
                    cut_method=(self.cut_method_train if stage_has_tree
                                else "traverse"),
                    n_roots=self.n_roots_bucket if stage_has_tree else 0,
                    **inputs,
                )
            )
            with span("training_iteration.apply"):
                self._apply_step(cfg, params, moments, counter, corr_state)
                self._counts_dev = metrics["counts"]
                self.visibility_flag = {"keep_mask": aux["keep_mask"]}
            return metrics, aux

    def _corr_device_state(self) -> dict:
        """The per-view gain Adam state on the device (built from the host
        Corrector on first use)."""
        if self._corr_dev is None:
            c = self.view_correction
            if not c._setup:
                c.training_setup()
            dev = self.device

            def t(a, dtype=torch.float32):
                return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

            self._corr_dev = {
                "values": t(c.values), "m1": t(c.exp_avg),
                "m2": t(c.exp_avg_sq), "vmax": t(c.max_exp_avg_sq),
                "steps": t(c.steps, torch.int32),
            }
        return self._corr_dev

    def _sync_corrector_to_host(self):
        if self._corr_dev is not None:
            c = self.view_correction
            d = {k: v.cpu().numpy() for k, v in self._corr_dev.items()}
            c.values, c.exp_avg, c.exp_avg_sq = d["values"], d["m1"], d["m2"]
            c.max_exp_avg_sq = d["vmax"]
            c.steps = d["steps"].astype(np.int64)

    @torch.no_grad()
    def render_fused(self, camera: dict, background):
        """Inference frame: cut + compaction + render. Returns a dict of
        device tensors: 'render' (3,H,W), 'alpha' (H,W), 'counts' and
        'pair_total' (the frame's unclamped pair demand, -1 on the
        reference backend). counts: the kept leaf/node counts, then -1 (the
        generic frame) or the pair demand (flat_slice), then the eligible
        blocks (the block-pruned frame).

        The slice budget comes from the first frame's prepare pass, then
        from the previous frame's counts (1.2x headroom, re-bucketed when
        the need grows or halves), as in the JAX package; so do the pair
        budget (from counts[2]) and the block budget (counts[3]).
        With cut_method 'flat_slice' the weight cull runs on the capacity
        axis (`fused_root_cull`) every check_render_every frames; after
        optimize_render_layout, with SH degree 0, the frame is the
        block-pruned one (model/block_render.py).
        """
        from ..render.renderer import camera_device

        with span("render_fused"):
            with span("render_fused.inputs"):
                cam = camera_device(camera, self.device)
                stage_has_tree = self.tree.num_nodes > 0
                if self._tree_dev is None or (
                    stage_has_tree
                    and self.cut_method in ("flat", "flat_slice")
                    and "parent_xyz" not in self._tree_dev
                ):
                    self._refresh_device_caches()
                self._update_frame_buckets(camera)
                # static alive bucket: the capacity-axis passes run over
                # [:cap_sort]
                cap_sort = min(self.capacity,
                               -(-self.num_points // (1 << 18)) * (1 << 18))
                k_vis = min(self._render_bucket, self.capacity, cap_sort)
                backend = pick_backend(self.capacity, device=self.device)
                tree_arrays, num_levels = self._tree_args(stage_has_tree)
                max_pairs = pick_max_pairs(k_vis, per_point=6)
                frame_pairs = min(max_pairs, self._pair_bucket or max_pairs)
                with span("sync.render_fused_background"):
                    bg = torch.as_tensor(np.asarray(background, np.float32),
                                         device=self.device)
                flat_slice = (stage_has_tree
                              and self.cut_method == "flat_slice")
                # the block-pruned frame needs the optimized layout, SH
                # degree 0 and a capacity past 2^16; otherwise the fused
                # flat_slice frame
                use_blocks = (self._layout_optimized
                              and self._block_cache is not None
                              and flat_slice
                              and self.gaussian.active_sh_degree == 0
                              and backend == "tiled"
                              and self.capacity >= 1 << 16)
            w_full = None
            if flat_slice:
                # cull first, as the reference orders it: the capacity-axis
                # mask is refreshed every check_render_every frames (every
                # frame by default), at full capacity for the block path
                cull_bucket = 0 if use_blocks else cap_sort
                if (self._cull_mask_dev is None
                        or self._cull_bucket != cull_bucket
                        or self._cull_frame_i % self.check_render_every == 0):
                    with span("render_fused.cull"):
                        self._cull_mask_dev = fused_root_cull(
                            self.gaussian.params(), tree_arrays, cam,
                            self.num_points, cam["image_height"],
                            cam["image_width"], prep_backend=backend,
                            prep_max_pairs=pick_max_pairs(self.capacity,
                                                          per_point=1),
                            check_scale=int(self.check_render_scale),
                            n_roots=self.n_roots_bucket,
                            cap_sort=cull_bucket,
                        )
                    self._cull_bucket = cull_bucket
                self._cull_frame_i += 1
                w_full = self._cull_mask_dev
            with span("render_fused.frame"):
                if use_blocks:
                    B = self.capacity // self._block_cache["S"]
                    render, alpha, counts = render_blocks(
                        self._block_cache["cols"], self._block_cache["meta"],
                        cam, float(self.tree.min_resolution_pixel),
                        self.current_depth, bg, cam["image_height"],
                        cam["image_width"], k_blocks=self._kb_bucket or B,
                        k_visible=k_vis, max_pairs=frame_pairs,
                        w_full=w_full,
                    )
                    pair_total = counts[2]
                else:
                    render, alpha, counts, pair_total = fused_prepare_render(
                        self.gaussian.params(), tree_arrays, cam,
                        self.num_points, self._leaf_opt_dev,
                        float(self.tree.min_resolution_pixel),
                        self.current_depth, bg, cam["image_height"],
                        cam["image_width"], k_visible=k_vis,
                        sh_degree=self.gaussian.active_sh_degree,
                        stage_has_tree=stage_has_tree, num_levels=num_levels,
                        backend=backend, max_pairs=frame_pairs,
                        check_scale=int(self.check_render_scale),
                        cut_method=(self.cut_method if stage_has_tree
                                    else "traverse"),
                        n_roots=self.n_roots_bucket if stage_has_tree else 0,
                        prep_backend=backend,
                        prep_max_pairs=pick_max_pairs(self.capacity,
                                                      per_point=1),
                        cap_sort=cap_sort, w_full=w_full,
                    )
            self._frame = {"counts": counts, "pair_total": pair_total,
                           "k_visible": k_vis, "max_pairs": frame_pairs}
            return {"render": render, "alpha": alpha, "counts": counts,
                    "pair_total": pair_total}

    def _update_frame_buckets(self, camera: dict):
        """The slice, pair and block budgets of the next frame: from the
        first frame's prepare pass, then from the last frame's counts."""
        if self._render_bucket is None:
            vf = self.prepare_from_camera(camera)
            self._render_bucket = next_capacity(
                int(sum(vf["counts"]) * 1.2), 1 << 14
            )
            return
        if self._frame is None:
            return
        with span("sync.render_fused_buckets"):
            c = self._frame["counts"].cpu().numpy()
        need = next_capacity(int(c[:2].sum() * 1.2), 1 << 14)
        b = self._render_bucket
        if need > b or need * 2 < b:
            self._render_bucket = need
        # counts[2] is the last frame's unclamped pair demand where the
        # frame reports it (1.3x headroom, shrink only below half)
        if len(c) > 2 and c[2] > 0:
            pneed = pick_max_pairs(int(c[2] * 1.3), per_point=1)
            pb = self._pair_bucket
            if pb is None or pneed > pb or pneed * 2 < pb:
                self._pair_bucket = pneed
        # the block path's bucket: counts[3], last frame's eligible
        # blocks (1.1x headroom, in steps of 16)
        if len(c) > 3 and self._block_cache is not None:
            B = self.capacity // self._block_cache["S"]
            kb = self._kb_bucket or B
            need = min(B, max(16, -(-int(c[3] * 1.1) // 16) * 16))
            if need > kb or need * 2 < kb:
                self._kb_bucket = need

    def frame_stats(self) -> dict:
        """Telemetry of the last render_fused frame (host values): the
        kept cut (leaf + node points), the slice bucket, the pair budget,
        the unclamped pair demand and, from the block-pruned frame, the
        eligible blocks (None otherwise)."""
        f = self._frame
        with span("sync.frame_stats"):
            c = f["counts"].cpu().tolist()
        with span("sync.frame_stats"):
            pair_total = int(f["pair_total"])
        return {"cut": c[0] + c[1], "k_visible": f["k_visible"],
                "max_pairs": f["max_pairs"], "pair_total": pair_total,
                "eligible_blocks": c[3] if len(c) > 3 else None}

    # ---------------------------------------------------------- init pass
    def at_init_start(self):
        self.num_views = 0

    @torch.no_grad()
    def init_view(self, camera: dict):
        """Lower each point's radius3d_min to the 3D size that projects to
        MIN_PIXEL pixels in this view (points the view sees only)."""
        from ..render.renderer import camera_device

        cam = camera_device(camera, self.device)
        params = self.gaussian.params()
        valid, r3d = _init_radius3d(params["xyz"], params["scaling"],
                                    params["rotation"], cam, self.num_points)
        old = self.counter.data["radius3d_min"]
        self.counter.data["radius3d_min"] = torch.where(
            valid, torch.minimum(old, r3d), old)
        self.num_views += 1

    def at_init_final(self):
        """Lift every scale to at least radius3d_min, set radius3d_max to
        0.2 x xyz_scale and size the per-view gain for the views seen."""
        n = self.num_points
        r3min = self.counter.data["radius3d_min"][:n].cpu().numpy()
        print(f"[{self.__class__.__name__}] minimum "
              f"{self.gaussian.log_radius(r3min)}")
        arrays = self.gaussian.to_numpy()
        floor = np.log(np.maximum(r3min, 1e-12))[:, None].repeat(3, axis=1)
        arrays["scaling"] = np.maximum(arrays["scaling"], floor).astype(
            np.float32)
        self.gaussian.set_numpy(arrays)
        self.counter.data["radius3d_max"] = torch.full(
            (self.capacity,), float(np.float32(self.gaussian.xyz_scale * 0.2)),
            dtype=torch.float32, device=self.device)
        self._refresh_device_caches()
        if self.view_correction is not None:
            self.view_correction.init(self.num_views)

    # ------------------------------------------------ densify: host path
    def clamp_scale_host(self, arrays, counter_np):
        smin = np.log(np.maximum(counter_np["radius3d_min"], 1e-12))[:, None]
        smax = np.log(np.maximum(counter_np["radius3d_max"], 1e-12))[:, None]
        arrays["scaling"] = np.clip(arrays["scaling"], smin, smax).astype(
            np.float32)
        return arrays

    def _pull_host(self):
        """Exact-size host copies of the params, counters and moments (the
        densify policies write into them)."""
        n = self.num_points
        arrays = {k: np.array(v) for k, v in self.gaussian.to_numpy().items()}
        counter_np = {k: np.array(v)
                      for k, v in self.counter.to_numpy(n).items()}
        moments_np = self.optimizer.to_numpy(n) if self.optimizer else None
        return arrays, counter_np, moments_np

    def _push_host(self, arrays, counter_np, moments_np):
        self.gaussian.set_numpy(arrays)
        cap = self.capacity
        self.counter.set_numpy(counter_np, cap)
        if moments_np is not None and self.optimizer is not None:
            self.optimizer.moments = {"exp_avg": {}, "exp_avg_sq": {}}
            self.optimizer.set_numpy(moments_np, cap)
        self._rows_changed()

    def _rows_changed(self):
        """After a densify: the step bucket, the row caches and the device
        tree arrays and parent cache are rebuilt from the new rows."""
        self._bucket = None
        self._counts_dev = None
        self._drop_row_caches()
        self._refresh_device_caches()

    # ---------------------------------------------- densify: device path
    def _use_device_densify(self) -> bool:
        """densify_and_remove.device_densify: on, off or auto (the device
        path from a capacity of 2^19 rows). Spilled moments live in host
        memory, where only the host path updates them."""
        if self.optimizer is not None and self.optimizer.spilled:
            return False
        mode = self.densify_and_remove.get("device_densify", "auto")
        if mode in (True, "on", "true", 1):
            return True
        if mode in (False, "off", "false", 0):
            return False
        return self.capacity >= (1 << 19)

    def _densify_buckets(self, n_keep, n_split, n_child):
        new_n = int(n_keep) + int(n_split) * n_child
        return new_n, next_capacity(new_n), next_capacity(int(n_split), 256)

    def _n_child(self) -> int:
        """Children per split parent on the device path: the bisections'
        2^k >= N."""
        n_child = 1
        while n_child < self.splitter.N:
            n_child *= 2
        return n_child

    def _moments_or_empty(self):
        if self.optimizer is None:
            return {"exp_avg": {}, "exp_avg_sq": {}}
        return self.optimizer.moments

    def _apply_device_rebuild(self, params, moments, counter, new_n, new_cap):
        self.gaussian.set_device(params, new_n, new_cap)
        if self.optimizer is not None:
            self.optimizer.moments = moments
        self.counter.data = counter
        self._rows_changed()

    @torch.no_grad()
    def _update_init_stage_device(self, scale=1, rand_u=None):
        d = self.densify_and_remove
        cap = self.capacity
        n = self.num_points
        if rand_u is None:
            key = jax_random.prng_key(self._rng.integers(1 << 31))
            u = jax_random.uniform(key, (2, cap), device=self.device)
        else:
            u = torch.zeros((2, cap), device=self.device)
            u[:, : rand_u.shape[1]] = torch.as_tensor(
                np.asarray(rand_u, np.float32), device=self.device)
        flag_split, flag_remove, reset_create, stats = dd.init_stage_flags(
            self.gaussian.params(), self.counter.data, n, u, scale,
            self.gaussian.xyz_scale, d["init_weight_min"],
            d["init_radius_min"], d.get("init_radius_split", -1),
            d["min_steps"], d["split_grad_thres"],
            mode=d.get("init_split_method", "split_by_2d"),
        )
        n_split = int(stats["n_split"])
        n_remove = int(stats["n_remove"])
        print(f"[LoG] device densify (init): split {n_split} remove "
              f"{n_remove} of {n}")
        n_keep = n - n_remove - n_split  # a split parent is replaced
        new_n, new_cap, s_cap = self._densify_buckets(n_keep, n_split,
                                                      self._n_child())
        counter_in = dict(self.counter.data)
        counter_in["create_steps"] = torch.where(
            reset_create, 0, counter_in["create_steps"])
        params, moments, counter, _, _ = dd.rebuild_split_remove(
            self.gaussian.params(), self._moments_or_empty(), counter_in,
            flag_split, flag_remove, n, new_cap=new_cap, s_cap=s_cap,
            n_child=self.splitter.N, remove_split=True,
            keys=tuple(self.gaussian.keys),
            scaling_decay=d.get("scaling_decay", 0.9),
            radius3d_max_fill=float(0.2 * self.gaussian.xyz_scale),
        )
        # the scale clamp into [radius3d_min, radius3d_max]
        # (clamp_scale_host)
        smin = torch.log(torch.clamp(counter["radius3d_min"], min=1e-12))
        smax = torch.log(torch.clamp(counter["radius3d_max"], min=1e-12))
        params["scaling"] = torch.clamp(params["scaling"], min=smin[:, None],
                                        max=smax[:, None])
        self._apply_device_rebuild(params, moments, counter, new_n, new_cap)
        print(f"[LoG] device densify (init): {n} -> {new_n} points")

    @torch.no_grad()
    def _update_depth_stage_device(self, global_iteration):
        d = self.densify_and_remove
        n = self.num_points
        if self._tree_dev is None:
            self._refresh_device_caches()
        flag_split_d, flag_remove_d, stats = dd.depth_stage_flags(
            self.gaussian.params(), self.counter.data, self._tree_dev, n,
            self.current_depth, d["min_steps_split"], d["split_grad_thres"],
            d["radius2d_thres"], d["remove_weights_thres"],
            d["max_split_points"], sort_method=d.get("sort_method", "radii"),
        )
        print(f"[LoG] {global_iteration:06d} device densify (depth): split "
              f"{int(stats['n_split'])} remove {int(stats['n_remove'])}")
        # the tree's structure stays on the host: fetch the policy flags,
        # apply the tree's guards, upload the effective flags
        flag_split, flag_remove = self.tree.split_and_remove(
            flag_split_d[:n].cpu().numpy(), flag_remove_d[:n].cpu().numpy())
        n_split = int(flag_split.sum())
        new_n, new_cap, s_cap = self._densify_buckets(
            n - int(flag_remove.sum()), n_split, self._n_child())

        def pad_flags(f):
            out = torch.zeros(self.capacity, dtype=torch.bool,
                              device=self.device)
            out[:n] = torch.from_numpy(f).to(self.device)
            return out

        params, moments, counter, _, _ = dd.rebuild_split_remove(
            self.gaussian.params(), self._moments_or_empty(),
            dict(self.counter.data), pad_flags(flag_split),
            pad_flags(flag_remove), n, new_cap=new_cap, s_cap=s_cap,
            n_child=self.splitter.N, remove_split=False,
            keys=tuple(self.gaussian.keys),
            scaling_decay=d.get("scaling_decay", 0.9),
            radius3d_max_fill=-1.0,
        )
        self._apply_device_rebuild(params, moments, counter, new_n, new_cap)
        self._print_depths()

    def _print_depths(self):
        for depth in range(self.current_depth + 1):
            n_at = int((self.tree.depth == depth).sum())
            if n_at:
                print(f"[LoG] depth = {depth:2d} | {n_at:10d} points")

    # ------------------------------------------------------ stage updates
    def update_init_stage(self, scale=1, rand_u=None):
        """Init-stage densify: remove by weight and size, split by 2D
        radius or gradient (split_by_2d) or by 3D size (split_by_3d).

        rand_u: optional (2, n) uniforms for the two random keep draws (the
        tests inject them to hold the host and device paths, and the two
        packages, against each other)."""
        d = self.densify_and_remove
        if self._use_device_densify():
            return self._update_init_stage_device(scale=scale, rand_u=rand_u)
        arrays, cnt, moments = self._pull_host()
        if rand_u is None:
            rand_u = self._rng.random((2, arrays["xyz"].shape[0]))
        weights_max = cnt["weights_max"]
        opacity = _sigmoid(arrays["opacity"][:, 0])
        flag_remove_weight = weights_max < d["init_weight_min"]
        flag_nonmax = weights_max < opacity * 0.1
        radii_max_max = cnt["radii_max_max"]
        flag_remove_small = radii_max_max < (d["init_radius_min"] * scale) ** 2
        print(f"[LoG] {int(flag_remove_weight.sum()):10d} points with weight "
              f"< {d['init_weight_min']:.2f}")
        print(f"[LoG] {int(flag_nonmax.sum()):10d} points with weight is non "
              f"max")
        print(f"[LoG] {int(flag_remove_small.sum()):10d} points with radius < "
              f"{d['init_radius_min']:.2f}")
        flag_remove_small = flag_remove_small & (rand_u[0] > 0.5)
        flag_remove = flag_remove_small | flag_remove_weight | flag_nonmax
        # the host path reckons the radii and the gradient in float64
        radii_max = radii_max_max.astype(np.float64)
        flag_activation = (cnt["create_steps"] > d["min_steps"]) & (radii_max > 0)
        grad = cnt["grad_sum"] / np.maximum(cnt["area_sum"], 1)
        print(f"[LoG] {str_min_mean_max('grad', grad)}")
        act_r = radii_max[flag_activation]
        radii_mean = act_r.mean() if act_r.size else 0.0
        radii_std = act_r.std() if act_r.size else 0.0
        mode = d.get("init_split_method", "split_by_2d")
        split_thres = d.get("init_radius_split", -1) * scale
        if mode == "split_by_2d":
            if split_thres < 0:
                split_thres = radii_mean + radii_std * 3
            flag_split_grad = (grad > 10 * d["split_grad_thres"]) & (
                radii_max > d["init_radius_min"] * scale * 8)
            flag_split_radii = radii_max > split_thres ** 2
            print(f"[LoG] split by grad : {int(flag_split_grad.sum()):8d}")
            print(f"[LoG] split by radii: {int(flag_split_radii.sum()):8d}")
            flag_split = flag_split_radii | flag_split_grad
            flag_split = flag_activation & flag_split & (~flag_remove)
        elif mode == "split_by_3d":
            radius_max3 = np.exp(arrays["scaling"]).max(axis=-1)
            flag_split = radius_max3 > self.gaussian.xyz_scale * 0.1
            flag_remove2d = flag_activation & (
                radius_max3 < self.gaussian.xyz_scale * 0.005)
            flag_rand = rand_u[1] > 0.5
            flag_remove = (flag_remove2d & flag_rand) | flag_remove
            cnt["create_steps"][flag_remove2d & (~flag_rand)] = 0
            flag_split = flag_split & (~flag_remove)
        else:
            raise ValueError(mode)
        # never prune the model to (near) nothing: keep the top-weight points
        min_keep = 16
        if (~flag_remove).sum() < min_keep:
            order = np.argsort(-weights_max)
            flag_remove[order[:min_keep]] = False
        new_arrays, _, _ = self.splitter.split_and_remove(
            arrays, self.gaussian.activation, flag_split, flag_remove,
            rng=self._rng)
        new_moments = (self.splitter.split_and_remove_moments(
            moments, flag_split, flag_remove) if moments else None)
        new_cnt = self.splitter.split_and_remove_other(
            cnt, ["create_steps", "radius3d_min", "radius3d_max"],
            flag_split, flag_remove)
        n_new = new_arrays["xyz"].shape[0]
        fresh = init_counter(n_new)
        for key in RESET_KEYS:
            new_cnt[key] = fresh[key]
        new_cnt["radius3d_max"] = np.full(
            (n_new,), 0.2 * self.gaussian.xyz_scale, np.float32)
        new_arrays = self.clamp_scale_host(new_arrays, new_cnt)
        self._push_host(new_arrays, new_cnt, new_moments)
        print(f"[LoG] {str_min_mean_max('radius3d_min', new_cnt['radius3d_min'])}")

    def update_depth_stage(self, global_iteration):
        """Tree densify: split leaf parents above both the gradient and the
        radius thresholds (the top max_split_points by sort_method), remove
        low-weight children."""
        if self._use_device_densify():
            return self._update_depth_stage_device(global_iteration)
        d = self.densify_and_remove
        log_prefix = f"[LoG] {global_iteration:06d}"
        arrays, cnt, moments = self._pull_host()
        radius_max = np.exp(arrays["scaling"]).max(axis=-1)
        node_index = self.tree.node_index
        depth = self.tree.depth
        flag_is_parent = (node_index == -1) & (depth < self.current_depth)
        flag_depth_parent = flag_is_parent & (
            cnt["create_steps"] > d["min_steps_split"])
        depth_minus1_sum = int((depth < self.current_depth).sum())
        flag_depth_child = (node_index == -1) & (depth > 0)
        # the host path reckons the gradient and the radii in float64
        grad = cnt["grad_sum"] / np.maximum(cnt["area_sum"], 1)
        radii_max_max = cnt["radii_max_max"].astype(np.float64)
        print(f"{log_prefix} {str_min_mean_max('grad', grad[flag_is_parent])}")
        print(f"{log_prefix} "
              f"{str_min_mean_max('radii', radii_max_max[flag_is_parent])}")
        flag_split_grad = grad > d["split_grad_thres"]
        flag_split_radii = cnt["radii_max_max"] > d["radius2d_thres"]
        print(f"{log_prefix} split by grad: {int(flag_split_grad.sum()):8d} "
              f"split by radii: {int(flag_split_radii.sum()):8d}")
        flag_split = flag_split_grad & flag_split_radii & flag_depth_parent
        if flag_depth_child.sum() == 0:
            flag_remove = np.zeros_like(flag_split)
        else:
            flag_remove = (flag_depth_child
                           & (cnt["weights_max"] < d["remove_weights_thres"])
                           & (cnt["visible_count"] > 1))
        flag_split = flag_split & (~flag_remove)
        num_max_split = min(int(depth_minus1_sum * 0.05), d["max_split_points"])
        sort_method = d.get("sort_method", "radii")
        if flag_split.sum() > num_max_split and num_max_split > 0:
            if sort_method == "radii":
                vals = radii_max_max
            elif sort_method == "opacity":
                vals = _sigmoid(arrays["opacity"][:, 0]).astype(np.float64)
            else:
                vals = grad
            cand = vals[flag_split]
            thres = np.partition(cand, -num_max_split)[-num_max_split]
            print(f"{log_prefix} select top {num_max_split} points to split. "
                  f"New {sort_method} thres = {thres:.3f}")
            flag_split = flag_split & (vals >= thres)
        flag_split, flag_remove = self.tree.split_and_remove(flag_split,
                                                             flag_remove)
        new_arrays, _, _ = self.splitter.split_and_remove(
            arrays, self.gaussian.activation, flag_split, flag_remove,
            remove_split=False, rng=self._rng)
        new_moments = (self.splitter.split_and_remove_moments(
            moments, flag_split, flag_remove, remove_split=False)
            if moments else None)
        new_cnt = self.splitter.split_and_remove_other(
            cnt, ["create_steps", "radius3d_min", "radius3d_max"],
            flag_split, flag_remove, remove_split=False)
        fresh = init_counter(new_arrays["xyz"].shape[0])
        for key in RESET_KEYS:
            new_cnt[key] = fresh[key]
        num_split = int(flag_split.sum()) * self.splitter.N
        if num_split > 0:
            scaling_decay = d.get("scaling_decay", 0.9)
            new_cnt["radius3d_max"][-num_split:] = np.repeat(
                scaling_decay * radius_max[flag_split], self.splitter.N)
        self._push_host(new_arrays, new_cnt, new_moments)
        self._print_depths()

    # ----------------------------------------------------------- schedule
    def upgrade_tree(self):
        if self.current_depth == 0:
            self.tree.initialize(self.num_points)
        self.current_depth = 20
        print(f"[{self.__class__.__name__}] current depth: {self.current_depth}")
        self.counter.reset(self.num_points, self.capacity)
        self._refresh_device_caches()

    def densify_due(self, iteration) -> bool:
        """True when update_by_iteration changes the model's device state
        at this iteration (a counter reset, a densify or a tree upgrade);
        the SH upgrade only bumps a host scalar."""
        d = self.densify_and_remove
        densify_from_iter = d["densify_from_iter"] * self.base_iter
        densify_every_iter = d["densify_every_iter"] * self.base_iter
        if (iteration + 1) == densify_from_iter:
            return True
        return ((iteration + 1) > densify_from_iter
                and (iteration + 1) % densify_every_iter == 0)

    def update_by_iteration(self, iteration, global_iteration):
        mutated = self._update_by_iteration(iteration, global_iteration)
        if mutated and self.optimizer is not None:
            # host-spilled moments past the memory threshold
            self.optimizer.maybe_spill(self.num_points)
        return mutated

    def _update_by_iteration(self, iteration, global_iteration):
        """The densify, SH and tree schedule of one stage iteration: a
        counter reset at densify_from_iter, then every densify_every_iter
        a tree upgrade (outside the init stage, every upgrade_repeat x
        (depth + 1) densify periods), an init-stage densify while the tree
        is flat, and on the tree a depth densify every second period and a
        counter reset between."""
        d = self.densify_and_remove
        base_iter = self.base_iter
        upgrade_sh_iter = d["upgrade_sh_iter"] * base_iter
        if global_iteration > 0 and (global_iteration + 1) % upgrade_sh_iter == 0:
            self.gaussian.oneupSHdegree()
        densify_from_iter = d["densify_from_iter"] * base_iter
        densify_every_iter = d["densify_every_iter"] * base_iter
        sum_iter = self.current_depth + 1
        upgrade_tree_iter = densify_every_iter * sum_iter * d["upgrade_repeat"]
        if (iteration + 1) == densify_from_iter:
            self.counter.reset(self.num_points, self.capacity)
            return False
        if (iteration + 1 > densify_from_iter
                and (iteration + 1) % densify_every_iter == 0):
            if ((iteration + 1) % upgrade_tree_iter == 0
                    and self.stage_name != "init"):
                self.upgrade_tree()
                return True
            if self.current_depth == 0:
                if self.stage_name == "init":
                    self.update_init_stage()
                else:
                    self.update_init_stage(scale=2)
            elif (iteration + 1) % (2 * densify_every_iter) == 0:
                self.update_depth_stage(global_iteration)
            else:
                self.counter.reset(self.num_points, self.capacity)
            return True
        return False

    # ------------------------------------------------- render layout / blocks
    def optimize_render_layout(self, morton_bits: int = 10,
                               mode: str = "root_major"):
        """Reorder the rows for fast inference (host numpy, as the JAX
        package does it). Inference only: optimizer moments are not
        remapped.

        mode="root_major" (default): the roots first (in Morton order), then
        each root's descendants as one contiguous tail segment (in root
        order, depth-minor). The segments make the weight cull's
        capacity-axis expansion a scatter-max + cummax
        (train_step.expand_weight_full), and blocks stay spatially tight
        for the block-pruned frame.
        mode="depth_major": rows depth-major, Morton-minor, so coarse cuts
        map to a level prefix.
        """
        if self.optimizer is not None:
            # AssertionError, as the JAX package's assert: apps/train.py
            # catches it to keep the unpruned frame with training state
            raise AssertionError("optimize_render_layout is inference-only: "
                                 "optimizer moments are not remapped")
        n = self.num_points
        if n == 0 or self.tree.num_points == 0:
            return
        t = self.tree
        t.ensure_root_id()
        xyz = self.gaussian.get("xyz")[:n].cpu().numpy()
        lo = xyz.min(axis=0)
        span = np.maximum(xyz.max(axis=0) - lo, 1e-9)
        q = np.minimum(
            ((xyz - lo) / span * (1 << morton_bits)).astype(np.int64),
            (1 << morton_bits) - 1,
        )
        morton = np.zeros(n, np.int64)
        for b in range(morton_bits):
            for ax in range(3):
                morton |= ((q[:, ax] >> b) & 1) << (3 * b + ax)
        if mode == "root_major":
            is_tail = (t.index_parent[:n] >= 0).astype(np.int64)
            # rank roots by morton; every row inherits its root's rank
            root_rows = np.flatnonzero(~is_tail.astype(bool))
            rank_of_root_row = np.full(n, n, np.int64)
            rank_of_root_row[root_rows[np.argsort(morton[root_rows],
                                                  kind="stable")]] = (
                np.arange(root_rows.size, dtype=np.int64)
            )
            rr = rank_of_root_row[t.root_id[:n]]
            perm = np.lexsort(
                (morton, t.depth[:n].astype(np.int64), rr, is_tail)
            ).astype(np.int64)
        else:
            key = t.depth[:n].astype(np.int64) << (3 * morton_bits)
            key |= morton
            perm = np.argsort(key, kind="stable").astype(np.int64)
        inv = np.empty(n, np.int64)
        inv[perm] = np.arange(n, dtype=np.int64)

        def remap_vals(a):
            out = np.asarray(a).copy()
            pos = out >= 0
            out[pos] = inv[out[pos]]
            return out

        arrays = self.gaussian.to_numpy()
        self.gaussian.set_numpy({k: v[perm] for k, v in arrays.items()})
        perm_dev = torch.from_numpy(perm).to(self.device)
        for key_c, val in list(self.counter.data.items()):
            if val.dim() >= 1 and val.shape[0] >= n:
                val = val.clone()
                val[:n] = val[:n][perm_dev]
                self.counter.data[key_c] = val
        t.node_index = t.node_index[perm]
        t.index_parent = remap_vals(t.index_parent[perm])
        t.local_index = t.local_index[perm]
        t.depth = t.depth[perm]
        t.root_id = remap_vals(t.root_id[perm])
        t.root_index = np.sort(remap_vals(t.root_index))
        t.tree = remap_vals(t.tree)
        self._cull_seg_starts = None
        if mode == "root_major":
            # static tail-segment starts: the segment of root rank j (its
            # row: roots are the prefix) begins at seg_starts[j]; empty
            # segments point at the next start
            n_roots = int((t.index_parent[:n] == -1).sum())
            tail_rids = t.root_id[n_roots:n].astype(np.int64)
            if not (np.diff(tail_rids) >= 0).all():
                raise AssertionError("tail rows are not grouped by root")
            self._cull_seg_starts = (
                n_roots
                + np.searchsorted(tail_rids, np.arange(n_roots), side="left")
            ).astype(np.int32)
        self._tree_dev = None
        self._block_cache = None
        self._render_bucket = None
        self._frame = None
        self._layout_optimized = True
        self._refresh_device_caches()
        print(f"[{self.__class__.__name__}] render layout optimized: "
              f"{mode}/morton over {n} rows")

    # ----------------------------------------------------------- checkpoint
    def state_dict(self) -> dict:
        """Flat numpy dict with the reference's key names: gaussian.*,
        tree.*, counter.*, and with training state optimizer.* and
        view_correction.*."""
        n = self.num_points
        sd = {f"gaussian.{k}": v for k, v in self.gaussian.to_numpy().items()}
        sd["tree.root_index"] = self.tree.root_index
        sd["tree.tree"] = self.tree.tree
        for key in self.tree.KEYS:
            sd[f"tree.{key}"] = getattr(self.tree, key)
        for key, val in self.counter.to_numpy(n).items():
            sd[f"counter.{key}"] = val
        if self.optimizer is not None:
            sd["optimizer.global_steps"] = np.float32(
                self.optimizer.global_steps)
            for mk, moments in self.optimizer.to_numpy(n).items():
                for key, val in moments.items():
                    sd[f"optimizer.{mk}.{key}"] = val
        if self.view_correction is not None:
            self._sync_corrector_to_host()
            sd["view_correction.view_correction"] = self.view_correction.values
        return sd

    def load_state_dict(self, state_dict, strict=True, split="demo"):
        """Shape-tolerant load of a checkpoint dict (numpy or tensors).
        split="train" sets the optimizer up first and loads its moments and
        step count; other splits skip the optimizer keys."""
        if split == "train":
            self.training_setup()
        arrays, counter_np = {}, {}
        moments_np = {"exp_avg": {}, "exp_avg_sq": {}}
        for key, val in state_dict.items():
            if isinstance(val, torch.Tensor):
                val = val.cpu().numpy()
            val = np.asarray(val)
            if split != "train" and "optimizer" in key:
                continue
            if key.startswith("gaussian."):
                arrays[key.split(".", 1)[1]] = val
            elif key.startswith("tree."):
                name = key.split(".", 1)[1]
                if name in ("root_index", "tree") or name in self.tree.KEYS:
                    setattr(self.tree, name, val.astype(np.int32))
            elif key.startswith("counter."):
                counter_np[key.split(".", 1)[1]] = val
            elif key == "optimizer.global_steps":
                if self.optimizer is not None:
                    self.optimizer.global_steps = float(val)
            elif key.startswith("optimizer.exp_avg."):
                moments_np["exp_avg"][key.rsplit(".", 1)[1]] = val
            elif key.startswith("optimizer.exp_avg_sq."):
                moments_np["exp_avg_sq"][key.rsplit(".", 1)[1]] = val
            elif key == "view_correction.view_correction":
                if self.view_correction is not None:
                    self.view_correction.set_values(val)
            else:
                print(f"[LoG] skip unknown checkpoint key {key}")
        if arrays:
            self.gaussian.keys = [k for k in ["scaling", "colors", "xyz",
                                              "opacity", "rotation", "shs"]
                                  if k in arrays]
            self.gaussian.set_numpy(arrays)
        if counter_np:
            self.counter.set_numpy(counter_np, self.capacity)
        if split == "train" and moments_np["exp_avg"]:
            self.optimizer.moments = {"exp_avg": {}, "exp_avg_sq": {}}
            self.optimizer.set_numpy(moments_np, self.capacity)
        if self.tree.num_nodes > 0:
            self.current_depth = int(self.tree.depth.max())
        self._corr_dev = None
        self._drop_row_caches()
        self._refresh_device_caches()
        return True


def _init_radius3d(xyz, scaling, rotation, cam: dict, n_alive: int):
    """(valid, r3d) of the init pass: valid where a live point projects to
    a positive radius r2d, and r3d = scale_x * MIN_PIXEL / r2d there (the
    3D size that covers MIN_PIXEL pixels), scale_x elsewhere."""
    s = torch.exp(scaling)
    r = rotation / torch.linalg.norm(rotation, dim=-1, keepdim=True)
    r2d = gm.compute_radius2d(xyz, s, r, cam["world_view"], cam["full_proj"],
                              cam["focal_x"], cam["focal_y"], cam["tan_fovx"],
                              cam["tan_fovy"])
    alive = torch.arange(xyz.shape[0], device=xyz.device) < n_alive
    valid = (r2d > 0) & alive
    r3d = s[:, 0] * torch.where(valid,
                                MIN_PIXEL / torch.clamp(r2d, min=1e-9), 1.0)
    return valid, r3d


def _fg_mask_bbox(fg_mask, H: int, W: int, device):
    """The foreground mask on the device and its bbox with the reference's
    training padding (max(H, W) / 50). Returns (uint8 mask (1, H, W),
    host int bbox [top, bottom, left, right])."""
    m = np.asarray(fg_mask).reshape(-1, W)[-H:] > 0.5
    rows = np.where(m.any(axis=1))[0]
    cols = np.where(m.any(axis=0))[0]
    if rows.size == 0:
        bbox = np.array([0, H - 1, 0, W - 1], np.int32)
    else:
        pad = int(max(H, W) / 50)
        bbox = np.array([max(int(rows[0]) - pad, 0), int(rows[-1]) + pad,
                         max(int(cols[0]) - pad, 0), int(cols[-1]) + pad],
                        np.int32)
    return torch.from_numpy(m.astype(np.uint8))[None].to(device), bbox


def _host_compact_index(keep: np.ndarray, k: int, cap: int) -> np.ndarray:
    """The host's copy of a step's compacted index (_compact_slices_gather):
    the kept rows ascending, cut or padded to k lanes with the sentinel
    cap."""
    idx = np.nonzero(keep)[0][:k].astype(np.int32)
    return np.concatenate([idx, np.full(k - idx.shape[0], cap, np.int32)])


def _host_lrs(optimizer: SparseOptimizer, step) -> dict:
    """Per-key LR values (host floats) for this step."""
    return optimizer.lrs_for_step(step)
