"""LoG: the level-of-Gaussians model; counterpart of
log_tpu/model/level_of_gaussian.py.

Owns the point store and the LoD tree, the densification counters, the
sparse optimizer and the per-view gain, the device caches the per-frame cut
reads (tree arrays, parent-attribute cache), checkpoint (de)serialization
with the reference's key names, the training step (`train_step`,
`training_iteration`), the inference frame `render_fused` (generic,
flat_slice and block-pruned) and the inference row layout
`optimize_render_layout`. Densification and its schedule (`update_by_iteration`) are ROADMAP
queue 1.2b.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import pick_backend, pick_max_pairs
from .block_render import block_size_for, build_block_cache, render_blocks
from .corrector import Corrector
from .counter import Counter
from .gaussian import GaussianPoint, next_capacity
from .sparse_optimizer import SparseOptimizer
from .tensor_tree import TensorTree
from .train_step import (StepConfig, fused_prepare_render,
                         fused_prepare_train_step, fused_root_cull,
                         fused_train_step, prepare_visibility)


class LoG:
    def __init__(self, gaussian: dict, tree: dict, optimizer: dict,
                 densify_and_remove: dict, use_view_correction: bool = False,
                 check_render_scale: int = 1, device="cuda"):
        # densify_and_remove configures densification (ROADMAP queue
        # 1.2b); it is kept so that the YAML model args load unchanged
        self.device = torch.device(device)
        self.optimizer_cfg = dict(optimizer)
        self.densify_and_remove = dict(densify_and_remove)
        self.gaussian = GaussianPoint(**gaussian, device=self.device)
        self.tree = TensorTree(**tree)
        self.counter = Counter(self.gaussian.capacity, device=self.device)
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

    def set_stage(self, stage_name: str):
        self.stage_name = stage_name
        self._bucket = None
        self._counts_dev = None

    def set_state(self, active_sh_degree=None, enable_sh=None,
                  min_resolution_pixel=None, current_depth=None,
                  log_query=None, check_render_every=None):
        if active_sh_degree is not None or enable_sh is not None:
            if enable_sh:
                self.gaussian.active_sh_degree = self.gaussian.max_sh_degree
            else:
                self.gaussian.active_sh_degree = min(
                    int(active_sh_degree), self.gaussian.max_sh_degree
                )
            print(f"[{self.__class__.__name__}] active_sh_degree: "
                  f"{self.gaussian.active_sh_degree}")
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
            backend=pick_backend(self.capacity, self.device),
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
            backend=pick_backend(k_total, self.device),
            max_pairs=pick_max_pairs(k_total),
            render_depth=render_depth, crop_loss=fg_mask is not None,
            spilled=self.optimizer.spilled,
        )

    def _step_inputs(self, cam: dict, cfg: StepConfig, gt_image, background,
                     mask_ignore, fg_mask) -> dict:
        """Device inputs of one step; advances the optimizer's step count
        and the LR schedule."""
        dev = self.device
        self.optimizer.global_steps += 1
        step = self.optimizer.global_steps
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
        return dict(
            gt=torch.as_tensor(gt_image, device=dev),
            background=torch.as_tensor(np.asarray(background, np.float32),
                                       device=dev),
            lrs=host_lrs, global_step=float(step), corr_state=corr_state,
            mask_ignore=(torch.as_tensor(mask_ignore, device=dev)[None]
                         if mask_ignore is not None
                         else torch.ones((1, 1, 1), device=dev)),
            gt_depth=None, fg_mask=fg_dev, bbox=bbox,
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
        inputs = self._step_inputs(cam, cfg, gt_image, background,
                                   mask_ignore, fg_mask)
        params, moments, counter, corr_state, metrics, aux = fused_train_step(
            self.gaussian.params(), self.optimizer.moments, self.counter.data,
            vf["keep_leaf"], vf["keep_node"], cam, view_index=view_index,
            cfg=cfg, **inputs,
        )
        self._apply_step(cfg, params, moments, counter, corr_state)
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

        if self._bucket is None:
            vf = self.prepare_from_camera(camera)
            self._bucket = (vf["k_leaf"], vf["k_node"])
            return self.train_step(
                camera, gt_image, background, mask_ignore=mask_ignore,
                view_index=view_index, gt_depth=gt_depth,
                render_depth=render_depth, fg_mask=fg_mask,
            )
        if self._counts_dev is not None:
            c = self._counts_dev.cpu().numpy()
            k_leaf = next_capacity(int(c[0]), 256)
            k_node = 0 if int(c[1]) == 0 else next_capacity(int(c[1]), 256)
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
                                   mask_ignore, fg_mask)
        params, moments, counter, corr_state, metrics, aux = (
            fused_prepare_train_step(
                self.gaussian.params(), self.optimizer.moments,
                self.counter.data, tree_arrays, self.num_points, leaf_opt,
                float(self.tree.min_resolution_pixel), self.current_depth,
                cam, view_index=view_index, stage_has_tree=stage_has_tree,
                num_levels=num_levels,
                prep_backend=pick_backend(self.capacity, self.device),
                prep_max_pairs=pick_max_pairs(self.capacity),
                check_scale=int(self.check_render_scale), cfg=cfg,
                cut_method=(self.cut_method_train if stage_has_tree
                            else "traverse"),
                n_roots=self.n_roots_bucket if stage_has_tree else 0,
                **inputs,
            )
        )
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

        cam = camera_device(camera, self.device)
        stage_has_tree = self.tree.num_nodes > 0
        if self._tree_dev is None or (
            stage_has_tree
            and self.cut_method in ("flat", "flat_slice")
            and "parent_xyz" not in self._tree_dev
        ):
            self._refresh_device_caches()
        if self._render_bucket is None:
            vf = self.prepare_from_camera(camera)
            self._render_bucket = next_capacity(
                int(sum(vf["counts"]) * 1.2), 1 << 14
            )
        elif self._frame is not None:
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
        # static alive bucket: the capacity-axis passes run over [:cap_sort]
        cap_sort = min(self.capacity,
                       -(-self.num_points // (1 << 18)) * (1 << 18))
        k_vis = min(self._render_bucket, self.capacity, cap_sort)
        backend = pick_backend(self.capacity, self.device)
        tree_arrays, num_levels = self._tree_args(stage_has_tree)
        max_pairs = pick_max_pairs(k_vis, per_point=6)
        frame_pairs = min(max_pairs, self._pair_bucket or max_pairs)
        bg = torch.as_tensor(np.asarray(background, np.float32),
                             device=self.device)
        flat_slice = stage_has_tree and self.cut_method == "flat_slice"
        # the block-pruned frame needs the optimized layout, SH degree 0
        # and a capacity past 2^16; otherwise the fused flat_slice frame
        use_blocks = (self._layout_optimized and self._block_cache is not None
                      and flat_slice and self.gaussian.active_sh_degree == 0
                      and backend == "tiled" and self.capacity >= 1 << 16)
        w_full = None
        if flat_slice:
            # cull first, as the reference orders it: the capacity-axis
            # mask is refreshed every check_render_every frames (every
            # frame by default), at full capacity for the block path
            cull_bucket = 0 if use_blocks else cap_sort
            if (self._cull_mask_dev is None
                    or self._cull_bucket != cull_bucket
                    or self._cull_frame_i % self.check_render_every == 0):
                self._cull_mask_dev = fused_root_cull(
                    self.gaussian.params(), tree_arrays, cam,
                    self.num_points, cam["image_height"], cam["image_width"],
                    prep_backend=backend,
                    prep_max_pairs=pick_max_pairs(self.capacity, per_point=1),
                    check_scale=int(self.check_render_scale),
                    n_roots=self.n_roots_bucket, cap_sort=cull_bucket,
                )
                self._cull_bucket = cull_bucket
            self._cull_frame_i += 1
            w_full = self._cull_mask_dev
        if use_blocks:
            B = self.capacity // self._block_cache["S"]
            render, alpha, counts = render_blocks(
                self._block_cache["cols"], self._block_cache["meta"], cam,
                float(self.tree.min_resolution_pixel), self.current_depth, bg,
                cam["image_height"], cam["image_width"],
                k_blocks=self._kb_bucket or B, k_visible=k_vis,
                max_pairs=frame_pairs, w_full=w_full,
            )
            pair_total = counts[2]
        else:
            render, alpha, counts, pair_total = fused_prepare_render(
                self.gaussian.params(), tree_arrays, cam, self.num_points,
                self._leaf_opt_dev, float(self.tree.min_resolution_pixel),
                self.current_depth, bg, cam["image_height"],
                cam["image_width"], k_visible=k_vis,
                sh_degree=self.gaussian.active_sh_degree,
                stage_has_tree=stage_has_tree, num_levels=num_levels,
                backend=backend, max_pairs=frame_pairs,
                check_scale=int(self.check_render_scale),
                cut_method=self.cut_method if stage_has_tree else "traverse",
                n_roots=self.n_roots_bucket if stage_has_tree else 0,
                prep_backend=backend,
                prep_max_pairs=pick_max_pairs(self.capacity, per_point=1),
                cap_sort=cap_sort, w_full=w_full,
            )
        self._frame = {"counts": counts, "pair_total": pair_total,
                       "k_visible": k_vis, "max_pairs": frame_pairs}
        return {"render": render, "alpha": alpha, "counts": counts,
                "pair_total": pair_total}

    def frame_stats(self) -> dict:
        """Telemetry of the last render_fused frame (host values): the
        kept cut (leaf + node points), the slice bucket, the pair budget,
        the unclamped pair demand and, from the block-pruned frame, the
        eligible blocks (None otherwise)."""
        f = self._frame
        c = f["counts"].cpu().tolist()
        return {"cut": c[0] + c[1], "k_visible": f["k_visible"],
                "max_pairs": f["max_pairs"],
                "pair_total": int(f["pair_total"]),
                "eligible_blocks": c[3] if len(c) > 3 else None}

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
        self._render_bucket = None
        self._pair_bucket = None
        self._frame = None
        self._corr_dev = None
        # freshly loaded state undoes any earlier layout optimization
        self._layout_optimized = False
        self._cull_seg_starts = None
        self._block_cache = None
        self._refresh_device_caches()
        return True


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


def _host_lrs(optimizer: SparseOptimizer, step) -> dict:
    """Per-key LR values (host floats) for this step."""
    return optimizer.lrs_for_step(step)
