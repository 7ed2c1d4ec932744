"""LoG: the level-of-Gaussians model; serving half of
log_tpu/model/level_of_gaussian.py.

Owns the point store and the LoD tree, the device caches the per-frame cut
reads (tree arrays, parent-attribute cache), checkpoint (de)serialization
with the reference's key names, and the inference frame `render_fused`.
Training (train_step, densification, optimizer, counters) is the next slice
of the port (ROADMAP queue 1).
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import pick_backend, pick_max_pairs
from .gaussian import GaussianPoint, next_capacity
from .tensor_tree import TensorTree
from .train_step import fused_prepare_render, prepare_visibility

# checkpoint key prefixes of training state, which the serving port skips
_TRAINING_KEYS = ("counter.", "optimizer.", "view_correction.")


class LoG:
    def __init__(self, gaussian: dict, tree: dict, optimizer: dict,
                 densify_and_remove: dict, use_view_correction: bool = False,
                 check_render_scale: int = 1, device="cuda"):
        # densify_and_remove and use_view_correction configure training;
        # they are accepted so that the YAML model args load unchanged
        self.device = torch.device(device)
        self.optimizer_cfg = dict(optimizer)
        self.gaussian = GaussianPoint(**gaussian, device=self.device)
        self.tree = TensorTree(**tree)
        self.check_render_scale = check_render_scale
        self.current_depth = 0
        self.training = True
        self.visibility_flag = None
        self._tree_dev = None
        self._leaf_opt_dev = None
        # static buckets of the inference frame and the last frame's
        # device-side counts they are sized from (see render_fused)
        self._render_bucket = None
        self._pair_bucket = None
        self._frame = None

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

    def set_state(self, active_sh_degree=None, enable_sh=None,
                  min_resolution_pixel=None, current_depth=None,
                  log_query=None):
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

    @torch.no_grad()
    def render_fused(self, camera: dict, background):
        """Inference frame: cut + compaction + render. Returns a dict of
        device tensors: 'render' (3,H,W), 'alpha' (H,W), 'counts' (the kept
        leaf/node counts and -1) and 'pair_total' (the frame's unclamped
        pair demand, -1 on the reference backend).

        The slice budget comes from the first frame's prepare pass, then
        from the previous frame's counts (1.2x headroom, re-bucketed when
        the need grows or halves), as in the JAX package.
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
        # static alive bucket: the capacity-axis passes run over [:cap_sort]
        cap_sort = min(self.capacity,
                       -(-self.num_points // (1 << 18)) * (1 << 18))
        k_vis = min(self._render_bucket, self.capacity, cap_sort)
        backend = pick_backend(self.capacity, self.device)
        tree_arrays, num_levels = self._tree_args(stage_has_tree)
        max_pairs = pick_max_pairs(k_vis, per_point=6)
        frame_pairs = min(max_pairs, self._pair_bucket or max_pairs)
        render, alpha, counts, pair_total = fused_prepare_render(
            self.gaussian.params(), tree_arrays, cam, self.num_points,
            self._leaf_opt_dev, float(self.tree.min_resolution_pixel),
            self.current_depth,
            torch.as_tensor(np.asarray(background, np.float32),
                            device=self.device),
            cam["image_height"], cam["image_width"],
            k_visible=k_vis, sh_degree=self.gaussian.active_sh_degree,
            stage_has_tree=stage_has_tree, num_levels=num_levels,
            backend=backend,
            max_pairs=frame_pairs,
            check_scale=int(self.check_render_scale),
            cut_method=self.cut_method if stage_has_tree else "traverse",
            n_roots=self.n_roots_bucket if stage_has_tree else 0,
            prep_backend=backend,
            prep_max_pairs=pick_max_pairs(self.capacity, per_point=1),
            cap_sort=cap_sort,
        )
        self._frame = {"counts": counts, "pair_total": pair_total,
                       "k_visible": k_vis, "max_pairs": frame_pairs}
        return {"render": render, "alpha": alpha, "counts": counts,
                "pair_total": pair_total}

    def frame_stats(self) -> dict:
        """Telemetry of the last render_fused frame (host values): the
        kept cut (leaf + node points), the slice bucket, the pair budget
        and the unclamped pair demand."""
        f = self._frame
        c = f["counts"].cpu().tolist()
        return {"cut": c[0] + c[1], "k_visible": f["k_visible"],
                "max_pairs": f["max_pairs"],
                "pair_total": int(f["pair_total"])}

    # ----------------------------------------------------------- checkpoint
    def state_dict(self) -> dict:
        """Flat numpy dict with the reference's key names."""
        sd = {f"gaussian.{k}": v for k, v in self.gaussian.to_numpy().items()}
        sd["tree.root_index"] = self.tree.root_index
        sd["tree.tree"] = self.tree.tree
        for key in self.tree.KEYS:
            sd[f"tree.{key}"] = getattr(self.tree, key)
        return sd

    def load_state_dict(self, state_dict, strict=True, split="demo"):
        """Shape-tolerant load of a checkpoint dict (numpy or tensors).
        Training state (counter, optimizer moments, view correction) is
        skipped: it belongs to the training slice."""
        if split == "train":
            raise NotImplementedError(
                "loading for training is the next slice (ROADMAP queue 1)"
            )
        arrays = {}
        for key, val in state_dict.items():
            if isinstance(val, torch.Tensor):
                val = val.cpu().numpy()
            val = np.asarray(val)
            if key.startswith("gaussian."):
                arrays[key.split(".", 1)[1]] = val
            elif key.startswith("tree."):
                name = key.split(".", 1)[1]
                if name in ("root_index", "tree") or name in self.tree.KEYS:
                    setattr(self.tree, name, val.astype(np.int32))
            elif not key.startswith(_TRAINING_KEYS):
                print(f"[LoG] skip unknown checkpoint key {key}")
        if arrays:
            self.gaussian.keys = [k for k in ["scaling", "colors", "xyz",
                                              "opacity", "rotation", "shs"]
                                  if k in arrays]
            self.gaussian.set_numpy(arrays)
        if self.tree.num_nodes > 0:
            self.current_depth = int(self.tree.depth.max())
        self._render_bucket = None
        self._pair_bucket = None
        self._frame = None
        self._refresh_device_caches()
        return True
