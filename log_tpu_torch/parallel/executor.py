"""ShardedExecutor: the host side of the multi-device training step;
counterpart of log_tpu/parallel/executor.py.

One executor per rank. It owns this rank's block of the PACKED state
(param columns, Adam moments, counters: capacity / n rows each) and
replicated copies of the tree arrays, the leaf mask and the per-view gain,
so that a step's host work is only camera staging. The state goes back
into the rank's `LoG` model only at densify, checkpoint and validation
boundaries (`sync_to_model`, an all_gather of the blocks); the model's
densify machinery then rebuilds it and `refresh_from_model` re-shards.

Every rank holds a whole model and densifies the same gathered state with
the same draws, so the models must stay equal: `refresh_from_model` checks
that every rank holds the same arrays bit for bit (a checksum of each,
gathered) and raises if they do not.

Used by the Trainer under cfg.train.parallel.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..model.gaussian import next_capacity
from ..ops import pick_backend, pick_max_pairs
from .comm import Comm
from .mesh import shard_rows
from .sharded_step import (ShardedStepConfig, _meta_for, pack_columns,
                           shard_step, unpack_columns)


def stack_cameras(pcams):
    """Host camera dicts -> (cam_mats (B, 2, 4, 4) f32, cam_scalars (B, 4)
    f64: focal_x, focal_y, tan_fovx, tan_fovy as camera_device computes
    them, cam_center (B, 3) f32)."""
    mats, scalars, centers = [], [], []
    for pc in pcams:
        H, W = int(pc["image_height"]), int(pc["image_width"])
        tx = math.tan(float(pc["FoVx"]) * 0.5)
        ty = math.tan(float(pc["FoVy"]) * 0.5)
        mats.append(np.stack([
            np.asarray(pc["world_view_transform"], np.float32),
            np.asarray(pc["full_proj_transform"], np.float32),
        ]))
        scalars.append([W / (2.0 * tx), H / (2.0 * ty), tx, ty])
        centers.append(np.asarray(pc["camera_center"], np.float32).reshape(3))
    return (np.stack(mats).astype(np.float32),
            np.asarray(scalars, np.float64),
            np.stack(centers).astype(np.float32))


def _checksum(t) -> int:
    """Position-weighted sum of the bit patterns of a tensor or array."""
    t = torch.as_tensor(t).detach().contiguous().reshape(-1)
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    width = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
             8: torch.int64}[t.element_size()]
    bits = t.view(width).to(torch.int64)
    w = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
    return int((bits * w).sum())


class ShardedExecutor:
    def __init__(self, model, n_devices: int | None = None,
                 cams_per_device: int = 1, backend: str | None = None,
                 check_cull: bool = True, check_scale: int | None = None,
                 comm: Comm | None = None):
        self.model = model
        self.comm = comm if comm is not None else Comm()
        self.n_devices = self.comm.world
        if n_devices is not None and int(n_devices) != self.n_devices:
            raise ValueError(f"{n_devices} devices asked for, {self.n_devices}"
                             f" ranks in the group (one device per rank)")
        self.cams_per_device = int(cams_per_device)
        self.batch = self.n_devices * self.cams_per_device
        self.backend = (backend if backend is not None
                        else pick_backend(model.capacity, device=model.device))
        self.check_cull = bool(check_cull)
        self.check_scale = (int(check_scale) if check_scale is not None
                            else int(getattr(model, "check_render_scale", 1)))
        self._bucket = None
        self.refresh_from_model()

    # ------------------------------------------------------------- state
    def _mine(self, x):
        return shard_rows(x, self.comm.rank, self.n_devices).clone()

    def refresh_from_model(self):
        """(Re)shard the model's state (after init, a densify or a load),
        once every rank's model is checked to be the same."""
        model = self.model
        cap = model.capacity
        if cap % self.n_devices:
            raise ValueError(f"capacity {cap} does not split over "
                             f"{self.n_devices} ranks")
        if model.optimizer is None:
            raise RuntimeError("call training_setup first")
        if model.optimizer.spilled:
            raise ValueError("the sharded step keeps every moment on the "
                             f"device; {model.optimizer.spilled} are spilled")
        model._sync_corrector_to_host()
        self.assert_ranks_agree()
        dev = model.device
        params = model.gaussian.params()
        self.meta = _meta_for(params, tuple(model.gaussian.keys))
        self.keys, self.dims, self.shapes = (
            self.meta["keys"], self.meta["dims"], self.meta["shapes"])
        moments = model.optimizer.moments
        self.packed = self._mine(pack_columns(params, self.keys)[0])
        self.m1 = self._mine(pack_columns(moments["exp_avg"], self.keys)[0])
        self.m2 = self._mine(pack_columns(moments["exp_avg_sq"],
                                          self.keys)[0])
        self.counter = {k: self._mine(v) for k, v in model.counter.data.items()}
        self.tree_rep = model.tree.device_arrays(cap, dev)
        pad = np.zeros((cap,), bool)
        if model.tree.num_nodes > 0:
            if model.optimizer_cfg.get("opt_all_levels", True):
                leaf_opt = ((model.tree.node_index == -1)
                            & (model.tree.depth > 0))
            else:
                leaf_opt = model.tree.depth == model.current_depth
            pad[: leaf_opt.shape[0]] = leaf_opt
        self.is_leaf_opt = torch.from_numpy(pad).to(dev)
        c = model.view_correction
        if c is not None and c.values.size:
            if not c._setup:
                c.training_setup()

            def t(a, dtype=torch.float32):
                return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

            self.corr = {"values": t(c.values), "m1": t(c.exp_avg),
                         "m2": t(c.exp_avg_sq), "vmax": t(c.max_exp_avg_sq),
                         "steps": t(c.steps, torch.int32)}
        else:
            self.corr = {
                "values": torch.ones((1, 3), device=dev),
                "m1": torch.zeros((1, 3), device=dev),
                "m2": torch.zeros((1, 3), device=dev),
                "vmax": torch.zeros((1, 3), device=dev),
                "steps": torch.zeros((1,), dtype=torch.int32, device=dev),
            }
        self._bucket = None

    def assert_ranks_agree(self):
        """Raise unless every rank's model holds the same point count and
        the same arrays bit for bit (params, moments, counters, tree, the
        per-view gain); one all_gather of a checksum per array."""
        if self.n_devices == 1:
            return
        model = self.model
        named = [("num_points", model.num_points),
                 ("capacity", model.capacity)]
        for k, v in model.gaussian.params().items():
            named.append((f"gaussian.{k}", _checksum(v)))
        for mk, mom in model.optimizer.moments.items():
            for k, v in mom.items():
                named.append((f"optimizer.{mk}.{k}", _checksum(v)))
        for k, v in model.counter.data.items():
            named.append((f"counter.{k}", _checksum(v)))
        for k in ("root_index", "tree") + tuple(model.tree.KEYS):
            named.append((f"tree.{k}", _checksum(getattr(model.tree, k))))
        if model.view_correction is not None:
            named.append(("view_correction",
                          _checksum(model.view_correction.values)))
        mine = torch.tensor([v for _, v in named], dtype=torch.int64,
                            device=model.device)
        every = self.comm.all_gather(mine, tiled=False).cpu()
        differ = [name for i, (name, _) in enumerate(named)
                  if not bool((every[:, i] == every[0, i]).all())]
        if differ:
            raise RuntimeError(f"the ranks' models differ in {differ}")

    def sync_to_model(self):
        """Write the gathered state back into this rank's LoG model (the
        host authority for densify, checkpoints and validation)."""
        model = self.model
        gather = self.comm.all_gather

        def full(x):
            return {k: v.contiguous() for k, v in unpack_columns(
                gather(x), self.keys, self.dims, self.shapes).items()}

        for k, v in full(self.packed).items():
            model.gaussian.set(k, v)
        model.optimizer.moments = {"exp_avg": full(self.m1),
                                   "exp_avg_sq": full(self.m2)}
        model.counter.data = {k: gather(v) for k, v in self.counter.items()}
        c = model.view_correction
        if c is not None and c.values.size:
            d = {k: v.cpu().numpy() for k, v in self.corr.items()}
            c.values, c.exp_avg, c.exp_avg_sq = d["values"], d["m1"], d["m2"]
            c.max_exp_avg_sq = d["vmax"]
            c.steps = d["steps"].astype(np.int64)
            model._corr_dev = None
        model._bucket = None
        model._counts_dev = None
        model._refresh_device_caches()

    # -------------------------------------------------------------- step
    def _seed_bucket(self, camera):
        """First step of a stage: one single-device prepare sizes the slice
        bucket (the lagged-bucket scheme of training_iteration); every rank
        runs it on the same gathered state and camera."""
        self.sync_to_model()
        self.model.clear()
        vf = self.model.prepare_from_camera(camera)
        self._bucket = (max(vf["k_leaf"], 256), vf["k_node"])
        self.model.clear()

    def step(self, cameras, gts, view_indices=None, backgrounds=None,
             min_res=None):
        """One data-parallel step over up to `self.batch` cameras, the same
        list on every rank; rank r renders cameras [r, r + 1) *
        cams_per_device. The batch is padded with camera 0 at loss weight
        0. gts: (3, H, W) or (H, W, 3) images (f32 in [0, 1] or uint8).
        Returns (metrics (device scalars, the batch's totals), counts (B, 2)
        ndarray of every camera's kept leaf / node rows)."""
        model = self.model
        B = self.batch
        n_real = len(cameras)
        if not 1 <= n_real <= B:
            raise ValueError(f"{n_real} cameras for a batch of {B}")
        if self._bucket is None:
            self._seed_bucket(cameras[0])
        k_leaf, k_node = self._bucket
        cam_pad = list(cameras) + [cameras[0]] * (B - n_real)
        weight = np.zeros((B,), np.float32)
        weight[:n_real] = 1.0
        cam_mats, cam_scalars, cam_center = stack_cameras(cam_pad)
        vidx = np.zeros((B,), np.int64)
        if view_indices is not None:
            vidx[:n_real] = np.asarray(view_indices, np.int64)
        bg = np.zeros((B, 3), np.float32)
        if backgrounds is not None:
            bg[:n_real] = np.asarray(backgrounds, np.float32).reshape(n_real, 3)
        mr = np.full((B,), float(model.tree.min_resolution_pixel), np.float64)
        if min_res is not None:
            mr[:n_real] = np.asarray(min_res, np.float64)

        r, Bl = self.comm.rank, self.cams_per_device
        mine = slice(r * Bl, (r + 1) * Bl)
        gt_list = []
        for g in (list(gts) + [gts[0]] * (B - n_real))[mine]:
            g = np.asarray(g)
            if g.ndim == 3 and g.shape[0] != 3:
                g = g.transpose(2, 0, 1)
            gt_list.append(g)
        gt = np.ascontiguousarray(np.stack(gt_list))
        H, W = gt.shape[-2:]
        dev = model.device

        def put(a):
            return torch.as_tensor(np.ascontiguousarray(a[mine]), device=dev)

        use_corr = (model.view_correction is not None
                    and int(self.corr["values"].shape[0]) > 1
                    and model.optimizer.global_steps >= model.base_iter)
        cfg = ShardedStepConfig(
            image_height=int(H), image_width=int(W), k_leaf=k_leaf,
            k_node=k_node, sh_degree=model.gaussian.active_sh_degree,
            n_devices=self.n_devices, cams_per_device=Bl, mode="antialias",
            use_correction=use_corr, opt_keys=tuple(self.keys),
            backend=self.backend, max_pairs=pick_max_pairs(k_leaf + k_node),
            stage_has_tree=model.tree.num_nodes > 0,
            num_levels=(int(model.tree.depth.max()) + 1
                        if model.tree.num_points else 1),
            check_cull=self.check_cull, check_scale=self.check_scale,
            prep_backend=self.backend,
            prep_max_pairs=pick_max_pairs(model.capacity),
        )
        model.optimizer.global_steps += 1
        step = model.optimizer.global_steps
        host_lrs = model.optimizer.lrs_for_step(step)
        model.lr = host_lrs.get("xyz", 0.0)
        lr_cols = torch.cat([
            torch.full((d,), float(host_lrs.get(k, 0.0)), dtype=torch.float32,
                       device=dev) for k, d in zip(self.keys, self.dims)])
        (self.packed, self.m1, self.m2, self.counter, self.corr, metrics,
         counts) = shard_step(
            self.packed, self.m1, self.m2, self.counter, self.tree_rep,
            self.is_leaf_opt, model.num_points, model.current_depth, put(mr),
            put(cam_mats), put(cam_scalars), put(cam_center), put(bg),
            torch.as_tensor(gt, device=dev), put(weight),
            max(float(weight.sum()), 1e-8), lr_cols, float(step), self.corr,
            put(vidx), self.meta, cfg, self.comm)
        # every rank grows or shrinks the bucket from the whole batch's
        # counts (one-step lag), so all reach the same one
        c = self.comm.all_gather(counts).cpu().numpy()
        need_leaf = next_capacity(int(c[:n_real, 0].max()), 256)
        cmax_node = int(c[:n_real, 1].max())
        need_node = 0 if cmax_node == 0 else next_capacity(cmax_node, 256)
        bl, bn = self._bucket
        if need_leaf > bl or need_leaf * 2 < bl:
            bl = need_leaf
        if need_node > bn or need_node * 2 < bn:
            bn = need_node
        self._bucket = (bl, bn)
        return metrics, c


def toy_tree_model(n: int = 384, seed: int = 0, device="cuda"):
    """A LoG model with a real 2-level tree, from a seed (no files)."""
    from ..dataset.synthetic import random_gaussians
    from ..model.level_of_gaussian import LoG

    rng = np.random.default_rng(seed)
    scene = random_gaussians(n, rng)
    model = LoG(
        gaussian={"sh_degree": 1, "xyz_scale": 1.0},
        tree={"max_child": 4, "max_level": 30},
        optimizer={
            "optimize_keys": ["xyz", "colors", "scaling", "opacity",
                              "rotation", "shs"],
            "opt_all_levels": True,
            "lr_dict": {
                "xyz": 0.00016, "xyz_final": 0.0000016, "colors": 0.0025,
                "shs": 0.000125, "scaling": 0.005, "opacity": 0.05,
                "rotation": 0.001, "max_steps": 600,
            },
        },
        densify_and_remove={
            "upgrade_sh_iter": 10, "densify_from_iter": 1,
            "densify_every_iter": 1, "upgrade_repeat": 50,
            "init_split_method": "split_by_2d", "init_radius_min": 4,
            "init_radius_split": 16, "init_weight_min": 0.1, "min_steps": 50,
            "method": "naive", "split_grad_thres": 0.0002,
            "radius2d_thres": 6, "remove_weights_thres": 0.005,
            "max_split_points": 20000, "sort_method": "radii",
            "min_steps_split": 100, "scaling_decay": 0.9,
        },
        device=device, seed=seed,
    )
    scales = np.full((n,), float(scene["scaling"].mean()), np.float32)
    model.gaussian.register_by_pointcloud(scene["xyz"], scene["colors"],
                                          scales, init_opacity=0.3)
    model.counter.reset(model.num_points, model.capacity)
    model.training_setup()
    model.upgrade_tree()
    n0 = model.num_points
    cnt = {k: np.array(v) for k, v in model.counter.to_numpy(n0).items()}
    cnt["create_steps"][:] = 1000
    cnt["grad_sum"][:16] = 100.0
    cnt["area_sum"][:] = 1
    cnt["radii_max_max"][:16] = 10_000
    model.counter.set_numpy(cnt, model.capacity)
    model.update_depth_stage(0)
    return model
