"""Training orchestration; the per-step part of log_tpu/utils/trainer.py.

`Trainer.training_step` takes one loader batch through the model's training
step: per camera, the renderer's training camera and background (random
under `use_randback`), the random LoD pixel threshold (`use_rand_radius`),
the GT as uint8 on the device (kept there across steps by the GT cache),
and `LoG.training_iteration`. Every random draw comes from the trainer's own
`torch.Generator`. `fit`, the init pass, validation, overlook renders and
checkpoints are ROADMAP queue 1, item 3.
"""
from __future__ import annotations

import numpy as np
import torch


class Trainer:
    def __init__(self, cfg, model, render, seed: int = 666):
        self.cfg = dict(cfg or {})
        self.model = model
        self.render = render
        self.global_iterations = 0
        self.generator = torch.Generator().manual_seed(seed)
        # device-resident GT cache, keyed by (view, shape), up to a byte
        # budget (cfg gt_cache_mb, default 512); off until set_gt_cache
        self.gt_cache_limit_bytes = int(self.cfg.get("gt_cache_mb", 512)) << 20
        self.set_gt_cache(False)

    def set_gt_cache(self, enabled: bool) -> None:
        """Empty the GT device cache and turn it on or off. It starts off,
        as in the JAX package, whose fit turns it on per stage for datasets
        that serve full frames only: under random crops one (view, shape)
        key holds different content from step to step."""
        self._gt_cache_ok = bool(enabled)
        self._gt_dev_cache = {}
        self._gt_cache_bytes = 0

    def _rand_radius_jitter(self) -> float:
        """Random LoD pixel threshold of a training step."""
        u = float(torch.rand((), generator=self.generator))
        if u > 0.5:
            return 3 * 2 ** (u * 8 - 3)
        return 3 * 2 ** (u * 2)

    def _gt_to_device(self, view_index: int, gt: np.ndarray):
        """The GT of a view on the model's device, cached: training revisits
        the same views, so a full frame is uploaded once. Past the byte
        budget the cache is dropped and every step uploads."""
        device = self.model.device
        if not self._gt_cache_ok:
            return torch.from_numpy(gt).to(device)
        key = (int(view_index), gt.shape)
        hit = self._gt_dev_cache.get(key)
        if hit is not None:
            return hit
        if self._gt_cache_bytes + gt.nbytes > self.gt_cache_limit_bytes:
            self._gt_cache_ok = False
            self._gt_dev_cache.clear()
            return torch.from_numpy(gt).to(device)
        dev = torch.from_numpy(gt).to(device)
        self._gt_cache_bytes += gt.nbytes
        self._gt_dev_cache[key] = dev
        return dev

    def training_step(self, model, data):
        """One loader batch of training steps. Returns (ok, output, loss):
        output holds the last camera's metrics (device scalars), render and
        GT; loss is a host float every 10th global iteration (the logging
        cadence) and the device scalar otherwise."""
        B = np.asarray(data["camera"]["camera_center"]).shape[0]
        output = {}
        for bn in range(B):
            camera, background = self.render.prepare_camera(
                data, bn, None, is_train=True, generator=self.generator
            )
            origin_radius = model.tree.min_resolution_pixel
            if getattr(self.render, "use_rand_radius", False):
                model.tree.min_resolution_pixel = self._rand_radius_jitter()
            gt = np.asarray(data["image"][bn]).transpose(2, 0, 1)
            if gt.dtype != np.uint8:
                # 8-bit sources: uint8 is exact and a quarter of the bytes;
                # the step normalizes on the device
                gt = (np.clip(gt, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
            gt = np.ascontiguousarray(gt)
            mask = None
            if "mask_ignore" in data:
                mask = np.asarray(data["mask_ignore"][bn])
            view_index = int(np.asarray(data["index"])[bn])
            gt_step = self._gt_to_device(view_index, gt)
            gt_depth = None
            if "depth" in data and isinstance(data["depth"][bn], np.ndarray):
                gt_depth = np.asarray(data["depth"][bn])
            fg_mask = None
            if getattr(self.render, "foreground_crop", False) and "mask" in data:
                fg_mask = np.asarray(data["mask"][bn])
            metrics, aux = model.training_iteration(
                camera, gt_step, background, mask_ignore=mask,
                view_index=view_index, gt_depth=gt_depth,
                render_depth=getattr(self.render, "render_depth", False),
                fg_mask=fg_mask,
            )
            model.tree.min_resolution_pixel = origin_radius
            output = {
                "metrics": metrics,
                "render": aux["render"],
                "loss_dev": metrics["loss"],
                "gt": gt.astype(np.float32) / 255.0,
            }
        if not output:
            return False, {}, 0.0
        if self.global_iterations % 10 == 0:
            return True, output, float(output["loss_dev"])
        return True, output, output["loss_dev"]
