"""Stage-driven training; counterpart of log_tpu/utils/trainer.py.

`Trainer.fit` runs the config's named stages in order: a stage whose
checkpoint exists is loaded and skipped (resume-skip); otherwise the dataset,
model and renderer states are applied, the optimizer is set up, and an
iteration-sampled loader drives `training_step` -> `LoG.training_iteration`,
with validation, overlook renders and checkpoints at their cadence and
`LoG.update_by_iteration` (densification) between steps. `init` is the init
pass over the training views. `make_validation` renders the held-out views
over a white background through the two-phase render, fits a per-channel
least-squares gain where the model has per-view gains, and computes L1, PSNR
and SSIM on the device.

Every host random draw comes from one numpy Generator (`seed`, 666 as in
the JAX package): the loader's sampler seeds, the random backgrounds and the
random LoD pixel thresholds, so a config and seed give the JAX package's
draws in the same order. A trainer made with an `exp` dir holds an exclusive
lock on it for its life and records scalars in `<logdir>/scalars.jsonl`.
"""
from __future__ import annotations

import fcntl
import os
import pickle
import time
from collections import defaultdict
from os.path import join

import numpy as np
import torch

from . import image_io
from .config import load_object
from .hbm import hbm_usage
from .recorder import Recorder
from .sampler import DataLoader, IndexSampler, IterationBasedSampler


def seed_everything(seed):
    import random

    random.seed(seed)
    np.random.seed(seed)


class Trainer:
    def __init__(self, cfg, model, render, logdir=None, seed: int = 666):
        self.cfg = cfg if cfg is not None else {}
        self.exp = self.cfg.get("exp")
        self._exp_lock_fd = None
        if self.exp is not None:
            os.makedirs(self.exp, exist_ok=True)
            self._acquire_exp_lock()
        if "train" in self.cfg and (self.cfg["train"].get("parallel") or
                                    {}).get("enable") in (True, "true", "on"):
            raise NotImplementedError(
                "cfg.train.parallel (multi-device training) is ROADMAP "
                "queue 1, item 7")
        self.model = model
        self.render = render
        self.device = model.device
        self.recorder = Recorder(logdir if logdir is not None else self.exp)
        self.check_val()
        self.check_overlook()
        self.log_interval = self.cfg.get("log_interval", 1000)
        self.save_interval = self.cfg.get("save_interval", 100_000)
        self.save_vis = self.cfg.get("save_vis", True)
        self.global_iterations = 0
        self.rng = np.random.default_rng(seed)
        # device-resident GT cache, keyed by (view, shape), up to a byte
        # budget (cfg gt_cache_mb, default 512); off until set_gt_cache
        self.gt_cache_limit_bytes = int(self.cfg.get("gt_cache_mb", 512)) << 20
        self.set_gt_cache(False)

    def _acquire_exp_lock(self):
        """Exclusive flock on <exp>/.lock for the life of this trainer: a
        second trainer on the same exp dir fails at once instead of
        interleaving scalars and overwriting checkpoints. Advisory, released
        when the process dies; the file holds the owner's pid."""
        path = os.path.join(self.exp, ".lock")
        fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            owner = os.read(fd, 64).decode().strip() or "?"
            os.close(fd)
            raise RuntimeError(
                f"experiment dir {self.exp!r} is locked by a running "
                f"trainer (pid {owner}); refusing to start a second one")
        os.ftruncate(fd, 0)
        os.write(fd, f"{os.getpid()}\n".encode())
        os.fsync(fd)
        self._exp_lock_fd = fd

    def close(self):
        """Release the exp lock and close the scalar log."""
        if self._exp_lock_fd is not None:
            os.close(self._exp_lock_fd)
            self._exp_lock_fd = None
        self.recorder.close()

    # ------------------------------------------------------------- setup
    def _load_render(self, node):
        return load_object(node.module, node.args, device=self.device)

    def check_val(self):
        self.val = None
        if "val" not in self.cfg:
            return
        dataset = load_object(self.cfg.val.dataset.module,
                              self.cfg.val.dataset.args)
        print(f">>> Load val dataset: {len(dataset)}")
        self.val = DataLoader(dataset, batch_size=1)
        if "render" in self.cfg.val:
            self.render_val = self._load_render(self.cfg.val.render)
        else:
            self.render_val = self.render
        self.lpips = None
        if dataset.scales and dataset.scales[0] >= 4:
            try:
                import lpips
            except ImportError:
                pass
            else:
                self.lpips = lpips.LPIPS(net="vgg", spatial=False)

    def check_overlook(self):
        self.overlook = None
        self.overlook_oneframe = None
        if "overlook" in self.cfg:
            dataset = load_object(self.cfg.overlook.dataset.module,
                                  self.cfg.overlook.dataset.args)
            print(f">>> Load overlook dataset: {len(dataset)}")
            self.overlook = DataLoader(dataset, batch_size=1)
        if "overlook_oneframe" in self.cfg:
            self.overlook_oneframe = load_object(
                self.cfg.overlook_oneframe.dataset.module,
                self.cfg.overlook_oneframe.dataset.args)
            self.overlook_oneframe_freq = self.cfg.overlook_oneframe.iteration

    def train_loader(self, dataset, args=None, base_iter=1):
        stage = args if args is not None else self.cfg.train.loader.args
        batch_size = stage.get("batch_size", 16)
        iterations = stage.get("iterations", 1024) * base_iter
        sampler = IterationBasedSampler(
            dataset, iterations * batch_size,
            seed=int(self.rng.integers(1 << 31)))
        return DataLoader(dataset, sampler=sampler, batch_size=batch_size,
                          drop_last=True)

    def val_loader(self, dataset, index=None, num_workers=1):
        return DataLoader(dataset, sampler=IndexSampler(dataset, index),
                          batch_size=1)

    # ----------------------------------------------------------- training
    def set_gt_cache(self, enabled: bool) -> None:
        """Empty the GT device cache and turn it on or off. fit turns it on
        per stage for datasets that serve full frames only: under random
        crops one (view, shape) key holds different content from step to
        step."""
        self._gt_cache_ok = bool(enabled)
        self._gt_dev_cache = {}
        self._gt_cache_bytes = 0

    def _rand_radius_jitter(self) -> float:
        """Random LoD pixel threshold of a training step."""
        u = float(self.rng.random())
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
        cadence, which also records the losses) and the device scalar
        otherwise."""
        B = np.asarray(data["camera"]["camera_center"]).shape[0]
        output = {}
        for bn in range(B):
            camera, background = self.render.prepare_camera(
                data, bn, None, is_train=True, rng=self.rng)
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
            loss = float(output["loss_dev"])
            self.recorder.log(self.global_iterations, "train/loss", loss)
            for key in ("l1", "ssim"):
                self.recorder.log(self.global_iterations, f"train/loss_{key}",
                                  float(output["metrics"][key]))
            return True, output, loss
        return True, output, output["loss_dev"]

    def init(self, dataset):
        """The init pass: every training view (cameras only) lowers the
        points' radius3d_min; then up to 3 renders of the initial model."""
        dataset.read_img = False
        os.makedirs(join(self.exp, "init"), exist_ok=True)
        if "init" in self.cfg.train:
            dataset.set_state(**self.cfg.train.init.get("dataset_state", {}))
            self.model.at_init_start()
            for iteration in range(len(dataset)):
                item = dataset[iteration]
                self.model.clear()
                self.model.init_view(item["camera"])
            self.model.at_init_final()
        dataset.set_partial_indices(list(range(len(dataset))))
        self.model.eval()
        for iteration in range(min(3, len(dataset)) if self.save_vis else 0):
            item = dataset[iteration]
            batch = {
                "camera": {k: np.asarray(v)[None]
                           for k, v in item["camera"].items()},
                "index": np.asarray([item.get("index", iteration)]),
            }
            ret = self.render.vis(batch, self.model)
            vis = self.render.tensor_to_bgr(ret["render"][0])
            image_io.imwrite(join(self.exp, "init", f"model_{iteration}.jpg"),
                             vis)
        self.model.train()
        dataset.read_img = True
        dataset.partial_indices = None

    # --------------------------------------------------------- validation
    @torch.no_grad()
    def make_validation(self, iteration, visualize=False):
        """L1, PSNR and SSIM over the val views, on the device (scalars
        fetched), with a white background and, where the model has per-view
        gains, a least-squares channel gain fitted on the left image half.
        Returns the record {'iteration', 'num_points', 'l1', 'psnr',
        'ssim'}."""
        if self.val is None:
            return None
        from ..ops.ssim import ssim_map

        metric = defaultdict(list)
        model = self.model
        model.eval()
        dev = model.device
        logdir = os.path.join(self.exp or ".", "val", f"{iteration:06d}")
        use_corr = (getattr(model, "view_correction", None) is not None
                    and model.view_correction.values.size)
        for _data in self.val:
            model.clear()
            camera, _bg = self.render_val.prepare_camera(_data, 0, None)
            model.prepare_from_camera(camera)
            out = self.render_val.render_one(model, camera,
                                             np.ones(3, np.float32))
            pred = out["render"]
            # MaskForeground crops both to the mask's box; the base keeps
            # them whole
            pred = self.render_val.process_pred(_data, pred)
            gt = torch.as_tensor(
                np.ascontiguousarray(self.render_val.process_gt(_data)[0]),
                dtype=torch.float32, device=dev)
            if use_corr:
                gt_left = gt[:, :, : gt.shape[2] // 2]
                pred_left = pred[:, :, : pred.shape[2] // 2]
                denom = torch.clamp((pred_left ** 2).sum(dim=(-2, -1)),
                                    min=1e-8)
                gain = (gt_left * pred_left).sum(dim=(-2, -1)) / denom
                pred = torch.clamp(pred * gain[:, None, None], 0.0, 1.0)
            l1 = torch.mean(torch.abs(pred - gt))
            mse = torch.mean((pred - gt) ** 2)
            ssim = torch.mean(ssim_map(pred, gt))
            metric["l1"].append(float(l1))
            metric["psnr"].append(
                float(-10 * torch.log10(torch.clamp(mse, min=1e-12))))
            metric["ssim"].append(float(ssim))
            metric["imgname"].append(_data["imgname"][0])
            if visualize and self.save_vis:
                vis = self.render_val.tensor_to_bgr(torch.cat([pred, gt], 1))
                image_io.imwrite(
                    join(logdir, f'{len(metric["imgname"]):06d}.jpg'), vis)
        print(f">>> Validation: {iteration}: {len(metric['imgname'])} images")
        record = {"iteration": iteration, "num_points": model.num_points}
        for key, val in metric.items():
            if key == "imgname":
                continue
            mean_val = sum(val) / len(val)
            record[key] = mean_val
            if self.global_iterations > 0:
                self.recorder.log(self.global_iterations, f"val/{key}", mean_val)
            print(f"    - {key}: {mean_val:.4f}")
        model.train()
        return record

    def make_overlook(self, mode="rgb", iteration=-1):
        if self.overlook is None:
            return
        if iteration == -1:
            iteration = self.global_iterations
        self.model.eval()
        for _iter, _data in enumerate(self.overlook):
            self.model.clear()
            output = self.render.vis(_data, self.model)
            vis = self.render.tensor_to_bgr(output["render"][0])
            image_io.imwrite(os.path.join(
                self.exp, "overlook", f"{mode}_{iteration:06d}_{_iter:02d}.jpg"),
                vis)
        self.model.train()

    def make_overlook_oneframe(self, iteration=-1):
        if self.overlook_oneframe is None:
            return
        iteration = self.global_iterations // max(self.overlook_oneframe_freq, 1)
        data = self.overlook_oneframe[iteration % len(self.overlook_oneframe)]
        batch = {
            "camera": {k: np.asarray(v)[None] for k, v in data["camera"].items()},
            "index": np.asarray([data["index"]]),
        }
        self.model.eval()
        self.model.clear()
        output = self.render.vis(batch, self.model)
        vis = self.render.tensor_to_bgr(output["render"][0])
        image_io.imwrite(os.path.join(
            self.exp, "overlook_oneframe", "rgb", f"{iteration:06d}.jpg"), vis)
        self.model.train()

    # --------------------------------------------------------- checkpoint
    def log_device_memory(self):
        """Device memory in MiB (in use and peak) on a CUDA device."""
        if self.device.type != "cuda":
            return
        usage = hbm_usage(self.device)
        self.recorder.log(self.global_iterations, "train/memory",
                          usage["in_use_gb"] * 1024)
        self.recorder.log(self.global_iterations, "train/max_mem",
                          usage["peak_gb"] * 1024)

    def log_point_cloud(self, output):
        """The current points as a PLY (xyz, colors from the SH DC term)."""
        from ..ops.sh import C0
        from .file import write_ply

        arrays = self.model.gaussian.to_numpy(["xyz", "colors"])
        colors = np.clip(arrays["colors"] * C0 + 0.5, 0, 1)
        write_ply(os.path.join(self.exp, "pointcloud",
                               f"{self.global_iterations:06d}.ply"),
                  arrays["xyz"], colors)

    def save_ckpt(self, ckptname):
        """The JAX package's checkpoint: a pickle of numpy arrays
        {'state_dict', 'global_iterations'}, and beside it <name>_wotrain.pth
        without the optimizer and counter keys."""
        state_dict = self.model.state_dict()
        payload = {"state_dict": state_dict,
                   "global_iterations": self.global_iterations}
        os.makedirs(os.path.dirname(ckptname) or ".", exist_ok=True)
        with open(ckptname, "wb") as f:
            pickle.dump(payload, f)
        wotrain = {k: v for k, v in state_dict.items()
                   if "optimizer" not in k and "counter" not in k}
        with open(ckptname.replace(".pth", "_wotrain.pth"), "wb") as f:
            pickle.dump(wotrain, f)

    def check_iteration(self, stage_name, iteration, cfg_iteration):
        if cfg_iteration == -1:
            return False
        if isinstance(cfg_iteration, int) and iteration % cfg_iteration == 0:
            return True
        if isinstance(cfg_iteration, dict):
            if stage_name not in cfg_iteration:
                return False
            iters = cfg_iteration[stage_name]
            if iters[0] < iteration < iters[1] and iteration % iters[2] == 0:
                return True
        return False

    # ---------------------------------------------------------------- fit
    def fit(self, dataset):
        from .command import load_statedict

        self.global_iterations = 0
        self.global_start_time = time.time()
        for stage_name, stage in self.cfg.train.stages.items():
            n_iter = stage.loader.args.iterations * self.model.base_iter
            print(f"> Run stage: {stage_name}. {n_iter} iterations")
            ckptname = stage.get("ckptname",
                                 join(self.exp, f"model_{stage_name}.pth"))
            if os.path.exists(ckptname):
                print(f"Load checkpoint: {ckptname}")
                self.model.load_state_dict(load_statedict(ckptname),
                                           split="train")
                self.global_iterations += n_iter
                continue
            dataset.set_state(**stage.get("dataset_state", {}))
            # the GT device cache holds only for full frames
            cs = tuple(getattr(dataset, "crop_size", (-1, -1)) or (-1, -1))
            self.set_gt_cache(cs == (-1, -1))
            self.model.set_stage(stage_name)
            self.model.set_state(**stage.get("model_state", {}))
            if "render_state" in stage:
                self.render.set_state(**stage.render_state)
            self.model.training_setup()
            trainloader = self.train_loader(dataset, stage.loader.args,
                                            base_iter=self.model.base_iter)
            if self.val is not None:
                self.make_validation(self.global_iterations + 1)
            self.start_time = time.time()
            loss_window = []
            need_log = True
            n_batches = len(trainloader)
            for iteration, data in enumerate(trainloader):
                self.model.clear()
                self.render.iteration = self.global_iterations
                flag, output, loss = self.training_step(self.model, data)
                if not flag:
                    self.global_iterations += 1
                    continue
                loss_window.append(loss)  # device scalars: no sync here
                if (iteration + 1) % self.log_interval == 0 or need_log:
                    need_log = False
                    window = loss_window[-self.log_interval:]
                    mean_loss = float(np.mean([float(x) for x in window]))
                    self.log_in_training(iteration, n_batches, data, mean_loss,
                                         output)
                    if (iteration + 1) % self.log_interval == 0 and iteration > 0:
                        self.recorder.log(self.global_iterations,
                                          "train/loss_mean", mean_loss)
                        loss_window = []
                if self.val is not None and \
                        (iteration + 1) % self.cfg.val.iteration == 0:
                    self.make_validation(self.global_iterations)
                if self.overlook is not None and self.check_iteration(
                        stage_name, iteration + 1, self.cfg.overlook.iteration):
                    self.make_overlook()
                if self.overlook_oneframe is not None and (
                        iteration % self.overlook_oneframe_freq == 0):
                    self.make_overlook_oneframe()
                if (iteration + 1) % self.save_interval == 0:
                    name = join(self.exp, "model_latest.pth")
                    print("Save checkpoint...: ", name)
                    self.save_ckpt(name)
                if (iteration + 1) < n_batches:
                    if self.model.update_by_iteration(iteration,
                                                      self.global_iterations):
                        need_log = True
                        self.recorder.log(self.global_iterations,
                                          "train/num_points",
                                          self.model.num_points)
                if self.global_iterations % 10 == 0:
                    self.recorder.log(self.global_iterations, "train/lr",
                                      self.model.lr)
                self.global_iterations += 1
            self.save_ckpt(join(self.exp, f"model_{stage_name}.pth"))

    def log_in_training(self, batch_idx, batch_total, data, loss, output):
        global_time = time.time() - self.global_start_time
        self.recorder.log(self.global_iterations, "train/time", global_time)
        current_time = time.time() - getattr(self, "start_time", time.time())
        print(f"[{self.global_iterations:6d}: {batch_idx:6d}/{batch_total:6d}] "
              f"{current_time:4.1f}s loss: {loss:.4f} model {self.model}")
        self.start_time = time.time()
        self.recorder.log(self.global_iterations, "train/num_points",
                          self.model.num_points)
        self.log_device_memory()
        if self.cfg.get("log_pointcloud", False):
            self.log_point_cloud(output)
        if not self.save_vis:
            return
        vis = np.hstack([self.render.tensor_to_bgr(output["gt"]),
                         self.render.tensor_to_bgr(output["render"])])
        image_io.imwrite(os.path.join(
            self.exp, "vis", f"{self.global_iterations:06d}.jpg"), vis)
