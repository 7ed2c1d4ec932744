"""Renderer; serving half of log_tpu/render/renderer.py.

`NaiveRendererAndLoss.vis` is the no-grad inference path of the demo, val
and viewer splits: one `LoG.render_fused` frame per camera of the batch.
The losses, `render_one` and the depth branch come with the training slice.
"""
from __future__ import annotations

import math
from collections import defaultdict

import numpy as np
import torch

CAMERA_KEYS = (
    "camera_center",
    "world_view_transform",
    "full_proj_transform",
    "image_width",
    "image_height",
    "FoVx",
    "FoVy",
    "K",
    "R",
    "T",
)


def camera_device(camera: dict, device="cuda") -> dict:
    """Host camera dict -> device matrices + host scalars for the render."""
    H = int(camera["image_height"])
    W = int(camera["image_width"])
    tan_fovx = math.tan(float(camera["FoVx"]) * 0.5)
    tan_fovy = math.tan(float(camera["FoVy"]) * 0.5)

    def dev(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return {
        "world_view": dev(camera["world_view_transform"]),
        "full_proj": dev(camera["full_proj_transform"]),
        "camera_center": dev(np.asarray(camera["camera_center"]).reshape(3)),
        "focal_x": W / (2.0 * tan_fovx),
        "focal_y": H / (2.0 * tan_fovy),
        "tan_fovx": tan_fovx,
        "tan_fovy": tan_fovy,
        "image_height": H,
        "image_width": W,
    }


class BaseRender:
    """Static visualization helpers."""

    @staticmethod
    def tensor_to_bgr(tensor):
        if isinstance(tensor, torch.Tensor):
            tensor = tensor.detach().cpu().numpy()
        vis = np.asarray(tensor).transpose(1, 2, 0)
        vis = (np.clip(vis[:, :, ::-1], 0.0, 1.0) * 255).astype(np.uint8)
        return np.ascontiguousarray(vis)


class NaiveRendererAndLoss(BaseRender):
    """Inference side of the 0.8 L1 + 0.2 SSIM training renderer."""

    def __init__(self, split="train", use_randback=False,
                 background=(0.0, 0.0, 0.0), use_rand_radius=False,
                 use_origin_render=False, render_depth=False, device="cuda"):
        # use_rand_radius and use_origin_render configure the training
        # renders; the fused frame renders in 'antialias' mode, as in the
        # JAX package
        self.split = split
        self.device = torch.device(device)
        self.use_randback = use_randback
        self.render_depth = render_depth
        self.background = np.asarray(background, np.float32)

    def set_state(self, render_depth=None, background=None):
        if render_depth is not None:
            self.render_depth = render_depth
        if background is not None:
            print(f"[{self.__class__.__name__}] Set background to {background}")
            self.background = np.asarray(background, np.float32)

    def prepare_camera(self, batch, bn, background=None, is_train=False,
                       generator: torch.Generator | None = None):
        """Camera bn of the batch, and its background (random in [0, 1)
        from `generator` for training with use_randback)."""
        camera = {key: np.asarray(batch["camera"][key])[bn]
                  for key in CAMERA_KEYS}
        if background is None:
            if is_train and self.use_randback:
                background = torch.rand(3, generator=generator).numpy()
            else:
                background = self.background
        return camera, np.asarray(background, np.float32)

    @torch.no_grad()
    def vis(self, batch, model, background=None):
        """Batch inference: one fused frame per camera. Returns host arrays
        'render' (B, 3, H, W), 'alpha' and 'mask' (B, H, W), quantized to
        8 bits on the device like the JAX package."""
        if self.render_depth or getattr(model, "training", False):
            raise NotImplementedError(
                "the two-phase render (depth maps, training-mode models) "
                "comes with the training slice; call model.eval() first"
            )
        preds = defaultdict(list)
        B = np.asarray(batch["camera"]["camera_center"]).shape[0]
        for bn in range(B):
            camera, bg = self.prepare_camera(batch, bn, background)
            out = model.render_fused(camera, bg)
            ren8 = (torch.clamp(out["render"], 0, 1) * 255).to(torch.uint8)
            alp8 = (torch.clamp(out["alpha"], 0, 1) * 255).to(torch.uint8)
            preds["render"].append(ren8.cpu().numpy().astype(np.float32) / 255.0)
            alpha = alp8.cpu().numpy().astype(np.float32) / 255.0
            preds["alpha"].append(alpha)
            preds["mask"].append(alpha)
        return {key: np.stack(val) for key, val in preds.items()}
