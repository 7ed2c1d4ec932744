"""Renderer; counterpart of log_tpu/render/renderer.py.

`NaiveRendererAndLoss.vis` is the no-grad inference path of the demo, val
and overlook renders: one `LoG.render_fused` frame per camera for a model in
eval mode, and for a model in training mode the two-phase render
(`LoG.prepare_from_camera`, then `render_one`). `render_one` renders the
prepared LoD cut with `rasterize_tiled(with_stats=False)` (or the oracle
where the backend is "reference"); validation calls it. `prepare_camera`
gives the training step its camera and its background (random under
`use_randback`, drawn from the caller's numpy Generator); the loss runs
inside the training step (model/train_step.py). `MaskForeground` crops
validation to the mask's box. With `render_depth`, `vis` takes the
two-phase render in either mode and renders (camera depth, world z, 1) as
colors over a zero background after each frame, into preds "depth",
"height" and "accmap"; `marigold_depth_vis` colors such a map with
matplotlib's Spectral colormap from the port's own copy of its table.
"""
from __future__ import annotations

import math
from collections import defaultdict

import numpy as np
import torch

from ..utils import image_io

# matplotlib's "Spectral" colormap (ColorBrewer's 11 classes) as 8-bit
# anchors; matplotlib spaces them evenly over [0, 1] and interpolates a
# 256-entry table between them (LinearSegmentedColormap.from_list)
SPECTRAL_ANCHORS = (
    (158, 1, 66), (213, 62, 79), (244, 109, 67), (253, 174, 97),
    (254, 224, 139), (255, 255, 191), (230, 245, 152), (171, 221, 164),
    (102, 194, 165), (50, 136, 189), (94, 79, 162),
)
LUT_SIZE = 256


def spectral_lut(n: int = LUT_SIZE) -> np.ndarray:
    """(n + 3, 3) float64 table: matplotlib's lookup table of the Spectral
    colormap (its _create_lookup_table, in the same float64 operations),
    then the colors below 0 (the first entry), above 1 (the last) and of
    NaN (black)."""
    y = np.asarray(SPECTRAL_ANCHORS, np.float64) / 255.0
    x = np.linspace(0, 1, len(y)) * (n - 1)
    xind = (n - 1) * np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([y[:1], distance[:, None] * (y[ind] - y[ind - 1])
                          + y[ind - 1], y[-1:]])
    lut = np.clip(lut, 0.0, 1.0)
    return np.concatenate([lut, lut[:1], lut[-1:], np.zeros((1, 3))])


def colormap_spectral(values) -> np.ndarray:
    """RGB floats of matplotlib.colormaps["Spectral"](values)[..., :3] for a
    float array: value * 256 truncated to an entry (1.0 the last), the
    first entry below 0, the last above 1, black for NaN."""
    xa = np.array(values, copy=True)
    if xa.dtype.kind != "f":
        raise TypeError(f"colormap_spectral takes floats, not {xa.dtype}")
    xa *= LUT_SIZE
    xa[xa == LUT_SIZE] = LUT_SIZE - 1
    under, over, bad = xa < 0, xa >= LUT_SIZE, np.isnan(xa)
    with np.errstate(invalid="ignore"):
        xa = xa.astype(int)
    xa[under] = LUT_SIZE
    xa[over] = LUT_SIZE + 1
    xa[bad] = LUT_SIZE + 2
    return spectral_lut().take(xa, axis=0, mode="clip")


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
    def float32_to_uint8(array):
        return np.clip(array * 255, 0, 255).astype(np.uint8)

    @staticmethod
    def tensor_to_bgr(tensor):
        if isinstance(tensor, torch.Tensor):
            tensor = tensor.detach().cpu().numpy()
        vis = np.asarray(tensor).transpose(1, 2, 0)
        vis = (np.clip(vis[:, :, ::-1], 0.0, 1.0) * 255).astype(np.uint8)
        return np.ascontiguousarray(vis)

    @staticmethod
    def marigold_depth_vis(tensor, cmap="Spectral"):
        """8-bit Spectral colors of a map normalized to [0, 1], in RGB
        order (the JAX package writes these bytes with cv2.imwrite, which
        reads them as BGR; the port's demo keeps the same bytes)."""
        if cmap != "Spectral":
            raise ValueError(f"only the Spectral colormap is kept: {cmap}")
        if isinstance(tensor, torch.Tensor):
            tensor = tensor.detach().cpu().numpy()
        return BaseRender.float32_to_uint8(colormap_spectral(tensor))

    @staticmethod
    def make_video(path, remove_image=False, fps=30):
        image_io.make_video(path, fps)


class NaiveRendererAndLoss(BaseRender):
    """Inference side of the 0.8 L1 + 0.2 SSIM training renderer."""

    def __init__(self, split="train", use_randback=False,
                 background=(0.0, 0.0, 0.0), use_rand_radius=False,
                 use_origin_render=False, render_depth=False, device="cuda"):
        # use_rand_radius: the trainer jitters the LoD pixel threshold per
        # step; use_origin_render selects the Inria dilation for the
        # two-phase render; the fused frame and the training step render in
        # 'antialias' mode, as in the JAX package
        self.split = split
        self.device = torch.device(device)
        self.use_randback = use_randback
        self.use_rand_radius = use_rand_radius
        self.mode = "original" if use_origin_render else "antialias"
        self.use_origin_render = use_origin_render
        self.iteration = 0
        self.render_depth = render_depth
        self.background = np.asarray(background, np.float32)

    def set_state(self, render_depth=None, background=None):
        if render_depth is not None:
            self.render_depth = render_depth
        if background is not None:
            print(f"[{self.__class__.__name__}] Set background to {background}")
            self.background = np.asarray(background, np.float32)

    def prepare_camera(self, batch, bn, background=None, is_train=False,
                       rng: np.random.Generator | None = None):
        """Camera bn of the batch, and its background: for training with
        use_randback three uniform draws from `rng` (the trainer's
        Generator), else the renderer's."""
        camera = {key: np.asarray(batch["camera"][key])[bn]
                  for key in CAMERA_KEYS}
        if background is None:
            if is_train and self.use_randback:
                if rng is None:
                    raise ValueError("a random background needs the caller's "
                                     "numpy Generator (rng)")
                background = rng.random(3).astype(np.float32)
            else:
                background = self.background
        return camera, np.asarray(background, np.float32)

    # ------------------------------------------------------------ inference
    @torch.no_grad()
    def render_one(self, model, camera, background, extra_colors=None):
        """Render of the LoD cut that `model.prepare_from_camera(camera)`
        left in `model.visibility_flag`, with the model's colors or, where
        given, extra_colors (capacity, C). Returns device tensors ('render'
        (C, H, W), 'alpha' (H, W), 'depth_cam' (capacity,), ...)."""
        from ..ops import pick_backend, pick_max_pairs, rasterize_ref

        cam = camera_device(camera, model.device)
        vf = model.visibility_flag
        params = model.gaussian.params()
        act = model.gaussian.activation
        colors = act.colors_activation(params, cam["camera_center"],
                                       model.gaussian.active_sh_degree)
        kwargs = dict(
            xyz=params["xyz"],
            colors=colors if extra_colors is None else extra_colors,
            opacity=act.opacity_activation(params["opacity"][:, 0]),
            scaling=act.scaling_activation(params["scaling"]),
            rotation=act.rotation_activation(params["rotation"]),
            means2d_offset=torch.zeros_like(params["xyz"][:, :2]),
            world_view=cam["world_view"], full_proj=cam["full_proj"],
            focal_x=cam["focal_x"], focal_y=cam["focal_y"],
            tan_fovx=cam["tan_fovx"], tan_fovy=cam["tan_fovy"],
            background=torch.as_tensor(np.asarray(background, np.float32),
                                       device=model.device),
            image_height=cam["image_height"], image_width=cam["image_width"],
            active_mask=vf["keep_mask"], mode=self.mode, use_filter=False,
        )
        # the pair budget from the prepared cut's kept count
        k_budget = max(int(vf["counts"][0]) + int(vf["counts"][1]), 1)
        if pick_backend(model.capacity, model.device) == "tiled":
            from ..ops.rasterize_tiled import rasterize_tiled

            return rasterize_tiled(**kwargs,
                                   max_pairs=pick_max_pairs(k_budget),
                                   with_stats=False)
        return rasterize_ref.rasterize(**kwargs)

    @torch.no_grad()
    def vis(self, batch, model, background=None):
        """Batch inference: per camera, one fused frame (eval mode) or the
        two-phase render (training mode, or with render_depth). Returns host
        arrays 'render' (B, 3, H, W), 'alpha' and 'mask' (B, H, W),
        quantized to 8 bits on the device like the JAX package, and with
        render_depth the float maps 'depth' (composited camera depth),
        'height' (world z) and 'accmap' (accumulated opacity), (B, H, W),
        rendered over a zero background."""
        preds = defaultdict(list)
        B = np.asarray(batch["camera"]["camera_center"]).shape[0]
        fused = not (getattr(model, "training", False) or self.render_depth)
        for bn in range(B):
            camera, bg = self.prepare_camera(batch, bn, background)
            if fused:
                out = model.render_fused(camera, bg)
            else:
                model.prepare_from_camera(camera)
                out = self.render_one(model, camera, bg)
            ren8 = (torch.clamp(out["render"], 0, 1) * 255).to(torch.uint8)
            alp8 = (torch.clamp(out["alpha"], 0, 1) * 255).to(torch.uint8)
            preds["render"].append(ren8.cpu().numpy().astype(np.float32) / 255.0)
            alpha = alp8.cpu().numpy().astype(np.float32) / 255.0
            preds["alpha"].append(alpha)
            preds["mask"].append(alpha)
            if self.render_depth:
                xyz = model.gaussian.params()["xyz"]
                cols = torch.stack([out["depth_cam"], xyz[:, 2],
                                    torch.ones_like(xyz[:, 2])], dim=-1)
                aux = self.render_one(model, camera, np.zeros(3, np.float32),
                                      extra_colors=cols)["render"].cpu()
                for c, key in enumerate(("depth", "height", "accmap")):
                    preds[key].append(aux[c].numpy())
        return {key: np.stack(val) for key, val in preds.items()}

    def process_gt(self, batch):
        img = np.asarray(batch["image"])
        return img.transpose(0, 3, 1, 2)

    def process_pred(self, batch, pred):
        return pred


class MaskForeground(NaiveRendererAndLoss):
    """Object-centric variant: validation crops the render and the GT to the
    mask's box and composites the background into the GT; training
    restricts the loss to the padded mask box inside the step (the trainer
    passes the batch mask through when `foreground_crop` is set)."""

    foreground_crop = True

    @staticmethod
    def bound_from_mask(msk, padding):
        msk_hw = msk[0, :, :, 0] > 0.5
        cols = np.where(msk_hw.any(axis=0))[0]
        rows = np.where(msk_hw.any(axis=1))[0]
        l, r = max(cols[0] - padding, 0), cols[-1] + padding
        t, b = max(rows[0] - padding, 0), rows[-1] + padding
        return int(l), int(t), int(r), int(b)

    def process_gt(self, batch):
        msk = np.asarray(batch["mask"])[..., None]
        l, t, r, b = self.bound_from_mask(msk, padding=0)
        gt = np.asarray(batch["image"])
        gt = gt * msk + (1 - msk) * self.background[None, None, None]
        gt = gt[:, t:b + 1, l:r + 1]
        return gt.transpose(0, 3, 1, 2)

    def process_pred(self, batch, pred):
        msk = np.asarray(batch["mask"])[..., None]
        l, t, r, b = self.bound_from_mask(msk, padding=0)
        return pred[:, t:b + 1, l:r + 1]
