"""Synthetic scenes: ground-truth images rendered from a known set of
Gaussians; counterpart of log_tpu/dataset/synthetic.py.

The scene and cameras come from numpy (the same draws as the JAX package for
one seed); the images are rendered with the port's oracle rasterizer
(ops/rasterize_ref.py) on the dataset's device, so a scene made on the card
stands in for one made by the JAX generator. Items follow ImageDataset's
contract ({'image', 'camera', 'index', 'imgname'}).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .base import prepare_camera


def ring_cameras(
    n_views: int,
    H: int,
    W: int,
    radius: float = 4.0,
    focal: float | None = None,
    center=(0.0, 0.0, 0.0),
    elevation: float = 0.35,
):
    """Cameras on a ring looking at `center` (z-up world)."""
    focal = focal or 1.2 * max(H, W)
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]], np.float64)
    center = np.asarray(center, np.float64)
    cams = []
    for i in range(n_views):
        theta = 2 * math.pi * i / n_views
        eye = center + radius * np.array(
            [math.cos(theta) * math.cos(elevation),
             math.sin(theta) * math.cos(elevation),
             math.sin(elevation)]
        )
        fwd = center - eye
        fwd = fwd / np.linalg.norm(fwd)
        up = np.array([0.0, 0.0, 1.0])
        right = np.cross(fwd, up)
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        R = np.stack([right, down, fwd], axis=0)  # world->cam rows
        T = -R @ eye[:, None]
        cams.append({"K": K.copy(), "R": R, "T": T, "W": W, "H": H,
                     "center": eye.reshape(3, 1)})
    return cams


def random_gaussians(n: int, rng, extent: float = 1.0, scale_range=(0.03, 0.12)):
    """A random but well-behaved Gaussian scene (activated space)."""
    xyz = rng.uniform(-extent, extent, size=(n, 3)).astype(np.float32)
    colors = rng.uniform(0.1, 0.9, size=(n, 3)).astype(np.float32)
    opacity = rng.uniform(0.5, 0.95, size=(n,)).astype(np.float32)
    scaling = rng.uniform(*scale_range, size=(n, 3)).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return {"xyz": xyz, "colors": colors, "opacity": opacity,
            "scaling": scaling, "rotation": q}


class SyntheticDataset:
    """GT images of a known scene through the oracle rasterizer."""

    def __init__(
        self,
        n_gaussians: int = 400,
        n_views: int = 12,
        H: int = 60,
        W: int = 80,
        seed: int = 0,
        background=(1.0, 1.0, 1.0),
        znear: float = 0.01,
        zfar: float = 100.0,
        device="cuda",
    ):
        from ..ops.rasterize_ref import rasterize

        rng = np.random.default_rng(seed)
        self.scene = random_gaussians(n_gaussians, rng)
        self.cameras = ring_cameras(n_views, H, W)
        self.background = np.asarray(background, np.float32)
        self.znear, self.zfar = znear, zfar
        self.read_img = True
        self.partial_indices = None
        self.scales = [1]
        self.images = []
        dev = torch.device(device)
        s = {k: torch.from_numpy(v).to(dev) for k, v in self.scene.items()}
        bg = torch.from_numpy(self.background).to(dev)
        with torch.no_grad():
            for cam in self.cameras:
                pc = prepare_camera(cam, 1, znear, zfar)
                tan_fovx = math.tan(pc["FoVx"] * 0.5)
                tan_fovy = math.tan(pc["FoVy"] * 0.5)
                out = rasterize(
                    xyz=s["xyz"], colors=s["colors"], opacity=s["opacity"],
                    scaling=s["scaling"], rotation=s["rotation"],
                    means2d_offset=torch.zeros((n_gaussians, 2), device=dev),
                    world_view=torch.from_numpy(pc["world_view_transform"]).to(dev),
                    full_proj=torch.from_numpy(pc["full_proj_transform"]).to(dev),
                    focal_x=pc["image_width"] / (2 * tan_fovx),
                    focal_y=pc["image_height"] / (2 * tan_fovy),
                    tan_fovx=tan_fovx, tan_fovy=tan_fovy, background=bg,
                    image_height=pc["image_height"],
                    image_width=pc["image_width"], use_filter=False,
                )
                self.images.append(out["render"].permute(1, 2, 0).float()
                                   .cpu().numpy())

    def set_state(self, **kwargs):
        pass

    def set_partial_indices(self, partial):
        self.partial_indices = partial

    def __len__(self):
        if self.partial_indices is not None:
            return len(self.partial_indices)
        return len(self.cameras)

    def __getitem__(self, index):
        true_index = (self.partial_indices[index]
                      if self.partial_indices is not None else index)
        camera = prepare_camera(self.cameras[true_index], 1, self.znear, self.zfar)
        return {
            "image": self.images[true_index] if self.read_img else None,
            "camera": camera,
            "index": index,
            "true_index": true_index,
            "imgname": f"synthetic/{true_index:04d}.jpg",
        }

    def noisy_pointcloud(self, rng=None, jitter: float = 0.02):
        """Init point cloud near the GT gaussians (for fit tests)."""
        rng = rng or np.random.default_rng(1)
        xyz = self.scene["xyz"] + rng.normal(0, jitter, self.scene["xyz"].shape)
        return {"xyz": xyz.astype(np.float32),
                "colors": self.scene["colors"].copy()}
