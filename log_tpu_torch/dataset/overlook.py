"""Overlook datasets (whole-scene renders from above); counterpart of
log_tpu/dataset/overlook.py. OverlookByScale: a log-spaced height sweep
above the scene; LookAt: an orbit with angle, radius and look-at
schedules."""
from __future__ import annotations

import numpy as np

from .camera_utils import rodrigues
from .demo import DemoBase


class OverlookByScale(DemoBase):
    def __init__(
        self,
        focal,
        shape,
        ground_height,
        rotate_x=0,
        lookat=(0, 0, 0),
        step=100,
        scales=(1, 2),
        border_length=1,
        axis_up="z",
        znear=0.01,
        zfar=100,
    ):
        super().__init__(znear=znear, zfar=zfar)
        lookat = list(lookat)
        lookat[2] += ground_height
        width, height = shape
        K = np.array(
            [[focal, 0, width / 2], [0, focal, height / 2], [0, 0, 1]], np.float32
        )
        if axis_up == "z":
            R = np.eye(3, dtype=np.float32)
        elif axis_up == "-z":
            R = np.diag([1.0, -1.0, -1.0]).astype(np.float32)
        else:
            raise ValueError(axis_up)
        scale_space = np.logspace(np.log10(scales[0]), np.log10(scales[1]), step)
        dist = focal / (scale_space * min(width, height)) * border_length
        sign = -1.0 if axis_up == "z" else 1.0
        z = sign * dist * np.cos(np.deg2rad(rotate_x)) + lookat[2]
        y = (-dist) * np.sin(np.deg2rad(rotate_x)) + lookat[1]
        x = np.zeros_like(z) + lookat[0]
        centers = np.stack([x, y, z], axis=-1)
        Rrel = rodrigues(np.deg2rad(np.array([rotate_x, 0.0, 0.0])))
        R = R @ Rrel
        infos = []
        for center_ in centers:
            center_ = center_.reshape(3, 1)
            infos.append(
                {
                    "camera": {
                        "K": K,
                        "R": R,
                        "T": -R @ center_,
                        "H": height,
                        "W": width,
                        "center": center_,
                    },
                    "scale": 1,
                }
            )
        self.infos = infos


class LookAt(DemoBase):
    def __init__(
        self,
        K,
        H,
        W,
        scale,
        lookat,
        radius,
        angle,
        znear=0.1,
        zfar=100.0,
        ranges=(0, 360, 181),
    ):
        super().__init__(znear=znear, zfar=zfar)
        K = np.array(K, np.float32)
        ranges = ranges if isinstance(ranges[0], (list, tuple)) else [ranges]
        xy_angle = np.deg2rad(
            np.concatenate([np.linspace(r[0], r[1], int(r[2])) for r in ranges])
        )
        radius = radius if isinstance(radius[0], (list, tuple)) else [radius]
        radius = np.concatenate(
            [np.logspace(np.log10(r[0]), np.log10(r[1]), int(r[2])) for r in radius]
        )
        if isinstance(lookat[0], (list, tuple)):
            start, end = np.array(lookat[0]), np.array(lookat[1])
            t = np.linspace(0, 1, radius.shape[0])
            lookat = start[None] * (1 - t[:, None]) + end[None] * t[:, None]
        else:
            lookat = np.array(lookat)[None].repeat(len(radius), 0)
        if isinstance(angle, (list, tuple)):
            angle_sched = np.linspace(angle[0], angle[1], radius.shape[0])
        else:
            angle_sched = np.full(radius.shape[0], angle)
        height = radius * np.cos(np.deg2rad(angle_sched))
        radius2d = radius * np.sin(np.deg2rad(angle_sched))
        x_ = radius2d * np.sin(xy_angle) + lookat[:, 0]
        y_ = radius2d * np.cos(xy_angle) + lookat[:, 1]
        z_ = np.zeros_like(x_) + lookat[:, 2] - height
        centers = np.stack([x_, y_, z_], axis=-1).reshape(-1, 3, 1).astype(np.float32)
        zaxis = lookat - centers.reshape(-1, 3)
        zaxis /= np.linalg.norm(zaxis, axis=-1, keepdims=True)
        world_up = np.array([[0.0, 0.0, -1.0]])
        right = np.cross(zaxis, world_up)
        right /= np.linalg.norm(right, axis=-1, keepdims=True)
        down = np.cross(zaxis, right)
        down /= np.linalg.norm(down, axis=-1, keepdims=True)
        infos = []
        for i in range(centers.shape[0]):
            R = np.stack([right[i], down[i], zaxis[i]], axis=0)
            infos.append(
                {
                    "camera": {
                        "K": K,
                        "R": R,
                        "T": -R @ centers[i],
                        "H": H,
                        "W": W,
                        "center": centers[i],
                    },
                    "scale": scale,
                }
            )
        self.infos = infos
