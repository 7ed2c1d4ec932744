"""Demo camera paths (orbit, zoom, LoD sweeps, B-spline fly-throughs);
counterpart of log_tpu/dataset/demo.py.

Each dataset returns {'index', 'camera'} items (and a per-frame
'model_state' for the LoD sweeps). `InterpolatePath` is the demo_interpolate
fly-through: a cubic B-spline through chosen camera poses with quaternion
hemisphere alignment. Host numpy and scipy.
"""
from __future__ import annotations

import os

import numpy as np

from .base import prepare_camera
from .camera_utils import read_cameras, rodrigues


class DemoBase:
    def __init__(self, znear=0.01, zfar=100.0):
        self.znear = znear
        self.zfar = zfar

    def __len__(self):
        return len(self.infos)

    def __getitem__(self, index):
        data = self.infos[index]
        camera = prepare_camera(data["camera"], data["scale"], self.znear, self.zfar)
        return {"index": index, "camera": camera}


def create_center_radius(
    center, radius=5.0, up="y", ranges=(0, 360, 36), angle_x=0, **kwargs
):
    center = np.array(center).reshape(1, 3)
    thetas = np.deg2rad(np.linspace(*ranges))
    st, ct = np.sin(thetas), np.cos(thetas)
    zero = np.zeros_like(st)
    rot_x = rodrigues(np.deg2rad(angle_x) * np.array([1.0, 0.0, 0.0]))
    if up == "z":
        centers = np.stack([radius * ct, radius * st, zero], axis=1) + center
        R = np.stack(
            [-st, ct, zero, zero, zero, zero - 1, -ct, -st, zero], axis=-1
        )
    elif up == "y":
        centers = np.stack([radius * ct, zero, radius * st], axis=1) + center
        R = np.stack(
            [+st, zero, -ct, zero, zero - 1, zero, -ct, zero, -st], axis=-1
        )
    else:
        raise ValueError(up)
    R = R.reshape(-1, 3, 3)
    R = np.einsum("ab,fbc->fac", rot_x, R)
    centers = centers.reshape(-1, 3, 1)
    T = -R @ centers
    return np.dstack([R, T])


class DemoDataset(DemoBase):
    """Orbit around a center."""

    def __init__(
        self,
        size=2048,
        znear=0.1,
        zfar=100.0,
        radius=3.0,
        ranges=(0, 360, 45),
        center=(0, 0, 0.0),
        focal=-1,
        focal_scale=1.0,
    ):
        super().__init__(znear, zfar)
        if focal == -1:
            focal = size * focal_scale
        K = np.array([[focal, 0, size // 2], [0, focal, size // 2], [0, 0, 1]])
        RT = create_center_radius(center, radius=radius, up="z", ranges=ranges)
        self.infos = [
            {
                "camera": {
                    "R": RT[i, :3, :3],
                    "T": RT[i, :3, 3:4],
                    "K": K,
                    "W": size,
                    "H": size,
                    "center": -RT[i, :3, :3].T @ RT[i, :3, 3:4],
                },
                "scale": 1,
            }
            for i in range(RT.shape[0])
        ]


class GivenTrajs(DemoBase):
    def __init__(self, cameras, znear=0.01, zfar=100, scale3d=1.0):
        super().__init__(znear, zfar)
        cameras = read_cameras(cameras)
        infos = []
        for camera in cameras.values():
            camera["T"] = camera["T"] * scale3d
            center = -camera["R"].T @ camera["T"]
            infos.append(
                {
                    "camera": {
                        "K": camera["K"],
                        "R": camera["R"],
                        "T": camera["T"],
                        "H": camera["H"],
                        "W": camera["W"],
                        "center": center,
                    },
                    "scale": 4,
                }
            )
        self.infos = infos


class ComposeDataset(DemoBase):
    def __init__(self, datasets):
        super().__init__()
        from ..utils.config import load_object

        infos = []
        for dataset in datasets:
            _dataset = load_object(dataset["module"], dataset["args"])
            infos.extend(_dataset.infos)
        self.infos = infos


class ZoomInOut(DemoBase):
    """Log- or linear-space dolly along a view direction."""

    def __init__(
        self,
        cameras,
        sub,
        zranges,
        scale=1,
        steps=100,
        znear=0.01,
        zfar=100.0,
        direction=(0.0, 0.0, 1.0),
        H=-1,
        W=-1,
        use_logspace=True,
    ):
        super().__init__(znear, zfar)
        cameras = read_cameras(cameras)
        camera = cameras[sub]
        zdir = np.array(direction).reshape(3, 1)
        zdir = zdir / np.linalg.norm(zdir)
        zdir = camera["R"].T @ zdir
        if use_logspace:
            zr = np.log(np.linspace(np.exp(zranges[0]), np.exp(zranges[1]), steps))
        else:
            zr = np.linspace(zranges[0], zranges[1], steps)
        H = camera["H"] if H == -1 else H
        W = camera["W"] if W == -1 else W
        infos = []
        for z in zr:
            R, T = camera["R"], camera["T"]
            center_new = (-R.T @ T) + zdir * z
            infos.append(
                {
                    "camera": {
                        "R": R,
                        "T": -R @ center_new,
                        "K": camera["K"],
                        "H": H,
                        "W": W,
                        "center": center_new,
                    },
                    "scale": scale,
                }
            )
        self.infos = infos


class ShowLevel(DemoBase):
    """Fixed camera; a per-frame model_state sweeps the LoD level or the
    pixel threshold."""

    def __init__(self, cameras, sub, steps=300, scale=1, znear=0.01, zfar=100,
                 mode="level"):
        super().__init__(znear, zfar)
        cameras = read_cameras(cameras)
        camera = cameras[sub]
        self.pixel_max = 6
        self.mode = mode
        center = -camera["R"].T @ camera["T"]
        self.infos = [
            {
                "camera": {
                    "R": camera["R"],
                    "T": camera["T"],
                    "K": camera["K"],
                    "H": camera["H"],
                    "W": camera["W"],
                    "center": center,
                },
                "scale": scale,
            }
            for _ in range(steps)
        ]

    def __getitem__(self, index):
        ret = super().__getitem__(index)
        if self.mode == "pixel":
            ret["model_state"] = {
                "min_resolution_pixel": 2 ** ((1 - index / len(self)) * self.pixel_max)
            }
        else:
            ret["model_state"] = {"current_depth": index}
        return ret


class GivenKRCenter(DemoBase):
    """Interpolated K/R/center path."""

    def __init__(self, K, R, center, H, W, steps, scale=1):
        super().__init__(0.01, 100.0)
        K = np.array(K, np.float64)
        R = np.array(R, np.float64)
        center = np.array(center, np.float64)
        t = np.linspace(0, 1, steps)

        def expand(x, rank):
            if x.ndim == rank:
                return np.repeat(x[None], steps, axis=0)
            if x.ndim == rank + 1 and x.shape[0] == 2:
                return np.stack([x[0] + (x[1] - x[0]) * ti for ti in t])
            assert x.shape[0] == steps
            return x

        K = expand(K, 2)
        R = expand(R, 2)
        center = expand(center, 1)
        self.infos = [
            {
                "camera": {
                    "K": K[i],
                    "R": R[i],
                    "T": -R[i] @ center[i].reshape(3, 1),
                    "H": H,
                    "W": W,
                    "center": center[i].reshape(3, 1),
                },
                "scale": scale,
            }
            for i in range(steps)
        ]


# --------------------------------------------------- B-spline interpolation
def cubic_bspline_weights(us, N):
    """Uniform cubic B-spline sample weights."""
    us = np.asarray(us, np.float64)
    t = (N - 1) * us
    i0 = np.floor(t).astype(np.int32) - 1
    i0 = np.where(us != 1.0, i0, i0 - 1)
    i1, i2, i3 = i0 + 1, i0 + 2, i0 + 3
    i0, i1, i2, i3 = (np.clip(i, 0, N - 1) for i in (i0, i1, i2, i3))
    t = (t - i1).astype(np.float32)
    tt = t * t
    ttt = tt * t
    a = (1 - t) ** 3 / 6.0
    b = (3 * ttt - 6 * tt + 4) / 6.0
    c = (-3 * ttt + 3 * tt + 3 * t + 1) / 6.0
    d = ttt / 6.0
    return (i0, i1, i2, i3), (a, b, c, d)


def interpolate_camera_path(c2ws: np.ndarray, steps=50, smoothing_term=10.0):
    """Cubic B-spline through c2w poses with quaternion hemisphere
    fixing."""
    from scipy.spatial.transform import Rotation

    N = len(c2ws)
    assert N > 3, "cubic spline needs >= 4 control poses"
    us = np.linspace(0, 1, steps)
    (i0, i1, i2, i3), (a, b, c, d) = cubic_bspline_weights(us, N)
    Q = Rotation.from_matrix(c2ws[..., :3, :3]).as_quat()
    T = c2ws[..., :3, 3]

    def blend(idxs, ws):
        q_acc = None
        t_acc = None
        for idx, w in zip(idxs, ws):
            qi = Q[idx]
            ti = T[idx]
            if q_acc is None:
                q_acc = w[..., None] * qi
                t_acc = w[..., None] * ti
            else:
                qi = np.where((q_acc * qi).sum(-1, keepdims=True) < 0, -qi, qi)
                q_acc = q_acc + w[..., None] * qi
                t_acc = t_acc + w[..., None] * ti
        return q_acc, t_acc

    q, tr = blend((i0, i1, i2, i3), (a, b, c, d))
    Rm = Rotation.from_quat(q).as_matrix()
    return np.concatenate([Rm, tr[..., None]], axis=-1).astype(np.float32)


class InterpolatePath(DemoBase):
    """Fly-through along a B-spline through selected cameras."""

    def __init__(
        self,
        cameras,
        subs=(),
        steps=300,
        znear=0.1,
        zfar=100.0,
        scale=1,
        scale3d=1.0,
        H=-1,
        W=-1,
        ref_cam=None,
    ):
        super().__init__(znear=znear, zfar=zfar)
        if os.path.isdir(cameras):
            cameras = read_cameras(cameras)
        elif os.path.isfile(cameras):
            cameras = read_cameras(os.path.dirname(cameras))
        Rlist, Tlist = [], []
        if len(subs) == 0:
            subs = list(cameras.keys())
        for sub in subs:
            if isinstance(sub, str):
                Rlist.append(cameras[sub]["R"])
                Tlist.append(cameras[sub]["T"][:, 0])
            else:  # dict with adjustments
                R = cameras[sub["name"]]["R"]
                T = cameras[sub["name"]]["T"][:, 0]
                center = -R.T @ T[:, None]
                if "rotate_axis" in sub:
                    axis = {"z": [0.0, 0.0, 1.0], "x": [1.0, 0.0, 0.0]}[
                        sub["rotate_axis"]
                    ]
                    rotation = rodrigues(
                        np.deg2rad(sub["rotate_angle"] * np.array(axis)))
                    R = rotation @ R
                    T = (-R @ center)[:, 0]
                if "translation" in sub:
                    center = center + np.array(sub["translation"]).reshape(3, 1) / scale3d
                    T = (-R @ center)[:, 0]
                Rlist.append(R)
                Tlist.append(T)
        Rlist = np.stack(Rlist)
        Tlist = np.stack(Tlist) * scale3d
        centerlist = np.einsum("ijk,ik->ij", Rlist.transpose(0, 2, 1), -Tlist)
        c2w = np.dstack([Rlist.transpose(0, 2, 1), centerlist[..., None]])
        path = interpolate_camera_path(c2w, steps=steps, smoothing_term=5.0)
        Rres = path[:, :3, :3].transpose(0, 2, 1)
        Tres = path[:, :3, 3:]
        ref_cam = ref_cam or list(cameras.keys())[0]
        K = cameras[ref_cam]["K"]
        first = cameras[list(cameras.keys())[0]]
        H = first["H"] if H == -1 else H
        W = first["W"] if W == -1 else W
        infos = []
        for i in range(Rres.shape[0]):
            R = Rres[i]
            center = Tres[i].reshape(3, 1)
            infos.append(
                {
                    "camera": {
                        "R": R,
                        "T": -R @ center,
                        "K": K,
                        "H": H,
                        "W": W,
                        "center": center,
                    },
                    "scale": scale,
                }
            )
        self.infos = infos
