"""Gaussian point state: capacity-padded device tensors, the point-cloud
init and the SH schedule; counterpart of log_tpu/model/gaussian.py.

The point axis is padded to a quantized capacity (powers of two with one
midpoint per octave) and carries a `num_points` alive count. The JAX package
pads so that XLA compiles one executable per bucket; the port keeps the same
buckets because they decide the LoD-cut budget and therefore truncation.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.sh import C0 as SH_C0
from ..utils.file import create_from_point
from .activation import Activation


def next_capacity(n: int, minimum: int = 256) -> int:
    """Smallest c in {2^k, 1.5*2^k} with c >= max(n, minimum)."""
    n = max(int(n), minimum)
    c = minimum
    while c < n:
        if c + c // 2 >= n:
            return c + c // 2
        c *= 2
    return c


def pad_rows(arr: np.ndarray, capacity: int, fill=0.0) -> np.ndarray:
    n = arr.shape[0]
    if n == capacity:
        return arr
    if n > capacity:
        raise ValueError(f"{n} rows do not fit capacity {capacity}")
    out = np.full((capacity,) + arr.shape[1:], fill, dtype=arr.dtype)
    out[:n] = arr
    return out


class GaussianPoint:
    """Point-attribute store (param space) on one device."""

    def __init__(self, init_ply=None, sh_degree: int = 1,
                 xyz_scale: float = 1.0, scaling_activation: str = "exp",
                 device="cuda") -> None:
        self.device = torch.device(device)
        self.xyz_scale = xyz_scale
        self.max_sh_degree = sh_degree
        self.active_sh_degree = 0
        self.activation = Activation(scaling_activation)
        self.keys: list[str] = []
        self._data: dict[str, torch.Tensor] = {}
        self.num_points = 0
        self.capacity = 0
        if init_ply is not None:
            xyz, colors, scales = create_from_point(**init_ply)
            self.register_by_pointcloud(xyz, colors, scales, **init_ply)

    def get(self, key):
        return self._data[key]

    def set(self, key, value):
        """Replace one capacity-padded parameter tensor (the train step's
        write-back)."""
        self._data[key] = value

    def items(self):
        for key in self.keys:
            yield key, self._data[key]

    @property
    def alive_mask(self) -> torch.Tensor:
        """(capacity,) bool: the rows below num_points."""
        return torch.arange(self.capacity, device=self.device) < self.num_points

    def params(self) -> dict:
        """Capacity-padded param dict."""
        return {k: self._data[k] for k in self.keys}

    def set_numpy(self, arrays: dict[str, np.ndarray]) -> None:
        """Replace state from exact-size host arrays; re-pads to capacity."""
        n = arrays[self.keys[0]].shape[0]
        self.num_points = int(n)
        self.capacity = next_capacity(n)
        for key, val in arrays.items():
            padded = pad_rows(np.asarray(val, np.float32), self.capacity)
            self._data[key] = torch.from_numpy(padded).to(self.device)

    def to_numpy(self, keys=None) -> dict[str, np.ndarray]:
        """Exact-size host copies of the param arrays."""
        keys = keys or self.keys
        return {k: self._data[k][: self.num_points].cpu().numpy()
                for k in keys}

    def set_device(self, arrays: dict, num_points: int, capacity: int) -> None:
        """Replace the state with capacity-padded tensors on the model's
        device (the device densify's rebuild, no host round trip)."""
        for key, val in arrays.items():
            if val.shape[0] != capacity:
                raise ValueError(f"{key}: {tuple(val.shape)} rows, capacity "
                                 f"{capacity}")
        self.num_points = int(num_points)
        self.capacity = int(capacity)
        self._data.update(arrays)

    # ------------------------------------------------------------- init
    @staticmethod
    def init_rotation(num_points: int) -> np.ndarray:
        rot = np.zeros((num_points, 4), dtype=np.float32)
        rot[:, 0] = 1.0
        return rot

    @staticmethod
    def create_from_ground(local_min, local_max, init_step, height,
                           init_opacity=0.9, padding=0.05):
        """A ground-plane grid of points under the cloud: (xyz, colors,
        activated scaling, opacity)."""
        x = np.arange(local_min[0] - padding, local_max[0] + padding, init_step)
        y = np.arange(local_min[1] - padding, local_max[1] + padding, init_step)
        gx, gy = np.meshgrid(x, y, indexing="ij")
        xy = np.stack([gx, gy], axis=-1).reshape(-1, 2)
        xyz = np.concatenate(
            [xy, np.full((xy.shape[0], 1), height, np.float32)], axis=1
        ).astype(np.float32)
        colors = np.full_like(xyz, 0.5)
        scaling = np.full_like(xyz, init_step)
        scaling[:, 2] = init_step * 0.1
        opacity = np.full((xyz.shape[0], 1), init_opacity, np.float32)
        return xyz, colors, scaling, opacity

    def log_radius(self, scales) -> str:
        s = np.asarray(scales)
        return f"scales: [{s.min():.4f}~{s.mean():.4f}~{s.max():.4f}]"

    def register_by_pointcloud(self, xyz, colors, scales, init_opacity=0.1,
                               **init_ply) -> None:
        """The parameters of a point cloud, on the host in numpy and
        uploaded once: scales clipped to [mean/4, mean*4] and repeated on
        the three axes (log), colors as the SH DC term, opacity init_opacity
        (logit), identity rotations, zero SH; with `height` in init_ply, a
        ground grid is appended."""
        print(f"[{self.__class__.__name__}] {self.log_radius(scales)}")
        scales = np.clip(scales, scales.mean() / 4, scales.mean() * 4)
        print(f"[{self.__class__.__name__}] -> {self.log_radius(scales)}")

        def np_logit(x):
            return np.log(x / (1.0 - x))

        scaling = np.log(scales)[:, None].repeat(3, axis=1)
        colors = (np.asarray(colors) - 0.5) / SH_C0
        xyz = np.asarray(xyz, np.float32)
        opacity = np_logit(np.full((xyz.shape[0], 1), init_opacity, np.float32))
        rotation = self.init_rotation(xyz.shape[0])
        n_coef = (self.max_sh_degree + 1) ** 2 - 1
        shs = np.zeros((xyz.shape[0], n_coef, 3), np.float32)
        if "height" in init_ply:
            local_min, local_max = xyz.min(axis=0), xyz.max(axis=0)
            g_xyz, g_col, g_scal, g_op = self.create_from_ground(
                local_min, local_max, init_ply["init_step"],
                init_ply["height"], init_ply.get("ground_opacity", 0.9),
            )
            print(f"[{self.__class__.__name__}] add {g_xyz.shape[0]} ground "
                  f"points")
            xyz = np.concatenate([xyz, g_xyz])
            opacity = np.concatenate([opacity, np_logit(g_op)])
            colors = np.concatenate([colors, (g_col - 0.5) / SH_C0])
            scaling = np.concatenate([scaling, np.log(g_scal)])
            rotation = np.concatenate(
                [rotation, self.init_rotation(g_xyz.shape[0])])
            shs = np.concatenate(
                [shs, np.zeros((g_xyz.shape[0],) + shs.shape[1:], np.float32)])
        arrays = {
            "scaling": scaling.astype(np.float32),
            "colors": colors.astype(np.float32),
            "xyz": xyz.astype(np.float32),
            "opacity": opacity.astype(np.float32),
            "rotation": rotation.astype(np.float32),
        }
        self.keys = ["scaling", "colors", "xyz", "opacity", "rotation"]
        if self.max_sh_degree > 0:
            arrays["shs"] = shs
            self.keys.append("shs")
        self.set_numpy(arrays)

    # ----------------------------------------------------------- schedule
    def oneupSHdegree(self) -> None:
        if self.active_sh_degree < self.max_sh_degree:
            self.active_sh_degree += 1
            print(f"[{self.__class__.__name__}] one up SH degree to "
                  f"{self.active_sh_degree}")
