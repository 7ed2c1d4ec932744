"""Gaussian point state: capacity-padded device tensors; serving half of
log_tpu/model/gaussian.py.

The point axis is padded to a quantized capacity (powers of two with one
midpoint per octave) and carries a `num_points` alive count. The JAX package
pads so that XLA compiles one executable per bucket; the port keeps the same
buckets because they decide the LoD-cut budget and therefore truncation.
"""
from __future__ import annotations

import numpy as np
import torch

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
        if init_ply is not None:
            raise NotImplementedError(
                "point-cloud initialization belongs to the training slice "
                "(ROADMAP queue 1); load a checkpoint instead"
            )
        self.device = torch.device(device)
        self.xyz_scale = xyz_scale
        self.max_sh_degree = sh_degree
        self.active_sh_degree = 0
        self.activation = Activation(scaling_activation)
        self.keys: list[str] = []
        self._data: dict[str, torch.Tensor] = {}
        self.num_points = 0
        self.capacity = 0

    def get(self, key):
        return self._data[key]

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
