"""Densification statistics: the per-step update and the host container;
counterpart of log_tpu/model/counter.py.

`update_counter` takes one training view's render statistics and updates the
per-point counters at the slice's global rows. Slice lanes that carry the
out-of-range sentinel (index == capacity) drop, as the JAX package's
`mode="drop"` scatters do: every scatter runs into a copy of the counter
with one spare row at the sentinel, which is then cut off.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.profiler import span
from .gaussian import pad_rows

COUNTER_KEYS = (
    "weights_max",
    "weights_sum",
    "grad_sum",
    "radii_max",
    "visible_count",
    "radii_max_max",
    "area_sum",
    "radius3d_min",
    "radius3d_max",
    "create_steps",
)
# keys cleared by Counter.reset (radius3d_min/max and create_steps persist)
RESET_KEYS = (
    "weights_max",
    "weights_sum",
    "radii_max",
    "radii_max_max",
    "area_sum",
    "grad_sum",
    "visible_count",
)
_FILL_ONE = ("radius3d_min", "radius3d_max")


def init_counter(num_points: int) -> dict[str, np.ndarray]:
    z = np.zeros((num_points,), np.float32)
    zi = np.zeros((num_points,), np.int32)
    return {
        "weights_max": z.copy(),
        "weights_sum": z.copy(),
        "grad_sum": z.copy(),
        "radii_max": zi.copy(),
        "visible_count": zi.copy(),
        "radii_max_max": zi.copy(),
        "area_sum": zi.copy(),
        "radius3d_min": z.copy() + 1,
        "radius3d_max": z.copy() + 1,
        "create_steps": zi.copy(),
    }


def str_min_mean_max(name, data) -> str:
    """One log line: count, min, mean + std and max of data."""
    data = np.asarray(data, np.float64)
    if data.size == 0:
        return f"{name:10s} 0 [empty]"
    return (
        f"{name:10s} {data.shape[0]:8d} [{data.min():.5f}~{data.mean():.5f}"
        f"+{data.std():.5f}~{data.max():.5f}]"
    )


def _scatter_drop(arr, index, values, reduce: str):
    """arr with values scattered at index (reduce 'sum' or 'amax'); indices
    equal to len(arr) drop."""
    out = torch.cat([arr, arr.new_zeros((1,))])
    out.scatter_reduce_(0, index.to(torch.int64), values.to(arr.dtype),
                        reduce=reduce)
    return out[:-1]


def update_counter(counter: dict, visible_index, radii, point_weight,
                   point_id_pixel, grad_means2d, identity: bool = False):
    """One training view's statistics update.

    visible_index: (K,) global rows of the render slice, the sentinel
      (capacity) on padding lanes. radii / point_weight: (K,) rasterizer
      outputs. point_id_pixel: (H, W) slice id of each pixel's argmax
      contributor (-1 empty). grad_means2d: (K, 2) NDC screen-space
      gradient of the slice.
    identity: the caller guarantees visible_index == arange(capacity) (the
      train step's identity path): the per-lane updates are elementwise and
      only the pixel-ownership histogram is a scatter.
    Returns the updated counter dict (new tensors).
    """
    K = radii.shape[0]
    capacity = counter["weights_max"].shape[0]
    pid = point_id_pixel.reshape(-1).to(torch.int64)
    pid = torch.where(pid >= 0, pid, K)  # -1 would wrap; push out of range
    # per-lane pixel ownership count (the reference's torch.unique counts)
    # bincount waits for the device twice (its min and its max): a span
    # for each wait
    with span("sync.counter_bincount"), span("sync.counter_bincount"):
        point_count = torch.bincount(pid, minlength=K + 1)[:K].to(torch.int32)

    flag_vis = radii > 0
    grad_norm = torch.sqrt(torch.sum(grad_means2d[:, :2] ** 2, dim=-1))
    ga = grad_norm * point_count.to(grad_norm.dtype)
    has_area = point_count > 0
    radii_i = radii.to(torch.int32)
    new = dict(counter)
    if identity:
        vis_i = flag_vis.to(torch.int32)
        new["area_sum"] = counter["area_sum"] + torch.where(
            has_area, point_count, 0)
        new["grad_sum"] = counter["grad_sum"] + torch.where(has_area, ga, 0.0)
        new["radii_max_max"] = torch.where(
            has_area, torch.maximum(counter["radii_max_max"], point_count),
            counter["radii_max_max"])
        new["create_steps"] = counter["create_steps"] + vis_i
        new["visible_count"] = counter["visible_count"] + vis_i
        new["weights_max"] = torch.where(
            flag_vis, torch.maximum(counter["weights_max"], point_weight),
            counter["weights_max"])
        new["weights_sum"] = counter["weights_sum"] + torch.where(
            flag_vis, point_weight, 0.0)
        new["radii_max"] = torch.where(
            flag_vis, torch.maximum(counter["radii_max"], radii_i),
            counter["radii_max"])
        return new
    index = visible_index.to(torch.int64)
    idx_area = torch.where(has_area, index, capacity)
    idx_vis = torch.where(flag_vis, index, capacity)
    ones = torch.ones_like(radii_i)
    new["area_sum"] = _scatter_drop(counter["area_sum"], idx_area,
                                    point_count, "sum")
    new["grad_sum"] = _scatter_drop(counter["grad_sum"], idx_area, ga, "sum")
    new["radii_max_max"] = _scatter_drop(counter["radii_max_max"], idx_area,
                                         point_count, "amax")
    new["create_steps"] = _scatter_drop(counter["create_steps"], idx_vis,
                                        ones, "sum")
    new["visible_count"] = _scatter_drop(counter["visible_count"], idx_vis,
                                         ones, "sum")
    new["weights_max"] = _scatter_drop(counter["weights_max"], idx_vis,
                                       point_weight, "amax")
    new["weights_sum"] = _scatter_drop(counter["weights_sum"], idx_vis,
                                       point_weight, "sum")
    new["radii_max"] = _scatter_drop(counter["radii_max"], idx_vis, radii_i,
                                     "amax")
    return new


class Counter:
    """Host container of the per-point counters (device tensors)."""

    def __init__(self, num_points: int, device="cuda"):
        self.device = torch.device(device)
        self.data = {k: torch.from_numpy(v).to(self.device)
                     for k, v in init_counter(num_points).items()}

    def __getattr__(self, key):
        data = self.__dict__.get("data", {})
        if key in data:
            return data[key]
        raise AttributeError(key)

    def get_gradmean(self) -> np.ndarray:
        """The mean 2D gradient of each row, grad_sum / max(area_sum, 1),
        on the host in float64 (numpy's promotion of float32 by int32, as
        the JAX package computes it)."""
        grad = self.data["grad_sum"].double()
        area = torch.clamp(self.data["area_sum"], min=1).double()
        return (grad / area).cpu().numpy()

    def reset(self, num_points: int, capacity: int | None = None) -> None:
        print(f"[{self.__class__.__name__}] reset counter -> {num_points}")
        capacity = capacity or num_points
        fresh = init_counter(capacity)
        for key in RESET_KEYS:
            self.data[key] = torch.from_numpy(fresh[key]).to(self.device)
        # persistent keys track the capacity too (their prefix is kept)
        for key in ("radius3d_min", "radius3d_max", "create_steps"):
            old = self.data[key]
            if old.shape[0] != capacity:
                new = fresh[key]
                n = min(old.shape[0], capacity)
                new[:n] = old[:n].cpu().numpy()
                self.data[key] = torch.from_numpy(new).to(self.device)

    def reset_create_steps(self) -> None:
        self.data["create_steps"] = torch.zeros_like(self.data["create_steps"])

    def set_numpy(self, arrays: dict, capacity: int) -> None:
        """Load exact-size arrays (reference checkpoints store int8/int16
        counters; they are cast to this module's dtypes) and pad to the
        capacity."""
        canon = {k: v.dtype for k, v in init_counter(1).items()}
        for key, val in arrays.items():
            if key not in canon:
                continue
            arr = np.asarray(val).astype(canon[key])
            fill = 1.0 if key in _FILL_ONE else 0
            self.data[key] = torch.from_numpy(
                np.ascontiguousarray(pad_rows(arr, capacity, fill=fill))
            ).to(self.device)

    def to_numpy(self, num_points: int) -> dict:
        return {k: v[:num_points].cpu().numpy() for k, v in self.data.items()}
