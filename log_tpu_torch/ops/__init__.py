"""Compute ops: rasterization backends, math, and the CUDA kernel wrappers.

`pick_backend` / `pick_max_pairs` centralize the runtime choice between the
plain reference rasterizer (the oracle) and the tiled production path, and
the static pair budget of the tiled path.
"""
from __future__ import annotations

import os

import torch


def pick_backend(num_points: int | None = None, device="cpu") -> str:
    """'tiled' on a CUDA device. On the CPU: the LOG_TPU_BACKEND override,
    else the oracle for small scenes and the tiled path (plain versions of
    its kernels) above 16384 points, where O(P*HW) costs more."""
    if torch.device(device).type == "cuda":
        return "tiled"
    env = os.environ.get("LOG_TPU_BACKEND")
    if env:
        return env
    if num_points is not None and num_points > 16384:
        return "tiled"
    return "reference"


def pick_max_pairs(k_visible: int, per_point: int = 8) -> int:
    """Static pair capacity for a visible-set bucket (~per_point
    tiles/gaussian headroom, floor 64k, cap 8M), in 1.5x steps. The cap is a
    safety rail for worst-case sizing; callers that know the frame's
    measured demand size from it with per_point=1."""
    cap = 1 << 16
    need = k_visible * per_point
    while cap < need and cap < (1 << 23):
        nxt = cap + cap // 2
        cap = nxt if nxt >= need else cap * 2
    return min(cap, 1 << 23)
