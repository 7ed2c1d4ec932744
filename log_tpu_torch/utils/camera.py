"""Pinhole camera helpers (host-side numpy); counterpart of
log_tpu/utils/camera.py."""
from __future__ import annotations

import math

import numpy as np


def focal2fov(focal, pixels):
    return 2 * math.atan(pixels / (2 * focal))


def fov2focal(fov, pixels):
    return pixels / (2 * math.tan(fov * 0.5))


def projection_matrix_from_K(K, H, W, znear, zfar):
    """4x4 projection from intrinsics, keeping cx/cy and skew (column-vector
    form; callers transpose for the row-vector convention)."""
    fx = K[0, 0]
    fy = K[1, 1]
    cx = K[0, 2]
    cy = K[1, 2]
    s = K[0, 1]
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = 2 * fx / W
    P[0, 1] = 2 * s / W
    P[0, 2] = -1 + 2 * (cx / W)
    P[1, 1] = 2 * fy / H
    P[1, 2] = -1 + 2 * (cy / H)
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    P[3, 2] = 1.0
    return P
