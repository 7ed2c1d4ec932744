"""Camera dict preparation; counterpart of log_tpu/dataset/base.py.

Row-vector convention: ``world_view_transform = [R|T]^T`` and
``full_proj_transform = W2C @ P^T``. Host numpy; the renderer moves the
matrices to the device (render/renderer.py:camera_device).
"""
from __future__ import annotations

import numpy as np

from ..utils.camera import focal2fov, projection_matrix_from_K


def rescale_camera(camera, scale, H=-1, W=-1):
    """Rescale K/W/H by an integer or fractional pyramid scale."""
    camera = camera.copy()
    if W == -1:
        W = int(camera["W"] / scale)
    if H == -1:
        H = int(camera["H"] / scale)
    K = camera["K"].copy()
    K[0, :] *= W / camera["W"]
    K[1, :] *= H / camera["H"]
    camera["W"] = W
    camera["H"] = H
    camera["K"] = K
    return camera


def prepare_camera(camera, scale, znear, zfar):
    """Build the render-ready camera dict.

    Input camera: {'K' 3x3, 'R' 3x3, 'T' 3x1, 'W', 'H', 'center' 3x1}.
    """
    ret = {}
    ret["image_width"] = int(camera["W"] / scale)
    ret["image_height"] = int(camera["H"] / scale)
    scale_x = ret["image_width"] / camera["W"]
    scale_y = ret["image_height"] / camera["H"]
    focal_y = camera["K"][1, 1] * scale_y
    focal_x = camera["K"][0, 0] * scale_x
    ret["FoVy"] = focal2fov(focal_y, camera["H"] * scale_y)
    ret["FoVx"] = focal2fov(focal_x, camera["W"] * scale_x)
    ret["K"] = camera["K"].copy()
    ret["K"][0, :] *= scale_x
    ret["K"][1, :] *= scale_y
    ret["projection_matrix"] = projection_matrix_from_K(
        ret["K"], ret["image_height"], ret["image_width"], znear, zfar
    ).T
    world_view = np.eye(4)
    world_view[:3, :3] = camera["R"]
    world_view[:3, 3:] = camera["T"]
    ret["camera_center"] = np.asarray(camera["center"]).reshape(3)
    ret["world_view_transform"] = world_view.T
    ret["full_proj_transform"] = ret["world_view_transform"] @ ret["projection_matrix"]
    ret["znear"] = znear
    ret["zfar"] = zfar
    ret["R"] = camera["R"]
    ret["T"] = camera["T"]
    ret["scale"] = scale
    for key, val in ret.items():
        if isinstance(val, np.ndarray):
            ret[key] = val.astype(np.float32)
    return ret
