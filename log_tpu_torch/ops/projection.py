"""Shared projection stage of both rasterizer backends; counterpart of
log_tpu/ops/projection.py.

Turns world-space Gaussian parameters into screen-space splats (pixel mean,
conic, effective opacity, depth, radius).

Antialias semantics of the 'wodilate' fork:
  * training (`use_filter=True`): covariance low-passed by +0.3 px and
    opacity scaled by sqrt(det(cov) / det(cov + 0.3 I));
  * inference (`use_filter=False`): raw covariance, no compensation.
`mode='original'` reproduces the Inria rasterizer (dilate, no compensation).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import gaussian_math as gm

# Inria near-plane cull threshold (camera-space z)
NEAR_Z = 0.2
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4


class Splats(NamedTuple):
    """Screen-space splats, all (P,) or (P, k)."""

    pix_xy: torch.Tensor  # (P, 2) pixel-space mean
    conic: torch.Tensor  # (P, 3) inverse 2x2 covariance (xx, xy, yy)
    opacity: torch.Tensor  # (P,) effective opacity (with AA compensation)
    depth: torch.Tensor  # (P,) camera-space z
    radius: torch.Tensor  # (P,) float pixel radius (0 for culled)
    valid: torch.Tensor  # (P,) bool


def project_gaussians(
    xyz, scaling, rotation, opacity, world_view, full_proj,
    focal_x, focal_y, tan_fovx, tan_fovy, image_height: int, image_width: int,
    mode: str = "antialias", use_filter: bool = True, means2d_offset=None,
    active_mask=None, tight_radius: bool = False,
) -> Splats:
    """Project activated Gaussian parameters to screen-space splats.

    `means2d_offset` is an optional (P, 2) offset added to the NDC mean.
    """
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    tx, ty, tz = gm.transform_point_c(x, y, z, world_view)
    depth = tz
    ndc_x, ndc_y, _, _ = gm.project_ndc_c(x, y, z, full_proj)
    if means2d_offset is not None:
        ndc_x = ndc_x + means2d_offset[..., 0]
        ndc_y = ndc_y + means2d_offset[..., 1]
    pix_x = gm.ndc_to_pix(ndc_x, image_width)
    pix_y = gm.ndc_to_pix(ndc_y, image_height)
    pix_xy = torch.stack([pix_x, pix_y], dim=-1)

    cov3d_c = gm.build_cov3d_c(scaling, rotation)
    cxx, cxy, cyy = gm.ewa_cov2d_c(
        cov3d_c, tx, ty, tz, world_view, focal_x, focal_y, tan_fovx, tan_fovy
    )
    det_raw = cxx * cyy - cxy * cxy
    if mode == "original":
        ucxx, ucxy, ucyy = gm.dilate_cov2d(cxx, cxy, cyy, mode="add")
        comp = torch.ones_like(cxx)
    elif mode == "antialias":
        if use_filter:
            ucxx, ucxy, ucyy = gm.dilate_cov2d(cxx, cxy, cyy, mode="add")
            det_f = ucxx * ucyy - ucxy * ucxy
            comp = torch.sqrt(
                torch.clamp(det_raw, min=1e-12)
                / torch.where(det_f != 0.0, det_f, 1.0)
            )
        else:
            ucxx, ucxy, ucyy = cxx, cxy, cyy
            comp = torch.ones_like(cxx)
    else:
        raise ValueError(f"unknown rasterizer mode {mode!r}")

    icxx, icxy, icyy, det = gm.inverse_cov2d(ucxx, ucxy, ucyy)
    conic = torch.stack([icxx, icxy, icyy], dim=-1)
    radius = gm.cov2d_radius(ucxx, ucxy, ucyy)
    op = opacity * comp
    if tight_radius:
        # opacity-aware extent: alpha*exp(-d^2/2) falls below 1/255 at
        # d = sqrt(2 ln(255 a)), inside the fixed 3-sigma rect
        lim = torch.sqrt(torch.clamp(2.0 * torch.log(255.0 * op), min=0.0))
        radius = radius * torch.clamp(lim * (1.0 / 3.0), max=1.0)
    radius = torch.ceil(radius)

    valid = (depth > NEAR_Z) & (det > 0.0)
    if active_mask is not None:
        valid = valid & active_mask
    radius = torch.where(valid, radius, 0.0)
    op = torch.where(valid, op, 0.0)
    return Splats(
        pix_xy=pix_xy, conic=conic, opacity=op, depth=depth, radius=radius,
        valid=valid,
    )
