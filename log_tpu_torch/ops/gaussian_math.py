"""Projective math for 3D Gaussian splatting on (N,) tensors; counterpart of
log_tpu/ops/gaussian_math.py.

Closed-form vector math, no (N, 3, 3) matrices on the hot path. Camera
convention (row-vector): ``x_cam = [x_world, 1] @ world_view`` where
``world_view`` is the 4x4 ``world_view_transform`` of
log_tpu_torch.dataset.base.prepare_camera (the transpose of [R|T]).
"""
from __future__ import annotations

import torch

# low-pass dilation of the Inria rasterizer and the compute_radius kernel
DILATE_PIXEL = 0.3


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz quaternion (unnormalized) -> (..., 3, 3) rotation."""
    norm = torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))
    q = q / norm
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    R = torch.stack([r00, r01, r02, r10, r11, r12, r20, r21, r22], dim=-1)
    return R.reshape(q.shape[:-1] + (3, 3))


def build_cov3d(scaling: torch.Tensor, rotation: torch.Tensor) -> torch.Tensor:
    """Sigma = (R S)(R S)^T as the packed upper triangle (N, 6), ordered
    (xx, xy, xz, yy, yz, zz) like the Inria CUDA kernels."""
    return torch.stack(build_cov3d_c(scaling, rotation), dim=-1)


def transform_point(xyz: torch.Tensor, world_view: torch.Tensor) -> torch.Tensor:
    """World -> camera, row-vector convention."""
    return xyz @ world_view[:3, :3] + world_view[3:4, :3]


def transform_point_c(x, y, z, world_view):
    """World -> camera as components. Returns (tx, ty, tz)."""
    m = world_view
    tx = x * m[0, 0] + y * m[1, 0] + z * m[2, 0] + m[3, 0]
    ty = x * m[0, 1] + y * m[1, 1] + z * m[2, 1] + m[3, 1]
    tz = x * m[0, 2] + y * m[1, 2] + z * m[2, 2] + m[3, 2]
    return tx, ty, tz


def project_ndc_c(x, y, z, full_proj, eps: float = 1e-7):
    """World -> NDC as components. Returns (px, py, pz, w)."""
    m = full_proj
    hx = x * m[0, 0] + y * m[1, 0] + z * m[2, 0] + m[3, 0]
    hy = x * m[0, 1] + y * m[1, 1] + z * m[2, 1] + m[3, 1]
    hz = x * m[0, 2] + y * m[1, 2] + z * m[2, 2] + m[3, 2]
    w = x * m[0, 3] + y * m[1, 3] + z * m[2, 3] + m[3, 3]
    inv = 1.0 / (w + eps)
    return hx * inv, hy * inv, hz * inv, w


def frustum_flag_c(px, py, pz, padding: float = 0.05):
    """NDC frustum test on components."""
    return (
        (pz > 0.0)
        & (pz < 1.0)
        & (px > -1.0 - padding)
        & (px < 1.0 + padding)
        & (py > -1.0 - padding)
        & (py < 1.0 + padding)
    )


def build_cov3d_c(scaling: torch.Tensor, rotation: torch.Tensor):
    """build_cov3d as a tuple of the 6 upper-triangle (N,) components."""
    return build_cov3d_cc(
        scaling[..., 0], scaling[..., 1], scaling[..., 2],
        rotation[..., 0], rotation[..., 1], rotation[..., 2],
        rotation[..., 3],
    )


def build_cov3d_cc(s0c, s1c, s2c, qw, qx, qy, qz):
    """build_cov3d_c on 7 column inputs (scales, wxyz quaternion)."""
    norm = torch.sqrt(qw * qw + qx * qx + qy * qy + qz * qz)
    inv = 1.0 / norm
    w, x, y, z = qw * inv, qx * inv, qy * inv, qz * inv
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    s0 = s0c * s0c
    s1 = s1c * s1c
    s2 = s2c * s2c
    # sigma_ij = sum_k s_k^2 R_ik R_jk
    sxx = s0 * r00 * r00 + s1 * r01 * r01 + s2 * r02 * r02
    sxy = s0 * r00 * r10 + s1 * r01 * r11 + s2 * r02 * r12
    sxz = s0 * r00 * r20 + s1 * r01 * r21 + s2 * r02 * r22
    syy = s0 * r10 * r10 + s1 * r11 * r11 + s2 * r12 * r12
    syz = s0 * r10 * r20 + s1 * r11 * r21 + s2 * r12 * r22
    szz = s0 * r20 * r20 + s1 * r21 * r21 + s2 * r22 * r22
    return sxx, sxy, sxz, syy, syz, szz


def ewa_cov2d_c(cov3d_c, tx, ty, tz, world_view, focal_x, focal_y,
                tan_fovx, tan_fovy):
    """EWA splat on components: cov3d_c = (sxx..szz), (tx, ty, tz) the
    camera-space point. Returns the raw (cxx, cxy, cyy), no dilation."""
    lim_x = 1.3 * tan_fovx
    lim_y = 1.3 * tan_fovy
    cx = torch.clamp(tx / tz, -lim_x, lim_x) * tz
    cy = torch.clamp(ty / tz, -lim_y, lim_y) * tz
    R = world_view[:3, :3]  # R[i, j] = Rw[j, i]
    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z
    ax = focal_x * inv_z
    bx = focal_x * cx * inv_z2
    ay = focal_y * inv_z
    by = focal_y * cy * inv_z2
    # rows of M = J Rw: m0 = ax*Rw0 - bx*Rw2, m1 = ay*Rw1 - by*Rw2
    m00 = ax * R[0, 0] - bx * R[0, 2]
    m01 = ax * R[1, 0] - bx * R[1, 2]
    m02 = ax * R[2, 0] - bx * R[2, 2]
    m10 = ay * R[0, 1] - by * R[0, 2]
    m11 = ay * R[1, 1] - by * R[1, 2]
    m12 = ay * R[2, 1] - by * R[2, 2]
    sxx, sxy, sxz, syy, syz, szz = cov3d_c
    s0x = sxx * m00 + sxy * m01 + sxz * m02
    s0y = sxy * m00 + syy * m01 + syz * m02
    s0z = sxz * m00 + syz * m01 + szz * m02
    cxx = m00 * s0x + m01 * s0y + m02 * s0z
    cxy = m10 * s0x + m11 * s0y + m12 * s0z
    s1x = sxx * m10 + sxy * m11 + sxz * m12
    s1y = sxy * m10 + syy * m11 + syz * m12
    s1z = sxz * m10 + syz * m11 + szz * m12
    cyy = m10 * s1x + m11 * s1y + m12 * s1z
    return cxx, cxy, cyy


def project_ndc(xyz: torch.Tensor, full_proj: torch.Tensor, eps: float = 1e-7):
    """World -> NDC via the full projection matrix. Returns (p_ndc (N, 3),
    w (N,)), with the +1e-7 guard."""
    h = xyz @ full_proj[:3] + full_proj[3:4]
    w = h[..., 3]
    p = h[..., :3] / (w[..., None] + eps)
    return p, w


def ndc_to_pix(v: torch.Tensor, size) -> torch.Tensor:
    """NDC [-1, 1] -> pixel coordinate; Inria's ndc2Pix: ((v+1)*S - 1)/2."""
    return ((v + 1.0) * size - 1.0) * 0.5


def frustum_flag(p_ndc: torch.Tensor, padding: float = 0.05) -> torch.Tensor:
    """NDC-space frustum test on (N, 3) points."""
    return frustum_flag_c(
        p_ndc[..., 0], p_ndc[..., 1], p_ndc[..., 2], padding=padding
    )


def ewa_cov2d(cov3d, xyz, world_view, focal_x, focal_y, tan_fovx, tan_fovy):
    """EWA splat of a packed (N, 6) 3D covariance to screen space. Returns
    the raw (cxx, cxy, cyy) (no low-pass dilation)."""
    tx, ty, tz = transform_point_c(xyz[..., 0], xyz[..., 1], xyz[..., 2],
                                   world_view)
    return ewa_cov2d_c(
        tuple(cov3d[..., i] for i in range(6)), tx, ty, tz, world_view,
        focal_x, focal_y, tan_fovx, tan_fovy,
    )


def dilate_cov2d(cxx, cxy, cyy, mode: str = "clamp"):
    """Low-pass policies: 'clamp' (diag = max(diag, 0.3)), 'add'
    (diag += 0.3, the Inria original) or 'none'."""
    if mode == "clamp":
        return (torch.clamp(cxx, min=DILATE_PIXEL), cxy,
                torch.clamp(cyy, min=DILATE_PIXEL))
    if mode == "add":
        return cxx + DILATE_PIXEL, cxy, cyy + DILATE_PIXEL
    if mode == "none":
        return cxx, cxy, cyy
    raise ValueError(f"unknown dilate mode {mode!r}")


def cov2d_radius(cxx, cxy, cyy):
    """Screen radius = 3 sqrt(lambda_max) of the 2x2 covariance, with the
    0.1 clamp inside the sqrt. Float pixels."""
    det = cxx * cyy - cxy * cxy
    mid = 0.5 * (cxx + cyy)
    disc = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    lambda_max = mid + disc
    return 3.0 * torch.sqrt(torch.clamp(lambda_max, min=0.0))


def inverse_cov2d(cxx, cxy, cyy, eps: float = 0.0):
    """Conic (inverse 2x2 covariance) + determinant; det <= 0 is invalid."""
    det = cxx * cyy - cxy * cxy
    det_safe = torch.where(det != 0.0, det, 1.0)
    inv_det = 1.0 / det_safe
    return cyy * inv_det, -cxy * inv_det, cxx * inv_det, det


def cut_radius(cxx, cxy, cyy, visible):
    """The LoD cut's radius of a raw cov2d: 'clamp' low-pass, then
    3 sqrt(lambda_max); 0 where not visible or degenerate."""
    cxx, cxy, cyy = dilate_cov2d(cxx, cxy, cyy, mode="clamp")
    det = cxx * cyy - cxy * cxy
    return torch.where(visible & (det > 0), cov2d_radius(cxx, cxy, cyy), 0.0)


def compute_radius2d_c(x, y, z, cov3d_c, world_view, full_proj, focal_x,
                       focal_y, tan_fovx, tan_fovy, padding: float = 0.3):
    """`compute_radius2d` on position columns and a cov3d tuple."""
    px, py, pz, _ = project_ndc_c(x, y, z, full_proj)
    visible = frustum_flag_c(px, py, pz, padding=padding)
    tx, ty, tz = transform_point_c(x, y, z, world_view)
    cxx, cxy, cyy = ewa_cov2d_c(
        cov3d_c, tx, ty, tz, world_view, focal_x, focal_y, tan_fovx, tan_fovy
    )
    return cut_radius(cxx, cxy, cyy, visible)


def compute_radius2d(xyz, scaling, rotation, world_view, full_proj, focal_x,
                     focal_y, tan_fovx, tan_fovy, padding: float = 0.3):
    """Per-point projected pixel radius with visibility gating: radius 0
    outside the padded NDC frustum or for a degenerate cov2d. 'clamp'
    low-pass, like LoG's compute_radius kernel."""
    return compute_radius2d_c(
        xyz[..., 0], xyz[..., 1], xyz[..., 2],
        build_cov3d_c(scaling, rotation), world_view, full_proj, focal_x,
        focal_y, tan_fovx, tan_fovy, padding,
    )
