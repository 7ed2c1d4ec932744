"""Gaussian splatting geometry in plain PyTorch: the camera transforms, the
3D and screen-space covariances, the LoD cut radius, the screen splats and
the SH colours, each written out from its definition (Kerbl et al. 2023,
3D Gaussian Splatting; LoG's antialias variant; the row-vector camera
convention of the benchmark's cameras, `x_cam = [x, 1] @ world_view`).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
NEAR_Z = 0.2            # camera-space z below which a splat is dropped
LOWPASS = 0.3           # the screen-space low-pass added to the diagonal
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_MIN = 1e-4            # compositing stops before the transmittance falls below


@dataclass(frozen=True)
class Prec:
    """The arithmetic of one evaluation: `dtype` for everything derived
    from a point's attributes (covariances, conic, radius, opacity,
    colour) and for the compositing, and `record` the dtype the splat
    records (conic, opacity, colour, radius) are rounded through before
    compositing, or None. Positions, the camera and pixel coordinates stay
    float32 in every evaluation: a pixel position in bfloat16 is off by up
    to 8 pixels at 1920."""

    dtype: torch.dtype = torch.float32
    record: torch.dtype | None = None

    def round_record(self, x):
        if self.record is None:
            return x
        return x.to(self.record).to(self.dtype)


F32 = Prec()
# one step below the program's own arithmetic: bfloat16 where it computes
# in float32, float8 (e4m3) where it packs splat records in bfloat16
CONTROL = Prec(torch.bfloat16, torch.float8_e4m3fn)


def camera_tensors(camera: dict, device) -> dict:
    """The host camera dict as float32 device tensors and host scalars."""
    H, W = int(camera["image_height"]), int(camera["image_width"])
    tan_x = math.tan(float(camera["FoVx"]) * 0.5)
    tan_y = math.tan(float(camera["FoVy"]) * 0.5)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    return {"wv": t(camera["world_view_transform"]),
            "proj": t(camera["full_proj_transform"]),
            "center": t(camera["camera_center"]).reshape(3),
            "fx": W / (2.0 * tan_x), "fy": H / (2.0 * tan_y),
            "tan_x": tan_x, "tan_y": tan_y, "H": H, "W": W}


def homogeneous(xyz, m):
    """[xyz, 1] @ m for a (4, 4) matrix: (N, 4)."""
    return xyz @ m[:3] + m[3]


def ndc(xyz, cam):
    """Normalised device coordinates (N, 3) of world points."""
    h = homogeneous(xyz, cam["proj"])
    return h[:, :3] / (h[:, 3:4] + 1e-7)


def in_frustum(p_ndc, padding: float):
    return ((p_ndc[:, 2] > 0) & (p_ndc[:, 2] < 1)
            & (p_ndc[:, 0].abs() < 1 + padding)
            & (p_ndc[:, 1].abs() < 1 + padding))


def rotation_matrix(q):
    """(N, 3, 3) rotation of (N, 4) wxyz quaternions (normalised here)."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    rows = [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]
    return torch.stack(rows, -1).reshape(q.shape[0], 3, 3)


def covariance3d(scale, q):
    """Sigma = R S S^T R^T, (N, 3, 3), from activated scales and
    quaternions."""
    rs = rotation_matrix(q) * scale[:, None, :]
    return (rs[:, :, None, :] * rs[:, None, :, :]).sum(-1)


def covariance2d(xyz, sigma, cam):
    """The EWA screen covariance (cxx, cxy, cyy), in sigma's dtype, and
    the camera depth tz: the Jacobian of the perspective map at the point
    (from float32 positions), its view direction clamped to 1.3x the field
    of view."""
    t = homogeneous(xyz, cam["wv"])[:, :3]
    tz = t[:, 2]
    lx, ly = 1.3 * cam["tan_x"], 1.3 * cam["tan_y"]
    cx = torch.clamp(t[:, 0] / tz, -lx, lx) * tz
    cy = torch.clamp(t[:, 1] / tz, -ly, ly) * tz
    rw = cam["wv"][:3, :3].T          # camera-from-world rotation
    zero = torch.zeros_like(tz)
    j0 = torch.stack([cam["fx"] / tz, zero, -cam["fx"] * cx / (tz * tz)], -1)
    j1 = torch.stack([zero, cam["fy"] / tz, -cam["fy"] * cy / (tz * tz)], -1)
    m0, m1 = (j0 @ rw).to(sigma.dtype), (j1 @ rw).to(sigma.dtype)
    s0 = (sigma * m0[:, None, :]).sum(-1)
    s1 = (sigma * m1[:, None, :]).sum(-1)
    return (m0 * s0).sum(-1), (m1 * s0).sum(-1), (m1 * s1).sum(-1), tz


def extent_radius(cxx, cxy, cyy):
    """3 sqrt(lambda_max) of a 2x2 covariance, the discriminant held at
    0.1 or more."""
    mid = 0.5 * (cxx + cyy)
    det = cxx * cyy - cxy * cxy
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    return 3.0 * torch.sqrt(torch.clamp(lam, min=0.0))


def cut_radius(xyz, scale, q, cam):
    """The LoD cut's pixel radius: the screen covariance with its diagonal
    held at the low-pass or above, 0 outside the frustum padded by 0.3 or
    for a degenerate covariance."""
    cxx, cxy, cyy, _ = covariance2d(xyz, covariance3d(scale, q), cam)
    cxx = torch.clamp(cxx, min=LOWPASS)
    cyy = torch.clamp(cyy, min=LOWPASS)
    ok = in_frustum(ndc(xyz, cam), 0.3) & (cxx * cyy - cxy * cxy > 0)
    return torch.where(ok, extent_radius(cxx, cxy, cyy),
                       torch.zeros_like(cxx))


def activate(params: dict):
    """Activated attributes: scale exp, opacity sigmoid, rotation as
    stored (normalised where it is used)."""
    return (torch.exp(params["scaling"]), torch.sigmoid(params["opacity"][:, 0]),
            params["rotation"])


def sh_colour(params: dict, xyz, cam, degree: int):
    """RGB of degree-0 SH plus, for degree 1, the first band along the
    unit view direction (no clamp)."""
    rgb = params["colors"] * SH_C0 + 0.5
    if degree >= 1:
        d = xyz - cam["center"]
        d = (d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)).to(
            rgb.dtype)
        sh = params["shs"]
        rgb = rgb + SH_C1 * (-d[:, 1:2] * sh[:, 0] + d[:, 2:3] * sh[:, 1]
                             - d[:, 0:1] * sh[:, 2])
    if degree > 1:
        raise ValueError("the reference evaluates SH degrees 0 and 1")
    return rgb


def screen_splats(xyz, scale, q, opacity, cam, active, lowpass: bool,
                  tight: bool):
    """Screen splats of activated points: pixel centre, conic (the inverse
    screen covariance), effective opacity, depth, pixel radius and
    validity. lowpass: the covariance gets +0.3 on its diagonal and the
    opacity sqrt(det / det_lowpassed) (training); otherwise it is used as
    projected (inference). tight: the radius shrinks to where the opacity
    can still reach 1/255."""
    cxx, cxy, cyy, tz = covariance2d(xyz, covariance3d(scale, q), cam)
    det_raw = cxx * cyy - cxy * cxy
    op = opacity
    if lowpass:
        cxx, cyy = cxx + LOWPASS, cyy + LOWPASS
        det = cxx * cyy - cxy * cxy
        op = op * torch.sqrt(torch.clamp(det_raw, min=1e-12)
                             / torch.where(det != 0, det, torch.ones_like(det)))
    else:
        det = det_raw
    inv = 1.0 / torch.where(det != 0, det, torch.ones_like(det))
    radius = extent_radius(cxx, cxy, cyy)
    if tight:
        reach = torch.sqrt(torch.clamp(2.0 * torch.log(255.0 * op), min=0.0))
        radius = radius * torch.clamp(reach / 3.0, max=1.0)
    valid = (tz > NEAR_Z) & (det > 0) & active
    p = ndc(xyz, cam)
    zero = torch.zeros_like(op)
    return {"px": ((p[:, 0] + 1.0) * cam["W"] - 1.0) * 0.5,
            "py": ((p[:, 1] + 1.0) * cam["H"] - 1.0) * 0.5,
            "a": cyy * inv, "b": -cxy * inv, "c": cxx * inv,
            "op": torch.where(valid, op, zero),
            "depth": tz, "radius": torch.where(valid, torch.ceil(radius), zero),
            "valid": valid}


def scale_camera(cam: dict, factor: int) -> dict:
    """The camera at 1/factor resolution (at least 128 x 8 pixels), the
    same view: the root cull's check render."""
    out = dict(cam)
    out["H"] = max(cam["H"] // factor, 8)
    out["W"] = max(cam["W"] // factor, 128)
    out["fx"] = cam["fx"] / factor
    out["fy"] = cam["fy"] / factor
    return out
