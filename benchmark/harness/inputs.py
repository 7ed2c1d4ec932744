"""What the benchmark makes from the seed, on the device, for both the
program and the reference: the synthetic LoD tree as a LoG checkpoint,
the orbit cameras and the training ground truth.

The tree is the repo's synthetic urban tree (the structure of
`log_tpu_torch/utils/synth_tree.py`'s `build_scene`, written out again
here): roots uniform over a 60 x 60 ground extent and 2 units of height,
Morton-ordered; every 2nd root splits into 4 children and 3 of every 10
depth-1 children split again, children jittered inside the parent at 0.55x
its scale. Its random numbers come from one torch.Generator on the device
seeded with --seed, in a few large draws, so the same seed gives the same
tree and a scene of 10M points takes a fraction of a second. The SH bank
of degree >= 1 is 0.1 x normal noise, so that view-dependent colour is
exercised.

Nothing here imports the program; the reference reads these tensors too.
"""
from __future__ import annotations

import math

import numpy as np
import torch

SH_C0 = 0.28209479177387814
MAX_CHILD = 4
EXTENT = 30.0


def tree_sizes(n_roots: int):
    """(depth-1 points, depth-2 points, all points) of the strided tree."""
    n1 = (n_roots // 2) * MAX_CHILD
    n2 = ((n1 // 10) * 3) * MAX_CHILD
    return n1, n2, n_roots + n1 + n2


def _morton2d(x, y):
    def q(v):
        return torch.clamp(((v + EXTENT) / (2 * EXTENT) * 1024).to(torch.int32),
                           0, 1023).to(torch.int64)

    qx, qy, key = q(x), q(y), torch.zeros_like(x, dtype=torch.int64)
    for b in range(10):
        key |= (((qx >> b) & 1) << (2 * b)) | (((qy >> b) & 1) << (2 * b + 1))
    return key


def make_tree(n_roots: int, seed: int, sh_degree: int, device) -> dict:
    """The checkpoint dict of the synthetic tree on `device`: gaussian.*
    (log scales, logit opacities), tree.* (int32) and the training scale
    bounds counter.radius3d_{min,max} (0.5x the smallest and 2x the largest
    axis)."""
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed) % (1 << 63))
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    n1, n2, n = tree_sizes(n_roots)
    s1, s2 = n1 // MAX_CHILD, n2 // MAX_CHILD

    u = torch.rand((n_roots, 7), generator=g, **f32)
    xyz_r = torch.stack([u[:, 0] * 2 * EXTENT - EXTENT,
                         u[:, 1] * 2 * EXTENT - EXTENT, u[:, 2] * 2.0], 1)
    scal_r = (0.08 + 0.17 * u[:, 3:4]) * (0.6 + 0.8 * u[:, 4:7])
    order = torch.sort(_morton2d(xyz_r[:, 0], xyz_r[:, 1]), stable=True).indices
    xyz_r, scal_r = xyz_r[order], scal_r[order]

    split1 = torch.arange(s1, **i32) * 2
    j = torch.arange(s2, **i32)
    split2 = (j // 3) * 10 + (j % 3) + n_roots
    index_parent = torch.cat([torch.full((n_roots,), -1, **i32),
                              split1.repeat_interleave(MAX_CHILD),
                              split2.repeat_interleave(MAX_CHILD)])
    off = torch.randn((s1 + s2, MAX_CHILD, 3), generator=g, **f32)

    def children(xyz_p, scal_p, rows, o):
        c_xyz = xyz_p[rows][:, None] + o * scal_p[rows][:, None] * 0.5
        c_scal = (scal_p[rows][:, None] * 0.55).expand_as(c_xyz)
        return c_xyz.reshape(-1, 3), c_scal.reshape(-1, 3)

    c1_xyz, c1_scal = children(xyz_r, scal_r, split1.long(), off[:s1])
    c2_xyz, c2_scal = children(c1_xyz, c1_scal, (split2 - n_roots).long(),
                               off[s1:])
    xyz = torch.cat([xyz_r, c1_xyz, c2_xyz])
    scal = torch.cat([scal_r, c1_scal, c2_scal])
    del c1_xyz, c2_xyz, c1_scal, c2_scal

    n_sh = (sh_degree + 1) ** 2 - 1
    normal = torch.randn((n, 4 + 3 * n_sh), generator=g, **f32)
    u = torch.rand((n, 4), generator=g, **f32)
    q = normal[:, :4]
    opac = 0.3 + 0.65 * u[:, 3:4]
    ck = {
        "gaussian.xyz": xyz,
        "gaussian.colors": (u[:, :3] - 0.5) / SH_C0,
        "gaussian.scaling": torch.log(scal),
        "gaussian.opacity": torch.log(opac / (1.0 - opac)),
        "gaussian.rotation": q / torch.linalg.vector_norm(q, dim=1,
                                                           keepdim=True),
        "counter.radius3d_min": 0.5 * scal.min(dim=1).values,
        "counter.radius3d_max": 2.0 * scal.max(dim=1).values,
    }
    if n_sh:
        ck["gaussian.shs"] = 0.1 * normal[:, 4:].reshape(n, n_sh, 3)
    del normal, u, scal

    node_index = torch.full((n,), -1, **i32)
    node_index[split1.long()] = torch.arange(s1, **i32)
    node_index[split2.long()] = s1 + torch.arange(s2, **i32)
    depth = torch.cat([torch.zeros(n_roots, **i32), torch.ones(n1, **i32),
                       torch.full((n2,), 2, **i32)])
    root_id = torch.arange(n, **i32)
    root_id[n_roots:n_roots + n1] = index_parent[n_roots:n_roots + n1]
    root_id[n_roots + n1:] = root_id[index_parent[n_roots + n1:].long()]
    ck.update({
        "tree.tree": (torch.arange(n1 + n2, **i32) + n_roots).reshape(
            -1, MAX_CHILD),
        "tree.root_index": torch.arange(n_roots, **i32),
        "tree.node_index": node_index,
        "tree.index_parent": index_parent,
        "tree.local_index": torch.cat([
            torch.full((n_roots,), -1, **i32),
            torch.arange(MAX_CHILD, **i32).repeat(s1 + s2)]),
        "tree.depth": depth,
        "tree.root_id": root_id,
    })
    return ck


def host_tree(cfg: dict, seed: int, device) -> dict:
    """make_tree for a configuration, copied to host numpy arrays (what
    LoG.load_state_dict takes); the device copy is freed and the card's
    peak reset, so that the peak a run reports is the program's."""
    ck = make_tree(cfg["scene"]["n_roots"], seed,
                   cfg["model"]["gaussian"]["sh_degree"], device)
    host = {k: v.cpu().numpy() for k, v in ck.items()}
    del ck
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    return host


def camera_of(cfg: dict, traffic: dict) -> dict:
    """The camera a cell renders at ({"height", "width", "focal"}): the
    traffic file's `camera` block where it has one (what a viewer or a
    trainer asks for), else the configuration's."""
    return traffic.get("camera", cfg["camera"])


def orbit_camera(theta: float, H: int, W: int, focal: float, height: float,
                 radius: float, znear: float = 0.01,
                 zfar: float = 1000.0) -> dict:
    """A render-ready camera at angle theta on the orbit, looking at the
    origin: intrinsics K (principal point at the centre), R, T, the
    row-vector world_view_transform ([R|T]^T) and full_proj_transform
    (world_view @ P^T), FoV and centre; float32 numpy, as the program's
    dataset cameras carry them."""
    pos = np.array([radius * math.cos(theta), radius * math.sin(theta),
                    height])
    fwd = -pos / np.linalg.norm(pos)
    right = np.cross(fwd, np.array([0, 0, 1.0]))
    right /= np.linalg.norm(right)
    R = np.stack([right, np.cross(fwd, right), fwd])
    T = (-R @ pos).reshape(3, 1)
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]])
    P = np.zeros((4, 4))
    P[0, 0] = 2 * focal / W
    P[0, 2] = -1 + 2 * (K[0, 2] / W)
    P[1, 1] = 2 * focal / H
    P[1, 2] = -1 + 2 * (K[1, 2] / H)
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    P[3, 2] = 1.0
    wv = np.eye(4)
    wv[:3, :3], wv[:3, 3:] = R, T
    wv = wv.T
    f32 = np.float32
    return {"image_width": W, "image_height": H,
            "FoVx": 2 * math.atan(W / (2 * focal)),
            "FoVy": 2 * math.atan(H / (2 * focal)),
            "K": K.astype(f32), "R": R.astype(f32), "T": T.astype(f32),
            "camera_center": pos.astype(f32),
            "world_view_transform": wv.astype(f32),
            "full_proj_transform": (wv @ P.astype(f32).T).astype(f32)}


def start_angle(seed: int) -> float:
    """The orbit's start angle drawn from the seed."""
    return float(np.random.default_rng(int(seed)).uniform(0.0, 2 * math.pi))


def orbit(seed: int, n: int, H: int, W: int, focal: float, height: float,
          radius: float) -> list:
    """n cameras a turn from the seed's start angle."""
    a0 = start_angle(seed)
    return [orbit_camera(a0 + 2 * math.pi * i / n, H, W, focal, height,
                         radius) for i in range(n)]


def ground_truth(seed: int, n_views: int, H: int, W: int, cells: int,
                 device) -> list:
    """n_views (3, H, W) uint8 images: smooth colour fields, uniform
    random values on a grid of `cells` rows (as many columns as the aspect
    gives) upsampled bilinearly."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) + 1) % (1 << 63))
    cw = max(2, round(cells * W / H))
    low = torch.rand((n_views, 3, cells, cw), generator=g,
                     dtype=torch.float32, device=device)
    up = torch.nn.functional.interpolate(low, size=(H, W), mode="bilinear",
                                         align_corners=False)
    return list((up * 255.0 + 0.5).clamp(0, 255).to(torch.uint8))
