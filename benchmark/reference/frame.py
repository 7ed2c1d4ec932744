"""The reference frame of a LoD tree: the root cull, the LoD cut, the SH
colours and the composited image (LoG, github.com/zju3dv/LoG: the tree's roots
are culled by a coarse render of their blend weights, then each point
is kept where its root survives, its parent projects at min_resolution or
more, and it is small, a leaf or at the deepest level).

Inputs are the benchmark's checkpoint (`gaussian.*`, `tree.*` tensors on
one device, rows as made) and a host camera dict.
"""
from __future__ import annotations

import torch

from . import math as m
from .raster import composite

CULL_WEIGHT = 1e-8   # a root survives the cull where a pixel blends it above


def params_of(ckpt: dict, prec: m.Prec) -> dict:
    """The point attributes: positions float32, the others in prec."""
    out = {}
    for k, v in ckpt.items():
        if k.startswith("gaussian."):
            name = k.split(".", 1)[1]
            out[name] = v.float() if name == "xyz" else v.to(prec.dtype)
    return out


def tree_of(ckpt: dict) -> dict:
    return {k.split(".", 1)[1]: v.long() for k, v in ckpt.items()
            if k.startswith("tree.") and v.dim() == 1}


def root_cull(p: dict, tree: dict, cam: dict, check_scale: int,
              prec: m.Prec):
    """(N,) bool: each point's root is in the frustum (padding 0.5) and
    blends above CULL_WEIGHT somewhere in the check render: the roots
    alone, white, over black, at 1/check_scale resolution, with the
    training low-pass and the tight radius."""
    is_root = tree["index_parent"] == -1
    roots = torch.nonzero(is_root).squeeze(1)
    xyz = p["xyz"][roots]
    cand = m.in_frustum(m.ndc(xyz, cam), 0.5)
    scale, op, q = (v[roots] for v in m.activate(p))
    chk = m.scale_camera(cam, check_scale)
    s = m.screen_splats(xyz, scale, q, op, chk, cand, lowpass=True,
                        tight=True)
    for k in ("a", "b", "c", "op", "radius"):
        s[k] = prec.round_record(s[k])
    white = torch.ones_like(xyz, dtype=op.dtype)
    out = composite(s, white, chk["H"], chk["W"],
                    torch.zeros(3, dtype=op.dtype, device=xyz.device),
                    point_weight=True, min_one=True)
    ok_root = torch.zeros_like(is_root)
    ok_root[roots] = cand & (out["point_weight"] > CULL_WEIGHT)
    return ok_root[tree["root_id"]], out


def lod_cut(p: dict, tree: dict, cam: dict, root_ok, min_res: float,
            max_depth: int):
    """(N,) bool: the LoD cut given each point's root verdict."""
    scale, _, q = m.activate(p)
    r = m.cut_radius(p["xyz"], scale, q, cam)
    parent = torch.where(tree["index_parent"] >= 0, tree["index_parent"],
                         torch.arange(r.shape[0], device=r.device))
    r_parent = r[parent]
    is_root = tree["index_parent"] == -1
    is_leaf = tree["node_index"] == -1
    depth = tree["depth"]
    reach = root_ok & (is_root | ((r_parent >= min_res) & (depth <= max_depth)))
    return reach & ((r < min_res) | is_leaf | (depth >= max_depth))


def frame(ckpt: dict, camera: dict, cfg: dict, background, prec: m.Prec,
          cull_camera: dict | None = None):
    """The served frame: the root cull (at cull_camera, the camera of the
    frame that last refreshed it, where it is not this frame's), the cut,
    colours and compositing without the low-pass. Returns a dict: image
    (3, H, W), cut (kept points), the frame's contributing (splat, pixel)
    combinations, (splat, tile) pairs and valid splats, and the check
    render's combinations."""
    dev = ckpt["gaussian.xyz"].device
    p, tree = params_of(ckpt, prec), tree_of(ckpt)
    cam = m.camera_tensors(camera, dev)
    ccam = cam if cull_camera is None else m.camera_tensors(cull_camera, dev)
    root_ok, check = root_cull(p, tree, ccam, cfg["check_render_scale"], prec)
    # a cull from an earlier frame's camera: the root is also in this
    # frame's frustum
    root_ok = root_ok & m.in_frustum(m.ndc(p["xyz"][tree["root_id"]], cam), 0.5)
    keep = lod_cut(p, tree, cam, root_ok, cfg["min_resolution_pixel"],
                   int(tree["depth"].max()))
    rows = torch.nonzero(keep).squeeze(1)
    sub = {k: v[rows] for k, v in p.items()}
    scale, op, q = m.activate(sub)
    s = m.screen_splats(sub["xyz"], scale, q, op, cam,
                        torch.ones_like(op, dtype=torch.bool), lowpass=False,
                        tight=True)
    rgb = m.sh_colour(sub, sub["xyz"], cam, cfg["sh_degree"])
    for k in ("a", "b", "c", "op", "radius"):
        s[k] = prec.round_record(s[k])
    rgb = prec.round_record(rgb)
    bg = torch.as_tensor(background, dtype=prec.dtype, device=dev)
    out = composite(s, rgb, cam["H"], cam["W"], bg, min_one=True)
    return {"image": out["image"].float(), "cut": int(rows.shape[0]),
            "combos": out["combos"], "pairs": out["pairs"],
            "splats": int(s["valid"].sum()), "check_combos": check["combos"]}


def quantize(image):
    """The 8-bit frame as the served path makes it: clamp to [0, 1], times
    255, truncated."""
    return (torch.clamp(image, 0, 1) * 255).to(torch.uint8)
