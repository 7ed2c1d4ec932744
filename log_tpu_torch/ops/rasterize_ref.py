"""Reference rasterizer: alpha compositing in plain torch; counterpart of
log_tpu/ops/rasterize_ref.py.

The oracle the tiled path is checked against and the "reference" backend for
small scenes. O(P * H * W): every (gaussian, pixel) pair is evaluated, over
depth-sorted chunks of `chunk` gaussians.

Output contract:
  render             (3, H, W) composited image over `background`
  radii              (P,)  int32 pixel radius, 0 = culled
  point_id_pixel     (H, W) int32 argmax-blend-weight contributor, -1 = none
  point_weight_pixel (H, W) max blend weight per pixel
  point_weight       (P,)  max blend weight of each gaussian over all pixels
  alpha              (H, W) 1 - final transmittance
  depth_cam          (P,)  camera-space depth
Compositing matches the Inria forward loop: alpha clamped to 0.99, skipped
below 1/255, contribution dropped once transmittance would fall under 1e-4.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .projection import ALPHA_MAX, ALPHA_MIN, T_EPS, Splats, project_gaussians


def _chunk_body(xy, cn, op, col, trans, gx, gy):
    """One depth-sorted chunk over all pixels: its color contribution
    (n_pix, C), its transmittance product (n_pix,), the per-pixel max
    weight and its lane (n_pix,), and the per-gaussian max weight
    (chunk,)."""
    dx = xy[:, 0:1] - gx[None, :]  # (chunk, n_pix)
    dy = xy[:, 1:2] - gy[None, :]
    power = -0.5 * (cn[:, 0:1] * dx * dx + cn[:, 2:3] * dy * dy) \
        - cn[:, 1:2] * dx * dy
    alpha = torch.clamp(op[:, None] * torch.exp(power), max=ALPHA_MAX)
    alpha = torch.where((power <= 0.0) & (alpha >= ALPHA_MIN), alpha, 0.0)

    cp_incl = torch.cumprod(1.0 - alpha, dim=0)
    cp_excl = torch.cat([torch.ones_like(cp_incl[:1]), cp_incl[:-1]], 0)
    t_after = trans[None, :] * cp_incl
    w = trans[None, :] * cp_excl * alpha
    w = torch.where(t_after >= T_EPS, w, 0.0)
    cw, ca = torch.max(w, dim=0)
    return w.T @ col, cp_incl[-1], cw, ca, torch.max(w, dim=1).values


def _composite(splats: Splats, colors, image_height: int, image_width: int,
               background, chunk: int):
    """Depth-sorted front-to-back compositing over all pixels. With
    autograd on, each chunk is recomputed in the backward
    (torch.utils.checkpoint): its (chunk, H*W) intermediates are not kept,
    so the saved tensors are O(H*W) per chunk, as the JAX package's
    jax.checkpoint of its scan body gives."""
    P = splats.opacity.shape[0]
    dev = colors.device
    n_pix = image_height * image_width
    n_chan = colors.shape[-1]

    depth_key = torch.where(splats.valid, splats.depth, torch.inf)
    order = torch.argsort(depth_key, stable=True)
    pix_xy = splats.pix_xy[order]
    conic = splats.conic[order]
    opac = splats.opacity[order]
    cols = colors[order]

    gx = torch.arange(image_width, dtype=torch.float32, device=dev).repeat(
        image_height
    )
    gy = torch.arange(image_height, dtype=torch.float32,
                      device=dev).repeat_interleave(image_width)

    color_acc = torch.zeros((n_pix, n_chan), dtype=torch.float32, device=dev)
    trans = torch.ones((n_pix,), dtype=torch.float32, device=dev)
    best_w = torch.zeros((n_pix,), dtype=torch.float32, device=dev)
    best_id = torch.full((n_pix,), -1, dtype=torch.int64, device=dev)
    point_weight = torch.zeros((P,), dtype=torch.float32, device=dev)
    remat = torch.is_grad_enabled()
    for c0 in range(0, P, chunk):
        sl = slice(c0, min(c0 + chunk, P))
        inputs = (pix_xy[sl], conic[sl], opac[sl], cols[sl], trans, gx, gy)
        if remat:
            out = checkpoint(_chunk_body, *inputs, use_reentrant=False,
                             preserve_rng_state=False)
        else:
            out = _chunk_body(*inputs)
        color_add, trans_chunk, cw, ca, pw = out
        color_acc = color_acc + color_add
        trans = trans * trans_chunk
        take = cw > best_w
        best_w = torch.where(take, cw, best_w)
        best_id = torch.where(take, c0 + ca, best_id)
        point_weight[sl] = pw

    image = color_acc + trans[:, None] * background[None, :].to(torch.float32)
    image = image.T.reshape(n_chan, image_height, image_width)
    point_id_pixel = torch.where(
        best_id >= 0, order[torch.clamp(best_id, min=0)], -1
    ).to(torch.int32).reshape(image_height, image_width)
    pw = torch.zeros_like(point_weight)
    pw[order] = point_weight
    alpha_map = (1.0 - trans).reshape(image_height, image_width)
    return (image, point_id_pixel, best_w.reshape(image_height, image_width),
            pw, alpha_map)


def rasterize(
    xyz, colors, opacity, scaling, rotation, means2d_offset, world_view,
    full_proj, focal_x, focal_y, tan_fovx, tan_fovy, background,
    image_height: int, image_width: int, active_mask=None,
    mode: str = "antialias", use_filter: bool = True, chunk: int = 32,
):
    """Rasterize activated Gaussians (see the module doc). Inputs may be
    capacity-padded; `active_mask` culls the padding. Differentiable under
    autograd (the serving callers run it under torch.no_grad)."""
    splats = project_gaussians(
        xyz, scaling, rotation, opacity, world_view, full_proj, focal_x,
        focal_y, tan_fovx, tan_fovy, image_height, image_width, mode=mode,
        use_filter=use_filter, means2d_offset=means2d_offset,
        active_mask=active_mask,
    )
    image, pid, pwp, pw, alpha_map = _composite(
        splats, colors, image_height, image_width, background, chunk
    )
    return {
        "render": image,
        "radii": splats.radius.to(torch.int32),
        "point_id_pixel": pid,
        "point_weight_pixel": pwp,
        "point_weight": pw,
        "alpha": alpha_map,
        "depth_cam": splats.depth,
    }
