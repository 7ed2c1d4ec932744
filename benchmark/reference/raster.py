"""Tiled front-to-back compositing in plain PyTorch.

The screen is cut into tiles of 8 rows x 128 columns. A splat is listed
in every tile its box covers: the box of the region where its alpha can
reach 1/255 (at most 3 standard deviations out), one pixel wider, and no
wider than its radius. Each pixel of a tile composites the tile's splats
in depth order: alpha = min(0.99, opacity exp(power)), a splat is skipped
where power > 0 or alpha < 1/255, and a splat adds its colour only where
the transmittance after it stays at 1e-4 or more. The transmittance is
that of LoG-TPU's compositing kernels (the JAX package's and the port's
alike): a tile's pairs, in the order they are binned, are walked in
chunks of 128 from the multiple of 128 at or below the tile's first pair;
every pixel multiplies its transmittance by 1 - alpha of every splat of a
chunk, past its own stop too, and the tile stops after the first chunk at
whose end every pixel is below 1e-4. The final transmittance, which
weighs the background, is where the walk stopped. The result is the
colour, the final transmittance and, per splat, its largest blend weight
over all pixels.

The box's far tile edge is the 3D Gaussian Splatting rasterizer's
`(int)((p + extent + tile - 1) / tile)`, which leaves out the tile of a
box that ends a fraction of a pixel into it. The frame's binning (the
served frame and the root cull's check render; `min_one`) lists a splat
whose box covers no whole tile in the tile at the box's top-left corner
all the same; the training render's does not.

Tiles go in groups, as dense (tiles, splats of the longest tile, 1024
pixels) blocks; with autograd on, each group is recomputed in the
backward (torch.utils.checkpoint), so what is kept is one group's inputs.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .math import ALPHA_MAX, ALPHA_MIN, T_MIN

TILE_H, TILE_W = 8, 128
TILE_PIX = TILE_H * TILE_W
CHUNK = 128   # the pairs a tile walks at a time
# elements of one group's (tiles x splats) index block: each float
# temporary of a group is this times 1024 pixels x 4 bytes (512 MiB)
GROUP_ELEMS = 1 << 17


def _tile_of(v, n_tiles: int):
    return torch.clamp(torch.clamp(v, -1.0, float(n_tiles + 1)).to(torch.int64),
                       0, n_tiles)


def tile_boxes(s: dict, H: int, W: int):
    """Per splat its tile box [x0, x1) x [y0, y1) and the grid size."""
    tx, ty = -(-W // TILE_W), -(-H // TILE_H)
    a, b, c, op, radius = s["a"], s["b"], s["c"], s["op"], s["radius"]
    det = a * c - b * b
    pos = det > 0
    inv = 1.0 / torch.where(pos, det, torch.ones_like(det))
    reach = torch.sqrt(torch.clamp(2.0 * torch.log(255.0 * op), 0.0, 9.0))
    ex = reach * torch.sqrt(torch.clamp(c * inv, min=0.0)) + 1.0
    ey = reach * torch.sqrt(torch.clamp(a * inv, min=0.0)) + 1.0
    ex = torch.minimum(torch.where(pos, ex, radius), radius)
    ey = torch.minimum(torch.where(pos, ey, radius), radius)
    px, py = s["px"], s["py"]
    x0 = _tile_of((px - ex) / TILE_W, tx)
    x1 = _tile_of((px + ex + TILE_W - 1) / TILE_W, tx)
    y0 = _tile_of((py - ey) / TILE_H, ty)
    y1 = _tile_of((py + ey + TILE_H - 1) / TILE_H, ty)
    live = s["valid"] & (radius > 0)
    w = torch.where(live, torch.clamp(x1 - x0, min=0), 0)
    h = torch.where(live, torch.clamp(y1 - y0, min=0), 0)
    return x0, y0, w, h, tx, ty


def bin_pairs(s: dict, H: int, W: int, min_one: bool):
    """(splat id, tile id) of every (splat, covered tile) pair, ordered by
    tile and within a tile by depth, and the grid size."""
    x0, y0, w, h, tx, ty = tile_boxes(s, H, W)
    n = (w * h).to(torch.int64)
    if min_one:
        live = s["valid"] & (s["radius"] > 0)
        n = torch.where(live, torch.clamp(n, min=1), n)
        w = torch.clamp(w, min=1)
    sid = torch.repeat_interleave(torch.arange(n.shape[0], device=n.device), n)
    k = torch.arange(sid.shape[0], device=n.device) - (torch.cumsum(n, 0)
                                                       - n)[sid]
    tile = (y0[sid] + k // w[sid]) * tx + x0[sid] + k % w[sid]
    on_grid = tile < tx * ty
    sid, tile = sid[on_grid], tile[on_grid]
    by_depth = torch.argsort(s["depth"].float()[sid], stable=True)
    sid, tile = sid[by_depth], tile[by_depth]
    by_tile = torch.argsort(tile, stable=True)
    return sid[by_tile], tile[by_tile], tx, ty


def _group(px, py, a, b, c, op, rgb, live, gx, gy, phase):
    """One group of tiles: (G, L) splat attributes, (G, 1024) pixel
    coordinates, (G,) the place of each tile's first pair in its chunk.
    Returns colour (G, 3, 1024), final transmittance (G, 1024), each
    slot's largest weight (G, L) and the number of contributing (splat,
    pixel) combinations, in the attributes' dtype from the float32
    offsets."""
    dx = (px[:, :, None] - gx[:, None, :]).to(a.dtype)
    dy = (py[:, :, None] - gy[:, None, :]).to(a.dtype)
    power = -0.5 * (a[:, :, None] * dx * dx + c[:, :, None] * dy * dy) \
        - b[:, :, None] * dx * dy
    alpha = torch.clamp(op[:, :, None] * torch.exp(power), max=ALPHA_MAX)
    gate = live[:, :, None] & (power <= 0) & (alpha >= ALPHA_MIN)
    alpha = torch.where(gate, alpha, torch.zeros_like(alpha))
    keep = 1.0 - alpha
    t_after = torch.cumprod(keep, dim=1)
    t_before = torch.cat([torch.ones_like(t_after[:, :1]), t_after[:, :-1]], 1)
    used = gate & (t_after >= T_MIN)
    w = torch.where(used, t_before * alpha, torch.zeros_like(alpha))
    colour = torch.einsum("glp,glc->gcp", w, rgb)
    with torch.no_grad():   # the slots walked: to the end of the chunk
        # after which the whole tile is below T_MIN
        sat = t_after.amax(dim=2) < T_MIN
        first = torch.where(sat.any(dim=1), sat.to(torch.int32).argmax(dim=1),
                            sat.shape[1])
        end = ((phase + first) // CHUNK + 1) * CHUNK - phase
        walked = torch.arange(sat.shape[1], device=sat.device)[None] \
            < end[:, None]
    t_final = torch.prod(torch.where(walked[:, :, None], keep,
                                     torch.ones_like(keep)), dim=1)
    return colour, t_final, w.amax(dim=2), used.sum()


def composite(s: dict, rgb, H: int, W: int, background, point_weight=False,
              min_one=False):
    """Render splats `s` (screen_splats) with colours rgb (N, 3) over
    `background` (3,), binned as bin_pairs says. Returns a dict: image (3, H, W), t_final (H, W),
    combos (contributing (splat, pixel) pairs, an int), pairs (the
    (splat, tile) pairs) and, with point_weight, each splat's largest
    blend weight (N,)."""
    sid, tile, tx, ty = bin_pairs(s, H, W, min_one)
    dev, dt = rgb.device, rgb.dtype
    n_tiles = tx * ty
    counts = torch.bincount(tile, minlength=n_tiles)
    starts = torch.cumsum(counts, 0) - counts
    order = torch.argsort(counts, descending=True)
    counts_h = counts[order].tolist()
    lane = torch.arange(TILE_PIX, device=dev)
    lx = (lane % TILE_W).to(torch.float32)
    ly = (lane // TILE_W).to(torch.float32)
    colour = torch.zeros((n_tiles, 3, TILE_PIX), dtype=dt, device=dev)
    t_final = torch.ones((n_tiles, TILE_PIX), dtype=dt, device=dev)
    pw = torch.zeros(rgb.shape[0] + 1, dtype=dt, device=dev)
    combos = 0
    n_pairs = sid.shape[0]
    attrs = [s[k] for k in ("px", "py", "a", "b", "c", "op")]
    i = 0
    while i < n_tiles and counts_h[i] > 0:
        L = counts_h[i]
        G = max(1, min(GROUP_ELEMS // L, n_tiles - i))
        t_ids = order[i:i + G]
        i += G
        slot = torch.arange(L, device=dev)
        live = slot[None, :] < counts[t_ids, None]
        idx = torch.clamp(starts[t_ids, None] + slot, max=max(n_pairs - 1, 0))
        ids = torch.where(live, sid[idx], rgb.shape[0])
        gx = ((t_ids % tx) * TILE_W).to(torch.float32)[:, None] + lx
        gy = ((t_ids // tx) * TILE_H).to(torch.float32)[:, None] + ly
        sl = torch.clamp(ids, max=rgb.shape[0] - 1)
        args = [v[sl] for v in attrs] + [rgb[sl], live, gx, gy,
                                         starts[t_ids] % CHUNK]
        if torch.is_grad_enabled():
            out = checkpoint(_group, *args, use_reentrant=False,
                             preserve_rng_state=False)
        else:
            out = _group(*args)
        c_g, t_g, w_g, n_g = out
        colour = colour.index_copy(0, t_ids, c_g)
        t_final = t_final.index_copy(0, t_ids, t_g)
        combos += int(n_g)
        if point_weight:
            pw = pw.scatter_reduce(0, ids.reshape(-1), w_g.detach().reshape(-1),
                                   reduce="amax")
    image = colour + t_final[:, None, :] * background.to(dt)[None, :, None]
    image = image.reshape(ty, tx, 3, TILE_H, TILE_W).permute(2, 0, 3, 1, 4)
    image = image.reshape(3, ty * TILE_H, tx * TILE_W)[:, :H, :W]
    t_img = t_final.reshape(ty, tx, TILE_H, TILE_W).permute(0, 2, 1, 3)
    t_img = t_img.reshape(ty * TILE_H, tx * TILE_W)[:H, :W]
    out = {"image": image, "t_final": t_img, "combos": combos,
           "pairs": n_pairs}
    if point_weight:
        out["point_weight"] = pw[:-1]
    return out
