"""3840x2160 frames of the 3.24M-point synthetic tree; counterpart of
scripts/bench_4k.py (BASELINE.json configs[4], the city-scale 4K
fly-through).

The JAX script's scene: `padded_model_device(PRNGKey(0), 600_000, cap,
"root_major")` (_common.PaddedTree, drawn on the card with the JAX
package's random numbers; SH degree 0) and its block cache, with no `LoG`
model; the JAX script's orbit (2 pi i / 26 at focal 2800: twice the 1080p
scripts' focal, the same field of view at twice the pixels), of which a
run with fewer frames takes the first poses. The block-pruned frame
(`render_blocks`) with the capacity-axis weight cull (`fused_root_cull`)
every 4 frames, at min_res 96 (a realistic cut) and at min_res 3 (the
dense cut), each through the honest loop of _common. The first and middle
frames of the min_res 96 orbit are written as JPEG and the orbit as an mp4
(utils/image_io.make_video) under `out_dir`. Then one 4K frame of the
tree's roots as a BaseGaussian from a close pose through
`NaiveRendererAndLoss.render_one`, whose demand is logged against the
2^23 rail: the frame must keep every pair (a check of the port's own; the
JAX script has no such frame).

What still differs from the JAX script: the budgets. Its cull composites
at most 1 << 19 pairs (ROADMAP fact an) and its block frames take the
ladder of the sizing frames' demand; here every budget holds the measured
demand (_common.honest_frames).

    python -m log_tpu_torch.scripts.bench_4k [n_roots] [frames]
"""
from __future__ import annotations

import os
import sys
import time

import torch

from . import _common as C

H, W = 2160, 3840
FOCAL = 2800.0
ORBIT_TURNS = 26  # the JAX script's FRAMES + 2 poses around the orbit
OUT_DIR = "output/bench4k_torch"
CLOSE_POSE = {"theta": 0.3, "height": 4.5, "radius": 5.5}


def check_grid(h: int, w: int) -> tuple[int, int]:
    """The tile grid of an h x w frame; the binning packs a rect's geometry
    as x0 + 32 * (y0 + 512 * width) in one int32, so the grid must fit in
    32 tile columns and 512 tile rows (4K: 30 x 270)."""
    from ..ops.rasterize_tiled import TILE_H, TILE_W

    tiles = (-(-w // TILE_W), -(-h // TILE_H))
    assert tiles[0] <= 32 and tiles[1] <= 512, tiles
    return tiles


def write_orbit(frame, cull, cams, frames: int, cull_every: int, max_pairs,
                out_dir: str, label: str) -> dict:
    """The cell's orbit rendered again and written as numbered JPEGs, the
    first and middle ones also by name, and their mp4."""
    from ..render.renderer import BaseRender
    from ..utils import image_io

    folder = os.path.join(out_dir, f"flythrough_4k_{label}")
    os.makedirs(folder, exist_ok=True)
    w = None
    named = []
    for i in range(frames):
        if i % cull_every == 0:
            w = cull(cams[2 + i])
        bgr = BaseRender.tensor_to_bgr(frame(cams[2 + i], w, max_pairs)[0])
        image_io.imwrite(os.path.join(folder, f"{i:06d}.jpg"), bgr)
        if i in (0, frames // 2):
            named.append(image_io.imwrite(
                os.path.join(out_dir, f"frame_{label}_{i:03d}.jpg"), bgr))
    image_io.make_video(folder, fps=12)
    video = folder + ".mp4"
    return {"frames_written": named,
            "video": video if os.path.exists(video) else None}


def vanilla_close_frame(roots: dict, n_roots: int, dev, h: int, w: int,
                        focal: float, hold=None) -> dict:
    """The roots (synth_tree.roots_record) as a BaseGaussian (SH 1) from
    CLOSE_POSE through render_one: the frustum mask, the capacity's pair
    budget, and a second binning at budget_for_demand(demand) where the
    frame needs more."""
    from ..model.base_gaussian import BaseGaussian
    from ..ops import PAIR_RAIL
    from ..render.renderer import NaiveRendererAndLoss

    model = BaseGaussian.create_from_record(roots, sh_degree=1, device=dev)
    model.eval()
    model.set_state(enable_sh=True)
    renderer = NaiveRendererAndLoss(split="demo", device=dev)
    cam = C.make_cam(CLOSE_POSE["theta"], h, w, focal, CLOSE_POSE["height"],
                     CLOSE_POSE["radius"])
    with C.held(hold, "4k vanilla frame"):
        model.prepare_from_camera(cam)
        renderer.render_one(model, cam, renderer.background)
    before = dict(C.kernels.LAUNCHES)
    C.sync(dev)
    t0 = time.perf_counter()
    model.prepare_from_camera(cam)
    out = renderer.render_one(model, cam, renderer.background)
    C.sync(dev)
    ms = (time.perf_counter() - t0) * 1e3
    demand = int(out["pair_total"])
    return {"points": n_roots, "pose": CLOSE_POSE, "ms": ms,
            "pairs_measured": demand, "max_pairs": int(out["max_pairs"]),
            "rail": PAIR_RAIL, "past_rail": demand > PAIR_RAIL,
            "budget_overflow": demand > int(out["max_pairs"]),
            "finite": C.finite(out), "launches": C.launches_since(before)}


def run(n_roots: int = 600_000, frames: int = 24, h: int = H, w: int = W,
        focal: float = FOCAL, device=None, hold=None,
        out_dir: str = OUT_DIR) -> dict:
    from ..utils.synth_tree import roots_record

    dev = C.resolve_device(device)
    tiles = check_grid(h, w)
    t0 = time.perf_counter()
    tree = C.PaddedTree(n_roots, dev)
    C.sync(dev)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tree.build_block_cache()
    C.sync(dev)
    out = {"metric": "fps_4k_3840x2160_blocks", "card": C.card_line(dev),
           "n_roots": n_roots, "n_points": tree.n, "capacity": tree.cap,
           "h": h, "w": w, "focal": focal, "tiles": list(tiles),
           "build_s": build_s, "block_cache_s": time.perf_counter() - t0}
    cams = C.orbit(frames + 2, h, w, focal, dev, turns=ORBIT_TURNS)
    for min_res, label in ((96.0, "minres96"), (3.0, "minres3")):
        cell, (frame, cull) = C.block_cell(
            tree, cams, min_res, frames, 4, dev, sizing=(8, 16), hold=hold,
            label=f"4k blocks {label}")
        if label == "minres96":
            cell.update(write_orbit(frame, cull, cams, frames, 4,
                                    cell["max_pairs"], out_dir, label))
        out[label] = cell
    out["value"] = out["minres96"]["fps"]
    out["budget_overflow"] = (out["minres96"]["budget_overflow"]
                              or out["minres3"]["budget_overflow"])
    roots = roots_record({f"gaussian.{k}": v[:n_roots].cpu().numpy()
                          for k, v in tree.params.items()}, n_roots)
    del tree, cell, frame, cull
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["vanilla_close"] = vanilla_close_frame(roots, n_roots, dev, h, w,
                                               focal, hold)
    return out


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    kw = {}
    if argv:
        kw["n_roots"] = int(argv[0])
    if len(argv) > 1:
        kw["frames"] = int(argv[1])
    C.emit(run(**kw))


if __name__ == "__main__":
    main()
