"""The frame's phases on a multi-M-point tree; counterpart of the
prepare, render and fused phases of scripts/bench_explore.py.

The scene is `utils/synth_tree.build_scene` on the device (n_roots roots,
from PRNGKey(0) as in the JAX script) in the level layout, 1920x1088 at
focal 1400, min_res 3, the generic flat cut (`cut_method="flat"`, SH 0):

  prepare   `prepare_visibility`: the frustum test, the root weight cull at
            1/4 resolution and the flat cut over the capacity; and again
            with the cull at 1/16 resolution;
  render    the render alone at the cut of the first camera: the
            compaction to the slice bucket and `rasterize_tiled` (K4, K3,
            the pair sort, K1 without stats);
  fused     `fused_prepare_render`: both in one call.

Each phase is a `_common.time_stage` row over 20 orbit cameras in turn.
The slice bucket is 1.3x the first camera's cut (the JAX script's rule);
the pair budget and the cull's come from the measured demand
(`budget_for_demand`; the JAX script's fixed 2^21 can drop pairs), and
every timed frame's demand must be at or under it.

    python -m log_tpu_torch.scripts.bench_explore [n_roots] [phase ...]
"""
from __future__ import annotations

import argparse
import math

import torch

from . import _common as C

FRAMES = 20
PHASES = ("prepare", "render", "fused")


def run(n_roots: int = 600_000, phases=PHASES, frames: int = FRAMES,
        h: int = 1088, w: int = 1920, focal: float = 1400.0,
        device=None) -> dict:
    from ..model.gaussian import next_capacity
    from ..model.train_step import (_compact_slices_gather,
                                    fused_prepare_render, prepare_visibility)
    from ..ops import budget_for_demand, pick_max_pairs
    from ..ops.rasterize_tiled import rasterize_tiled
    from ..ops.sh import sh_to_rgb
    from .bench_frame_dissect import make_scene

    dev = C.resolve_device(device)
    params, tree, leaf, n, cap = make_scene(n_roots, "level", dev)
    n_roots_b = min(next_capacity(n_roots), cap)
    cams = [C.camera_device(C.make_cam(2 * math.pi * i / (frames + 2), h, w,
                                       focal), dev)
            for i in range(frames + 2)]
    cull_budget = pick_max_pairs(cap, per_point=1)
    common = dict(n_alive=n, is_leaf_opt=leaf, min_resolution_pixel=3.0,
                  current_depth=C.CURRENT_DEPTH, image_height=h,
                  image_width=w, stage_has_tree=True, num_levels=3,
                  backend="tiled", prep_backend="tiled",
                  prep_max_pairs=cull_budget, check_scale=C.CHECK_SCALE,
                  cut_method="flat", n_roots=n_roots_b)
    bg = torch.zeros(3, device=dev)

    def prep(cam, check_scale=C.CHECK_SCALE):
        return prepare_visibility(
            params, tree, cam, n, leaf, 3.0, C.CURRENT_DEPTH, h, w, True, 3,
            "antialias", "tiled", cull_budget, check_scale, "flat",
            n_roots_b)

    kl, kn, counts = prep(cams[0])
    cut = int(counts.sum())
    k_vis = min(next_capacity(int(cut * 1.3), 1 << 15), cap)
    # the demand of every camera sizes the one budget
    demands = [int(fused_prepare_render(
        params, tree, cam, background=bg, k_visible=k_vis, sh_degree=0,
        max_pairs=min(1 << 21, cull_budget), **common)[3]) for cam in cams]
    budget = budget_for_demand(int(max(demands) * C.REBUMP))
    keep = kl | kn
    it = [0]
    seen = []

    def rotating(fn):
        def call():
            it[0] += 1
            return fn(cams[2 + it[0] % frames])
        return call

    def render_only(cam):
        need = ["xyz", "colors", "scaling", "opacity", "rotation"]
        slices, _, lane_valid = _compact_slices_gather(
            {k: params[k] for k in need}, keep, k_vis)
        out = rasterize_tiled(
            xyz=slices["xyz"], colors=sh_to_rgb(slices["colors"]),
            opacity=torch.sigmoid(slices["opacity"][:, 0]),
            scaling=torch.exp(slices["scaling"]),
            rotation=slices["rotation"] / torch.linalg.norm(
                slices["rotation"], dim=-1, keepdim=True),
            means2d_offset=torch.zeros((k_vis, 2), device=dev),
            world_view=cam["world_view"], full_proj=cam["full_proj"],
            focal_x=cam["focal_x"], focal_y=cam["focal_y"],
            tan_fovx=cam["tan_fovx"], tan_fovy=cam["tan_fovy"],
            background=bg, image_height=h, image_width=w,
            active_mask=lane_valid, mode="antialias", use_filter=False,
            max_pairs=budget, with_stats=False)
        seen.append(out["pair_total"])
        return out["render"]

    def fused(cam):
        out = fused_prepare_render(params, tree, cam, background=bg,
                                   k_visible=k_vis, sh_degree=0,
                                   max_pairs=budget, **common)
        seen.append(out[3])
        return out

    rows = []
    if "prepare" in phases:
        rows.append(C.time_stage("prepare", rotating(prep), frames, dev))
        rows.append(C.time_stage("prepare_check16", rotating(
            lambda cam: prep(cam, 16)), frames, dev))
    if "render" in phases:
        rows.append(C.time_stage("render", rotating(render_only), frames,
                                 dev))
    if "fused" in phases:
        rows.append(C.time_stage("fused", rotating(fused), frames, dev))
    measured = max([int(x) for x in seen] or [0])
    out = {"metric": "explore_1080p", "card": C.card_line(dev),
           "n_roots": n_roots, "n_points": n, "capacity": cap,
           "cut_leaf": int(counts[0]), "cut_node": int(counts[1]),
           "k_vis": k_vis, "max_pairs": budget, "demand_per_camera": demands,
           "pairs_measured": measured, "budget_overflow": measured > budget,
           "rows": rows}
    if out["budget_overflow"]:
        raise RuntimeError(f"a timed frame's pair demand {measured} passed "
                           f"its budget {budget}")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_roots", nargs="?", type=int, default=600_000)
    ap.add_argument("phases", nargs="*", default=list(PHASES))
    a = ap.parse_args(argv)
    C.emit(run(a.n_roots, a.phases))


if __name__ == "__main__":
    main()
