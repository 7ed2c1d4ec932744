"""One card at the scale of an urban block: the 10.26M-point synthetic tree
(1.9M roots by tree_sizes, a capacity of 12,582,912 rows); counterpart of
scripts/bench_capacity.py (BASELINE.json configs[3], "UrbanScene3D block
~10M Gaussians").

The JAX script's scene: `padded_model_device(PRNGKey(0), 1_900_000, cap,
"root_major")` (_common.PaddedTree, drawn on the card with the JAX
package's random numbers; SH degree 0) and its block cache, with no `LoG`
model; the JAX script's orbit (2 pi i / 14), of which a run with fewer
frames takes the first poses; the step's GT `uniform(PRNGKey(7)) * 255` as
uint8. The JAX step also takes `PRNGKey(1)`, the key of its depth patches;
the port's step takes no key where it renders no depth.

Measures:
- the tree's build on the card (seconds) and device memory at rest, with
  the block cache (utils/hbm.py; beside the bytes the caller held before
  the build), and the peak of the training steps;
- three 1080p cells through the honest loop of _common: the block-pruned
  frame at min_res 96 and at min_res 3, and the fused flat_slice frame
  (`fused_prepare_render`) at min_res 96, each culled every 4 frames;
- the tree-stage training step at this capacity: `fused_prepare_train_step`
  on the flat cut at min_res 96, zero moments; the median of the timed
  steps after the warm-up ones;
- that `SparseOptimizer.maybe_spill` does not engage at this size (its
  thresholds: 50M and 100M points).

What still differs from the JAX script: the budgets (ROADMAP facts an and
ao). Its cull composites at most 1 << 19 pairs, and its step keeps one
leaf bucket and no node bucket, which at min_res 96 drops every node of
the cut (this orbit's cut is roots, which are nodes), so its step renders
nothing. Here the cull's budget holds the capacity, each bucket of the
step's cut (leaf and node rows) is next_capacity(1.3 x its count in the
fused cell's sizing frame, 2^15), the JAX script's rule for its one leaf
bucket, and the step's pair budget holds the measured demand
(bench_trainstep's rule, _common.honest_steps).

The compaction's i32 columns are exact below 2^24 rows (ROADMAP fact c),
which bounds the capacity of this cell on one card at 16,777,216 rows.

    python -m log_tpu_torch.scripts.bench_capacity [n_roots] [frames]
"""
from __future__ import annotations

import inspect
import sys
import time

import numpy as np
import torch

from . import _common as C

N_ROOTS = 1_900_000
H, W = 1088, 1920
FOCAL = 1400.0
ORBIT_TURNS = 14  # the JAX script's FRAMES + 2 poses around the orbit
GT_SEED = 7  # the step's GT: uniform(PRNGKey(7))
ROW_LIMIT = 1 << 24  # the compaction's i32 columns are exact below it


def memory(dev) -> dict | None:
    """utils/hbm.hbm_usage on the card (None on the CPU)."""
    if dev.type != "cuda":
        return None
    from ..utils.hbm import hbm_usage

    return hbm_usage(dev)


def fused_cell(tree: C.PaddedTree, cams, min_res: float, frames: int,
               cull_every: int, dev, hold=None, label="fused"):
    """The fused flat_slice frame (fused_prepare_render with the cull's
    w_full at the alive bucket cap_sort) through the honest loop: the slice
    bucket 1.2x the sizing frame's cut, the pair budget
    budget_for_demand(1.25x the larger of its demand and the bucket).
    Returns (cell dict, (frame, cull))."""
    from ..model.gaussian import next_capacity
    from ..model.train_step import fused_prepare_render, fused_root_cull
    from ..ops import budget_for_demand, pick_max_pairs

    params, arrays, cap, n = tree.params, tree.tree, tree.cap, tree.n
    cap_sort = min(cap, -(-n // (1 << 18)) * (1 << 18))
    H_, W_ = cams[0]["image_height"], cams[0]["image_width"]
    common = dict(
        n_alive=n, is_leaf_opt=tree.leaf,
        min_resolution_pixel=float(min_res), current_depth=C.CURRENT_DEPTH,
        background=torch.zeros(3, device=dev), image_height=H_,
        image_width=W_, sh_degree=0, stage_has_tree=True,
        num_levels=tree.num_levels, backend="tiled",
        check_scale=C.CHECK_SCALE, cut_method="flat_slice",
        n_roots=tree.n_roots, prep_backend="tiled",
        prep_max_pairs=pick_max_pairs(cap, per_point=1), cap_sort=cap_sort)

    def cull(cam):
        return fused_root_cull(
            params, arrays, cam, n, H_, W_, prep_backend="tiled",
            prep_max_pairs=pick_max_pairs(cap, per_point=1),
            check_scale=C.CHECK_SCALE, n_roots=tree.n_roots,
            cap_sort=cap_sort)

    _, _, c, _ = fused_prepare_render(
        params, arrays, cams[0], k_visible=min(1 << 21, cap_sort),
        max_pairs=min(1 << 21, pick_max_pairs(cap, per_point=1)),
        w_full=cull(cams[0]), **common)
    c = c.cpu().numpy()
    cut = int(c[:2].sum())
    k_vis = min(next_capacity(int(cut * 1.2), 1 << 15), cap_sort)

    def frame(cam, w_full, max_pairs):
        img, _, counts, _ = fused_prepare_render(
            params, arrays, cam, k_visible=k_vis, max_pairs=max_pairs,
            w_full=w_full, **common)
        return img, counts

    cell = C.honest_frames(
        frame, cull, cams, budget_for_demand(int(max(c[2], k_vis) * 1.25)),
        frames, cull_every, dev, hold, label)
    cell.update(min_res_pixel=float(min_res), cut=cut, cut_leaf=int(c[0]),
                cut_node=int(c[1]), k_vis=k_vis,
                cut_overflow=max(cell["cut_per_frame"]) > k_vis,
                sizing_demand=int(c[2]), cap_sort=cap_sort)
    return cell, (frame, cull)


def make_step(tree: C.PaddedTree, cams, cut_leaf: int, cut_node: int, dev,
              min_res: float = 96.0):
    """The tree-stage step on the flat cut at min_res over the capacity
    axis: each bucket next_capacity(1.3 x its count, 2^15) (none for no
    nodes), zero moments, a fresh counter, the JAX script's 8-bit GT
    (GT_SEED). Returns
    (step(i) -> metrics, state [params, moments, counter, gain], cfg);
    step i trains on cams[i % len(cams)] and updates the state."""
    from ..model.gaussian import next_capacity
    from ..model.train_step import StepConfig, fused_prepare_train_step
    from ..ops import pick_max_pairs
    from ..utils.jax_random import prng_key
    from .bench_trainstep import random_gt, step_inputs

    cap = tree.cap
    H_, W_ = cams[0]["image_height"], cams[0]["image_width"]
    params = tree.params
    moments, counter, lrs, corr = step_inputs(params, dev)

    def bucket(count):
        return 0 if count == 0 else min(
            next_capacity(int(count * 1.3), 1 << 15), cap)

    k_leaf, k_node = bucket(cut_leaf), bucket(cut_node)
    cfg = StepConfig(image_height=H_, image_width=W_, k_leaf=k_leaf,
                     k_node=k_node, sh_degree=0, mode="antialias",
                     backend="tiled",
                     max_pairs=pick_max_pairs(k_leaf + k_node))
    gt = random_gt(H_, W_, dev, prng_key(GT_SEED))
    bg = torch.zeros(3, device=dev)
    ones = torch.ones((1, 1, 1), device=dev)
    state = [params, moments, counter, corr]

    def step(i, cfg):
        p, m, c, co, metrics, _ = fused_prepare_train_step(
            *state[:3], tree.tree, tree.n, tree.leaf, min_res,
            C.CURRENT_DEPTH, cams[i % len(cams)], gt, bg, lrs, float(i + 1),
            state[3], 0, ones, None, stage_has_tree=True,
            num_levels=tree.num_levels, prep_backend="tiled",
            prep_max_pairs=pick_max_pairs(cap), check_scale=C.CHECK_SCALE,
            cfg=cfg, cut_method="flat", n_roots=tree.n_roots)
        state[:] = [p, m, c, co]
        return metrics

    return step, state, cfg


def train_cell(tree: C.PaddedTree, cams, cut_leaf: int, cut_node: int,
               steps: int, warmup: int, dev, hold=None) -> dict:
    """make_step's step through _common.honest_steps, with the device
    memory after the warm-up steps."""
    step, state, cfg = make_step(tree, cams, cut_leaf, cut_node, dev)
    warm = {}

    def counted(i, cfg):
        metrics = step(i, cfg)
        if i == warmup:
            warm["memory"] = memory(dev)
        return metrics

    out = C.honest_steps(counted, cfg, steps, warmup, dev, hold,
                         "capacity step")
    kept = np.array(out["kept"])
    out.update(k_leaf=cfg.k_leaf, k_node=cfg.k_node,
               cut_overflow=bool((kept[:, 0] > cfg.k_leaf).any()
                                 or (kept[:, 1] > cfg.k_node).any()),
               memory_after_warmup=warm.get("memory"),
               finite=C.finite({"p": state[0], "m": state[1],
                                "c": state[2]}))
    return out


def spill_check(n_points: int) -> dict:
    """maybe_spill at n_points with the optimizer's own default thresholds
    (no moments are moved: a fresh optimizer without state)."""
    from ..model.sparse_optimizer import SparseOptimizer

    sig = inspect.signature(SparseOptimizer.__init__).parameters
    opt = SparseOptimizer.__new__(SparseOptimizer)
    opt.spilled = ()
    opt.spill_points = sig["spill_points"].default
    opt.spill_points_full = sig["spill_points_full"].default
    return {"engaged": bool(opt.maybe_spill(int(n_points))),
            "threshold_points": opt.spill_points,
            "threshold_points_full": opt.spill_points_full}


def run(n_roots: int = N_ROOTS, frames: int = 12, steps: int = 8,
        warmup: int = 2, h: int = H, w: int = W, focal: float = FOCAL,
        device=None, hold=None) -> dict:
    dev = C.resolve_device(device)
    before = C.live_bytes(dev)  # what the caller holds on the card already
    t0 = time.perf_counter()
    tree = C.PaddedTree(n_roots, dev)
    C.sync(dev)
    build_s = time.perf_counter() - t0
    if tree.cap >= ROW_LIMIT:
        raise ValueError(f"capacity {tree.cap} reaches {ROW_LIMIT} rows: "
                         f"the compaction's i32 columns are not exact")
    out = {"metric": "capacity_10m_single_card", "card": C.card_line(dev),
           "n_roots": n_roots, "n_points": tree.n, "capacity": tree.cap,
           "h": h, "w": w, "build_s": build_s, "live_bytes_before": before,
           "memory_at_rest": memory(dev)}
    t0 = time.perf_counter()
    tree.build_block_cache()
    C.sync(dev)
    out["block_cache_s"] = time.perf_counter() - t0
    out["memory_with_block_cache"] = memory(dev)
    cams = C.orbit(frames + 2, h, w, focal, dev, turns=ORBIT_TURNS)
    for min_res, label in ((96.0, "blocks_minres96"), (3.0, "blocks_minres3")):
        out[label], _ = C.block_cell(tree, cams, min_res, frames, 4, dev,
                                     sizing=(4, 8), hold=hold,
                                     label=f"capacity {label}")
    out["fused_minres96"], _ = fused_cell(tree, cams, 96.0, frames, 4, dev,
                                          hold, "capacity fused_minres96")
    out["memory_after_render"] = memory(dev)
    out["budget_overflow"] = any(out[k]["budget_overflow"] for k in (
        "blocks_minres96", "blocks_minres3", "fused_minres96"))
    fused = out["fused_minres96"]
    out["train"] = train_cell(tree, cams, fused["cut_leaf"],
                              fused["cut_node"], steps, warmup, dev, hold)
    out["spill"] = spill_check(tree.n)
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
