"""The band-exchange sharded render at the serving scale, on NCCL ranks
where the machine has a card for each, else on gloo ranks on the CPU;
counterpart of scripts/check_sharded_fullscale.py.

`parallel/sharded_render.sharded_render_frame` runs over the frame
dissection's scene (`build_scene` + `pad_scene`, 600k roots = 3.24M
points, root_major, then `interleave_shard_rows`, the executor's strided
layout; every rank draws it from the seed on the CPU and moves it to its
device) and its orbit (1920x1088, focal 1400, min_res 3: camera i at
2 pi i / 32) on `world` ranks in as many processes
(`parallel/launch.spawn`): NCCL, rank r on card r, where the reference
runs on the card and the machine has `world` cards (NCCL cannot put two
ranks on one card), else gloo. The forward band kernel (K1) runs on NCCL
ranks and is skipped by default on gloo ones, as in the JAX script (the
plain K1 at this scale takes minutes on the CPU): the exchange statistics
are computed before it. Per camera it records the largest bucket overflow
(it must be 0), the launches, the (n_src, n_dst) exchange-length matrix
and the pairs exchanged against the single-card frame's pair demand (`fused_prepare_render`'s flat_slice
column route without the cull, the frame the sharded one matches), which
runs on the card unless device="cpu".

The budgets come from the single-card frames: k_local 1.5x a rank's share
of the largest cut, the pair budget `budget_for_demand` of 1.5x a rank's
share of the largest demand (a multiple of 512), and the (src, dst) bucket
`budget_for_demand` of three times the mean exchange length.

    python -m log_tpu_torch.scripts.check_sharded_fullscale [n_roots]
        [frames] [--world N] [--with-kernel]

(under a `__main__` guard in any script that calls `run`: the ranks
are spawned processes).
"""
from __future__ import annotations

import argparse
import math
import time

import torch

from . import _common as C

H, W = 1088, 1920
MIN_RES = 3.0
WIRE_BYTES_PER_PAIR = 48  # 10 f32 value rows + the tile and gid int32s


def _no_kernel(pair_data, tile_start, tile_count, background, tiles_x,
               tiles_y, with_stats):
    """K1's outputs as zeros: the statistics do not depend on it."""
    shape = (3, tiles_y * 8, tiles_x * 128)
    z = torch.zeros(shape, device=pair_data.device)
    return z, torch.ones(shape[1:], device=pair_data.device), None, None, \
        None, None


def _scene(n_roots, seed, layout="root_major"):
    from ..model.gaussian import next_capacity
    from ..utils.jax_random import prng_key
    from ..utils.synth_tree import build_scene, pad_scene, tree_sizes

    n = tree_sizes(n_roots)[2]
    params, tree, _ = pad_scene(
        *build_scene(n_roots, prng_key(seed), "cpu"), next_capacity(n),
        layout)
    return params, tree, n


def _cams(frames, h, w, focal, dev="cpu"):
    """The frame dissection's orbit: camera i at 2 pi i / 32."""
    return [C.camera_device(C.make_cam(2 * math.pi * i / 32, h, w, focal),
                            dev) for i in range(frames)]


def _rank(rank, world, device, scene, n_roots, frames, h, w, focal, cfg,
          threads, with_kernel):
    from ..ops import kernels
    from ..ops import rasterize_tiled as rt
    from ..parallel.sharded_render import (ShardedRenderConfig,
                                           interleave_shard_rows,
                                           sharded_render_frame)

    torch.set_num_threads(threads)
    if scene is None:
        params, tree, n = _scene(n_roots, C.SEED)
    else:
        params, tree, n = (
            {k: torch.from_numpy(v) for k, v in scene[0].items()},
            {k: torch.from_numpy(v) for k, v in scene[1].items()}, scene[2])
    params = interleave_shard_rows(
        {k: v.to(device) for k, v in params.items()}, world)
    tree = interleave_shard_rows(
        {k: v.to(device) for k, v in tree.items()}, world)
    if not with_kernel:
        rt.rasterize_forward = _no_kernel
    out = []
    for cam in _cams(frames, h, w, focal, device):
        C.sync(device)
        kernels.reset_launches()
        t0 = time.perf_counter()
        img, _, stats = sharded_render_frame(
            params, tree, cam, n, MIN_RES, C.CURRENT_DEPTH,
            torch.zeros(3, device=device), ShardedRenderConfig(**cfg))
        C.sync(device)
        out.append({"stats": [int(x) for x in stats],
                    "wall_s": time.perf_counter() - t0,
                    "image_std": float(img.std()) if with_kernel else None,
                    "launches": dict(kernels.LAUNCHES)})
    return out


def single_card(params, tree, n, cams, h, w, k_visible):
    """(cut, pair demand) of each camera's single-card frame: the
    flat_slice column route without the cull at SH 0."""
    from ..model.train_step import fused_prepare_render
    from ..ops import pick_max_pairs

    leaf = (tree["node_index"] == -1) & (tree["depth"] > 0)
    bg = torch.zeros(3, device=leaf.device)
    res = []
    for cam in cams:
        _, _, c, _ = fused_prepare_render(
            params, tree, cam, n, leaf, MIN_RES, C.CURRENT_DEPTH, bg, h, w,
            k_visible=k_visible, sh_degree=0,
            stage_has_tree=True, num_levels=3,
            max_pairs=pick_max_pairs(params["xyz"].shape[0], per_point=1),
            cut_method="flat_slice", check_cull=False, pack_pairs=False)
        res.append((int(c[0] + c[1]), int(c[2])))
    return res


def run(n_roots: int = 600_000, frames: int = 8, world: int = 2,
        h: int = H, w: int = W, focal: float = 1400.0, threads: int = 0,
        with_kernel: bool | None = None, scene=None,
        timeout_s: float = 1800.0, device=None) -> dict:
    """scene: (params, tree arrays, n) as numpy dicts already padded (the
    ranks then use it in place of building the scene). threads: torch
    threads per rank (0: the cores over the ranks). device: where the
    single-card reference frames run (the card unless "cpu"); the ranks are
    NCCL ones where that is the card and the machine has `world` cards,
    gloo ones on the CPU otherwise. with_kernel: run K1 in the bands (None:
    on NCCL ranks only)."""
    from ..model.gaussian import next_capacity
    from ..ops import budget_for_demand
    from ..parallel.launch import spawn

    dev = C.resolve_device(device)
    nccl = dev.type == "cuda" and torch.cuda.device_count() >= world
    with_kernel = nccl if with_kernel is None else bool(with_kernel)
    threads = threads or max(1, torch.get_num_threads() // world)
    t0 = time.perf_counter()
    if scene is None:
        params, tree, n = _scene(n_roots, C.SEED)
    else:
        params = {k: torch.from_numpy(v) for k, v in scene[0].items()}
        tree = {k: torch.from_numpy(v) for k, v in scene[1].items()}
        n = scene[2]
    cap = params["xyz"].shape[0]
    ref = single_card({k: v.to(dev) for k, v in params.items()},
                      {k: v.to(dev) for k, v in tree.items()}, n,
                      _cams(frames, h, w, focal, dev), h, w,
                      min(cap, 1 << 21))
    del params, tree
    max_cut = max(c for c, _ in ref)
    max_demand = max(d for _, d in ref)
    cfg = dict(image_height=h, image_width=w, n_devices=world,
               k_local=min(cap // world,
                           next_capacity(int(max_cut * 1.5 / world), 4096)),
               max_pairs_local=-(-budget_for_demand(
                   int(max_demand * 1.5 / world)) // 512) * 512,
               bucket_pairs=budget_for_demand(
                   int(3 * max_demand / world ** 2)),
               sh_degree=0, min_res_pixel=MIN_RES, layout="strided")
    setup_s = time.perf_counter() - t0
    ranks = spawn(_rank, world, "cuda" if nccl else "cpu", args=(
        scene, n_roots, frames, h, w, focal, cfg, threads, with_kernel),
        timeout_s=timeout_s)
    per = []
    for i, fr in enumerate(ranks[0]):
        s = fr["stats"]
        lens = [s[3 + r * world:3 + (r + 1) * world] for r in range(world)]
        per.append({"cam": i, "cut": s[0], "pairs_exchanged": s[1],
                    "bucket_overflow": s[2], "lens": lens,
                    "lens_max": max(max(r) for r in lens),
                    "single_card_cut": ref[i][0],
                    "single_card_demand": ref[i][1],
                    "wall_s": fr["wall_s"], "image_std": fr["image_std"],
                    "launches": fr["launches"]})
    out = {"metric": f"sharded_fullscale_{'nccl' if nccl else 'gloo'}",
           "card": C.card_line(dev), "n_points": n,
           "capacity": cap, "world": world, "threads_per_rank": threads,
           "with_kernel": with_kernel, "config": cfg, "setup_s": setup_s,
           "frames": per,
           "ranks_agree": all(
               [f["stats"] for f in r] == [f["stats"] for f in ranks[0]]
               for r in ranks[1:]),
           "max_overflow": max(f["bucket_overflow"] for f in per),
           "max_pairs_exchanged": max(f["pairs_exchanged"] for f in per),
           "max_bucket_fill": max(f["lens_max"] for f in per)
           / cfg["bucket_pairs"],
           "wire_bytes_per_pair": WIRE_BYTES_PER_PAIR}
    out["wire_mb_per_frame"] = (out["max_pairs_exchanged"]
                                * WIRE_BYTES_PER_PAIR / 1e6)
    out["wire_mb_per_frame_bucket_capacity"] = (
        world * world * cfg["bucket_pairs"] * WIRE_BYTES_PER_PAIR / 1e6)
    if out["max_overflow"]:
        raise RuntimeError(f"bucket overflow at {world} ranks: {per}")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_roots", nargs="?", type=int, default=600_000)
    ap.add_argument("frames", nargs="?", type=int, default=8)
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--with-kernel", action="store_true",
                    help="K1 in the bands on gloo ranks too")
    a = ap.parse_args(argv)
    C.emit(run(a.n_roots, a.frames, a.world,
               with_kernel=a.with_kernel or None))


if __name__ == "__main__":
    main()
