"""The frame dissection on the port: every ms of the serving frame by
stage; counterpart of scripts/bench_frame_dissect.py.

The scene is the JAX script's: `utils/synth_tree.build_scene` on the device
(600k roots, 3.24M points, from PRNGKey(0) as in the JAX script: the same
points, drawn with `utils/jax_random.py`) padded by `pad_scene` in
the root_major layout, SH 0, 1920x1088 at focal 1400, min_res 3, the
flat_slice cut over the alive bucket `cap_sort`. No stage is a copy: the
script runs the port's own stage chains (`train_step.flat_slice_stages`,
`block_render.block_stages`, `train_step.root_cull_stages`), whose
`run_stages` is the frame itself. Each stage is timed alone on the state
the stages before it left (`_common.stage_table`): host ms (a synchronize
around each call), device ms and the launches of every other kernel (the
profiler, in a separate window), the seven kernels' launches (their
counters), host syncs (`torch.cuda.set_sync_debug_mode`) and peak bytes.
The sum of the stages stands beside the whole frame, with the residual.

Budgets are honest: the slice bucket is 1.2x the sizing frame's cut and
every pair budget `budget_for_demand` of the measured demand (the JAX
script clamps `pick_max_pairs(k_vis, per_point=6)`, which can drop pairs);
the cull renders at `render_fused`'s budget, `pick_max_pairs(capacity,
per_point=1)` (fact an). Every timed frame's demand is read back and must
be at or under its budget.

Stage phases (`stages` runs them all): full (`fused_prepare_render`), cut,
act, compact (the sort compaction and K6, LOG_TPU_COMPACT=pallas, side by
side), check (the per-frame slice-axis weight cull), pairs, kernel (K5),
then prefix23 (cut to check), nocheck (pairs and kernel), f2nok (all but
the kernel), fused2, nocull (check_cull=False) and check8 (the check at
1/8 resolution, half the cull budget). `blocks` is the same table for the
block-pruned frame after `build_block_cache`, with the root cull's stages.
TPU-only variants, timed here on the port's path: the JAX `pairs` stage
also projected (the port projects the capacity axis in `cut`); `fused2`
asked whether XLA fused the two halves (eager torch runs the same chain
either way).

Probe phases: headline (the root cull, the fused frame with a fixed cull
mask and the block frame, at min_res 3 and 96), cull (the root cull's
stages with the seg-broadcast expansion against the `w[root_id]` take),
kernel2 (K5 alone on prebuilt pairs, and the tile-starts search), prims
(the torch primitives the frame uses), blocksize (`block_size_for`'s target
from 1,024 to 16,384 rows), demand (unclamped pair demand per camera over
tile heights and binnings; counts only: the port's tile is 8x128) and
trace (a Chrome trace of three full frames, `utils/profiler.profile_if`).

    python -m log_tpu_torch.scripts.bench_frame_dissect [phase ...]
        [--n-roots N] [--reps R] [--min-res M] [--layout L] [--h H]
        [--w W] [--focal F]
"""
from __future__ import annotations

import argparse
import contextlib
import math
import os
import time

import numpy as np
import torch

from . import _common as C

STAGE_PHASES = ("full", "cut", "act", "compact", "check", "pairs", "kernel",
                "prefix23", "nocheck", "f2nok", "fused2", "nocull", "check8")
PROBE_PHASES = ("headline", "cull", "kernel2", "prims", "blocksize",
                "demand", "trace")
DEFAULT_PHASES = ("stages", "blocks")
CAMS = 8
TPU_ONLY = {
    "pairs": "the JAX stage also projected the slice; the port projects the "
             "capacity axis in 'cut', so this is unpack, expansion, sort, "
             "pack",
    "fused2": "asked whether XLA fused the two halves; eager torch runs the "
              "same chain either way, so this is the chain in one go",
}


def make_scene(n_roots: int, layout: str, dev, seed: int = C.SEED):
    """(params, tree arrays, is_leaf_opt, n, cap) of the synthetic scene
    built on the device and padded to next_capacity(n)."""
    from ..model.gaussian import next_capacity
    from ..utils.jax_random import prng_key
    from ..utils.synth_tree import build_scene, pad_scene, tree_sizes

    n = tree_sizes(n_roots)[2]
    cap = next_capacity(n)
    params, tree, leaf = pad_scene(
        *build_scene(n_roots, prng_key(seed), dev), cap, layout)
    return params, tree, leaf, n, cap


class Dissector:
    """The scene, its cameras and budgets, and the frame functions the
    phases time."""

    def __init__(self, n_roots, reps, min_res, layout, h, w, focal, dev):
        from ..model.gaussian import next_capacity
        from ..ops import pick_max_pairs

        self.dev, self.reps, self.min_res = dev, reps, float(min_res)
        self.h, self.w = h, w
        (self.params, self.tree, self.leaf, self.n,
         self.cap) = make_scene(n_roots, layout, dev)
        self.n_roots = min(next_capacity(n_roots), self.cap)
        self.cap_sort = min(self.cap, -(-self.n // (1 << 18)) * (1 << 18))
        self.cull_budget = pick_max_pairs(self.cap, per_point=1)
        self.cam = C.camera_device(C.make_cam(0.7, h, w, focal), dev)
        self.cams = [C.camera_device(C.make_cam(2 * math.pi * i / 32, h, w,
                                                focal), dev)
                     for i in range(CAMS)]
        self.bg = torch.zeros(3, device=dev)
        self.over = []  # (label, demand, budget) of timed calls past it

    # ---------------------------------------------------------- frames
    def common(self, min_res=None, **kw):
        return dict(
            n_alive=self.n, is_leaf_opt=self.leaf,
            min_resolution_pixel=self.min_res if min_res is None
            else float(min_res),
            current_depth=C.CURRENT_DEPTH, background=self.bg,
            image_height=self.h, image_width=self.w, sh_degree=0,
            stage_has_tree=True, num_levels=3, backend="tiled",
            check_scale=C.CHECK_SCALE, cut_method="flat_slice",
            n_roots=self.n_roots, prep_backend="tiled",
            prep_max_pairs=self.cull_budget, cap_sort=self.cap_sort, **kw)

    def root_cull(self, cam, full_cap=False):
        from ..model.train_step import fused_root_cull

        return fused_root_cull(
            self.params, self.tree, cam, self.n, self.h, self.w,
            prep_backend="tiled", prep_max_pairs=self.cull_budget,
            check_scale=C.CHECK_SCALE, n_roots=self.n_roots,
            cap_sort=0 if full_cap else self.cap_sort)

    def size_fused(self, cams, min_res=None, w_full=None, **kw):
        """(k_vis, budget, cut, demands) of the fused frame over cams:
        k_vis 1.2x the first camera's cut, the budget from the largest
        unclamped demand."""
        from ..model.gaussian import next_capacity
        from ..model.train_step import fused_prepare_render
        from ..ops import budget_for_demand

        c = [fused_prepare_render(
            self.params, self.tree, cam, k_visible=min(1 << 21, self.cap_sort),
            max_pairs=min(1 << 21, self.cull_budget), w_full=w_full,
            **self.common(min_res, **kw))[2]
            .cpu().numpy() for cam in cams]
        cut = int(c[0][:2].sum())
        k_vis = min(next_capacity(int(cut * 1.2), 1 << 15), self.cap_sort)
        demands = [int(x[2]) for x in c]
        return (k_vis, budget_for_demand(int(max(demands) * C.REBUMP)), cut,
                demands)

    def checked(self, label, budget):
        """(seen, done): append a timed call's counts to seen; done()
        records the calls whose pair demand (counts[2]) passed budget."""
        seen = []

        def done():
            if not seen:
                return
            d = int(torch.stack([c[2].to(torch.int64) for c in seen]).max())
            if d > budget:
                self.over.append((label, d, budget))
            seen.clear()
        return seen, done

    def rotating(self, fn):
        """fn over the cameras in turn, one per call."""
        it = [0]

        def call():
            out = fn(self.cams[it[0] % len(self.cams)])
            it[0] += 1
            return out
        return call

    def row(self, name, fn, **extra):
        r = C.time_stage(name, fn, self.reps, self.dev)
        r.update(extra)
        return r


def stage_phases(d: Dissector, phases, hold=None) -> dict:
    """The flat_slice frame's stage table and its composite phases."""
    from ..model.train_step import (alive_rows, flat_slice_stages,
                                    fused_prepare_render, run_stages)

    k_vis, budget, cut, demands = d.size_fused([d.cam])
    params, tree, leaf = alive_rows(d.params, d.tree, d.leaf, d.cap_sort)

    def chain(check_scale=C.CHECK_SCALE, prep_max_pairs=d.cull_budget):
        return flat_slice_stages(
            params, tree, d.cam, d.n, leaf, d.min_res, C.CURRENT_DEPTH, d.bg,
            d.h, d.w, k_vis, 0, "antialias", budget, check_scale, d.n_roots,
            "tiled", prep_max_pairs, False, True, None)

    def full(**kw):
        return fused_prepare_render(d.params, d.tree, d.cam, k_visible=k_vis,
                                    max_pairs=budget, **d.common(**kw))

    stages = chain()
    with C.held(hold, "dissect flat_slice"):
        snaps = C.stage_chain(stages)
    names = [n for n, _ in stages]
    idx = {n: i for i, n in enumerate(names)}
    out = {"k_vis": k_vis, "max_pairs": budget, "cut": cut,
           "pairs_measured": demands[0], "cap_sort": d.cap_sort,
           "cull_budget": d.cull_budget, "tpu_only": TPU_ONLY}
    # the chain's frame against the whole function, bit for bit
    img, alpha, counts, _ = full()
    final = snaps[-1]
    out["chain_equal"] = bool(torch.equal(final["render"], img)
                              and torch.equal(final["alpha"], alpha)
                              and torch.equal(final["counts"], counts))
    out["demand"] = int(final["counts"][2])
    if out["demand"] > budget:
        d.over.append(("flat_slice chain", out["demand"], budget))

    def from_snap(i, j=None):
        """Stages i .. j-1 on the state before stage i."""
        sub = stages[i:j]
        return lambda: run_stages(sub, dict(snaps[i]))

    rows = []
    for name in names:
        if name in phases or "stages" in phases:
            rows.append(d.row(name, from_snap(idx[name], idx[name] + 1),
                              note=TPU_ONLY.get(name)))
            if name == "compact":
                with _compact_env("pallas"):
                    with C.held(hold, "dissect compact_k6"):
                        from_snap(idx[name], idx[name] + 1)()
                    rows.append(d.row("compact_k6",
                                      from_snap(idx[name], idx[name] + 1)))
    if rows:
        parts = [r for r in rows if r["stage"] != "compact_k6"]
        out["stages"] = rows
        out["sum"] = C.sum_row("sum", parts)
    want = set(STAGE_PHASES) if "stages" in phases else set(phases)
    extra = []
    if "full" in want:
        extra.append(d.row("full", full))
        if "sum" in out:
            out["residual"] = C.residual(extra[-1], out["sum"])
    if "prefix23" in want:
        extra.append(d.row("prefix23", from_snap(0, idx["check"] + 1)))
    if "nocheck" in want:
        extra.append(d.row("nocheck", from_snap(idx["pairs"])))
    if "f2nok" in want:
        extra.append(d.row("f2nok", from_snap(0, idx["kernel"])))
    if "fused2" in want:
        extra.append(d.row("fused2", from_snap(0),
                           note=TPU_ONLY["fused2"]))
    if "nocull" in want:
        extra.append(d.row("nocull", lambda: full(check_cull=False)))
    if "check8" in want:
        c8 = chain(8, d.cull_budget // 2)
        extra.append(d.row("check8", lambda: c8[idx["check"]][1](
            dict(snaps[idx["check"]]))))
    out["phases"] = extra
    return out


@contextlib.contextmanager
def _compact_env(value):
    old = os.environ.get("LOG_TPU_COMPACT")
    os.environ["LOG_TPU_COMPACT"] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("LOG_TPU_COMPACT")
        else:
            os.environ["LOG_TPU_COMPACT"] = old


def block_cache(d: Dissector, target: int = 4096):
    from ..model.block_render import block_size_for, build_block_cache

    S = block_size_for(d.cap, target)
    cols, meta = build_block_cache(d.params, d.tree, d.leaf, d.n, S)
    return cols, meta, S


def size_blocks(d: Dissector, cols, meta, S, w_full, cams, min_res):
    """(k_blocks, k_vis, budget, cut) of the block frame over cams, as
    _common.block_cell sizes it."""
    from ..model.block_render import render_blocks
    from ..model.gaussian import next_capacity
    from ..ops import budget_for_demand

    B = d.cap // S
    c = np.stack([render_blocks(
        cols, meta, cam, float(min_res), C.CURRENT_DEPTH, d.bg, d.h, d.w,
        k_blocks=B, k_visible=min(1 << 21, d.cap),
        max_pairs=min(1 << 22, d.cull_budget),
        w_full=w_full)[2].cpu().numpy() for cam in cams])
    cut = int(c[0, :2].sum())
    k_vis = min(next_capacity(int(cut * 1.2), 1 << 15), d.cap)
    kb = min(B, max(16, -(-int(int(c[:, 3].max()) * 1.3) // 16) * 16))
    return kb, k_vis, budget_for_demand(int(c[:, 2].max() * C.REBUMP)), cut


def blocks_phase(d: Dissector, hold=None) -> dict:
    """The block-pruned frame's stage table (after build_block_cache, with
    the full-capacity cull mask fixed) and the root cull's."""
    from ..model.block_render import block_stages, render_blocks
    from ..model.train_step import root_cull_stages, run_stages

    cols, meta, S = block_cache(d)
    cull_stages = root_cull_stages(
        d.params, d.tree, d.cam, d.n, d.h, d.w, prep_backend="tiled",
        prep_max_pairs=d.cull_budget, check_scale=C.CHECK_SCALE,
        n_roots=d.n_roots)
    w_full = run_stages(cull_stages)["w_full"]
    kb, k_vis, budget, cut = size_blocks(d, cols, meta, S, w_full, [d.cam],
                                         d.min_res)
    stages = block_stages(cols, meta, d.cam, d.min_res, C.CURRENT_DEPTH,
                          d.bg, d.h, d.w, kb, k_vis, budget, w_full)
    with C.held(hold, "dissect blocks"):
        snaps = C.stage_chain(stages)
    img, alpha, counts = render_blocks(
        cols, meta, d.cam, d.min_res, C.CURRENT_DEPTH, d.bg, d.h, d.w, kb,
        k_vis, budget, w_full)
    final = snaps[-1]
    out = {"S": S, "k_blocks": kb, "blocks_total": d.cap // S,
           "k_vis": k_vis, "max_pairs": budget, "cut": cut,
           "chain_equal": bool(torch.equal(final["render"], img)
                               and torch.equal(final["alpha"], alpha)
                               and torch.equal(final["counts"], counts)),
           "demand": int(final["counts"][2]),
           "blocks_eligible": int(final["counts"][3])}
    if out["demand"] > budget:
        d.over.append(("blocks chain", out["demand"], budget))
    rows, _ = C.stage_table(stages, d.reps, d.dev)
    out["stages"], out["sum"] = rows[:-1], rows[-1]
    full = d.row("full", lambda: render_blocks(
        cols, meta, d.cam, d.min_res, C.CURRENT_DEPTH, d.bg, d.h, d.w, kb,
        k_vis, budget, w_full))
    out["phases"] = [full]
    out["residual"] = C.residual(full, out["sum"])
    crow, _ = C.stage_table(cull_stages, d.reps, d.dev)
    out["cull_stages"], out["cull_sum"] = crow[:-1], crow[-1]
    return out


def headline_phase(d: Dissector) -> dict:
    """Per-frame calls of the serving split: the root cull (alive bucket and
    full capacity), the fused frame and the block frame with a fixed cull
    mask, at d.min_res and 96, over the rotating cameras."""
    from ..model.block_render import render_blocks
    from ..model.train_step import fused_prepare_render

    cols, meta, S = block_cache(d)
    out = {}
    for min_res in (d.min_res, 96.0):
        w0 = d.root_cull(d.cams[0])
        k_vis, budget, cut, demands = d.size_fused(d.cams, min_res, w0)
        seen, done = d.checked(f"headline fused {min_res:g}", budget)

        def fused(cam):
            r = fused_prepare_render(
                d.params, d.tree, cam, k_visible=k_vis, max_pairs=budget,
                w_full=w0, **d.common(min_res))
            seen.append(r[2])
            return r

        wf = d.root_cull(d.cams[0], full_cap=True)
        kb, k_visb, budget_b, cutb = size_blocks(d, cols, meta, S, wf,
                                                 d.cams, min_res)
        seen_b, done_b = d.checked(f"headline blocks {min_res:g}", budget_b)

        def blocks(cam):
            r = render_blocks(cols, meta, cam, float(min_res),
                              C.CURRENT_DEPTH, d.bg, d.h, d.w, kb, k_visb,
                              budget_b, wf)
            seen_b.append(r[2])
            return r

        rows = [d.row("root_cull_bucket", d.rotating(d.root_cull)),
                d.row("root_cull_fullcap", d.rotating(
                    lambda cam: d.root_cull(cam, full_cap=True))),
                d.row("fused_frame_w_fixed", d.rotating(fused)),
                d.row("block_frame_w_fixed", d.rotating(blocks))]
        done()
        done_b()
        out[f"min_res_{min_res:g}"] = {
            "cut": cut, "k_vis": k_vis, "max_pairs": budget,
            "demand_per_camera": demands, "blocks_cut": cutb,
            "blocks_k_vis": k_visb, "blocks_max_pairs": budget_b,
            "k_blocks": kb, "rows": rows}
    return out


def cull_phase(d: Dissector) -> dict:
    """fused_root_cull over the alive bucket by stage, and its expansion
    two ways: the seg-broadcast (scatter-max + cummax over the root_major
    segments, the default where cull_seg_starts exists) and the
    w[root_id] take (the same function without the segment starts)."""
    from ..model.train_step import (alive_rows, expand_weight_full,
                                    root_cull_stages)

    stages = root_cull_stages(
        d.params, d.tree, d.cam, d.n, d.h, d.w, prep_backend="tiled",
        prep_max_pairs=d.cull_budget, check_scale=C.CHECK_SCALE,
        n_roots=d.n_roots, cap_sort=d.cap_sort)
    rows, state = C.stage_table(stages, d.reps, d.dev)
    _, tree, _ = alive_rows(d.params, d.tree, None, d.cap_sort)
    no_seg = {k: v for k, v in tree.items() if k != "cull_seg_starts"}
    ok = state["weight_ok"]
    seg = expand_weight_full(ok, tree, d.cap_sort, d.n_roots)
    take = expand_weight_full(ok, no_seg, d.cap_sort, d.n_roots)
    alive = torch.arange(d.cap_sort, device=d.dev) < d.n
    return {
        "stages": rows[:-1], "sum": rows[-1],
        "has_seg_starts": "cull_seg_starts" in tree,
        "branches_equal_on_alive_rows": bool(torch.equal(seg[alive],
                                                         take[alive])),
        "expand_seg_broadcast": d.row("expand_seg_broadcast",
                                      lambda: expand_weight_full(
                                          ok, tree, d.cap_sort, d.n_roots)),
        "expand_take": d.row("expand_take", lambda: expand_weight_full(
            ok, no_seg, d.cap_sort, d.n_roots)),
        "roots_kept": int(ok.sum()), "rows": d.cap_sort}


def kernel2_phase(d: Dissector, hold=None) -> dict:
    """K5 alone on the packed pair records that the flat_slice chain built
    for two cameras (alternating), and the tile-starts search over a sorted
    tile column of the budget's length."""
    from ..model.train_step import alive_rows, flat_slice_stages
    from ..ops import rasterize_tiled as rt

    w0 = d.root_cull(d.cams[0])
    k_vis, budget, _, _ = d.size_fused(d.cams[:2], w_full=w0)
    params, tree, leaf = alive_rows(d.params, d.tree, d.leaf, d.cap_sort)
    data = []
    for cam in d.cams[:2]:
        st = flat_slice_stages(
            params, tree, cam, d.n, leaf, d.min_res, C.CURRENT_DEPTH, d.bg,
            d.h, d.w, k_vis, 0, "antialias", budget, C.CHECK_SCALE,
            d.n_roots, "tiled", d.cull_budget, False, False, w0[:d.cap_sort])
        s = C.stage_chain(st[:-1])[-1]
        data.append(s["pairs"])
    it = [0]

    def k5():
        pd, start, count, tx, ty, _ = data[it[0] % 2]
        it[0] += 1
        return rt.rasterize_forward_packed(pd, start, count, d.bg, tx, ty)

    with C.held(hold, "dissect kernel2"):
        k5()
    tiles_x, tiles_y = data[0][3], data[0][4]
    nt = tiles_x * tiles_y
    tile_s = torch.sort(torch.cumsum(torch.ones(budget, dtype=torch.int32,
                                                device=d.dev), 0) % nt).values
    bounds = torch.arange(nt + 1, dtype=torch.int32, device=d.dev)
    return {"pairs": [int(x[-1]) for x in data], "max_pairs": budget,
            "k5": d.row("k5_packed_forward", k5),
            "tile_starts": d.row("searchsorted_tile_starts",
                                 lambda: torch.searchsorted(tile_s, bounds))}


def prims_phase(d: Dissector) -> dict:
    """The torch primitives the frame is made of, at the alive bucket's
    length: takes of a root verdict by random and by sorted root ids
    (advanced indexing and index_select), a take of 1.08M run roots,
    scatter_reduce(amax) of R codes into cap_sort rows, torch.cummax,
    their composition (the seg-broadcast), repeat_interleave, and the
    int64 sort of cap_sort keys with one payload gather."""
    R, n = d.n_roots, d.cap_sort
    g = torch.Generator(device=d.dev).manual_seed(0)
    rid = torch.randint(0, R, (n,), generator=g, device=d.dev)
    rid_sorted = torch.sort(rid).values
    counts = torch.bincount(rid, minlength=R)
    starts = torch.cumsum(counts, 0) - counts
    w = [torch.rand(R, generator=g, device=d.dev) > 0.5 for _ in range(4)]
    runs = torch.randint(0, R, (1_080_000,), generator=g, device=d.dev)
    key = torch.randint(0, 1 << 62, (n,), generator=g, device=d.dev)
    pay = torch.rand(n, generator=g, device=d.dev)
    it = [0]

    def wi():
        it[0] += 1
        return w[it[0] % 4]

    def scatter():
        b = torch.zeros(n + 1, dtype=torch.int64, device=d.dev)
        return b.scatter_reduce_(0, starts, starts * 2 + wi() + 1, "amax")

    b0 = scatter()
    return {"rows": [
        d.row(f"take_{n}_random", lambda: wi()[rid]),
        d.row(f"index_select_{n}_sorted",
              lambda: torch.index_select(wi(), 0, rid_sorted)),
        d.row("take_1080000_run_roots", lambda: wi()[runs]),
        d.row(f"scatter_reduce_amax_{R}_to_{n}", scatter),
        d.row(f"cummax_{n}", lambda: torch.cummax(b0[:n], 0)),
        d.row("scatter_cummax_broadcast",
              lambda: (torch.cummax(scatter()[:n], 0).values & 1)),
        d.row("repeat_interleave_segments",
              lambda: torch.repeat_interleave(wi(), counts,
                                              output_size=n)),
        d.row(f"sort_int64_{n}_payload_gather",
              lambda: pay[torch.sort(key).indices]),
    ]}


def blocksize_phase(d: Dissector) -> dict:
    """The block frame at min_res d.min_res and 96 for block_size_for's
    targets 1,024-16,384 rows (a size that does not divide the capacity
    falls to a smaller power of two)."""
    from ..model.block_render import render_blocks

    wf = d.root_cull(d.cams[0], full_cap=True)
    out = []
    for target in (1024, 2048, 4096, 8192, 16384):
        cols, meta, S = block_cache(d, target)
        for min_res in (d.min_res, 96.0):
            kb, k_vis, budget, cut = size_blocks(
                d, cols, meta, S, wf, d.cams[:1] + d.cams[3:7:3], min_res)
            seen, done = d.checked(f"blocksize {S} {min_res:g}", budget)

            def frame(cam):
                r = render_blocks(cols, meta, cam, float(min_res),
                                  C.CURRENT_DEPTH, d.bg, d.h, d.w, kb, k_vis,
                                  budget, wf)
                seen.append(r[2])
                return r

            out.append(d.row(f"S{S}_minres{min_res:g}", d.rotating(frame),
                             target=target, S=S, min_res=min_res, cut=cut,
                             k_blocks=kb, rows=kb * S, max_pairs=budget))
            done()
        del cols, meta
    return {"rows": out}


def demand_phase(d: Dissector) -> dict:
    """The unclamped pair demand of the flat cut per camera, at tile
    heights 8, 16 and 32 (width 128) with the circle rect (radius) and the
    ellipse bbox (`splat_extents`) binning; counts only. The port's own
    binning is the 8-row ellipse bbox."""
    from ..model.train_step import alive_rows, flat_slice_stages
    from ..ops import rasterize_tiled as rt

    params, tree, leaf = alive_rows(d.params, d.tree, d.leaf, d.cap_sort)
    out = []
    for min_res in (d.min_res, 96.0):
        per = {}
        for cam in d.cams:
            st = flat_slice_stages(
                params, tree, cam, d.n, leaf, float(min_res),
                C.CURRENT_DEPTH, d.bg, d.h, d.w, 1 << 15, 0, "antialias",
                1 << 16, C.CHECK_SCALE, d.n_roots, "tiled", d.cull_budget,
                False, False, None)
            s = C.stage_chain(st[:1])[-1]
            sp, keep = s["splats"], s["keep"]
            valid = sp.valid & (sp.radius > 0) & keep
            ext = rt.splat_extents(sp.cxx, sp.cxy, sp.cyy, sp.opacity,
                                   sp.radius)
            for tile_h in (8, 16, 32):
                for bbox in (False, True):
                    ex, ey = ext if bbox else (sp.radius, sp.radius)
                    tx, ty = -(-d.w // 128), -(-d.h // tile_h)
                    x0 = torch.clamp(((sp.px - ex) / 128).int(), 0, tx)
                    y0 = torch.clamp(((sp.py - ey) / tile_h).int(), 0, ty)
                    x1 = torch.clamp(((sp.px + ex + 127) / 128).int(), 0, tx)
                    y1 = torch.clamp(((sp.py + ey + tile_h - 1) / tile_h)
                                     .int(), 0, ty)
                    pairs = torch.where(valid, torch.clamp(x1 - x0, min=0)
                                        * torch.clamp(y1 - y0, min=0), 0)
                    per.setdefault((tile_h, bbox), []).append(
                        int(pairs.sum()))
        for (tile_h, bbox), v in per.items():
            out.append({"min_res": min_res, "tile_h": tile_h, "bbox": bbox,
                        "max": max(v), "mean": float(np.mean(v)),
                        "min": min(v), "per_camera": v})
    return {"rows": out}


def trace_phase(d: Dissector, logdir: str) -> dict:
    from ..model.train_step import fused_prepare_render
    from ..utils.profiler import profile_if

    k_vis, budget, _, _ = d.size_fused([d.cam])

    def frame():
        return fused_prepare_render(d.params, d.tree, d.cam, k_visible=k_vis,
                                    max_pairs=budget, **d.common())

    frame()
    C.sync(d.dev)
    with profile_if(True, logdir):
        for _ in range(3):
            frame()
        C.sync(d.dev)
    return {"logdir": logdir}


def run(phases=DEFAULT_PHASES, n_roots: int = 600_000, reps: int = 10,
        min_res: float = 3.0, layout: str = "root_major", h: int = 1088,
        w: int = 1920, focal: float = 1400.0,
        trace_dir: str = "output/dissect_trace", device=None,
        hold=None) -> dict:
    """The phases named (stage names, "stages" for all of them, "blocks",
    and the probe phases) on one scene; hold(label) wraps the first call
    of the chains, of the K6 compaction and of K5 in kernel2 (chip_smoke.py
    holds their kernel calls against the plain versions). Raises where a
    timed call's pair demand passed its budget."""
    dev = C.resolve_device(device)
    phases = tuple(phases)
    unknown = set(phases) - set(STAGE_PHASES) - set(PROBE_PHASES) - {
        "stages", "blocks"}
    if unknown:
        raise ValueError(f"unknown phases {sorted(unknown)}")
    d = Dissector(n_roots, reps, min_res, layout, h, w, focal, dev)
    out = {"metric": "frame_dissect", "card": C.card_line(dev),
           "n_points": d.n, "capacity": d.cap, "n_roots": n_roots,
           "layout": layout, "h": h, "w": w, "focal": focal,
           "min_res": float(min_res), "reps": reps, "phases": list(phases)}
    wall = out["phase_wall_s"] = {}

    def timed_phase(name, fn):
        t0 = time.perf_counter()
        res = fn()
        wall[name] = time.perf_counter() - t0
        return res

    if set(phases) & (set(STAGE_PHASES) | {"stages"}):
        out["flat_slice"] = timed_phase(
            "stages", lambda: stage_phases(d, phases, hold))
    if "blocks" in phases:
        out["blocks"] = timed_phase("blocks", lambda: blocks_phase(d, hold))
    probes = {"headline": lambda: headline_phase(d),
              "cull": lambda: cull_phase(d),
              "kernel2": lambda: kernel2_phase(d, hold),
              "prims": lambda: prims_phase(d),
              "blocksize": lambda: blocksize_phase(d),
              "demand": lambda: demand_phase(d),
              "trace": lambda: trace_phase(d, trace_dir)}
    for name, fn in probes.items():
        if name in phases:
            out[name] = timed_phase(name, fn)
    out["budget_overflow"] = d.over
    if d.over:
        raise RuntimeError(f"timed calls past their pair budget: {d.over}")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("phases", nargs="*", default=list(DEFAULT_PHASES))
    ap.add_argument("--n-roots", type=int, default=600_000)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--min-res", type=float, default=3.0)
    ap.add_argument("--layout", default="root_major")
    ap.add_argument("--h", type=int, default=1088)
    ap.add_argument("--w", type=int, default=1920)
    ap.add_argument("--focal", type=float, default=1400.0)
    a = ap.parse_args(argv)
    C.emit(run(a.phases, a.n_roots, a.reps, a.min_res, a.layout, a.h, a.w,
               a.focal))


if __name__ == "__main__":
    main()
