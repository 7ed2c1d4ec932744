"""The repo's benchmark on the port: bench.py's four 1080p cells on one
card; counterpart of bench.py.

The scene is bench.py's: the synthetic tree of n_roots roots (600k ->
3.24M points, a capacity of 4,194,304 rows) built on the device
(`utils/synth_tree.build_scene` from PRNGKey(0), bench.py's key: the same
points, drawn with `utils/jax_random.py`) and padded by `pad_scene` in the
root_major layout; SH degree 0, 3 levels, current depth 20, check scale 4,
a black background; an orbit of frames + 2 cameras at 2 pi i /
(frames + 2) (focal 1400, height 18, radius 22). The cells, under
bench.py's labels and JSON keys:

- headline, `minres3_cullfirst_perframe`: the reference's per-frame order
  (LoG/model/level_of_gaussian.py:229-243 culls the roots before the tree
  cut): the root cull over the alive bucket cap_sort (`fused_root_cull`'s
  stages, whose state also holds the check render's pair demand), then
  `fused_prepare_render(cut_method="flat_slice", w_full=...)`, every frame,
  at min_res 3;
- blocks_cull4, `minres3_blocks_cull4`: `render_blocks` after
  `build_block_cache`, the full-capacity cull every 4 frames;
- secondary, `realistic_minres{mr}_cullfirst_perframe`: the headline at
  the first min_res of FIND_CANDIDATES whose cut holds at most 300,000
  points, the reference's real-scene live set (`find_min_res_for_cut`);
- secondary_blocks_cull4, `realistic_minres{mr}_blocks_cull4`.

Sizing, value for value bench.py's (the helpers below): n_roots_bucket,
cap_sort, the slice bucket k_vis and the pair budget from the first
camera's sizing frame, the block bucket from the eligible blocks at
cameras 0, 8, 16 and 24; two warm-up frames at cameras 0 and 1, then
`frames` timed frames at cameras 2 onward.

Changed from bench.py, each for a reason:
- the cull renders at render_fused's budget, pick_max_pairs(capacity,
  per_point=1), not 1 << 19, which drops pairs and so roots past 524,288
  composited pairs (ROADMAP fact an); each cell reports its culls' largest
  demand as cull_pairs beside BENCH_CULL_PAIRS;
- honest budgets to the end: `_common.honest_frames` times a cell again at
  a raised budget where a timed frame's demand passed it, up to TRIES
  times; a cell whose timed cut passed its slice bucket (which
  fused_prepare_render truncates without a word) or whose eligible blocks
  passed its block bucket is timed again at buckets sized from them; a
  cell that still overflows, or a cull past its budget, raises;
- no fallback: bench.py builds the block cache inside a try, falls back to
  the fused frame where the block path fails, retries without the quadform
  kernel and drops the memory report on any error; here a failure raises;
- timing on the card: each cell's pass over its frames is timed `repeats`
  times between two synchronizes (ms_per_frame is the median pass); in
  separate passes over the same frames, the profiler's device time, its
  kernel launches and its top device ops, and the host syncs
  (set_sync_debug_mode); every timed frame's finiteness and the peak
  memory of the timed passes. hbm_* is torch.cuda's allocated bytes and the card's total
  memory, in GiB.

hold(label), where given, wraps a replay of each cell's first timed frame
with its cull after the timing (chip_smoke.py records its kernel calls
there and holds them against the plain versions).

    python -m log_tpu_torch.scripts.bench [n_roots]
"""
from __future__ import annotations

import sys
import time

import torch

from . import _common as C

N_ROOTS = 600_000
H, W = 1088, 1920
FOCAL = 1400.0
FRAMES, REPEATS = 30, 5
SH_DEGREE, NUM_LEVELS = 0, 3
HEADLINE_MIN_RES = 3.0
REALISTIC_CUT = 300_000
FIND_CANDIDATES = (12.0, 18.0, 24.0, 36.0, 48.0, 64.0, 96.0)
BLOCK_SIZING_CAMS = (0, 8, 16, 24)
SIZING_BUCKET = 1 << 21  # the sizing frames' slice bucket and pair budget
BENCH_CULL_PAIRS = 1 << 19  # bench.py's cull budget (ROADMAP fact an)
BASELINE_FPS = 30.0  # BASELINE.md's bar: 30 fps at 1080p
CELLS = ("headline", "blocks_cull4", "secondary", "secondary_blocks_cull4")
TOP_OPS = 5
GIB = 2 ** 30


def n_roots_bucket(n_roots: int, cap: int) -> int:
    from ..model.gaussian import next_capacity

    return min(next_capacity(n_roots), cap)


def cap_sort_for(n: int, cap: int) -> int:
    """The alive bucket: n rounded up to 2^18 rows."""
    return min(cap, -(-n // (1 << 18)) * (1 << 18))


def k_vis_for(cut: int, cap: int) -> int:
    """The slice bucket: 1.2x the cut, at least 2^15 rows."""
    from ..model.gaussian import next_capacity

    return min(next_capacity(int(cut * 1.2), 1 << 15), cap)


def fused_budget(k_vis: int, demand: int) -> int:
    """The fused frame's pair budget: six tiles per slot, clamped to 1.1x the
    sizing frame's demand where it measured one."""
    from ..ops import pick_max_pairs

    budget = pick_max_pairs(k_vis, per_point=6)
    if demand > 0:
        budget = min(budget, pick_max_pairs(int(demand * 1.1), per_point=1))
    return budget


def block_budget(demand: int) -> int:
    from ..ops import pick_max_pairs

    return pick_max_pairs(int(max(demand, 1) * 1.1), per_point=1)


def k_blocks_for(n_elig: int, blocks_total: int) -> int:
    """The block bucket: 1.3x the eligible blocks in steps of 16, at least
    16."""
    return min(blocks_total, max(16, -(-int(n_elig * 1.3) // 16) * 16))


class Scene:
    """bench.py's scene and orbit on one device, and the cull and frames its
    cells call."""

    def __init__(self, n_roots: int, frames: int, h: int, w: int,
                 focal: float, dev):
        from ..ops import pick_max_pairs
        from .bench_frame_dissect import make_scene

        (self.params, self.tree, self.leaf, self.n,
         self.cap) = make_scene(n_roots, "root_major", dev)
        self.n_roots = n_roots_bucket(n_roots, self.cap)
        self.cap_sort = cap_sort_for(self.n, self.cap)
        self.cull_budget = pick_max_pairs(self.cap, per_point=1)
        # the sizing frames read the unclamped demand: their budget only
        # keeps them cheap (bench.py's 1 << 21 at full size)
        self.sizing = (min(SIZING_BUCKET, self.cap),
                       min(SIZING_BUCKET, self.cull_budget))
        self.cams = C.orbit(frames + 2, h, w, focal, dev)
        self.h, self.w, self.dev = h, w, dev
        self.bg = torch.zeros(3, device=dev)
        self.cull_pairs = []  # each cull's demand (device scalars)

    @torch.no_grad()
    def cull(self, cam, full_cap: bool = False):
        """fused_root_cull over the alive bucket (or every row): its stages
        run as fused_root_cull runs them, keeping the check's demand."""
        from ..model.train_step import root_cull_stages, run_stages

        s = run_stages(root_cull_stages(
            self.params, self.tree, cam, self.n, self.h, self.w,
            prep_backend="tiled", prep_max_pairs=self.cull_budget,
            check_scale=C.CHECK_SCALE, n_roots=self.n_roots,
            cap_sort=0 if full_cap else self.cap_sort))
        self.cull_pairs.append(s["cull_pairs"])
        return s["w_full"]

    def fused(self, cam, min_res: float, k_vis: int, max_pairs: int,
              w_full):
        """(image, counts: leaf, node, pair demand) of the flat_slice
        frame."""
        from ..model.train_step import fused_prepare_render

        img, _, counts, _ = fused_prepare_render(
            self.params, self.tree, cam, self.n, self.leaf, float(min_res),
            C.CURRENT_DEPTH, self.bg, self.h, self.w, k_vis, SH_DEGREE,
            True, NUM_LEVELS, backend="tiled", max_pairs=max_pairs,
            check_scale=C.CHECK_SCALE, cut_method="flat_slice",
            n_roots=self.n_roots, prep_backend="tiled",
            prep_max_pairs=self.cull_budget, cap_sort=self.cap_sort,
            w_full=w_full)
        return img, counts


def find_min_res_for_cut(scene: Scene, target: int, candidates):
    """(the first candidate min_res whose cut at camera 0 holds at most
    target points, else the last; {candidate: cut} of those tried): the
    sizing frame of bench.py, with the per-frame slice cull."""
    cuts = {}
    for mr in candidates:
        _, c = scene.fused(scene.cams[0], mr, *scene.sizing, None)
        cuts[mr] = int(c[:2].sum())
        if cuts[mr] <= target:
            return mr, cuts
    return candidates[-1], cuts


def timed_cell(scene: Scene, make_frame, cull, sizes: dict, budget: int,
               cull_every: int, frames: int, repeats: int, label: str,
               hold=None) -> dict:
    """One cell through `_common.honest_frames` at the buckets `sizes`
    (k_vis; k_blocks and blocks_total for the block frame;
    make_frame(sizes) -> frame(cam, w_full, max_pairs)), then the device
    pass, the sync pass and the held replay. A timed cut past k_vis, or
    eligible blocks past k_blocks, re-sizes that bucket from the largest
    and times the cell again, up to TRIES times; raises where a bucket or
    the pair budget still overflows, or a cull's demand passed its
    budget."""
    dev = scene.dev
    sized_budget, sized = budget, dict(sizes)
    scene.cull_pairs.clear()
    C.reset_peak(dev)
    for attempt in range(C.TRIES):
        frame = make_frame(sizes)
        cell = C.honest_frames(frame, cull, scene.cams, budget, frames,
                               cull_every, dev, repeats=repeats)
        budget = cell["max_pairs"]
        cut = max(cell["cut_per_frame"])
        elig = max(cell["eligible_per_frame"] or [0])
        cell["cut_overflow"] = cut > sizes["k_vis"]
        cell["blocks_overflow"] = elig > sizes.get("k_blocks", elig)
        if not (cell["cut_overflow"] or cell["blocks_overflow"]
                or cell["budget_overflow"]):
            break
        if attempt == C.TRIES - 1:
            raise RuntimeError(
                f"{label}: still overflowing after {C.TRIES} tries: cut "
                f"{cut} (bucket {sizes['k_vis']}), eligible blocks {elig} "
                f"(bucket {sizes.get('k_blocks')}), pair demand "
                f"{cell['pairs_measured']} (budget {budget})")
        sizes["k_vis"] = max(sizes["k_vis"], k_vis_for(cut, scene.cap))
        if cell["blocks_overflow"]:
            sizes["k_blocks"] = k_blocks_for(elig, sizes["blocks_total"])
    peak = C.peak_bytes(dev)
    cull_pairs = int(torch.stack(scene.cull_pairs).max())
    if cull_pairs > scene.cull_budget:
        raise RuntimeError(f"{label}: a cull's pair demand {cull_pairs} "
                           f"passed its budget {scene.cull_budget}")

    def loop(keep=None):
        return C.frame_loop(frame, cull, scene.cams, budget, frames,
                            cull_every, keep)

    device_ms, n_dev, top = C.profiled(loop, 1, dev, TOP_OPS)
    syncs = C.count_syncs(loop, dev)
    if hold is not None:
        with hold(f"bench {label}"):
            frame(scene.cams[2], cull(scene.cams[2]), budget)
    per = frames * repeats
    seven = {k: v / per for k, v in cell["launches"].items()}
    ms = cell["ms_per_frame"]
    cell.update(
        label=label, k_vis=sizes["k_vis"], **{k: v for k, v in sizes.items()
                                              if k != "k_vis"},
        k_vis_resized=sizes["k_vis"] != sized["k_vis"],
        k_blocks_resized=sizes.get("k_blocks") != sized.get("k_blocks"),
        budget_rebumped=budget != sized_budget, sizing_max_pairs=sized_budget,
        device_ms_per_frame=None if device_ms is None else device_ms / frames,
        busy_share=None if device_ms is None else device_ms / frames / ms,
        launches_per_frame=dict(seven, other=None if n_dev is None
                                else n_dev / frames - sum(seven.values())),
        syncs_per_frame=None if syncs is None else syncs / frames,
        top_device_ops=None if top is None else [
            [name[:96], t / frames] for name, t in top],
        peak_gb=None if peak is None else peak / GIB,
        cull_pairs=cull_pairs, cull_budget=scene.cull_budget,
        bench_cull_pairs=BENCH_CULL_PAIRS,
        cull_past_bench_budget=cull_pairs > BENCH_CULL_PAIRS)
    return cell


def fused_cell(scene: Scene, min_res: float, label: str, frames: int,
               repeats: int, hold=None) -> dict:
    """bench.py's measure_honest(min_res, label, cull_every=1): the cull
    over cap_sort, then the flat_slice frame, every frame."""
    cams = scene.cams
    _, c = scene.fused(cams[0], min_res, *scene.sizing, scene.cull(cams[0]))
    c = c.cpu().numpy()
    cut = int(c[:2].sum())
    k_vis = k_vis_for(cut, scene.cap)

    def make_frame(sizes):
        return lambda cam, w, mp: scene.fused(cam, min_res, sizes["k_vis"],
                                              mp, w)

    cell = timed_cell(scene, make_frame, scene.cull, {"k_vis": k_vis},
                      fused_budget(k_vis, int(c[2])), 1, frames, repeats,
                      label, hold)
    cell.update(min_res_pixel=float(min_res), cut=cut,
                sizing_demand=int(c[2]), cap_sort=scene.cap_sort)
    return cell


def block_cache(scene: Scene):
    """(cols, meta, S) of `build_block_cache` at block_size_for(capacity)."""
    from ..model.block_render import block_size_for, build_block_cache

    S = block_size_for(scene.cap)
    cols, meta = build_block_cache(scene.params, scene.tree, scene.leaf,
                                   scene.n, S)
    return cols, meta, S


def block_cell(scene: Scene, cache, min_res: float, label: str,
               frames: int, repeats: int, hold=None) -> dict:
    """bench.py's measure_blocks(min_res, label): the block-pruned frame,
    the full-capacity cull every 4 frames."""
    from ..model.block_render import render_blocks

    cols, meta, S = cache
    B = scene.cap // S
    cams = scene.cams

    def blocks(cam, w_full, k_blocks, k_vis, max_pairs):
        img, _, counts = render_blocks(
            cols, meta, cam, float(min_res), C.CURRENT_DEPTH, scene.bg,
            scene.h, scene.w, k_blocks=k_blocks, k_visible=k_vis,
            max_pairs=max_pairs, w_full=w_full)
        return img, counts

    def cull(cam):
        return scene.cull(cam, full_cap=True)

    def sizing(cam):
        return blocks(cam, cull(cam), B, *scene.sizing)[1].cpu().numpy()

    # cameras past a short orbit's end fall to its last
    c, *rest = [sizing(cams[i]) for i in sorted({min(i, len(cams) - 1)
                                                for i in BLOCK_SIZING_CAMS})]
    cut = int(c[:2].sum())
    n_elig = max(int(x[3]) for x in [c] + rest)

    def make_frame(sizes):
        return lambda cam, w, mp: blocks(cam, w, sizes["k_blocks"],
                                         sizes["k_vis"], mp)

    sizes = {"k_vis": k_vis_for(cut, scene.cap),
             "k_blocks": k_blocks_for(n_elig, B), "blocks_total": B}
    cell = timed_cell(scene, make_frame, cull, sizes, block_budget(int(c[2])),
                      4, frames, repeats, label, hold)
    cell.update(min_res_pixel=float(min_res), cut=cut, blocks_eligible=n_elig,
                sizing_demand=int(c[2]), block_rows=S)
    return cell


def memory(dev) -> dict:
    """bench.py's hbm fields: torch.cuda's allocated bytes and the card's
    total memory, in GiB (None on the CPU)."""
    if dev.type != "cuda":
        return {"hbm_in_use_gb": None, "hbm_limit_gb": None,
                "hbm_source": None}
    return {"hbm_in_use_gb": C.live_bytes(dev) / GIB,
            "hbm_limit_gb": torch.cuda.get_device_properties(dev)
            .total_memory / GIB, "hbm_source": "torch.cuda"}


def run(n_roots: int = N_ROOTS, frames: int = FRAMES,
        repeats: int = REPEATS, h: int = H, w: int = W, focal: float = FOCAL,
        cells=None, device=None, hold=None) -> dict:
    """The cells named (all of CELLS by default) on one scene; bench.py's
    JSON line as a dict, each cell under its key, with the card, the
    realistic search and each cell's wall seconds beside. The realistic
    search tries FIND_CANDIDATES scaled by focal / FOCAL (a splat's radius
    in pixels scales with the focal) against REALISTIC_CUT."""
    dev = C.resolve_device(device)
    cells = CELLS if cells is None else tuple(cells)
    unknown = set(cells) - set(CELLS)
    if unknown:
        raise ValueError(f"unknown cells {sorted(unknown)}")
    t0 = time.perf_counter()
    scene = Scene(n_roots, frames, h, w, focal, dev)
    C.sync(dev)
    out = {"card": C.card_line(dev), "n_roots": n_roots,
           "capacity": scene.cap, "cap_sort": scene.cap_sort,
           "n_roots_bucket": scene.n_roots, "h": h, "w": w, "focal": focal,
           "frames": frames, "repeats": repeats,
           "setup_s": time.perf_counter() - t0}
    wall, res = {}, {}

    def timed(key, fn):
        t = time.perf_counter()
        res[key] = fn()
        wall[key] = time.perf_counter() - t

    cache = None
    if {"blocks_cull4", "secondary_blocks_cull4"} & set(cells):
        cache = block_cache(scene)
    if "headline" in cells:
        timed("headline", lambda: fused_cell(
            scene, HEADLINE_MIN_RES, "minres3_cullfirst_perframe", frames,
            repeats, hold))
    if "blocks_cull4" in cells:
        timed("blocks_cull4", lambda: block_cell(
            scene, cache, HEADLINE_MIN_RES, "minres3_blocks_cull4", frames,
            repeats, hold))
    if {"secondary", "secondary_blocks_cull4"} & set(cells):
        mr, cuts = find_min_res_for_cut(
            scene, REALISTIC_CUT,
            tuple(c * focal / FOCAL for c in FIND_CANDIDATES))
        out.update(realistic_cut=REALISTIC_CUT, realistic_min_res=mr,
                   realistic_cuts={f"{k:g}": v for k, v in cuts.items()})
        if "secondary" in cells:
            timed("secondary", lambda: fused_cell(
                scene, mr, f"realistic_minres{mr:g}_cullfirst_perframe",
                frames, repeats, hold))
        if "secondary_blocks_cull4" in cells:
            timed("secondary_blocks_cull4", lambda: block_cell(
                scene, cache, mr, f"realistic_minres{mr:g}_blocks_cull4",
                frames, repeats, hold))
    head = res.get("headline", {})
    size = "1080p" if (h, w) == (H, W) else f"{w}x{h}"
    fps = head.get("fps")
    out.update({
        "metric": f"full_frame_fps_{size}_{scene.n}pts_tree_cut",
        "value": fps, "unit": "fps",
        "vs_baseline": None if fps is None else fps / BASELINE_FPS,
        "n_points": scene.n, "cut": head.get("cut"),
        "k_vis": head.get("k_vis"), "max_pairs": head.get("max_pairs"),
        "pairs_measured": head.get("pairs_measured"),
        "ms_per_frame": head.get("ms_per_frame"),
        "headline_label": head.get("label"),
        "blocks_cull4": res.get("blocks_cull4"), **memory(dev),
        "secondary": res.get("secondary"),
        "secondary_blocks_cull4": res.get("secondary_blocks_cull4"),
        "headline": head or None, "cell_wall_s": wall})
    return out


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    out = run(*(int(a) for a in argv[:1]))
    if out["card"]:
        print(out["card"], flush=True)
    C.emit(out)


if __name__ == "__main__":
    main()
