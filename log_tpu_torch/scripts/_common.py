"""Shared pieces of the scale and dissection scripts: the device rule, the
card line, the orbit camera of the repo's scripts (`make_cam`), the
synthetic tree as the JAX scale scripts hold it (`PaddedTree`), the
honest timing loop of the frame cells, and the stage timer (`time_stage`,
`stage_table`).

The honest loop sizes a cell's pair budget from the unclamped demand that
its sizing frames measured (`budget_for_demand`), times the frames between
two `torch.cuda.synchronize()` calls and reads every timed frame's demand
(`counts[2]`) after the loop. If a timed frame's demand exceeded the
budget, the frames are timed again at a budget raised from that demand, so
that no reported frame dropped a pair (`bench.py`'s `measure_honest`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import subprocess
import time
import warnings

import numpy as np
import torch

from ..dataset.base import prepare_camera
from ..model.gaussian import next_capacity
from ..ops import budget_for_demand, kernels
from ..render.renderer import camera_device
from ..utils.profiler import is_span

SEED = 0
# model.args of config/synthetic/level_of_gaussian.yml without init_ply
MODEL_ARGS = {
    "use_view_correction": True,
    "gaussian": {"xyz_scale": 1.0, "sh_degree": 1},
    "optimizer": {
        "optimize_keys": ["xyz", "colors", "scaling", "opacity", "rotation",
                          "shs"],
        "opt_all_levels": True,
        "lr_dict": {"xyz": 0.00016, "xyz_final": 0.0000016, "xyz_scale": 1.0,
                    "colors": 0.0025, "shs": 0.000125, "scaling": 0.005,
                    "opacity": 0.05, "rotation": 0.001, "max_steps": 600},
    },
    "tree": {"max_child": 4, "max_level": 30},
    "densify_and_remove": {},
}
CURRENT_DEPTH = 20
CHECK_SCALE = 4
REBUMP = 1.15  # headroom of a budget raised from an overflowing demand
TRIES = 3


def resolve_device(device=None) -> torch.device:
    """The card unless the caller asks for the CPU; raises where CUDA is
    asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the "
                           "CPU")
    return dev


def card_line(dev) -> str | None:
    """`nvidia-smi --query-gpu=name,power.limit` of the card (None on the
    CPU)."""
    if dev.type != "cuda":
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def reset_peak(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)


def peak_bytes(dev) -> int | None:
    """The peak of allocated device memory since reset_peak (None on the
    CPU: a CPU run has no device memory to report)."""
    if dev.type != "cuda":
        return None
    torch.cuda.synchronize(dev)
    return int(torch.cuda.max_memory_allocated(dev))


def live_bytes(dev) -> int | None:
    if dev.type != "cuda":
        return None
    torch.cuda.synchronize(dev)
    return int(torch.cuda.memory_allocated(dev))


def held(hold, label: str):
    """hold(label), the caller's context for a cell's first frame or step
    (chip_smoke.py records its kernel calls there), or nothing."""
    return contextlib.nullcontext() if hold is None else hold(label)


def launches_since(before: dict) -> dict:
    return {k: v - before[k] for k, v in kernels.LAUNCHES.items()}


def make_cam(theta, h, w, focal, height=18.0, radius=22.0) -> dict:
    """The repo's scripts' orbit camera at angle theta, looking at the
    origin, as a render-ready host camera."""
    pos = np.array([radius * math.cos(theta), radius * math.sin(theta),
                    height])
    fwd = -pos / np.linalg.norm(pos)
    right = np.cross(fwd, np.array([0, 0, 1.0]))
    right /= np.linalg.norm(right)
    R = np.stack([right, np.cross(fwd, right), fwd])
    K = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]])
    return prepare_camera({"K": K, "R": R, "T": (-R @ pos).reshape(3, 1),
                           "H": h, "W": w, "center": pos.reshape(3, 1)},
                          1, 0.01, 1000.0)


def orbit(n, h, w, focal, dev, height=18.0, radius=22.0, turns=None):
    """n device cameras at 2 pi i / turns (turns defaults to n)."""
    turns = n if turns is None else turns
    return [camera_device(make_cam(2 * math.pi * i / turns, h, w, focal,
                                   height, radius), dev) for i in range(n)]


class PaddedTree:
    """The synthetic tree as the JAX scale scripts hold it: the arrays of
    `padded_model_device(PRNGKey(seed), n_roots, cap, layout)`
    (scripts/bench_4k.py:82-84, scripts/bench_capacity.py:91-93), drawn on
    the device with the JAX package's random numbers
    (`bench_frame_dissect.make_scene`: synth_tree's build_scene +
    pad_scene; SH degree 0), and the root bucket and level count the
    scripts derive from them. No `LoG` model: the cells call the model's
    functions on these arrays, as the JAX scripts do."""

    def __init__(self, n_roots: int, dev, layout: str = "root_major",
                 seed: int = SEED):
        from .bench_frame_dissect import make_scene

        (self.params, self.tree, self.leaf, self.n,
         self.cap) = make_scene(n_roots, layout, dev, seed)
        self.n_roots = min(next_capacity(n_roots), self.cap)
        self.num_levels = int(self.tree["depth"][: self.n].max()) + 1
        self.block_cache = None

    def build_block_cache(self) -> None:
        """`build_block_cache` at block_size_for(capacity), as the JAX
        scripts call it."""
        from ..model.block_render import block_size_for, build_block_cache

        S = block_size_for(self.cap)
        cols, meta = build_block_cache(self.params, self.tree, self.leaf,
                                       self.n, S)
        self.block_cache = {"cols": cols, "meta": meta, "S": S}


def finite(tensors) -> bool:
    """Every float tensor in a (nested) dict is finite."""
    if isinstance(tensors, dict):
        return all(finite(v) for v in tensors.values())
    if isinstance(tensors, torch.Tensor) and tensors.is_floating_point():
        return bool(torch.isfinite(tensors).all())
    return True


def frame_loop(frame, cull, cams, budget: int, frames: int,
               cull_every: int, keep=None):
    """One pass over the timed frames cams[2:2 + frames]; the cull (cull(cam)
    -> w_full) runs before every cull_every-th frame. keep(image, counts)
    is what the pass keeps of each frame (default: its counts). Returns
    (the last image, [kept])."""
    kept, w = [], None
    for i in range(frames):
        if i % cull_every == 0:
            w = cull(cams[2 + i])
        img, c = frame(cams[2 + i], w, budget)
        kept.append(c if keep is None else keep(img, c))
    return img, kept


def honest_frames(frame, cull, cams, max_pairs: int, frames: int,
                  cull_every: int, dev, hold=None, label: str = "frame",
                  repeats: int = 1):
    """Times `frames` frames over cams[2:] after two warm-up frames (cams[0]
    and cams[1]); the cull (cull(cam) -> w_full) runs every cull_every
    frames, before the frame (`frame_loop`). frame(cam, w_full, max_pairs)
    -> (image, counts) with counts[2] the frame's unclamped pair demand.
    The first warm-up frame and its cull run inside hold(label). The pass
    over the frames is timed `repeats` times, a synchronize before and
    after each: ms_per_frame is the median pass, ms_per_frame_runs every
    pass and ms_per_frame_spread (max - min) / median. Where a timed
    frame's demand passed the budget, the frames are timed again at
    budget_for_demand(demand * REBUMP), up to TRIES times. Reports whether
    every timed frame was finite, and the last one's finiteness and
    spread."""
    def keep_finite(img, counts):  # the counts, then the frame's finiteness
        return torch.cat([counts.to(torch.int64),
                          torch.isfinite(img).all().reshape(1).to(torch.int64)])

    budget = max_pairs
    for attempt in range(TRIES):
        if attempt:
            budget = budget_for_demand(int(demand * REBUMP))
        with (held(hold, label) if attempt == 0
              else contextlib.nullcontext()):
            w0 = cull(cams[0])
            frame(cams[0], w0, budget)
        frame(cams[1], w0, budget)
        before = dict(kernels.LAUNCHES)
        runs, counts = [], []
        for _ in range(repeats):
            sync(dev)
            t0 = time.perf_counter()
            img, kept = frame_loop(frame, cull, cams, budget, frames,
                                   cull_every, keep_finite)
            sync(dev)
            runs.append((time.perf_counter() - t0) * 1e3 / frames)
            counts += kept
        launched = launches_since(before)
        c = torch.stack(counts).cpu().numpy()
        demand = int(c[:, 2].max())
        if demand <= budget:
            break
    ms = float(np.median(runs))
    return {
        "ms_per_frame": ms, "fps": 1e3 / ms, "ms_per_frame_runs": runs,
        "ms_per_frame_spread": (max(runs) - min(runs)) / ms,
        "frames": frames, "repeats": repeats,
        "cull_every": cull_every, "max_pairs": int(budget),
        "pairs_measured": demand,
        "demand_per_frame": [int(x) for x in c[:frames, 2]],
        "cut_per_frame": [int(x) for x in c[:frames, 0] + c[:frames, 1]],
        # columns: the frame's counts, then its finiteness; the block
        # frame's fourth count is its eligible blocks
        "eligible_per_frame": ([int(x) for x in c[:frames, 3]]
                               if c.shape[1] > 4 else None),
        "budget_overflow": demand > budget,
        "budget_rebumped": budget != max_pairs, "launches": launched,
        "image_finite": bool(torch.isfinite(img).all()),
        "images_finite": bool(c[:, -1].all()), "image_std": float(img.std()),
    }


def honest_steps(step, cfg, steps: int, warmup: int, dev, hold=None,
                 label: str = "step") -> dict:
    """Times a training step with a pair budget that holds its demand.
    step(i, cfg) -> metrics runs step i at cfg (a StepConfig) and advances
    the caller's state. The warm-up steps 0 .. warmup - 1 run at
    cfg.max_pairs and measure the unclamped demand (pair_total); step
    `warmup` runs inside hold(label) at the budget max(cfg.max_pairs,
    budget_for_demand(demand * REBUMP)), and the timed steps after it at
    the same budget, a synchronize around each; where one of them passed
    it they are timed again at a budget raised from its demand, up to TRIES
    times. The peak device memory is that of the timed steps."""
    demand = 0
    for i in range(warmup):
        demand = max(demand, int(step(i, cfg)["pair_total"]))
    budget = max(cfg.max_pairs, budget_for_demand(int(demand * REBUMP)))
    with held(hold, label):
        step(warmup, dataclasses.replace(cfg, max_pairs=budget))
    for _ in range(TRIES):
        run_cfg = dataclasses.replace(cfg, max_pairs=budget)
        reset_peak(dev)
        before = dict(kernels.LAUNCHES)
        ms, metrics = [], []
        for i in range(warmup + 1, warmup + 1 + steps):
            sync(dev)
            t0 = time.perf_counter()
            m = step(i, run_cfg)
            sync(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
            metrics.append(m)
        launched = launches_since(before)
        peak = peak_bytes(dev)
        pairs = [int(m["pair_total"]) for m in metrics]
        if max(pairs) <= budget:
            break
        budget = budget_for_demand(int(max(pairs) * REBUMP))
    return {"steps": steps, "warmup": warmup, "step_ms": ms,
            "step_ms_median": float(np.median(ms)), "max_pairs": budget,
            "call_budget": cfg.max_pairs, "warmup_demand": demand,
            "pairs_measured": max(pairs),
            "budget_overflow": max(pairs) > budget,
            "budget_rebumped": budget != cfg.max_pairs,
            "loss": [float(m["loss"]) for m in metrics],
            "kept": [[int(x) for x in m["counts"].cpu()] for m in metrics],
            "peak_bytes": peak, "launches": launched}


def block_cell(tree: PaddedTree, cams, min_res: float, frames: int,
               cull_every: int, dev, sizing=(8, 16), hold=None,
               label="blocks"):
    """The block-pruned frame (render_blocks over the tree's block cache)
    through the honest loop. Sizing frames at cams[0] and cams[sizing]
    (full block and slice buckets) give the cut, the pair demand and the
    eligible blocks; the slice bucket is 1.2x the cut, the block bucket
    1.3x the eligible blocks (steps of 16), the pair budget
    budget_for_demand(1.3x the demand). Returns (cell dict, (frame,
    cull)), the closures the cell timed."""
    from ..model.block_render import render_blocks
    from ..model.train_step import fused_root_cull
    from ..ops import pick_max_pairs

    cache = tree.block_cache
    if cache is None:
        raise RuntimeError("block_cell needs build_block_cache() first")
    params, arrays, cap, n = tree.params, tree.tree, tree.cap, tree.n
    H, W = cams[0]["image_height"], cams[0]["image_width"]
    B = cap // cache["S"]
    bg = torch.zeros(3, device=dev)

    def cull(cam):
        return fused_root_cull(
            params, arrays, cam, n, H, W, prep_backend="tiled",
            prep_max_pairs=pick_max_pairs(cap, per_point=1),
            check_scale=CHECK_SCALE, n_roots=tree.n_roots, cap_sort=0)

    def blocks(cam, w_full, k_blocks, k_visible, max_pairs):
        return render_blocks(
            cache["cols"], cache["meta"], cam, float(min_res), CURRENT_DEPTH,
            bg, H, W, k_blocks=k_blocks, k_visible=k_visible,
            max_pairs=max_pairs, w_full=w_full)

    # the sizing frames read the unclamped demand, so their own budget
    # only needs to be large enough to keep them cheap
    c = []
    for i in (0,) + tuple(min(s, len(cams) - 1) for s in sizing):
        c.append(blocks(cams[i], cull(cams[i]), B, min(1 << 21, cap),
                        min(1 << 22, pick_max_pairs(cap, per_point=1)))[2]
                 .cpu().numpy())
    c = np.stack(c)
    cut = int(c[0, :2].sum())
    k_vis = min(next_capacity(int(cut * 1.2), 1 << 15), cap)
    demand = int(max(c[:, 2].max(), 1))
    n_elig = int(c[:, 3].max())
    kb = min(B, max(16, -(-int(n_elig * 1.3) // 16) * 16))

    def frame(cam, w_full, max_pairs):
        img, _, counts = blocks(cam, w_full, kb, k_vis, max_pairs)
        return img, counts

    budget = budget_for_demand(int(demand * 1.3))
    cell = honest_frames(frame, cull, cams, budget, frames, cull_every, dev,
                         hold, label)
    cell.update(min_res_pixel=float(min_res), cut=cut, k_vis=k_vis,
                cut_overflow=max(cell["cut_per_frame"]) > k_vis,
                sizing_demand=demand, k_blocks=kb, blocks_eligible=n_elig,
                blocks_total=B)
    return cell, (frame, cull)


def _device_events(prof):
    """The profiler's device-side kernel records (not the copies that the
    port's spans also draw on the device timeline)."""
    from torch.autograd import DeviceType

    return [e for e in prof.events()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not is_span(e.name)]


PROFILE_PAD_S = 0.05  # idle host time at each end of a profiled window
PROFILE_TRIES = 3


def profiled(fn, reps: int, dev, top: int = 0):
    """(device ms per call, device kernel launches per call, the `top`
    device ops by time as [name, ms per call]) of fn over reps calls under
    torch.profiler: the time of every device record (copies and fills
    included), the count of the kernels. Nones on the CPU. The profiler
    traces the device only: the host's ops would double the time it takes
    to read the window (17 against 9 s for 30 frames of 1,700 launches on
    an H100) and add no device record. It keeps only the device records
    inside its window, so the calls sit between two idle pads, and a
    window that holds no device record is taken again, up to
    PROFILE_TRIES times (a stage that launches nothing reads 0 after the
    last)."""
    if dev.type != "cuda":
        return None, None, None
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILE_TRIES):
        sync(dev)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            for _ in range(reps):
                fn()
            sync(dev)
            time.sleep(PROFILE_PAD_S)
        events = _device_events(prof)
        if events:
            break
    by_name = {}
    for e in events:
        us = (e.device_time_total if hasattr(e, "device_time_total")
              else e.cuda_time_total)
        by_name[e.name] = by_name.get(e.name, 0.0) + us
    n_kernels = sum(not e.name.startswith(("Memcpy", "Memset"))
                    for e in events)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return (sum(by_name.values()) / 1e3 / reps, n_kernels / reps,
            [[name, us / 1e3 / reps] for name, us in ops])


def count_syncs(fn, dev) -> int | None:
    """Host-device synchronizations of one call of fn: the warnings of
    torch.cuda.set_sync_debug_mode("warn") (None on the CPU)."""
    if dev.type != "cuda":
        return None
    sync(dev)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    sync(dev)
    return sum("synchroniz" in str(w.message) for w in caught)


def time_stage(name: str, fn, reps: int, dev, warmup: int = 1) -> dict:
    """One row of a stage table: fn (one call of the stage on prepared
    inputs) after warmup calls, then
      host_ms: median host time of reps calls, a synchronize around each;
      device_ms, other_launches: the profiler's device kernel time and
        kernel count per call over reps more calls (a separate window: the
        profiler inflates host time), other_launches excluding the seven
        kernels' own;
      launches: the seven kernels' launches per call (ops.kernels counters);
      syncs: host syncs in one more call (set_sync_debug_mode);
      peak_bytes: the peak device memory of one more call.
    Device fields are None on the CPU."""
    for _ in range(warmup):
        fn()
    before = dict(kernels.LAUNCHES)
    ms = []
    for _ in range(reps):
        sync(dev)
        t0 = time.perf_counter()
        fn()
        sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    launched = {k: v / reps for k, v in launches_since(before).items() if v}
    device_ms, n_dev, _ = profiled(fn, reps, dev)
    syncs = count_syncs(fn, dev)
    reset_peak(dev)
    fn()
    return {"stage": name, "host_ms": float(np.median(ms)),
            "host_ms_min": float(np.min(ms)), "device_ms": device_ms,
            "launches": launched,
            "other_launches": (None if n_dev is None
                               else n_dev - sum(launched.values())),
            "syncs": syncs, "peak_bytes": peak_bytes(dev)}


def stage_chain(stages, state=None) -> list:
    """The state dict before each stage of a chain [(name, fn(state))] run
    once in order, and after the last: len(stages) + 1 shallow copies (the
    stages build new tensors and leave their inputs as they were)."""
    state = {} if state is None else dict(state)
    snaps = [dict(state)]
    for _, fn in stages:
        fn(state)
        snaps.append(dict(state))
    return snaps


def stage_table(stages, reps: int, dev, state=None, warmup: int = 1):
    """(rows, final state): each stage of the chain timed alone
    (`time_stage`) on the state the stages before it left, then a row
    "sum" of the stages' host and device times."""
    snaps = stage_chain(stages, state)
    rows = [time_stage(name, lambda fn=fn, i=i: fn(dict(snaps[i])), reps,
                       dev, warmup)
            for i, (name, fn) in enumerate(stages)]
    rows.append(sum_row("sum", rows))
    return rows, snaps[-1]


def sum_row(name: str, rows) -> dict:
    """The sum of rows' times and launches (peak: their largest)."""
    def total(key):
        vals = [r[key] for r in rows]
        return None if any(v is None for v in vals) else sum(vals)

    launched = {}
    for r in rows:
        for k, v in r["launches"].items():
            launched[k] = launched.get(k, 0) + v
    peaks = [r["peak_bytes"] for r in rows]
    return {"stage": name, "host_ms": total("host_ms"),
            "host_ms_min": total("host_ms_min"),
            "device_ms": total("device_ms"), "launches": launched,
            "other_launches": total("other_launches"),
            "syncs": total("syncs"),
            "peak_bytes": None if None in peaks else max(peaks)}


def residual(full: dict, parts: dict) -> dict:
    """full's host and device ms less parts' (the time no stage holds)."""
    return {k: (None if full[k] is None or parts[k] is None
                else full[k] - parts[k]) for k in ("host_ms", "device_ms")}


def emit(out: dict) -> None:
    print(json.dumps(out), flush=True)
